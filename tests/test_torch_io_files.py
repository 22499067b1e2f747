"""The port's copied and new host helpers against the JAX package's, on
the CPU: ops/cvdft.match_template_max (the OpenCV-exact score of the
DIALS_NOT_FOUND string) bit for bit; the JPEG file helpers of io/jpeg.py
(decode_file, decode_region, crop_rect, load_crops, load_crops_threaded,
load_crop_bytes_u8) on synthetic JPEGs, an undersized frame, a truncated
one, garbage bytes and a missing path; and the coefficient feed's
``compact=`` switch (dense planes equal to the JAX feed's, the step's
results equal across compact and dense, METERELF_COEF_COMPACT read when
compact is None). Exact everywhere."""
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from meterelf_tpu.io import jpeg as jio
from meterelf_tpu.ops import cvdft as j_cvdft
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import cvdft as t_cvdft
from meterelf_tpu_torch.ops.jpegdec import coef_window
from meterelf_tpu_torch.pipeline.decode import (MeterDecoder,
                                                make_coef_decode_fn)

torch.set_num_threads(2)

FRAME_WH = (640, 480)
CAMERAS = {"default": t_syn.DEFAULT_CAMERA, "alt": t_syn.ALT_CAMERA}


def test_cvdft_is_a_copy():
    with open(j_cvdft.__file__) as a, open(t_cvdft.__file__) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_match_template_max_bit_equal(cam):
    """Random, blank, constant and frame-derived lightness crops of the
    camera's crop size against its template: the same f32 bits."""
    camera = CAMERAS[cam]
    t = camera.make_template()
    rng = np.random.default_rng(11)
    h, w = camera.meter_rect.height, camera.meter_rect.width
    frame = camera.render_frame([1.0, 2.0, 3.0, 4.0])
    (x0, y0), (x1, y1) = camera.meter_rect
    crops = [rng.integers(0, 256, (h, w), np.uint8),
             np.zeros((h, w), np.uint8),
             np.full((h, w), 128, np.uint8),
             np.ascontiguousarray(frame[y0:y1, x0:x1, 1])]
    for c in crops:
        a = j_cvdft.match_template_max(c, t)
        b = t_cvdft.match_template_max(c, t)
        assert np.float32(a).tobytes() == np.float32(b).tobytes()


@pytest.fixture(scope="module")
def jpeg_files(tmp_path_factory):
    """Flagship frames (PIL and the port's encoder), an undersized frame,
    a truncated stream, garbage bytes and a missing path."""
    d = tmp_path_factory.mktemp("jpegs")
    cam = t_syn.DEFAULT_CAMERA
    rng = np.random.default_rng(5)
    files = []
    for i, f in enumerate(cam.render_frames(t_syn.dial_positions(4))):
        p = str(d / f"f{i}.jpg")
        if i % 2:
            with open(p, "wb") as fp:
                fp.write(t_syn.encode_jpeg(f, 92))
        else:
            Image.fromarray(f[..., ::-1]).save(p, quality=85)
        files.append(p)
    p = str(d / "small.jpg")
    Image.fromarray(np.full((200, 240, 3), 90, np.uint8)).save(p)
    files.append(p)
    data = open(files[0], "rb").read()
    p = str(d / "trunc.jpg")
    open(p, "wb").write(data[:len(data) * 3 // 5])
    files.append(p)
    p = str(d / "garbage.jpg")
    open(p, "wb").write(rng.integers(0, 256, 5000, np.uint8).tobytes())
    files += [p, str(d / "missing.jpg")]
    return cam, files


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_decode_file_and_region(jpeg_files):
    cam, files = jpeg_files
    for fn in files:
        name = os.path.basename(fn)
        assert _same(jio.decode_file(fn), tio.decode_file(fn)), name
        assert _same(jio.decode_region(fn, cam.meter_rect),
                     tio.decode_region(fn, cam.meter_rect)), name
        img = tio.decode_file(fn)
        if img is not None:
            assert _same(jio.crop_rect(img, cam.meter_rect),
                         tio.crop_rect(img, cam.meter_rect))
    assert tio.decode_file(files[0], max_w=100) is None
    assert tio.decode_region(files[4], cam.meter_rect) is None  # undersized


@pytest.mark.parametrize("batch", [None, 10])
def test_load_crops_equal(jpeg_files, batch):
    cam, files = jpeg_files
    for jf, tf in ((jio.load_crops, tio.load_crops),
                   (jio.load_crops_threaded, tio.load_crops_threaded)):
        (a, ak), (b, bk) = (jf(files, cam.meter_rect, batch),
                            tf(files, cam.meter_rect, batch))
        assert _same(a, b) and _same(ak, bk), jf.__name__
        assert bk[:len(files)].tolist() == [True] * 4 + [False, True] + [
            False] * 2


def test_load_crop_bytes_u8_equal(jpeg_files):
    cam, files = jpeg_files
    datas = [open(f, "rb").read() if os.path.exists(f) else b""
             for f in files]
    (a, ak), (b, bk) = (jio.load_crop_bytes_u8(datas, cam.meter_rect),
                        tio.load_crop_bytes_u8(datas, cam.meter_rect))
    assert _same(a, b) and _same(ak, bk)


def _datas(cam, n):
    frames = cam.render_frames(t_syn.dial_positions(n))
    out = []
    for i, f in enumerate(frames):
        if i % 2:
            out.append(t_syn.encode_jpeg(f, 92))
        else:
            buf = io.BytesIO()
            Image.fromarray(f[..., ::-1]).save(buf, "JPEG", quality=92)
            out.append(buf.getvalue())
    out[3] = t_syn.encode_jpeg(frames[3], 92, subsampling="4:4:4")
    return out


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_coef_feed_compact_switch(cam, monkeypatch):
    """Dense planes (compact=False) equal the JAX feed's dense planes; the
    compact wire equals the JAX compact wire; compact=None follows
    METERELF_COEF_COMPACT; the step gives the same BatchResult on the
    compact and the dense feed."""
    camera = CAMERAS[cam]
    rect = camera.meter_rect
    pad = (rect.height, rect.width)
    datas = _datas(camera, 6)
    win = tuple(coef_window(rect, *FRAME_WH))
    feeds = {}
    for compact in (False, True):
        tf = tio.load_coef_feed(datas, rect, FRAME_WH, pad, compact=compact)
        jf = jio.load_coef_feed_shard(datas, win, True, rect, FRAME_WH, pad,
                                      compact=compact)
        assert tf[0].dtype == (np.int8 if compact else np.int16)
        for i, (a, b) in enumerate(zip(jf, tf)):
            assert _same(np.asarray(a), b), (compact, i)
        ts = tio.load_coef_feed_shard(datas, win, True, rect, FRAME_WH, pad,
                                      compact=compact)
        assert all(_same(a, b) for a, b in zip(ts, tf))
        feeds[compact] = tf
    for env, compact in (("0", False), ("1", True)):
        monkeypatch.setenv("METERELF_COEF_COMPACT", env)
        f = tio.load_coef_feed(datas, rect, FRAME_WH, pad)
        assert all(_same(a, b) for a, b in zip(f, feeds[compact])), env
    monkeypatch.delenv("METERELF_COEF_COMPACT")
    assert tio.load_coef_feed(datas, rect, FRAME_WH, pad)[0].dtype == np.int8
    step, _, _ = make_coef_decode_fn(
        MeterDecoder(camera.make_params(), device="cpu"), FRAME_WH)
    dense, packed = (step(None, *feeds[c]) for c in (False, True))
    for f, a, b in zip(dense._fields, dense, packed):
        assert torch.equal(a, b), f
    assert (dense.err == 0).all()
