"""The port's general JPEG decoder (io/native/decoder.c) and the feed's
fallback slots against libjpeg, through the JAX package's reader, on the
CPU: whole-frame pixels (``decode_bytes_full``), packed meter crops
(``load_packed_crops_from_bytes``), the coefficient reader's ok flags and
coefficients on streams its fast path rejects, the feed's fallback slots
and the coefficient step's BatchResult.

Streams come from PIL, from byte patches of them, and from libjpeg's
own encoder through a small C helper (ENCODER_C, built with gcc against
the installed libjpeg): genuine arithmetic-coded and sequential
multi-scan streams, which PIL does not write.

Tolerance: exact everywhere (pixels, coefficients, quant tables, ok
flags, fallback slots, error codes, match locations), except the f64
dial positions, which agree within 1e-9 (assert_port_equal of
test_torch_decode)."""
import io
import subprocess

import jax
import numpy as np
import pytest
from PIL import Image
from test_jpegdec import (_adobe_app14, _insert_before_sof, _rng_frame,
                          _strip_app0, _widen_dqt)
from test_torch_decode import assert_port_equal

from meterelf_tpu import synthetic as j_syn
from meterelf_tpu.io import jpeg as jio
from meterelf_tpu.ops import jpegdec as jdec
from meterelf_tpu.pipeline.decode import MeterDecoder as JaxDecoder
from meterelf_tpu.pipeline.decode import make_coef_decode_fn as jax_coef_fn
from meterelf_tpu.types import Rect
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import jpegdec as tdec
from meterelf_tpu_torch.pipeline.decode import MeterDecoder
from meterelf_tpu_torch.pipeline.decode import make_coef_decode_fn

WH = (160, 128)
RECT = Rect((13, 9), (141, 117))      # odd origin, inside the frame
FRAME_WH = (640, 480)


def _pil(frame_bgr, mode="RGB", **kw):
    buf = io.BytesIO()
    arr = frame_bgr[..., ::-1] if mode == "RGB" else frame_bgr
    Image.fromarray(np.ascontiguousarray(arr), mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _sof_at(data):
    for m in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2"):
        if m in data:
            return data.index(m)
    raise AssertionError("no SOF")


def _sof_at_any(data):
    """The first SOF0/1/2/9/10 marker of a stream."""
    return min(data.index(m) for m in (b"\xff\xc0", b"\xff\xc1",
                                       b"\xff\xc2", b"\xff\xc9",
                                       b"\xff\xca") if m in data)


def _patch(data, offset, value):
    b = bytearray(data)
    b[offset] = value
    return bytes(b)


def _sampling(data, factors):
    """The stream with its SOF's sampling bytes replaced: the entropy data
    then decodes as other (corrupt) blocks, which libjpeg still reads."""
    i = _sof_at(data)
    for c, f in enumerate(factors):
        data = _patch(data, i + 11 + 3 * c, f)
    return data


def _markers(data, lo, hi):
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and lo <= data[i + 1] <= hi]


def _streams():
    """name -> JPEG bytes of a 160x128 frame: every stream class of the
    decoder's contract."""
    rng = np.random.default_rng(20261017)
    fr = _rng_frame(rng, *WH)            # BGR
    s = {}
    for name, ss in (("420", 2), ("422", 1), ("444", 0)):
        s[f"seq_{name}"] = _pil(fr, quality=85, subsampling=ss)
        s[f"prog_{name}"] = _pil(fr, quality=85, subsampling=ss,
                                 progressive=True)
    s["optimized"] = _pil(fr, quality=70, subsampling=2, optimize=True)
    s["gray"] = _pil(fr[..., 1], mode="L", quality=80)
    s["gray_prog"] = _pil(fr[..., 1], mode="L", quality=80,
                          progressive=True)
    base = s["seq_420"]
    s["dqt16"] = _widen_dqt(base, scale=1)
    s["adobe_rgb"] = _insert_before_sof(_strip_app0(base), _adobe_app14(0))
    s["adobe_transform2"] = _insert_before_sof(_strip_app0(base),
                                               _adobe_app14(2))
    s["odd_size"] = _pil(_rng_frame(rng, 157, 99), quality=90, subsampling=2)
    s["tiny"] = _pil(_rng_frame(rng, 3, 3), quality=85, subsampling=2)
    s["encoder_444"] = t_syn.encode_jpeg(fr, 90, subsampling="4:4:4")
    rst = t_syn.encode_jpeg(fr, 90, restart_interval=3)
    r = _markers(rst, 0xD0, 0xD7)
    s["restart"] = rst
    s["restart_missing"] = rst[:r[2]] + rst[r[2] + 2:]
    for name, k, step in (("restart_far", 4, 3), ("restart_prior", 5, -1),
                          ("restart_next", 6, 1)):
        s[name] = _patch(rst, r[k] + 1,
                         0xD0 + ((rst[r[k] + 1] - 0xD0 + step) & 7))
    s["restart_garbage"] = (rst[:r[3]]
                            + bytes(rng.integers(0, 255, 40, np.uint8))
                            + rst[r[3]:])
    s["restart_cut_at_marker"] = rst[:r[7] + 1]
    s["restart_cut_before"] = rst[:r[7] - 5]
    for frac in (0.1, 0.3, 0.5, 0.8, 0.97):
        s[f"truncated_{frac}"] = base[:int(len(base) * frac)]
    prog = s["prog_420"]
    # cut inside the last refinement scans, and before them (libjpeg then
    # smooths the blocks: jdcoefct.c decompress_smooth_data)
    for frac in (0.2, 0.35, 0.65, 0.8, 0.97):
        s[f"prog_truncated_{frac}"] = prog[:int(len(prog) * frac)]
    s["prog_truncated_early"] = prog[:len(prog) // 2]
    # SOF9/SOF10: the Huffman-coded data read by the arithmetic decoder
    s["arithmetic"] = _patch(base, _sof_at(base) + 1, 0xC9)
    s["arithmetic_prog"] = _patch(prog, _sof_at(prog) + 1, 0xCA)
    s444 = s["seq_444"]
    s["sampling_h1v2"] = _sampling(s444, (0x12, 0x11, 0x11))
    s["sampling_h2v1"] = _sampling(s444, (0x21, 0x11, 0x11))
    s["sampling_chroma22"] = _sampling(s444, (0x11, 0x22, 0x11))
    s["sampling_mixed"] = _sampling(s444, (0x22, 0x12, 0x21))
    s["prog_sampling_h1v2"] = _sampling(s["prog_444"], (0x12, 0x11, 0x11))
    # sampling factors 3 and 4: libjpeg's int_upsample
    s["sampling_3"] = _sampling(s444, (0x31, 0x11, 0x11))
    s["sampling_h4"] = _sampling(s444, (0x41, 0x11, 0x11))
    s["sampling_v4"] = _sampling(s444, (0x14, 0x11, 0x11))
    s["garbage_mid"] = (s444[:300] + bytes(rng.integers(0, 255, 200,
                                                        np.uint8))
                        + s444[500:])
    return s


STREAMS = _streams()
NAMES = sorted(STREAMS)


@pytest.fixture(scope="module")
def streams():
    return STREAMS


def _assert_matches_libjpeg(data, name):
    ref = jio._decode_bytes_full(data)
    got = tio.decode_bytes_full(data)
    assert ref is not None and got is not None, name
    assert got.shape == ref.shape and np.array_equal(got, ref), name
    rect = RECT if ref.shape[:2] == WH[::-1] else Rect((0, 0), ref.shape[1::-1])
    pad = (rect.height + 3, rect.width + 5)
    pk_ref, ok_ref = jio.load_packed_crops_from_bytes([data, data[:40]],
                                                      rect, pad)
    pk, ok = tio.load_packed_crops_from_bytes([data, data[:40]], rect, pad)
    assert ok.tolist() == ok_ref.tolist() == [True, False]
    assert np.array_equal(pk, pk_ref)


@pytest.mark.parametrize("name", NAMES)
def test_decoder_matches_libjpeg(streams, name):
    """Whole frames and packed meter crops bit-equal to libjpeg's."""
    _assert_matches_libjpeg(streams[name], name)


# libjpeg's encoder: raw RGB in, a JPEG out, with arithmetic coding, one
# scan per component (sequential) or jpeg_simple_progression, and a
# restart interval in MCUs
ENCODER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

int main(int argc, char **argv)
{
    /* enc IN.rgb W H OUT.jpg QUALITY ARITH MODE RESTART; MODE 0: one
     * interleaved scan, 1: one scan per component, 2: progressive */
    if (argc != 9)
        return 2;
    int w = atoi(argv[2]), h = atoi(argv[3]), mode = atoi(argv[7]);
    unsigned char *rgb = malloc((size_t)w * h * 3);
    FILE *f = fopen(argv[1], "rb");
    if (!f || fread(rgb, 3, (size_t)w * h, f) != (size_t)w * h)
        return 3;
    fclose(f);
    struct jpeg_compress_struct c;
    struct jpeg_error_mgr e;
    static jpeg_scan_info si[3];
    c.err = jpeg_std_error(&e);
    jpeg_create_compress(&c);
    FILE *o = fopen(argv[4], "wb");
    jpeg_stdio_dest(&c, o);
    c.image_width = w;
    c.image_height = h;
    c.input_components = 3;
    c.in_color_space = JCS_RGB;
    jpeg_set_defaults(&c);
    jpeg_set_quality(&c, atoi(argv[5]), TRUE);
    c.arith_code = atoi(argv[6]);
    if (mode == 1) {
        for (int k = 0; k < 3; k++) {
            si[k].comps_in_scan = 1;
            si[k].component_index[0] = k;
            si[k].Ss = 0;
            si[k].Se = 63;
        }
        c.scan_info = si;
        c.num_scans = 3;
    } else if (mode == 2) {
        jpeg_simple_progression(&c);
    }
    c.restart_interval = atoi(argv[8]);
    jpeg_start_compress(&c, TRUE);
    while (c.next_scanline < c.image_height) {
        JSAMPROW row = rgb + (size_t)c.next_scanline * w * 3;
        jpeg_write_scanlines(&c, &row, 1);
    }
    jpeg_finish_compress(&c);
    fclose(o);
    jpeg_destroy_compress(&c);
    return 0;
}
"""


@pytest.fixture(scope="module")
def encode(tmp_path_factory):
    """encode(frame_bgr, quality, arith=0, mode=0, restart=0) -> bytes, by
    libjpeg's encoder (ENCODER_C, compiled here)."""
    d = tmp_path_factory.mktemp("enc")
    (d / "enc.c").write_text(ENCODER_C)
    subprocess.run(["gcc", "-O1", "-o", str(d / "enc"), str(d / "enc.c"),
                    "-ljpeg"], check=True, capture_output=True)

    def run(frame_bgr, quality, arith=0, mode=0, restart=0):
        h, w = frame_bgr.shape[:2]
        (d / "in.rgb").write_bytes(
            np.ascontiguousarray(frame_bgr[..., ::-1]).tobytes())
        subprocess.run([str(d / "enc"), str(d / "in.rgb"), str(w), str(h),
                        str(d / "out.jpg"), str(quality), str(arith),
                        str(mode), str(restart)], check=True)
        return (d / "out.jpg").read_bytes()
    return run


# (arith, mode, restart, cut): genuine libjpeg streams of the 160x128
# frame, whole or cut at a fraction of their bytes
ENCODED = {
    "arith_seq": (1, 0, 0, None),
    "arith_seq_restart": (1, 0, 2, None),
    "arith_seq_multiscan": (1, 1, 0, None),
    "arith_prog": (1, 2, 0, None),
    "arith_prog_restart": (1, 2, 3, None),
    "arith_seq_cut_0.5": (1, 0, 0, 0.5),
    "arith_prog_cut_0.2": (1, 2, 0, 0.2),
    "arith_prog_cut_0.65": (1, 2, 0, 0.65),
    "seq_multiscan": (0, 1, 0, None),
    "seq_multiscan_cut_0.5": (0, 1, 0, 0.5),
    "prog_restart_cut_0.35": (0, 2, 2, 0.35),
}


@pytest.mark.parametrize("name", sorted(ENCODED))
def test_decoder_matches_libjpeg_encoded_streams(encode, name):
    """Arithmetic-coded (SOF9, SOF10, with restarts and cuts) and
    sequential multi-scan streams written by libjpeg itself decode
    bit-equal to libjpeg."""
    arith, mode, restart, cut = ENCODED[name]
    fr = _rng_frame(np.random.default_rng(7), *WH)
    data = encode(fr, 85, arith, mode, restart)
    sof = {(0, False): 0xC0, (0, True): 0xC2, (1, False): 0xC9,
           (1, True): 0xCA}[arith, mode == 2]
    assert data[_sof_at_any(data) + 1] == sof
    _assert_matches_libjpeg(data if cut is None
                            else data[:int(len(data) * cut)], name)


def test_refused_streams(streams):
    """What the decoder does not read, as libjpeg's 8-bit BGR decode does
    not: 12-bit, lossless, CMYK-to-BGR, a sampling ratio that is not an
    integer (3/2: JERR_FRACT_SAMPLE_NOTIMPL) and an MCU of 11 blocks
    (JERR_BAD_MCU_SIZE). Each keeps load_ok=False in both packages."""
    base = streams["seq_420"]
    i = _sof_at(base)
    rng = np.random.default_rng(4)
    cmyk = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (32, 40, 4), np.uint8),
                    "CMYK").save(cmyk, "JPEG", quality=80)
    both = {"12bit": _patch(base, i + 4, 12),
            "lossless": _patch(base, i + 1, 0xC3),
            "cmyk": cmyk.getvalue(),
            "sampling_3_2": _sampling(streams["seq_444"], (0x31, 0x21, 0x11)),
            "mcu_11_blocks": _sampling(streams["seq_444"],
                                       (0x33, 0x11, 0x11))}
    for name, data in both.items():
        assert tio.decode_bytes_full(data) is None, name
        _, ok = tio.load_packed_crops_from_bytes([data], Rect((0, 0), (8, 8)),
                                                 (8, 8))
        assert not ok[0], name
        assert jio._decode_bytes_full(data) is None, name


def _camera_frame_streams():
    """Flagship frames (640x480) as streams the fast coefficient reader
    rejects, cut above, inside and below the meter window, plus restart
    faults and 16-bit DQT."""
    cam = t_syn.DEFAULT_CAMERA
    frames = cam.render_frames(t_syn.dial_positions(4))
    base = _pil(frames[0], quality=92, subsampling=2)
    win = tdec.coef_window(cam.meter_rect, *FRAME_WH)
    # the window's iMCU rows end at luma block row lby0 + lbh: cut points
    # as a fraction of the scan's bytes, which are about uniform in y
    stop = (win.lby0 + win.lbh) * 8 / FRAME_WH[1]
    start = win.lby0 * 8 / FRAME_WH[1]
    cuts = {"above": 0.8 * start, "inside": (start + stop) / 2,
            "below": stop + 0.5 * (1 - stop)}
    s = {f"cut_{k}": base[:int(len(base) * v)] for k, v in cuts.items()}
    rst = t_syn.encode_jpeg(frames[1], 92, restart_interval=20)
    r = _markers(rst, 0xD0, 0xD7)
    s["restart_missing"] = rst[:r[30]] + rst[r[30] + 2:]
    s["restart_wrong"] = _patch(rst, r[40] + 1,
                                0xD0 + ((rst[r[40] + 1] - 0xD0 + 3) & 7))
    s["dqt16"] = _widen_dqt(_pil(frames[2], quality=92, subsampling=2))
    s["adobe_transform2"] = _insert_before_sof(_strip_app0(base),
                                               _adobe_app14(2))
    s["progressive"] = _pil(frames[3], quality=92, subsampling=2,
                            progressive=True)
    s["444"] = _pil(frames[3], quality=92, subsampling=0)
    s["arithmetic"] = _patch(base, _sof_at(base) + 1, 0xC9)
    return cam, s


@pytest.mark.parametrize("layout", ["block", "plane", "compact"])
def test_coefficient_reader_matches_jax(layout):
    """ok flags, coefficients and quant tables of the streams the fast
    reader rejects equal the JAX reader's (libjpeg's
    jpeg_read_coefficients with its early stop: a frame cut below the
    window reads ok with exact coefficients, one cut inside it with the
    rest zero-filled)."""
    kw = {"block": {}, "plane": {"plane_layout": True},
          "compact": {"plane_layout": True, "compact": True}}[layout]
    cam, s = _camera_frame_streams()
    datas = list(s.values())
    ref = jio.read_coefs_batch(datas, jdec.coef_window(cam.meter_rect,
                                                       *FRAME_WH),
                               FRAME_WH, **kw)
    got = tio.read_coefs_batch(datas, tdec.coef_window(cam.meter_rect,
                                                       *FRAME_WH),
                               FRAME_WH, **kw)
    for k in range(5):
        assert np.array_equal(np.array(ref[k]), got[k]), k
    want = {name: name not in ("progressive", "444", "arithmetic")
            for name in s}
    assert dict(zip(s, got[4].tolist())) == want


def test_feed_fallback_slots_match_jax(streams):
    """load_coef_feed_shard with more rejected rows than fallback slots:
    load_ok, fb_idx and fb_packed equal the JAX feed's; the first
    fb_slots rejected rows that decode take the slots, the rest stay not
    loaded."""
    names = ["seq_420", "prog_420", "seq_444", "prog_422", "gray",
             "dqt16", "truncated_0.5", "restart_missing", "adobe_rgb",
             "optimized", "prog_444", "seq_422", "encoder_444"]
    datas = [streams[n] for n in names]
    win = tuple(tdec.coef_window(RECT, *WH))
    pad = (RECT.height, RECT.width + 4)
    for fb_slots in (3, 8):
        ref = jio.load_coef_feed_shard(datas, win, False, RECT, WH, pad,
                                       fb_slots=fb_slots)
        got = tio.load_coef_feed_shard(datas, win, False, RECT, WH, pad,
                                       fb_slots=fb_slots)
        for k in range(7):
            assert np.array_equal(np.array(ref[k]), got[k]), (fb_slots, k)
    assert got[4].all()
    assert got[6].tolist()[:7] == [1, 2, 3, 4, 8, 10, 11]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    jdecoder = JaxDecoder(j_syn.DEFAULT_CAMERA.make_params(
        str(tmp_path_factory.mktemp("p"))))
    jstep, _, _ = jax_coef_fn(jdecoder, FRAME_WH)
    tdecoder = MeterDecoder(t_syn.DEFAULT_CAMERA.make_params(), device="cpu")
    tstep, _, pad = make_coef_decode_fn(tdecoder, FRAME_WH)
    return jdecoder, jstep, tstep, pad


def test_coef_step_with_fallback_frames_matches_jax(steps):
    """A batch of flagship frames that mixes clean frames with frames the
    coefficient reader reads only through its general path and frames
    only the fallback slots read: the step's BatchResult equals the JAX
    package's, every row loads, and the readings lie within 0.1 of the
    rendered positions."""
    jdecoder, jstep, tstep, pad = steps
    cam = t_syn.DEFAULT_CAMERA
    pos = t_syn.dial_positions(8)
    frames = cam.render_frames(pos)
    datas = [t_syn.encode_jpeg(frames[0], 92),
             _pil(frames[1], quality=92, subsampling=2, progressive=True),
             t_syn.encode_jpeg(frames[2], 92, subsampling="4:4:4"),
             _widen_dqt(_pil(frames[3], quality=92, subsampling=2)),
             _pil(frames[4], quality=92, subsampling=1),
             _pil(frames[5], quality=92, subsampling=2),
             _insert_before_sof(_strip_app0(_pil(frames[6], quality=92)),
                                _adobe_app14(0)),
             t_syn.encode_jpeg(frames[7], 92)]
    cut = datas[7]
    datas[7] = cut[:int(len(cut) * 0.9)]     # cut below the meter window
    jfeed = jio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad)
    tfeed = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad)
    for k in (4, 5, 6):
        assert np.array_equal(np.array(jfeed[k]), tfeed[k]), k
    assert tfeed[4].all() and sorted(tfeed[6][:4].tolist()) == [1, 2, 4, 6]
    ref = jax.tree.map(np.asarray, jstep(jdecoder.param_arrays, *jfeed))
    res = tstep(None, *tfeed)
    res = type(res)(*[v.numpy() for v in res])
    assert_port_equal(ref, res, "coef step with fallback frames")
    assert (res.err == 0).all()
    err = np.abs((res.dial_pos - np.array(pos) + 5) % 10 - 5)
    assert err.max() < 0.1, err.max()


def test_coef_step_with_arithmetic_frames_matches_jax(steps, encode):
    """Flagship frames that libjpeg's encoder wrote arithmetic-coded
    (sequential, progressive, with restarts): both coefficient readers
    refuse them (the JAX reader's rc 6) and both feeds decode them whole
    into the fallback slots, the port's decoder now reading SOF9/SOF10.
    The feeds' load flags and fallback slots, and the BatchResults, equal
    the JAX package's."""
    jdecoder, jstep, tstep, pad = steps
    cam = t_syn.DEFAULT_CAMERA
    pos = t_syn.dial_positions(4)
    frames = cam.render_frames(pos)
    datas = [t_syn.encode_jpeg(frames[0], 92),
             encode(frames[1], 92, arith=1),
             encode(frames[2], 92, arith=1, mode=2),
             encode(frames[3], 92, arith=1, restart=4)]
    jfeed = jio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad)
    tfeed = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad)
    for k in (4, 5, 6):                  # load_ok, fb_packed, fb_idx
        assert np.array_equal(np.array(jfeed[k]), tfeed[k]), k
    assert tfeed[4].all() and sorted(tfeed[6][:3].tolist()) == [1, 2, 3]
    ref = jax.tree.map(np.asarray, jstep(jdecoder.param_arrays, *jfeed))
    res = tstep(None, *tfeed)
    res = type(res)(*[v.numpy() for v in res])
    assert_port_equal(ref, res, "coef step with arithmetic frames")
    err = np.abs((res.dial_pos - np.array(pos) + 5) % 10 - 5)
    assert (res.err == 0).all() and err.max() < 0.1, err.max()


def test_multiscan_sequential_is_a_reference_side_fault(steps, encode):
    """Sequential 4:2:0 in one scan per component (libjpeg's encoder, noisy
    flagship frames of ~130 KB). The JAX coefficient reader's libjpeg path
    stops at the window's last iMCU row inside the first (Y) scan once its
    4 KB chunks reach it (meterelf_jpeg.c:787-797), so it reports the frame
    read with every chroma coefficient zero: the JAX feed's readings then
    differ from the JAX pixel path's (ROADMAP, open faults on the reference
    side). The port's reader refuses the frame, its feed decodes it whole
    into a fallback slot, and its step equals the JAX pixel path."""
    jdecoder, jstep, tstep, pad = steps
    cam = t_syn.DEFAULT_CAMERA
    pos = t_syn.dial_positions(4)
    rng = np.random.default_rng(1)
    frames = [np.clip(f.astype(int) + rng.integers(-20, 21, f.shape), 0,
                      255).astype(np.uint8) for f in cam.render_frames(pos)]
    datas = [encode(f, 92, mode=1) for f in frames]
    win = jdec.coef_window(cam.meter_rect, *FRAME_WH)
    coefs = jio.read_coefs_batch(datas, win, FRAME_WH)
    assert np.asarray(coefs[4]).all()
    assert not np.asarray(coefs[1]).any() and not np.asarray(coefs[2]).any()
    jfeed = jio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad)
    jax_feed = jax.tree.map(np.asarray,
                            jstep(jdecoder.param_arrays, *jfeed))
    pk, ok = jio.load_packed_crops_from_bytes(datas, cam.meter_rect, pad)
    jax_pixels = jdecoder.decode_numpy(pk, ok)
    assert np.abs(jax_feed.dial_pos - jax_pixels.dial_pos).max() > 0.1
    tfeed = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad)
    assert tfeed[4].all() and sorted(tfeed[6][:4].tolist()) == [0, 1, 2, 3]
    res = tstep(None, *tfeed)
    res = type(res)(*[v.numpy() for v in res])
    assert_port_equal(jax_pixels, res, "multi-scan frames vs JAX pixels")
    err = np.abs((res.dial_pos - np.array(pos) + 5) % 10 - 5)
    assert (res.err == 0).all() and err.max() < 0.1, err.max()
