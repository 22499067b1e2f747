"""The port's JPEG coefficient feed against the JAX package's, on the CPU:
the host coefficient reader (io/jpeg.py, io/native/coefs.c), the plain
back-half (ops/jpegdec.py, the plain versions of the K10/K11 kernels),
the test-data encoder (synthetic.encode_jpeg) and the whole coefficient
step (pipeline/decode.py make_coef_decode_fn).

Tolerance: exact everywhere (coefficients, quant tables, ok flags,
packed pixels, error codes, match locations), except the f64 dial
positions, which agree within 1e-9 (reductions run in another order;
assert_port_equal of test_torch_decode)."""
import io

import jax
import numpy as np
import pytest
import torch
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
from meterelf_tpu_torch.errors import ErrCode
from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import jpeg_tail
from meterelf_tpu_torch.ops import jpegdec as tdec
from meterelf_tpu_torch.pipeline.decode import MeterDecoder
from meterelf_tpu_torch.pipeline.decode import make_coef_decode_fn

torch.set_num_threads(2)

CAMERAS = {
    "default": (j_syn.DEFAULT_CAMERA, t_syn.DEFAULT_CAMERA),
    "alt": (j_syn.ALT_CAMERA, t_syn.ALT_CAMERA),
}
FRAME_WH = (640, 480)
FLAGSHIP = t_syn.DEFAULT_CAMERA.meter_rect
# the window of test_jpegdec.py:325-376: odd crop row origin (oy=13),
# plane width 80, staging pad taller and wider than the window
UNALIGNED = (Rect((9, 13), (70, 72)), (128, 96), (96, 128))
LAYOUTS = {"block": {}, "plane": {"plane_layout": True},
           "compact": {"plane_layout": True, "compact": True}}


def _pil(frame_bgr, **kw):
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame_bgr[..., ::-1]), "RGB").save(
        buf, "JPEG", **kw)
    return buf.getvalue()


def _frames(cam, n):
    """n full frames of ``cam`` (the crop offsets of render_crops)."""
    return cam.render_frames(t_syn.dial_positions(n))


def _reader_cases():
    """(frame_wh, rect, datas): PIL-encoded synthetic and rng frames at
    640x480 and odd sizes, quality 75/85/92, with and without restart
    markers every 2 MCU rows, plus frames of the port's own encoder."""
    rng = np.random.default_rng(20261016)
    cam = t_syn.DEFAULT_CAMERA
    synth = _frames(cam, 2)
    cases = [(FRAME_WH, FLAGSHIP,
              [_pil(f, quality=q, subsampling=2, **rst)
               for f in synth + [_rng_frame(rng, 640, 480)[..., ::-1]]
               for q in (75, 85, 92)
               for rst in ({}, {"restart_marker_rows": 2})]
              + [t_syn.encode_jpeg(synth[0], 92),
                 t_syn.encode_jpeg(synth[1], 92, restart_interval=40)])]
    for w, h, rect in ((175, 133, Rect((0, 0), (175, 133))),
                       (161, 97, Rect((140, 70), (161, 97))),
                       (320, 240, Rect((7, 3), (311, 235)))):
        cases.append(((w, h), rect,
                      [_pil(_rng_frame(rng, w, h), quality=q, subsampling=2,
                            **rst)
                       for q in (75, 92)
                       for rst in ({}, {"restart_marker_rows": 2})]))
    return cases


@pytest.fixture(scope="module")
def reader_cases():
    return _reader_cases()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reader_matches_jax(reader_cases, layout):
    """Coefficients, quant tables and ok flags bit-equal to the JAX
    package's reader, in each layout."""
    kw = LAYOUTS[layout]
    for wh, rect, datas in reader_cases:
        win = jdec.coef_window(rect, *wh)
        ref = [np.array(a) for a in jio.read_coefs_batch(datas, win, wh,
                                                         **kw)]
        got = tio.read_coefs_batch(datas, tdec.coef_window(rect, *wh), wh,
                                   **kw)
        assert ref[4].all(), (wh, layout)
        for i, (a, b) in enumerate(zip(ref, got)):
            assert _same(a, b), (wh, layout, i)


def test_reader_table_cache_alternating_streams():
    """Two streams with different (optimised) Huffman tables, decoded
    alternately on one thread: each decodes as it does alone, and as the
    JAX reader decodes it."""
    rng = np.random.default_rng(5)
    a = _pil(_rng_frame(rng, 320, 240), quality=85, subsampling=2,
             optimize=True)
    b = _pil(_rng_frame(rng, 320, 240)[::-1] // 3, quality=60,
             subsampling=2, optimize=True)
    assert _segments(a, 0xC4) != _segments(b, 0xC4)
    rect = Rect((7, 3), (311, 235))
    win = tdec.coef_window(rect, 320, 240)
    datas = [a, b, a, b, b, a]
    got = tio.read_coefs_batch(datas, win, (320, 240), num_threads=1)
    ref = jio.read_coefs_batch(datas, jdec.coef_window(rect, 320, 240),
                               (320, 240), num_threads=1)
    alone = [tio.read_coefs_batch([d], win, (320, 240)) for d in (a, b)]
    assert got[4].all()
    for k in range(5):
        assert _same(np.array(ref[k]), got[k]), k
        for i, d in enumerate(datas):
            assert _same(got[k][i], alone[d is b][k][0]), (k, i)


def test_rejected_frames_are_not_loaded():
    """Frames the fast coefficient reader rejects, held equal to the JAX
    package (whose reader hands them to libjpeg). 16-bit DQT, truncated
    and restart-mismatched frames come back read by the coefficient reader
    with the JAX coefficients; progressive, 4:4:4 and Adobe-RGB frames
    stay rejected there, and the feed decodes them whole into fallback
    slots bit-equal to the JAX feed's, so no frame is left not loaded.
    (The name is that of the test which pinned the old divergence.)"""
    rng = np.random.default_rng(20260819)
    frame = _rng_frame(rng, 160, 128)
    base = _pil(frame[..., ::-1], quality=85, subsampling=2)
    rst = t_syn.encode_jpeg(frame[..., ::-1], 85, restart_interval=2)
    cut = rst.index(b"\xff\xd2")
    bad = {
        "progressive": _pil(frame[..., ::-1], quality=85, subsampling=2,
                            progressive=True),
        "444": _pil(frame[..., ::-1], quality=85, subsampling=0),
        "dqt16": _widen_dqt(base, scale=1),
        "truncated": base[:len(base) // 2],
        "adobe_rgb": _insert_before_sof(_strip_app0(base), _adobe_app14(0)),
        "restart_missing": rst[:cut] + rst[cut + 2:],
    }
    datas = [base] + list(bad.values())
    rect = Rect((16, 16), (80, 80))
    wh = (160, 128)
    read = [True, False, False, True, True, False, True]
    for kw in LAYOUTS.values():
        got = tio.read_coefs_batch(datas, tdec.coef_window(rect, *wh), wh,
                                   **kw)
        ref = jio.read_coefs_batch(datas, jdec.coef_window(rect, *wh), wh,
                                   **kw)
        assert got[4].tolist() == read, kw
        for k in range(5):
            assert _same(np.array(ref[k]), got[k]), (kw, k)
    pad = (rect.height, rect.width)
    win = tuple(tdec.coef_window(rect, *wh))
    feed = tio.load_coef_feed_shard(datas, win, False, rect, wh, pad)
    ref = jio.load_coef_feed_shard(datas, win, False, rect, wh, pad)
    for k in range(7):
        assert _same(np.array(ref[k]), feed[k]), k
    assert feed[4].all()
    assert feed[6].tolist() == [1, 2, 5] + [len(datas)] * 5


def test_encode_jpeg_tables_and_decode(tmp_path):
    """The port's encoder writes PIL's (libjpeg's) quant and Huffman
    tables at quality 92; the JAX fast reader accepts its streams, with
    and without restart markers; libjpeg decodes them within a mean
    absolute error of 1.0 (max 80: chroma subsampling at the needle
    edges) of the rendered frame."""
    cam = t_syn.DEFAULT_CAMERA
    frame = _frames(cam, 1)[0]
    plain = t_syn.encode_jpeg(frame, 92)
    rst = t_syn.encode_jpeg(frame, 92, restart_interval=40)
    pil = _pil(frame, quality=92, subsampling=2)
    for marker in (0xC4, 0xDB):     # DHT, DQT
        assert _segments(plain, marker) == _segments(pil, marker)
    assert b"\xff\xd0" in rst
    win = jdec.coef_window(cam.meter_rect, *FRAME_WH)
    *_, ok = jio.read_coefs_batch([plain, rst], win, FRAME_WH)
    assert ok.all()
    for i, data in enumerate((plain, rst)):
        path = tmp_path / f"enc{i}.jpg"
        path.write_bytes(data)
        img = jio.decode_file(str(path))
        err = np.abs(img.astype(np.int32) - frame.astype(np.int32))
        assert err.mean() < 1.0 and err.max() <= 80, (err.mean(), err.max())


def _segments(data, marker):
    """The bodies of the ``marker`` segments before SOS, joined."""
    out, p = [], 2
    while p + 4 <= len(data):
        m, ln = data[p + 1], (data[p + 2] << 8) | data[p + 3]
        if m == marker:
            out.append(data[p + 4:p + 2 + ln])
        if m == 0xDA:
            break
        p += 2 + ln
    return b"".join(out)


def test_uncompact_plane_full_range():
    """[-2048, 2047] through the compact wire (the C packer's format, by
    its numpy copy io/jpeg.compact_planes) into both packages'
    unpackers."""
    v = np.arange(-2048, 2048).reshape(2, 8, 256).astype(np.int16)
    wire = tio.compact_planes(v)
    ref = np.asarray(jdec.uncompact_plane(jax.numpy.asarray(wire)))
    got = tdec.uncompact_plane(torch.as_tensor(wire)).numpy()
    assert _same(ref, got) and _same(got, v)


@pytest.mark.parametrize("hi", [2048, 32768])
def test_idct_matches_jax(hi):
    """ISLOW IDCT bit-equal to the JAX graph, including |coef| up to
    32767 with qt up to 255, where the i32 sums wrap."""
    rng = np.random.default_rng(7)
    B, bh, bw = 2, 3, 5
    coef = rng.integers(-hi, hi, (B, bh * bw, 64)).astype(np.int16)
    qt = rng.integers(1, 256, (B, 64)).astype(np.uint16)
    ref = np.asarray(jax.jit(lambda c, q: jdec.idct_to_plane(
        c, q, bh, bw))(coef, qt))
    got = tdec.idct_to_plane(torch.as_tensor(coef), torch.as_tensor(qt),
                             bh, bw).numpy()
    assert _same(ref, got)


def test_upsample_and_color_match_jax():
    rng = np.random.default_rng(11)
    c = rng.integers(0, 256, (2, 24, 40)).astype(np.uint8)
    for chv, cwv in ((24, 40), (17, 33)):
        ref = np.asarray(jdec._upsample_h2v2_fancy(
            jax.numpy.asarray(c), chv, cwv))
        got = tdec._upsample_h2v2_fancy(torch.as_tensor(c), chv,
                                        cwv).numpy()
        assert _same(ref, got), (chv, cwv)
    y, cb, cr = (rng.integers(0, 256, (2, 16, 32)).astype(np.uint8)
                 for _ in range(3))
    ref = np.asarray(jdec._ycc_to_packed_bgr(*map(jax.numpy.asarray,
                                                  (y, cb, cr))))
    got = tdec._ycc_to_packed_bgr(*map(torch.as_tensor, (y, cb, cr)))
    assert _same(ref, got.numpy())


def _to_planes(blk, bh, bw):
    n = blk.shape[0]
    return (blk.reshape(n, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4)
            .reshape(n, bh * 8, bw * 8))


WINDOWS = {
    "flagship": (FLAGSHIP, FRAME_WH, (250, 250)),
    "alt": (t_syn.ALT_CAMERA.meter_rect, FRAME_WH, (200, 210)),
    "unaligned": UNALIGNED,
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_backhalf_matches_jax(name):
    """backhalf_to_packed and backhalf_planes_to_packed (dense and
    compact), and the CPU paths of the K10/K11 wrappers, bit-equal to
    the JAX back-half under jax.jit on the CPU (what the JAX package runs
    off the TPU): random coefficients within the compact range, and at
    full i16 range with qt up to 255 for the block and dense layouts."""
    rect, wh, pad_hw = WINDOWS[name]
    win = jdec.coef_window(rect, *wh)
    twin = tdec.coef_window(rect, *wh)
    assert tuple(win) == tuple(twin) and tdec.backhalf_ok(twin, pad_hw)
    rng = np.random.default_rng(20261016)
    B, cbh, cbw = 2, win.lbh // 2, win.lbw // 2
    ref_fn = jax.jit(lambda a, b, c, q: jdec.backhalf_to_packed(
        a, b, c, q, win, pad_hw=pad_hw))
    for hi in (2048, 32768):
        blk = [rng.integers(-hi, hi, (B, n, 64)).astype(np.int16)
               for n in (win.lbh * win.lbw, cbh * cbw, cbh * cbw)]
        if hi == 2048:
            blk = [np.clip(b, -2047, 2047) for b in blk]
        qt = rng.integers(1, 256, (B, 3, 64)).astype(np.uint16)
        ref = np.asarray(ref_fn(*blk, qt))
        t = [torch.as_tensor(b) for b in blk]
        tq = torch.as_tensor(qt)
        got = tdec.backhalf_to_packed(*t, tq, twin, pad_hw).numpy()
        assert _same(ref, got), (name, hi)
        assert _same(ref, jpeg_tail.backhalf_blocks(*t, tq, twin,
                                                    pad_hw).numpy())
        planes = [_to_planes(blk[0], win.lbh, win.lbw)] + [
            _to_planes(b, cbh, cbw) for b in blk[1:]]
        feeds = [planes] + ([[tio.compact_planes(p) for p in planes]]
                            if hi == 2048 else [])
        for f in feeds:
            tf = [torch.as_tensor(p) for p in f]
            assert _same(ref, tdec.backhalf_planes_to_packed(
                *tf, tq, twin, pad_hw).numpy()), (name, hi, f[0].dtype)
            assert _same(ref, jpeg_tail.backhalf_planes(
                *tf, tq, twin, pad_hw).numpy())
    if pad_hw != (win.rh, win.rw):
        assert not got[:, win.rh:].any() and not got[:, :, win.rw:].any()


# a crop past the frame's valid chroma rows (frame 470 rows high, crop to
# row 476): inside the decoded window, so K11 takes it, but K10 does not
PAST_CHROMA = (Rect((50, 300), (300, 476)), (640, 470))


def test_backhalf_gate():
    """K10's gate (backhalf_ok) admits the shipped cameras and the
    unaligned window; K11's (tail_ok) admits every window K10 does, and
    also a crop past the valid chroma and a window too wide for K10's
    shared memory; both refuse a crop that leaves the window and staging
    smaller than the crop."""
    for rect, wh, pad_hw in WINDOWS.values():
        win = tdec.coef_window(rect, *wh)
        assert tdec.backhalf_ok(win, pad_hw) and tdec.tail_ok(win, pad_hw)
    win = tdec.coef_window(FLAGSHIP, *FRAME_WH)
    for gate in (tdec.backhalf_ok, tdec.tail_ok):
        assert not gate(win._replace(rh=win.rh + 40), None)
        assert not gate(win, (200, 250))
    past = tdec.coef_window(PAST_CHROMA[0], *PAST_CHROMA[1])
    wide = win._replace(lbw=620, cw_valid=8 * 310)
    for w in (past, wide):
        assert tdec.tail_ok(w, None) and not tdec.backhalf_ok(w, None), w


def test_feed_sends_windows_k10_refuses_to_the_block_branch():
    """load_coef_feed gives blocks for a window K10 refuses (crop past the
    valid chroma), equal to the JAX reader's; the block branch
    (backhalf_blocks: the plain IDCT, then K11's plain version here)
    finishes them bit-equal to the JAX back-half."""
    rect, wh = PAST_CHROMA
    rng = np.random.default_rng(3)
    datas = [_pil(_rng_frame(rng, *wh), quality=q, subsampling=2)
             for q in (75, 92)]
    pad = (rect.height, rect.width)
    feed = tio.load_coef_feed(datas, rect, wh, pad)
    win = tdec.coef_window(rect, *wh)
    assert feed[4].all() and feed[0].shape == (2, win.lbh * win.lbw, 64)
    jwin = jdec.coef_window(rect, *wh)
    ref_feed = jio.read_coefs_batch(datas, jwin, wh)
    for a, b in zip(ref_feed[:4], feed[:4]):
        assert _same(np.array(a), b)
    ref = np.asarray(jax.jit(lambda a, b, c, q: jdec.backhalf_to_packed(
        a, b, c, q, jwin, pad_hw=pad))(*feed[:4]))
    got = jpeg_tail.backhalf_blocks(*map(torch.as_tensor, feed[:4]), win,
                                    pad)
    assert _same(ref, got.numpy())


def _encoded(cam, n):
    """n frames: the first half encoded by the port's encoder, the rest
    by PIL, all at quality 92."""
    frames = _frames(cam, n)
    return [t_syn.encode_jpeg(f, 92) if i < n // 2
            else _pil(f, quality=92, subsampling=2)
            for i, f in enumerate(frames)]


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def coef_steps(request, tmp_path_factory):
    jc, tc = CAMERAS[request.param]
    jdecoder = JaxDecoder(jc.make_params(str(tmp_path_factory.mktemp("p"))))
    jstep, _, jpad = jax_coef_fn(jdecoder, FRAME_WH)
    tdecoder = MeterDecoder(tc.make_params(), device="cpu")
    tstep, twin, tpad = make_coef_decode_fn(tdecoder, FRAME_WH)
    assert jpad == tpad == (tc.meter_rect.height, tc.meter_rect.width)
    datas = _encoded(tc, 8)
    return (tc, jdecoder, jstep, tdecoder, tstep, datas)


def test_coef_step_matches_jax(coef_steps):
    """Each package on its own feed (the port: compact planes; JAX on the
    CPU: blocks), the same bytes, equal results; readings within 0.1 of
    the rendered positions."""
    cam, jdecoder, jstep, _, tstep, datas = coef_steps
    pad = (cam.meter_rect.height, cam.meter_rect.width)
    jfeed = jio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad)
    tfeed = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad)
    assert tfeed[0].dtype == np.int8 and jfeed[0].dtype == np.int16
    ref = jax.tree.map(np.asarray,
                       jstep(jdecoder.param_arrays, *jfeed))
    res = tstep(None, *tfeed)
    res = type(res)(*[v.numpy() for v in res])
    assert_port_equal(ref, res, "coef step")
    assert (res.err == 0).all() and res.converged.all()
    pos = np.array(t_syn.dial_positions(8))
    err = np.abs((res.dial_pos - pos + 5) % 10 - 5)
    assert err.max() < 0.1, err.max()


def test_coef_step_fallback_scatter(coef_steps):
    """The same fallback slots into both steps: packed pixel crops at
    rows 1 and 6, one slot out of range (dropped), the rest unused; the
    scattered rows decode as their crops do, and row 3 (load_ok False)
    to the load error."""
    cam, jdecoder, jstep, tdecoder, tstep, datas = coef_steps
    pad = (cam.meter_rect.height, cam.meter_rect.width)
    jfeed = list(jio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad))
    tfeed = list(tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad))
    crops = cam.render_crops([[9.9, 0.1, 4.5, 5.5], [2.0, 7.0, 1.0, 8.0],
                              [3.0, 3.0, 3.0, 3.0]])
    fb_packed = np.zeros((8,) + pad, np.int32)
    fb_packed[:3] = tio.pack_crops(crops)
    fb_idx = np.full(8, len(datas), np.int32)
    fb_idx[:3] = [1, 6, len(datas) + 5]
    load_ok = np.ones(len(datas), bool)
    load_ok[3] = False
    for feed in (jfeed, tfeed):
        feed[4:] = [load_ok, fb_packed, fb_idx]
    ref = jax.tree.map(np.asarray, jstep(jdecoder.param_arrays, *jfeed))
    res = tstep(None, *tfeed)
    res = type(res)(*[v.numpy() for v in res])
    assert_port_equal(ref, res, "fallback scatter")
    assert res.err[3] == ErrCode.LOAD and (np.delete(res.err, 3) == 0).all()
    direct = tdecoder.decode_numpy(crops[:2])
    np.testing.assert_array_equal(res.dial_pos[[1, 6]], direct.dial_pos)


@pytest.mark.parametrize("slots", [(-1, -8, -9), (-7, 2, 8)])
def test_coef_step_fallback_negative_indices(coef_steps, slots):
    """Negative fallback indices -B <= i < 0 write row i + B, as JAX's
    scatter with mode="drop" does; i < -B and i >= B drop (B = 8, so
    (-1, -8, -9) writes rows 7 and 0, (-7, 2, 8) rows 1 and 2)."""
    cam, jdecoder, jstep, tdecoder, tstep, datas = coef_steps
    B = len(datas)
    pad = (cam.meter_rect.height, cam.meter_rect.width)
    jfeed = list(jio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad))
    tfeed = list(tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, pad))
    crops = cam.render_crops([[9.9, 0.1, 4.5, 5.5], [2.0, 7.0, 1.0, 8.0],
                              [3.0, 3.0, 3.0, 3.0]])
    fb_packed = np.zeros((8,) + pad, np.int32)
    fb_packed[:3] = tio.pack_crops(crops)
    fb_idx = np.full(8, B, np.int32)
    fb_idx[:3] = slots
    for feed in (jfeed, tfeed):
        feed[4:] = [np.ones(B, bool), fb_packed, fb_idx]
    ref = jax.tree.map(np.asarray, jstep(jdecoder.param_arrays, *jfeed))
    res = tstep(None, *tfeed)
    res = type(res)(*[v.numpy() for v in res])
    assert_port_equal(ref, res, "fallback scatter, negative indices")
    written = [(j, i % B) for j, i in enumerate(slots) if -B <= i < B]
    direct = tdecoder.decode_numpy(crops[[j for j, _ in written]])
    np.testing.assert_array_equal(res.dial_pos[[r for _, r in written]],
                                  direct.dial_pos)
    # the frames' own readings differ from the fallback crops' there
    plain = tstep(None, *tfeed[:4], np.ones(B, bool), fb_packed,
                  np.full(8, B, np.int32))
    assert not np.array_equal(
        plain.dial_pos.numpy()[[r for _, r in written]], direct.dial_pos)
