"""The port's CUDA kernels against their plain torch versions on the
card (marked ``cuda``; each test skips where torch.cuda.is_available()
is False). Run them on a machine with a GPU, where JAX need not be
installed (``--noconftest`` skips tests/conftest.py, which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The first test builds the kernels with nvcc (meterelf_tpu_torch/_build).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from meterelf_tpu_torch import _build, params, synthetic
from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import angles, ccl, components, frontend
from meterelf_tpu_torch.ops import jpeg_tail, jpegdec, match, stats, windows
from meterelf_tpu_torch.ops.color import lightness_from_planes, unpack_planes
from meterelf_tpu_torch.pipeline.decode import MeterDecoder, make_coef_decode_fn
from meterelf_tpu_torch.types import Rect
from jpeg_windows import JPEG_WINDOWS, K11_ALL, k11_random_planes
from window_families import FAMILIES, STATS_CASES, family_case, stats_cases

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda
W = 64


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def case(dev):
    """Flagship decoder on the card and 8 synthetic crops with speckle."""
    cam = synthetic.DEFAULT_CAMERA
    rng = np.random.default_rng(3)
    crops = cam.render_crops(rng.uniform(0, 10, (8, 4)).tolist())
    speck = rng.random(crops.shape[:3]) < 0.01
    crops[speck] = (40, 40, 200)
    dec = MeterDecoder(cam.make_params(), device=dev)
    return dec, crops, torch.as_tensor(tio.pack_crops(crops)).to(dev)


def test_frontend_kernel_equals_plain(case):
    dec, _, packed = case
    args = (packed, dec.param_arrays.template_u8, dec.score_c1, dec.score_c0)
    got = frontend.frontend(*args)
    ref = frontend.frontend_plain(*args)
    torch.cuda.synchronize()
    assert got[0].cpu().numpy().tobytes() == ref[0].cpu().numpy().tobytes()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


def test_windows_ccl_stats_kernels_equal_plain(case):
    dec, _, packed = case
    mx, my = frontend.frontend(packed, dec.param_arrays.template_u8,
                               dec.score_c1, dec.score_c0)[1:]
    args = (packed, mx, my, dec.geom, dec.disk, dec.hue_shift)
    bits = windows.windows(*args)
    assert torch.equal(bits, windows.windows_plain(*args))
    flat = bits.reshape(-1, W, W)
    for caps in (None, (1, 1, 1), components.RESCUE_CAPS):
        got = ccl.ccl(flat, caps)
        ref = components.propagate(flat, caps)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    okey3 = ccl.ccl(flat)[0]
    km, ha = stats.stats(okey3)
    km_r, ha_r = stats.stats_plain(okey3)
    assert torch.equal(km, km_r) and torch.equal(ha, ha_r)


# caps of the CCL card tests: the defaults, small and zero caps whose
# partial states the rescue depends on, and the rescue's own
CCL_CAPS = [None, (1, 1, 1), (4, 2, 2), (3, 5, 0), (0, 0, 0),
            components.RESCUE_CAPS]
CCL_WINDOWS = ["speckled", "noise_0.05", "noise_0.2", "noise_0.35",
               "noise_0.6", "all_masked", "no_disk", "odd_batch"]


def _ccl_windows(name, case):
    """Window bits [K, 64, 64] on the card: the speckled flagship windows
    of ``case`` (K1 then K2), numpy dense noise inside the r=23 disk, an
    all-masked window, a window whose disk bit is 0 everywhere, and a
    batch of 7 mixed windows (one window a CTA: any count is whole)."""
    dec, _, packed = case
    if name == "speckled":
        mx, my = frontend.frontend(packed, dec.param_arrays.template_u8,
                                   dec.score_c1, dec.score_c0)[1:]
        return windows.windows(packed, mx, my, dec.geom, dec.disk,
                               dec.hue_shift).reshape(-1, W, W)
    yy, xx = np.mgrid[:W, :W]
    disk = (yy - 32) ** 2 + (xx - 32) ** 2 <= 23 ** 2
    rng = np.random.default_rng(len(name))
    if name.startswith("noise_"):
        closed = rng.random((8, W, W)) < float(name[6:])
    elif name == "all_masked":
        closed = np.ones((1, W, W), bool)
        disk = np.ones((W, W), bool)
    elif name == "no_disk":
        closed = rng.random((2, W, W)) < 0.3
        disk = np.zeros((W, W), bool)
    else:
        closed = rng.random((7, W, W)) < rng.uniform(0.02, 0.6, (7, 1, 1))
    masked = closed & disk
    bits = masked + 2 * disk + 4 * closed.astype(np.int32)
    return torch.as_tensor(bits.astype(np.int32)).to(dec.device)


@pytest.mark.parametrize("caps", CCL_CAPS)
@pytest.mark.parametrize("family", CCL_WINDOWS)
def test_ccl_kernels_equal_plain_on_window_families(case, family, caps):
    """K3 and K6 bit-equal to components.propagate (okey and converged)
    under every caps set on each window family, each launch checked by a
    synchronize."""
    bits = _ccl_windows(family, case)
    for kernel, pack_closed in ((ccl.ccl, True), (ccl.propagate, False)):
        n = kernel.launches
        got = kernel(bits, caps)
        torch.cuda.synchronize()
        assert kernel.launches == n + 1
        ref = components.propagate(bits, caps, pack_closed=pack_closed)
        assert torch.equal(got[0], ref[0]), (family, caps, pack_closed)
        assert torch.equal(got[1], ref[1]), (family, caps, pack_closed)


def test_propagate_and_match_kernels_equal_plain(case):
    """K6 under three caps and K8 on the flagship crops, bit-equal to
    their plain versions; K1's staging size equals its Python gate's."""
    dec, _, packed = case
    mx, my = frontend.frontend(packed, dec.param_arrays.template_u8,
                               dec.score_c1, dec.score_c0)[1:]
    flat = windows.windows(packed, mx, my, dec.geom, dec.disk,
                           dec.hue_shift).reshape(-1, W, W)
    for caps in (None, (1, 1, 1), components.RESCUE_CAPS):
        got = ccl.propagate(flat, caps)
        ref = components.propagate(flat, caps, pack_closed=False)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    L = lightness_from_planes(*unpack_planes(packed)).to(torch.float32)
    tmpl = dec.param_arrays.template_u8
    got = match.match_scores(L, tmpl, dec.tmean)
    ref = match.match_scores_plain(L, tmpl, dec.tmean)
    torch.cuda.synchronize()
    assert got.cpu().numpy().tobytes() == ref.cpu().numpy().tobytes()
    lib = _build.library()
    for shape in ((250, 250, 119, 188), (200, 210, 90, 141),
                  (256, 256, 128, 129), (250, 256, 128, 192),
                  (120, 200, 40, 141)):
        assert lib.meterelf_frontend_smem_bytes(*shape) == \
            frontend.k1_smem_bytes(*shape)


def test_variant_kernels_equal_plain(case):
    """K5 against its plain version and against K1 then K2; K7 on K6's
    okey against its plain version and K4's keymax on the same windows;
    K9 against its plain version, and match_scores_v1 bitwise against
    K8's map."""
    dec, _, packed = case
    tmpl = dec.param_arrays.template_u8
    args = (packed, tmpl, dec.score_c1, dec.score_c0, dec.geom, dec.disk,
            dec.hue_shift)
    n5 = frontend.frontend_windows.launches
    got = frontend.frontend_windows(*args)
    ref = frontend.frontend_windows_plain(*args)
    mv, mx, my = frontend.frontend(*args[:4])
    split = (mv, mx, my, windows.windows(packed, mx, my, *args[4:]))
    torch.cuda.synchronize()
    assert frontend.frontend_windows.launches == n5 + 1
    for other in (ref, split):
        assert got[0].cpu().numpy().tobytes() == \
            other[0].cpu().numpy().tobytes()
        for x, y in zip(got[1:], other[1:]):
            assert torch.equal(x, y)
    flat = got[3].reshape(-1, W, W)
    okey, _ = ccl.propagate(flat)
    contrib = stats.cell_contrib(okey >> 2)
    n7 = stats.stats_select.launches
    km = stats.stats_select(okey, contrib)
    assert stats.stats_select.launches == n7 + 1
    assert torch.equal(km, stats.stats_select_plain(okey, contrib))
    # contributions 4-7 carry the same low bits: & 3 masks the rest
    assert torch.equal(km, stats.stats_select(okey, contrib | 4))
    assert torch.equal(km, stats.stats(ccl.ccl(flat)[0])[0])
    L = lightness_from_planes(*unpack_planes(packed)).to(torch.float32)
    n9 = match.match_corr.launches
    corr = match.match_corr(L, tmpl)
    assert match.match_corr.launches == n9 + 1
    torch.cuda.synchronize()
    assert corr.cpu().numpy().tobytes() == \
        match.match_corr_plain(L, tmpl).cpu().numpy().tobytes()
    v1 = match.match_scores_v1(L, tmpl, dec.tmean)
    torch.cuda.synchronize()
    assert v1.cpu().numpy().tobytes() == \
        match.match_scores(L, tmpl, dec.tmean).cpu().numpy().tobytes()


def _on(dev, *arrays):
    return [torch.as_tensor(a).to(dev) for a in arrays]


@pytest.mark.parametrize("name", FAMILIES + ("mixed",))
def test_window_kernels_equal_plain_on_families(dev, name):
    """K2 (five dials) and K5 (four) bit-equal to their plain versions on
    the window families of tests/window_families.py (every pixel in
    range, none, checkerboards, raw pixels on every window edge, layers
    that stop at each test of the colour chain, random), with the dial
    centres at 0, 1, 2, 61, 62 and 63 and hue shifts 0, 128 and 255; K5
    equal to K1 then K2."""
    for D in (5, 4):
        packed, mx, my, geom, disk = family_case(name, 3, 17 + D, D)
        p, mxt, myt, dk = _on(dev, packed, mx, my, disk)
        for hue in (0, 128, 255):
            args = (p, mxt, myt, geom, dk, hue)
            n = windows.windows.launches
            got = windows.windows(*args)
            torch.cuda.synchronize()
            assert windows.windows.launches == n + 1
            assert torch.equal(got, windows.windows_plain(*args)), (D, hue)
    # K5: the template is image 0's lightness over its four windows, so
    # the located offsets put the families' windows in place
    L = lightness_from_planes(*unpack_planes(p))
    tmpl_np = L[0, my[0]:my[0] + 128, mx[0]:mx[0] + 192].cpu().numpy() \
        .astype(np.uint8)
    tmpl = torch.as_tensor(tmpl_np).to(dev)
    c1, c0 = frontend.score_constants(tmpl_np)
    for hue in (0, 255):
        args = (p, tmpl, c1, c0, geom, dk, hue)
        n = frontend.frontend_windows.launches
        got = frontend.frontend_windows(*args)
        ref = frontend.frontend_windows_plain(*args)
        mv, mx1, my1 = frontend.frontend(*args[:4])
        split = (mv, mx1, my1, windows.windows(p, mx1, my1, geom, dk, hue))
        torch.cuda.synchronize()
        assert frontend.frontend_windows.launches == n + 1
        assert (int(mx1[0]), int(my1[0])) == (int(mx[0]), int(my[0]))
        for other in (ref, split):
            assert got[0].cpu().numpy().tobytes() == \
                other[0].cpu().numpy().tobytes()
            for x, y in zip(got[1:], other[1:]):
                assert torch.equal(x, y), hue


@pytest.mark.parametrize("B", [1, 257])
@pytest.mark.parametrize("D", range(1, 9))
def test_windows_kernel_dials_and_batches(dev, D, B):
    """K2 at every dial count it takes (1..8) and batches of 1 and 257
    (one window a CTA: any B * D), on mixed window families, hue shifts
    0, 128 and 255."""
    packed, mx, my, geom, disk = family_case("mixed", B, 31 * D + B, D)
    p, mxt, myt, dk = _on(dev, packed, mx, my, disk)
    for hue in (0, 128, 255):
        args = (p, mxt, myt, geom, dk, hue)
        got = windows.windows(*args)
        torch.cuda.synchronize()
        assert got.shape == (B, D, W, W)
        assert torch.equal(got, windows.windows_plain(*args)), hue


@pytest.mark.parametrize("name", STATS_CASES)
def test_stats_kernels_equal_plain_on_cases(dev, name):
    """K4 and K7 bit-equal to their plain versions on the one-owner
    window (worst contention; area2 and bcount at their maxima, and K7's
    area2 at 12288 with contributions 3), the 4096-owner window, only the
    sentinel, alternating owners, owner blocks and propagated windows,
    each tiled to 1030 windows (more than one CTA an SM); K7's keymax
    equal to K4's on the same windows."""
    okey3 = stats_cases()[name]
    okey3 = np.ascontiguousarray(np.resize(okey3, (1030, W, W)))
    okey = ((okey3 >> 3) * 4 + (okey3 & 3)).astype(np.int32)
    ok3, ok = _on(dev, okey3, okey)
    contrib = stats.cell_contrib(ok >> 2)
    high = contrib | 3 | 4 * torch.as_tensor(
        np.random.default_rng(1).integers(0, 2, okey.shape).astype(np.int32)
    ).to(dev)
    n4, n7 = stats.stats.launches, stats.stats_select.launches
    km, ha = stats.stats(ok3)
    km_r, ha_r = stats.stats_plain(ok3)
    assert ha.dtype == torch.bool
    assert torch.equal(km, km_r) and torch.equal(ha, ha_r)
    for c in (contrib, high):
        km7 = stats.stats_select(ok, c)
        assert torch.equal(km7, stats.stats_select_plain(ok, c))
    assert torch.equal(stats.stats_select(ok, contrib), km)
    torch.cuda.synchronize()
    assert (stats.stats.launches, stats.stats_select.launches) == \
        (n4 + 1, n7 + 3)


# (H, W, th, tw) of the tensor-core correlation's card tests, for K1/K5
# and for K8/K9: ALT_CAMERA's template (K8's gate admits it on maps up to
# 205 wide, ow <= 65), the largest staging each gate admits, and a
# template under 64 rows
CORR_GEOMS = {
    "alt": ((200, 210, 90, 141), (200, 205, 90, 141)),
    "largest": ((256, 256, 128, 129), (250, 256, 128, 192)),
    "short": ((120, 200, 40, 141), (120, 200, 40, 141)),
}


def _corr_inputs(shape, fill, dev):
    """Packed grey-or-random crops [B, H, W] and a template [th, tw] on
    the card; fill "a_b" makes every lightness a and every template
    value b (the accumulator extremes)."""
    H, W, th, tw = shape
    rng = np.random.default_rng(H * 3 + tw)
    B = 1 if th < 64 else 3   # K5's windows must fit every row's argmax
    if fill == "random":
        bgr = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
        tmpl = rng.integers(0, 256, (th, tw), dtype=np.uint8)
    else:
        lv, tv = map(int, fill.split("_"))
        bgr = np.full((B, H, W, 3), lv, np.uint8)
        tmpl = np.full((th, tw), tv, np.uint8)
    return (torch.as_tensor(tio.pack_crops(bgr)).to(dev),
            torch.as_tensor(tmpl).to(dev), tmpl)


def _fitting_geom(base, mx, my, H, W):
    """K5's 4 dials with window origins at the corners of the range that
    keeps every row's windows inside the crop; the rest of each dial as
    the flagship's."""
    x_lo, x_hi = -int(mx.min()), W - 64 - int(mx.max())
    y_lo, y_hi = -int(my.min()), H - 64 - int(my.max())
    assert x_lo <= x_hi and y_lo <= y_hi
    corners = ((x_lo, y_lo), (x_hi, y_lo), (x_lo, y_hi), (x_hi, y_hi))
    return [c + tuple(g[2:]) for c, g in zip(corners, base)]


@pytest.mark.parametrize("fill", ["random", "0_0", "255_255", "0_255"])
@pytest.mark.parametrize("name", sorted(CORR_GEOMS))
def test_correlation_kernels_equal_plain(case, name, fill):
    """K1, K5, K8 and K9 on the int8 tensor cores bit-equal to their
    plain versions at ALT_CAMERA's template, the largest gated stagings,
    a template under 64 rows, and all-0 / all-255 operands (every
    product +2^14, +127^2, or -128 * 127)."""
    dec, _, _ = case
    dev = dec.device
    fe_shape, sc_shape = CORR_GEOMS[name]
    packed, tmpl, tmpl_np = _corr_inputs(fe_shape, fill, dev)
    c1, c0 = frontend.score_constants(tmpl_np)
    n1, n5 = frontend.frontend.launches, frontend.frontend_windows.launches
    got = frontend.frontend(packed, tmpl, c1, c0)
    ref = frontend.frontend_plain(packed, tmpl, c1, c0)
    torch.cuda.synchronize()
    assert got[0].cpu().numpy().tobytes() == ref[0].cpu().numpy().tobytes()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    geom = _fitting_geom(dec.geom, ref[1].cpu(), ref[2].cpu(),
                         *fe_shape[:2])
    args = (packed, tmpl, c1, c0, geom, dec.disk, dec.hue_shift)
    got5 = frontend.frontend_windows(*args)
    ref5 = frontend.frontend_windows_plain(*args)
    torch.cuda.synchronize()
    assert got5[0].cpu().numpy().tobytes() == \
        ref5[0].cpu().numpy().tobytes()
    for x, y in zip(got5[1:], ref5[1:]):
        assert torch.equal(x, y)
    assert (frontend.frontend.launches, frontend.frontend_windows.launches) \
        == (n1 + 1, n5 + 1)

    packed, tmpl, tmpl_np = _corr_inputs(sc_shape, fill, dev)
    assert match.fits(*sc_shape)
    L = lightness_from_planes(*unpack_planes(packed)).to(torch.float32)
    tmean = float(np.float32(tmpl_np.astype(np.int64).sum())
                  / np.float32(tmpl_np.size))
    n8, n9 = match.match_scores.launches, match.match_corr.launches
    for got, ref in ((match.match_scores(L, tmpl, tmean),
                      match.match_scores_plain(L, tmpl, tmean)),
                     (match.match_corr(L, tmpl),
                      match.match_corr_plain(L, tmpl))):
        torch.cuda.synchronize()
        assert got.cpu().numpy().tobytes() == ref.cpu().numpy().tobytes()
    assert (match.match_scores.launches, match.match_corr.launches) == \
        (n8 + 1, n9 + 1)


# (H, W, th, tw) of K1's wgmma correlation: one x tile (ow = 63, 64) and
# two (65, 128); oh at a multiple of 8 and one past it; th = 64 and 136,
# tw = 64 and 256 (n = 16 ceil(oh / 16) from 128 to 208)
K1_GEOMS = {
    "ow63": (250, 250, 119, 188),
    "ow64": (250, 251, 119, 188),
    "ow65": (250, 252, 119, 188),
    "ow128": (256, 256, 64, 129),
    "oh128": (191, 191, 64, 64),
    "oh129": (192, 191, 64, 64),
    "th136": (256, 250, 136, 188),
    "tw256": (256, 256, 136, 256),
}


@pytest.mark.parametrize("fill", ["random", "0_0", "255_255", "0_255"])
@pytest.mark.parametrize("name", sorted(K1_GEOMS))
def test_k1_wgmma_equals_plain(case, name, fill):
    """K1's warpgroup-product correlation bit-equal to frontend_plain
    (max_val bytes, mx, my) across its x tiles, y widths and template
    sizes; the constant fills tie every offset, so the first maximum in
    row-major order is what they check."""
    dev = case[0].device
    packed, tmpl, tmpl_np = _corr_inputs(K1_GEOMS[name], fill, dev)
    c1, c0 = frontend.score_constants(tmpl_np)
    n1 = frontend.frontend.launches
    got = frontend.frontend(packed, tmpl, c1, c0)
    ref = frontend.frontend_plain(packed, tmpl, c1, c0)
    torch.cuda.synchronize()
    assert got[0].cpu().numpy().tobytes() == ref[0].cpu().numpy().tobytes()
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert frontend.frontend.launches == n1 + 1


def _equal_results(a, b):
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if f in ("dial_pos", "value"):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-9, err_msg=f)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


# the flagship with dial "0.1" 1 px below the template's top edge: its
# 5x5 colour sample starts at window row -1, which K2 wraps as the JAX
# graph's dynamic slice does
EDGE_CAMERA = synthetic.SyntheticCamera(
    dial_specs=tuple(synthetic.DIAL_SPECS[:3]) + (("0.1", (160.9, 1.5), 12),))


@pytest.mark.parametrize("branch", ["five_dial", "edge_centre", "scorer_only"])
def test_general_branches_on_card_equal_cpu(dev, branch):
    """FIVE_DIAL_CAMERA and the edge-centre camera (K1, K2, K6) and the
    flagship forced down the scorer-only branch (K8, K2, K6) on the card
    equal the CPU decoder; K3 and K4 never launch there."""
    cam = {"five_dial": synthetic.FIVE_DIAL_CAMERA,
           "edge_centre": EDGE_CAMERA,
           "scorer_only": synthetic.DEFAULT_CAMERA}[branch]
    D = len(cam.dial_specs)
    pos = synthetic.dial_positions(8, dials=D)
    crops = cam.render_crops(pos)
    decs = [MeterDecoder(cam.make_params(), device=d) for d in (dev, "cpu")]
    if branch == "scorer_only":
        for d in decs:
            d.static_kwargs["static_win_origin"] = None
    kernels = (frontend.frontend, match.match_scores, ccl.ccl, stats.stats,
               ccl.propagate)
    before = [k.launches for k in kernels]
    a = decs[0].decode_numpy(crops)
    n = [k.launches - b for k, b in zip(kernels, before)]
    _equal_results(a, decs[1].decode_numpy(crops))
    assert n[2:] == [0, 0, 1]
    assert n[:2] == ([0, 1] if branch == "scorer_only" else [1, 0])
    if branch != "edge_centre":     # its clipped dial reads off the needle
        err = np.abs((a.dial_pos - np.array(pos) + 5) % 10 - 5)
        assert (a.err == 0).all() and err.max() < 0.1


def test_fallback_feed_on_card_equals_cpu(dev):
    """A coefficient feed whose fallback slots hold 4:4:4 and truncated
    frames (the port's encoder; the card's machine has no PIL): every row
    loads, and the card's step equals the CPU step."""
    cam = synthetic.DEFAULT_CAMERA
    frames = cam.render_frames(synthetic.dial_positions(6))
    datas = [synthetic.encode_jpeg(f, 92, subsampling="4:4:4" if i % 2
                                   else "4:2:0")
             for i, f in enumerate(frames)]
    datas[4] = datas[4][:len(datas[4]) // 2]
    feed = tio.load_coef_feed(datas, cam.meter_rect, (640, 480), (250, 250))
    assert feed[4].all() and sorted(feed[6][:3].tolist()) == [1, 3, 5]
    steps = [make_coef_decode_fn(MeterDecoder(cam.make_params(), device=d),
                                 (640, 480))[0] for d in (dev, "cpu")]
    a, b = (s(None, *feed) for s in steps)
    _equal_results(type(a)(*[v.cpu().numpy() for v in a]),
                   type(b)(*[v.numpy() for v in b]))


def test_decoder_on_card_equals_cpu_decoder(case):
    dec, crops, _ = case
    cpu = MeterDecoder(dec.params, device="cpu")
    launches = [f.launches for f in (frontend.frontend, windows.windows,
                                     ccl.ccl, stats.stats)]
    a, b = dec.decode_numpy(crops), cpu.decode_numpy(crops)
    after = [f.launches for f in (frontend.frontend, windows.windows,
                                  ccl.ccl, stats.stats)]
    assert all(n1 > n0 for n0, n1 in zip(launches, after))
    for f in ("err", "match_x", "match_y", "readable", "converged",
              "match_val"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # f64 angle sums run in another order on the card
    np.testing.assert_allclose(a.dial_pos, b.dial_pos, rtol=0, atol=1e-9)


def test_wrappers_refuse_bad_inputs(case, dev):
    dec, _, packed = case
    with pytest.raises(TypeError):
        frontend.frontend(packed.to(torch.int64),
                          dec.param_arrays.template_u8, 0.0, 0.0)
    with pytest.raises(ValueError):
        ccl.ccl(torch.zeros((2, 32, 32), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):   # a crop past K1's 256 x 256
        frontend.frontend(
            torch.zeros((1, 1024, 1024), dtype=torch.int32, device=dev),
            torch.zeros((119, 188), dtype=torch.uint8, device=dev), 0.0, 0.0)
    # K12: inputs of another dtype or shape, more dials than its warps,
    # geometry off the card; none launches, and a good call still does
    pa = dec.param_arrays
    okey3 = torch.zeros((2, 4, W * W), dtype=torch.int32, device=dev)
    keymax = torch.full((2, 4), -1, dtype=torch.int32, device=dev)
    n = angles.readout.launches
    with pytest.raises(TypeError):
        angles.readout(okey3.to(torch.int64), keymax, pa)
    with pytest.raises(TypeError):
        angles.readout(okey3.to(torch.bool), keymax, pa)
    with pytest.raises(ValueError):
        angles.readout(okey3, keymax[:1], pa)
    with pytest.raises(ValueError):
        angles.readout(okey3[..., :W], keymax, pa)
    with pytest.raises(ValueError):
        angles.readout(torch.zeros((2, 9, W * W), dtype=torch.bool,
                                   device=dev), None, pa)
    with pytest.raises(ValueError):
        angles.readout(okey3, keymax,
                       params.to_device(dec.params.arrays(), "cpu"))
    assert angles.readout.launches == n
    got = angles.readout(okey3, keymax, pa)
    assert angles.readout.launches == n + 1
    want = angles.readout_plain(okey3, keymax, pa)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wrappers_refuse_misaligned_inputs(case, dev):
    """A contiguous view whose data does not start on the kernel's widest
    load (an int2 of okey3, okey and contrib in K4/K7, two disk bytes in
    K2/K5) is refused with a ValueError before any launch, and the card
    stays usable."""
    dec, _, packed = case

    def shifted(like: torch.Tensor) -> torch.Tensor:
        flat = torch.empty(like.numel() + 1, dtype=like.dtype, device=dev)
        view = flat[1:].view(like.shape)
        view.copy_(like)
        return view

    okey = torch.full((4, W, W), 4096 << 3, dtype=torch.int32, device=dev)
    contrib = torch.zeros_like(okey)
    with pytest.raises(ValueError, match="aligned"):
        stats.stats(shifted(okey))
    with pytest.raises(ValueError, match="aligned"):
        stats.stats_select(shifted(okey), contrib)
    with pytest.raises(ValueError, match="aligned"):
        stats.stats_select(okey, shifted(contrib))
    tmpl = dec.param_arrays.template_u8
    mx, my = frontend.frontend(packed, tmpl, dec.score_c1, dec.score_c0)[1:]
    disk = shifted(dec.disk)
    assert disk.is_contiguous() and disk.data_ptr() % 2
    with pytest.raises(ValueError, match="aligned"):
        windows.windows(packed, mx, my, dec.geom, disk, dec.hue_shift)
    with pytest.raises(ValueError, match="aligned"):
        frontend.frontend_windows(packed, tmpl, dec.score_c1, dec.score_c0,
                                  dec.geom, disk, dec.hue_shift)
    # the aligned inputs still launch and agree with the plain versions
    got = stats.stats(okey)
    ref = stats.stats_plain(okey)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    args = (packed, mx, my, dec.geom, dec.disk, dec.hue_shift)
    assert torch.equal(windows.windows(*args), windows.windows_plain(*args))


def _planes(win, B, hi, rng):
    lh, lw = 8 * win.lbh, 8 * win.lbw
    return [rng.integers(-hi, hi, (B, r, c)).astype(np.int16)
            for r, c in ((lh, lw), (lh // 2, lw // 2), (lh // 2, lw // 2))]


def _blocks(planes, win, dev):
    return [jpegdec._plane_to_blocks(torch.as_tensor(p).to(dev), *bs)
            for p, bs in zip(planes, [(win.lbh, win.lbw)]
                             + [(win.lbh // 2, win.lbw // 2)] * 2)]


@pytest.mark.parametrize("name", sorted(JPEG_WINDOWS))
def test_jpeg_kernels_equal_plain(dev, name):
    """K10 on compact and dense planes (dense also at full i16 range,
    where the IDCT sums wrap) and the block branch (plain IDCT + K11)
    bit-equal to their plain versions on the card."""
    rect, wh, pad_hw = JPEG_WINDOWS[name]
    win = jpegdec.coef_window(rect, *wh)
    rng = np.random.default_rng(9)
    B = 4
    qt = torch.as_tensor(rng.integers(1, 256, (B, 3, 64)).astype(
        np.uint16)).to(dev)
    n0, n1 = jpeg_tail.backhalf_planes.launches, \
        jpeg_tail.upsample_color_pack.launches
    for hi in (2047, 32767):
        planes = _planes(win, B, hi + 1, rng)
        feeds = [planes] + ([[tio.compact_planes(p) for p in planes]]
                            if hi == 2047 else [])
        for f in feeds:
            t = [torch.as_tensor(p).to(dev) for p in f]
            got = jpeg_tail.backhalf_planes(*t, qt, win, pad_hw)
            ref = jpegdec.backhalf_planes_to_packed(*t, qt, win, pad_hw)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (name, hi, f[0].dtype)
        blocks = _blocks(planes, win, dev)
        got = jpeg_tail.backhalf_blocks(*blocks, qt, win, pad_hw)
        ref = jpegdec.backhalf_to_packed(*blocks, qt, win, pad_hw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (name, hi, "blocks")
    assert jpeg_tail.backhalf_planes.launches == n0 + 3
    assert jpeg_tail.upsample_color_pack.launches == n1 + 2


def _k10_equal_plain(dev, planes, qt, win, pad_hw):
    """K10 on the dense planes (and their compact wire when they fit it)
    bit-equal to its plain version; returns the launches made."""
    feeds = [planes]
    if all(-2048 <= p.min() and p.max() <= 2047 for p in planes):
        feeds.append([tio.compact_planes(p) for p in planes])
    tq = torch.as_tensor(qt).to(dev)
    for f in feeds:
        t = [torch.as_tensor(p).to(dev) for p in f]
        got = jpeg_tail.backhalf_planes(*t, tq, win, pad_hw)
        ref = jpegdec.backhalf_planes_to_packed(*t, tq, win, pad_hw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f[0].dtype
    return len(feeds)


@pytest.mark.parametrize("B", [1, 257])
def test_k10_batch_sizes_equal_plain(dev, B):
    """K10 at one image and at 257 (a grid of 16 bands x 257) on the
    flagship window, compact and dense, bit-equal to the plain version."""
    rect, wh, pad_hw = JPEG_WINDOWS["flagship"]
    win = jpegdec.coef_window(rect, *wh)
    rng = np.random.default_rng(B)
    qt = rng.integers(1, 256, (B, 3, 64)).astype(np.uint16)
    n0 = jpeg_tail.backhalf_planes.launches
    n = _k10_equal_plain(dev, _planes(win, B, 2048, rng), qt, win, pad_hw)
    assert jpeg_tail.backhalf_planes.launches == n0 + n == n0 + 2


@pytest.mark.parametrize("fill", ["zero", "extreme"])
@pytest.mark.parametrize("name", sorted(JPEG_WINDOWS))
def test_k10_zero_and_extreme_coefficients(dev, name, fill):
    """K10 bit-equal to the plain version on all-zero coefficients, and on
    coefficients at the ends of their range with q = 255 (+-2047 on the
    compact wire, +-32767 dense: the butterfly's sums wrap)."""
    rect, wh, pad_hw = JPEG_WINDOWS[name]
    win = jpegdec.coef_window(rect, *wh)
    rng = np.random.default_rng(6)
    B = 3
    shapes = [p.shape for p in _planes(win, B, 1, rng)]
    if fill == "zero":
        qt = rng.integers(1, 256, (B, 3, 64)).astype(np.uint16)
        sets = [[np.zeros(s, np.int16) for s in shapes]]
    else:
        qt = np.full((B, 3, 64), 255, np.uint16)
        sets = [[(hi * rng.choice([-1, 1], s)).astype(np.int16)
                 for s in shapes] for hi in (2047, 32767)]
    for planes in sets:
        _k10_equal_plain(dev, planes, qt, win, pad_hw)


def test_block_branch_takes_windows_k10_refuses(dev):
    """A crop past the frame's valid chroma rows (frame 470 rows high,
    crop to row 476): K10 refuses the window, and the block branch (plain
    IDCT + K11) finishes it bit-equal to its plain version."""
    rect, wh = Rect((50, 300), (300, 476)), (640, 470)
    win = jpegdec.coef_window(rect, *wh)
    assert not jpegdec.backhalf_ok(win, None)
    rng = np.random.default_rng(4)
    planes = _planes(win, 2, 2048, rng)
    qt = torch.as_tensor(rng.integers(1, 256, (2, 3, 64)).astype(
        np.uint16)).to(dev)
    with pytest.raises(ValueError):
        jpeg_tail.backhalf_planes(*[torch.as_tensor(p).to(dev)
                                    for p in planes], qt, win)
    blocks = _blocks(planes, win, dev)
    n1 = jpeg_tail.upsample_color_pack.launches
    got = jpeg_tail.backhalf_blocks(*blocks, qt, win)
    ref = jpegdec.backhalf_to_packed(*blocks, qt, win)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert jpeg_tail.upsample_color_pack.launches == n1 + 1


def test_coef_step_on_card_equals_cpu(dev):
    """JPEG bytes through the card's coefficient step equal the CPU step
    (plain versions): 8 flagship frames from the port's encoder."""
    cam = synthetic.DEFAULT_CAMERA
    datas = [synthetic.encode_jpeg(f, 92)
             for f in cam.render_frames(synthetic.dial_positions(8))]
    feed = tio.load_coef_feed(datas, cam.meter_rect, (640, 480), (250, 250))
    assert feed[4].all() and feed[0].dtype == np.int8
    step, _, _ = make_coef_decode_fn(
        MeterDecoder(cam.make_params(), device=dev), (640, 480))
    cpu_step, _, _ = make_coef_decode_fn(
        MeterDecoder(cam.make_params(), device="cpu"), (640, 480))
    n0 = jpeg_tail.backhalf_planes.launches
    res = step(None, *feed)
    assert jpeg_tail.backhalf_planes.launches == n0 + 1
    for f, x, y in zip(res._fields, res, cpu_step(None, *feed)):
        x, y = x.cpu().numpy(), y.numpy()
        if f in ("dial_pos", "value"):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-9)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_jpeg_wrappers_refuse_bad_inputs(dev):
    rect, wh, _ = JPEG_WINDOWS["flagship"]
    win = jpegdec.coef_window(rect, *wh)
    lh, lw = 8 * win.lbh, 8 * win.lbw
    fy = torch.zeros((1, lh, lw), dtype=torch.int16, device=dev)
    fc = torch.zeros((1, lh // 2, lw // 2), dtype=torch.int16, device=dev)
    qt = torch.ones((1, 3, 64), dtype=torch.uint16, device=dev)
    with pytest.raises(ValueError):      # staging smaller than the crop
        jpeg_tail.backhalf_planes(fy, fc, fc, qt, win, (200, 250))
    with pytest.raises(TypeError):
        jpeg_tail.backhalf_planes(fy, fc, fc, qt.to(torch.int32), win)
    with pytest.raises(ValueError):      # chroma plane of the wrong shape
        jpeg_tail.backhalf_planes(fy, fy, fy, qt, win)


def _k11_equal_plain(dev, win, pad_hw, B, rng, fill=None):
    """K11 on u8 planes (uniform from rng, or all ``fill``) bit-equal to
    its plain version through the wrapper and through its C entry."""
    planes = k11_random_planes(win, B, rng, dev, fill)
    ref = jpegdec.tail_to_packed(*planes, win, pad_hw)
    n0 = jpeg_tail.upsample_color_pack.launches
    got = jpeg_tail.upsample_color_pack(*planes, win, pad_hw)
    args, out = jpeg_tail.upsample_c_args(*planes, win, pad_hw)
    assert _build.library().meterelf_upsample_color_pack(*args) == 0
    torch.cuda.synchronize()
    assert torch.equal(got, ref), (win, pad_hw, B, fill)
    assert torch.equal(out, ref), (win, pad_hw, B, fill)
    assert jpeg_tail.upsample_color_pack.launches == n0 + 1


@pytest.mark.parametrize("name", sorted(K11_ALL))
def test_k11_equals_plain_on_windows(dev, name):
    """K11 bit-equal to tail_to_packed on random u8 planes and on all-0
    and all-255 planes, on every K11 window: both cameras, JPEG_WINDOWS,
    the windows K10 refuses (past the valid chroma rows, past the valid
    chroma columns, 4,960 columns wide, the far clamps outside a tile),
    staging widths of every residue mod 4, an odd ox, a pad past the
    crop."""
    win, pad_hw = K11_ALL[name]
    assert jpegdec.tail_ok(win, pad_hw)
    rng = np.random.default_rng(sum(map(ord, name)))
    B = 2 if win.lbw > 64 else 5
    for fill in (None, 0, 255):
        _k11_equal_plain(dev, win, pad_hw, B, rng, fill)


@pytest.mark.parametrize("B", [1, 257])
@pytest.mark.parametrize("name", ["flagship", "past_chroma_rows",
                                  "past_chroma_cols", "odd_ox_odd_pw"])
def test_k11_batch_sizes_equal_plain(dev, name, B):
    """K11 at one image and at 257 (flagship: a grid of 257 x 16 bands)
    bit-equal to its plain version."""
    win, pad_hw = K11_ALL[name]
    _k11_equal_plain(dev, win, pad_hw, B, np.random.default_rng(B))


def test_cli_on_card_equals_cpu(dev, tmp_path):
    """``python -m meterelf_tpu_torch`` on the card (the default device)
    prints the bytes METERELF_DEVICE=cpu prints, on flagship JPEGs (the
    port's encoder) with every error kind: a stubbed dial, a blind dial,
    an all-zero frame, garbage bytes and a missing path; then the same
    under METERELF_EXACT=0."""
    cam = synthetic.DEFAULT_CAMERA
    yml = cam.write_params(str(tmp_path))
    rng = np.random.default_rng(12)
    frames = cam.render_frames(rng.uniform(0, 10, (6, 4)).tolist())
    off = (30, 40)
    stub = cam.render_frame([1.0, 3.0, 5.0, 7.0], offset=off,
                            stub_dials=(1,))
    frames += [stub, synthetic.blind_dial(stub, cam, off, 1),
               np.zeros_like(stub)]
    files = []
    for i, f in enumerate(frames):
        files.append(str(tmp_path / f"f{i}.jpg"))
        with open(files[-1], "wb") as fp:
            fp.write(synthetic.encode_jpeg(f, 92))
    files.append(str(tmp_path / "garbage.jpg"))
    with open(files[-1], "wb") as fp:
        fp.write(rng.integers(0, 256, 3000, np.uint8).tobytes())
    files.append(str(tmp_path / "missing.jpg"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = {k: v for k, v in os.environ.items()
            if k not in ("DEBUG", "METERELF_DEVICE", "METERELF_EXACT")}
    base["PYTHONPATH"] = repo
    for extra in ({}, {"METERELF_EXACT": "0"}):
        out = {}
        for device in ("", "cpu"):
            env = {**base, **extra}
            if device:
                env["METERELF_DEVICE"] = device
            r = subprocess.run([sys.executable, "-m", "meterelf_tpu_torch",
                                yml, *files], env=env, capture_output=True,
                               text=True, timeout=600)
            assert r.returncode == 0, r.stderr[-3000:]
            out[device] = r.stdout
        assert out[""] == out["cpu"], extra
        lines = out[""].splitlines()
        assert len(lines) == len(files)
        assert sum("UNKNOWN" not in line for line in lines) >= 5
        for i, what in ((6, "Cannot determine angle"),
                        (7, "Cannot find needle contours"),
                        (8, "Dials not found (match val = 0.0)"),
                        (9, "Unable to load image"),
                        (10, "Unable to load image")):
            assert what in lines[i], lines[i]
