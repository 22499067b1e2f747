"""The kernels that no decode of the PyTorch port runs, K5
frontend_windows, K7 stats_select and K9 match_corr (plain versions, as
they run on the CPU), against the JAX package: Pallas kernels in
interpret mode, as tests/test_ops.py runs them on the CPU, or through
their JAX compositions. And the JAX package's decode knobs, which select
nothing in the port: whole decodes under each of them against the JAX
CPU decoder, and the kernels each decode runs.

Tolerances: exact for window bits, match locations, keymax, needle
regions and every discrete decode field. K5's max_val against the JAX
CPU scorer within rtol 1e-4 (tests/fuzz_frames.py's bound: that scorer
rounds in f32). K9 against the TPU kernel: |difference| <= 1e-5 of the
map's largest |score| (the TPU kernel sums its 119 row partials in f32,
the port's corr is exact; PERF.md section 6, K8), and bitwise against
K8's plain map. f64 dial positions within 1e-9 (assert_port_equal of
test_torch_decode)."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fuzz_frames import fuzz_frames
from test_torch_decode import assert_port_equal

from meterelf_tpu import synthetic as j_syn
from meterelf_tpu.ops import color as j_color
from meterelf_tpu.ops import components as j_comp
from meterelf_tpu.ops import pallas_frontend as j_fe
from meterelf_tpu.ops import pallas_match as j_match
from meterelf_tpu.ops import pallas_stats as j_stats
from meterelf_tpu.ops import pallas_windows as j_win
from meterelf_tpu.ops import template as j_template
from meterelf_tpu.pipeline.decode import MeterDecoder as JaxDecoder
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.ops import ccl, components, frontend, match, stats
from meterelf_tpu_torch.pipeline import decode as t_decode
from meterelf_tpu_torch.pipeline.decode import MeterDecoder

torch.set_num_threads(2)

W = 64
CAMERAS = {
    "default": (j_syn.DEFAULT_CAMERA, t_syn.DEFAULT_CAMERA),
    "alt": (j_syn.ALT_CAMERA, t_syn.ALT_CAMERA),
}
# one value of each JAX decode knob other than the JAX default, as
# meterelf_tpu/ops/pallas_{ccl,stats,frontend}.py and
# meterelf_tpu/pipeline/decode.py parse them
KNOBS = [("METERELF_FRONTEND", "merged"),
         ("METERELF_QUAD_STATS", "hist_pallas"),
         ("METERELF_QUAD_STATS", "sort"),
         ("METERELF_QUAD_STATS", "hist"),
         ("METERELF_QUAD_STATS", "hist_pallas_interpret"),
         ("METERELF_CCL_SKIPREV", "1"),
         ("METERELF_CCL_GLUE", "fwd"),
         ("METERELF_CCL_GQ", "16"),
         ("METERELF_STATS_GW", "8"),
         ("METERELF_STATS_SLICED", "1"),
         ("METERELF_CCL_DEQUAD", "0"),
         ("METERELF_FE_SHEAR", "0"),
         ("METERELF_FE_XG", "4"),
         ("METERELF_CCL_RIDMM", "0")]


def _pack(crops):
    c = crops.astype(np.int64)
    return (c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)).astype(np.int32)


def _crops(camera, frames):
    (x0, y0), (x1, y1) = camera.meter_rect
    return np.ascontiguousarray(np.stack([f[y0:y1, x0:x1] for f in frames]))


def _speckled(camera, seed, n=3):
    """Rendered crops with red speckle near the dials."""
    rng = np.random.default_rng(seed)
    crops = camera.render_crops(rng.uniform(0, 10, (n, 4)).tolist())
    speck = rng.random(crops.shape[:3]) < 0.02
    crops[speck] = (40, 40, 200)
    return crops


def _geom(pa):
    return tuple((int(ox), int(oy), int(cx), int(cy), *map(int, cr))
                 for (ox, oy), (cx, cy), cr in zip(
                     pa.win_origin, pa.centers_int, pa.color_range))


def _frontend_windows(camera, crops):
    """The port's K5 (plain) on crops -> numpy (max_val, mx, my, bits)."""
    pa = camera.make_params().arrays()
    c1, c0 = frontend.score_constants(pa.template_u8)
    out = frontend.frontend_windows(
        torch.as_tensor(_pack(crops)), torch.as_tensor(pa.template_u8), c1,
        c0, _geom(pa), torch.as_tensor(pa.mask_full.astype(np.uint8)),
        int(pa.hue_shift))
    return pa, [x.numpy() for x in out]


def _dequad(x):
    """[B, 64, 256] quad layout -> [B, 4, 64, 64] per window."""
    B = x.shape[0]
    return np.asarray(x).reshape(B, W, 4, W).transpose(0, 2, 1, 3)


# ---------------------------------------------------------------- K5 --

@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_frontend_windows_plain_matches_jax_composition(cam):
    """K5's plain version against the JAX composition of its two halves:
    mx/my exactly as the JAX CPU decoder's scorer (matmul + locate) and
    max_val within its rtol, as test_torch_ops.py checks K1; the bits
    equal pallas_windows.window_bits_quads (interpret=True) dequadded, on
    the superwindow the TPU frontend cuts at that match."""
    _, camera = CAMERAS[cam]
    crops = _speckled(camera, 5)
    pa, (mv, mx, my, bits) = _frontend_windows(camera, crops)
    tmpl = pa.template_u8
    tmean = np.float32(int(tmpl.astype(np.int64).sum())) / np.float32(
        tmpl.size)
    L = np.asarray(j_color.lightness_from_planes(
        *(jnp.asarray(crops[..., i]) for i in range(3))))
    scores = j_template.match_template_scores_matmul(
        jnp.asarray(L.astype(np.float32)), jnp.asarray(tmpl), tmean)
    j_mv, j_mx, j_my = (np.asarray(x) for x in j_template.locate(scores))
    np.testing.assert_array_equal(mx, j_mx)
    np.testing.assert_array_equal(my, j_my)
    assert np.allclose(mv, j_mv, rtol=1e-4)

    packed = _pack(crops)
    H, Wc = packed.shape[1:]
    sw = np.zeros((len(crops), j_fe.SW_H, j_fe.SW_W), np.int32)
    for b in range(len(crops)):
        pad = np.zeros((j_fe.H_PAD, j_fe.W_PAD), np.int32)
        pad[:H, :Wc] = packed[b]
        sw[b] = np.roll(np.roll(pad, -my[b], 0), -mx[b], 1)[
            :j_fe.SW_H, :j_fe.SW_W]
    origins = tuple((int(x), int(y)) for x, y in pa.win_origin)
    centers = tuple((int(x), int(y)) for x, y in pa.centers_int)
    disk_quad = np.concatenate(
        [pa.mask_full[i].astype(np.int32) for i in range(4)], axis=1)
    want = _dequad(jax.jit(functools.partial(
        j_win.window_bits_quads, origins=origins, centers=centers,
        interpret=True))(jnp.asarray(sw), jnp.asarray(disk_quad),
                         jnp.asarray(pa.color_range), int(pa.hue_shift)))
    assert bits.shape == (len(crops), 4, W, W) and bits.dtype == np.int32
    np.testing.assert_array_equal(bits, want)
    assert (want & 1).any()


def test_frontend_windows_matches_pallas_kernel():
    """K5's plain version against frontend_windows_pallas itself (interpret
    mode): match location and bits exact, max_val bitwise (both compute
    the TPU kernel's exact score)."""
    if not os.environ.get("METERELF_FULL_GOLDEN"):
        pytest.skip("interpret-mode compile of the merged 64-column kernel "
                    "takes minutes on CPU: set METERELF_FULL_GOLDEN=1")
    camera = t_syn.DEFAULT_CAMERA
    crops = _speckled(camera, 6, n=2)
    pa, (mv, mx, my, bits) = _frontend_windows(camera, crops)
    tmpl = pa.template_u8
    tmean = np.float32(int(tmpl.astype(np.int64).sum())) / np.float32(
        tmpl.size)
    disk_quad = np.concatenate(
        [pa.mask_full[i].astype(np.int32) for i in range(4)], axis=1)
    j_mv, j_mx, j_my, j_bits = j_fe.frontend_windows_pallas(
        jnp.asarray(_pack(crops)), jnp.asarray(tmpl), tmean,
        jnp.asarray(disk_quad), jnp.asarray(pa.color_range),
        int(pa.hue_shift),
        tuple((int(x), int(y)) for x, y in pa.win_origin),
        tuple((int(x), int(y)) for x, y in pa.centers_int),
        interpret=True, crop_hw=crops.shape[1:3])
    np.testing.assert_array_equal(mx, np.asarray(j_mx))
    np.testing.assert_array_equal(my, np.asarray(j_my))
    assert mv.tobytes() == np.asarray(j_mv).astype(np.float32).tobytes()
    np.testing.assert_array_equal(bits, _dequad(j_bits))


def test_frontend_windows_takes_four_dials():
    camera = t_syn.FIVE_DIAL_CAMERA
    pa = camera.make_params().arrays()
    with pytest.raises(ValueError, match="4 dials"):
        frontend.frontend_windows(
            torch.zeros((1, 250, 250), dtype=torch.int32),
            torch.as_tensor(pa.template_u8), 0.0, 0.0, _geom(pa),
            torch.as_tensor(pa.mask_full.astype(np.uint8)), 0)


# ---------------------------------------------------------------- K7 --

def _blobby(density, K=18):
    """tests/test_ops.py test_pallas_stats_matches_sort's windows: random
    closed masks, half of them with a blob, inside a dial disk."""
    rng = np.random.default_rng(int(density * 1000))
    yy, xx = np.mgrid[:W, :W]
    disk = (yy - 32) ** 2 + (xx - 32) ** 2 <= 23 ** 2
    closed = rng.random((K, W, W)) < density
    for k in range(K // 2):
        cy, cx = rng.integers(16, 48, 2)
        closed[k] |= ((yy - cy) ** 2 + (xx - cx) ** 2) <= 64
    masked = closed & disk
    okey, _ = j_comp._propagate_xla(
        jnp.asarray(masked), jnp.asarray(np.broadcast_to(disk, masked.shape)))
    return rng, np.asarray(okey), masked, closed


@pytest.mark.parametrize("density", [0.08, 0.3])
def test_stats_select_plain_matches_pallas_interpret(density):
    """K7's plain version == pallas_stats.stats_select (interpret=True),
    also with contributions 4-7, whose bit 2 the kernel's & 3 drops."""
    rng, okey, _, _ = _blobby(density)
    # and a window with no component (every owner the sentinel 4096)
    okey = np.concatenate([okey, np.full((1, W, W), 4 * W * W, np.int32)])
    contrib = np.asarray(j_comp._cell_contrib(jnp.asarray(okey >> 2), W * W),
                         np.int32)
    high = contrib | (4 * rng.integers(0, 2, contrib.shape)).astype(np.int32)
    assert (high >= 4).any()
    for c in (contrib, high):
        want = np.asarray(jax.jit(functools.partial(
            j_stats.stats_select, interpret=True))(jnp.asarray(okey),
                                                   jnp.asarray(c)))
        got = stats.stats_select(torch.as_tensor(okey), torch.as_tensor(c))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want >= 0).any() and (want == -1).any()


def test_finalize_hist_pallas_matches_jax():
    """finalize(stats="hist_pallas") == components._finalize(stats=
    "hist_pallas_interpret"): needle region and has_any, with a stats box
    given (the hist_pallas selection ignores it, as in JAX), and equal to
    the port's sort selection."""
    _, okey, masked, closed = _blobby(0.3)
    conv = np.ones(len(okey), bool)
    box = (((8, 8),) * 3, 48)
    ref = j_comp._finalize(jnp.asarray(okey), jnp.asarray(masked),
                           jnp.asarray(closed), jnp.asarray(conv),
                           static_bbox=box, stats="hist_pallas_interpret")
    args = [torch.as_tensor(a) for a in (okey, masked, closed, conv)]
    got = components.finalize(*args, static_bbox=box, stats="hist_pallas")
    np.testing.assert_array_equal(got.needle_region.numpy(),
                                  np.asarray(ref.needle_region))
    np.testing.assert_array_equal(got.has_any.numpy(),
                                  np.asarray(ref.has_any))
    srt = components.finalize(*args, static_bbox=box, stats="sort")
    assert torch.equal(srt.needle_region, got.needle_region)
    with pytest.raises(ValueError):
        components.finalize(*args, stats="fused")


# ---------------------------------------------------------------- K9 --

def test_match_corr_plain_matches_pallas_interpret():
    """match_scores_v1 on K9's plain version against
    pallas_match.match_scores_pallas (interpret=True) within 1e-5 of the
    largest |score|, with the same argmax; bitwise against K8's plain
    map; the TPU function's shape assertion is kept."""
    rng = np.random.default_rng(7)
    L = rng.integers(0, 256, (2, 250, 250)).astype(np.float32)
    T = rng.integers(0, 256, (119, 188)).astype(np.uint8)
    tmean = 117.25
    want = np.asarray(jax.jit(functools.partial(
        j_match.match_scores_pallas, interpret=True))(
            jnp.asarray(L), jnp.asarray(T), jnp.float32(tmean)))
    Lt, Tt = torch.as_tensor(L), torch.as_tensor(T)
    got = match.match_scores_v1(Lt, Tt, tmean).numpy()
    assert got.shape == want.shape == (2, 132, 63)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    np.testing.assert_array_equal(got.reshape(2, -1).argmax(1),
                                  want.reshape(2, -1).argmax(1))
    k8 = match.match_scores_plain(Lt, Tt, tmean).numpy()
    assert got.tobytes() == k8.tobytes()
    corr = match.match_corr(Lt, Tt).numpy()
    assert corr.dtype == np.float32
    T64 = T.astype(np.int64)
    for b, y, x in ((0, 0, 0), (1, 131, 62), (0, 70, 31)):
        exact = int((L[b, y:y + 119, x:x + 188].astype(np.int64) * T64).sum())
        assert corr[b, y, x] == np.float32(exact)
    with pytest.raises(ValueError, match="shape family"):
        match.match_scores_v1(Lt[:, :200], Tt, tmean)


# ------------------------------------------------------------ decodes --

def _frames(jc, tc):
    """Synthetic, stub-needle and fuzz crops of one camera."""
    pos = [[(i * 1.7 + d * 2.3) % 10 for d in range(4)] for i in range(4)]
    synth = tc.render_crops(pos)
    stub = _crops(tc, [tc.render_frame([1.0, 2.0, 3.0, 4.0],
                                       stub_dials=(2,))])
    fuzz = _crops(tc, fuzz_frames(tc, 8, seed=23))
    return np.concatenate([synth, stub, fuzz])


@pytest.fixture(scope="module")
def reference(request, tmp_path_factory):
    """(port camera, crops, the JAX CPU decoder's result) per camera."""
    jc, tc = CAMERAS[request.param]
    crops = _frames(jc, tc)
    jdec = JaxDecoder(jc.make_params(str(tmp_path_factory.mktemp("p"))))
    return tc, crops, jdec.decode_numpy(crops)


@pytest.mark.parametrize("reference", sorted(CAMERAS), indirect=True)
@pytest.mark.parametrize("knob", KNOBS, ids=["=".join(k) for k in KNOBS])
def test_jax_decode_knobs_select_nothing(reference, knob, monkeypatch):
    """With one JAX decode knob set, MeterDecoder(device="cpu") equals the
    JAX CPU decoder on synthetic, stub-needle and fuzz crops, and calls
    exactly K1, K2, K3 and K4's wrappers on the quad branch and K1, K2
    and K6's on the five-dial camera's (recorded by monkeypatching them
    where the decode looks them up)."""
    tc, crops, ref = reference
    monkeypatch.setenv(*knob)
    res = MeterDecoder(tc.make_params(), device="cpu").decode_numpy(crops)
    assert_port_equal(ref, res, "=".join(knob))
    assert (res.err[:4] == 0).all()

    calls = []

    def record(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapper)

    for name in ("frontend", "windows", "ccl", "stats"):
        record(t_decode, name)
    record(ccl, "propagate")
    record(components, "stats_select")
    record(frontend, "frontend_windows")
    MeterDecoder(tc.make_params(), device="cpu").decode_numpy(
        tc.render_crops([[1.0, 3.5, 7.2, 9.9]]))
    assert calls == ["frontend", "windows", "ccl", "stats"]
    calls.clear()
    five = t_syn.FIVE_DIAL_CAMERA
    MeterDecoder(five.make_params(), device="cpu").decode_numpy(
        five.render_crops([[1.0, 3.5, 7.2, 9.9, 2.2]]))
    assert calls == ["frontend", "windows", "propagate"]


@pytest.mark.parametrize("kw", ["frontend", "quad_stats"])
def test_variant_arguments_raise_type_error(kw):
    """MeterDecoder takes neither ``frontend=`` nor ``quad_stats=``, as
    the JAX decoder takes neither."""
    with pytest.raises(TypeError):
        MeterDecoder(t_syn.DEFAULT_CAMERA.make_params(), device="cpu",
                     **{kw: "split" if kw == "frontend" else "fused"})
