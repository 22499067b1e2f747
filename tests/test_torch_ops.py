"""The PyTorch port's kernel modules (plain versions, as they run on the
CPU) against the JAX package: frontend, colour, windows, stats, angles.
The CCL module is in test_torch_ccl.py.

Same numpy inputs from a seed go to both; Pallas kernels run in
interpret mode, as tests/test_ops.py runs them on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meterelf_tpu.ops import angles as j_angles
from meterelf_tpu.ops import color as j_color
from meterelf_tpu.ops import components as j_comp
from meterelf_tpu.ops import pallas_frontend as j_fe
from meterelf_tpu.ops import pallas_stats as j_stats
from meterelf_tpu.ops import pallas_windows as j_win
from meterelf_tpu.ops import template as j_template
from meterelf_tpu_torch import params as t_params
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.ops import angles as t_angles
from meterelf_tpu_torch.ops import color as t_color
from meterelf_tpu_torch.ops import frontend as t_fe
from meterelf_tpu_torch.ops import stats as t_stats
from meterelf_tpu_torch.ops import windows as t_win
from meterelf_tpu_torch.pipeline.decode import FAST_F32, MeterDecoder
from meterelf_tpu_torch.types import Rect
import readout_windows

torch.set_num_threads(2)

W = 64
(_X0, _Y0) = t_syn.METER_RECT.top_left
FRONTEND_CAMERAS = {
    "default": t_syn.DEFAULT_CAMERA,
    "alt": t_syn.ALT_CAMERA,
    # the second shipped camera's crop shape: 220x135, 188x119 template
    "camera2shape": t_syn.SyntheticCamera(
        meter_rect=Rect((_X0, _Y0), (_X0 + 220, _Y0 + 135))),
}


def _pack(crops):
    c = crops.astype(np.int64)
    return (c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)).astype(np.int32)


def _dequad(x):
    """[B, 64, 256] quad layout -> [B, 4, 64, 64] per window."""
    B = x.shape[0]
    return np.asarray(x).reshape(B, W, 4, W).transpose(0, 2, 1, 3)


# ---------------------------------------------------------------- K1 --

@pytest.mark.parametrize("cam", sorted(FRONTEND_CAMERAS))
def test_frontend_plain_matches_jax_and_exact_reference(cam):
    """mx/my exactly as the JAX CPU decoder's scorer
    (match_template_scores_matmul + locate), max_val within its rtol
    1e-4 (assert_results_equal's bound: that scorer rounds in f32); and
    mx/my/max_val bitwise against the int64 numpy reference of
    tests/test_ops.py (the TPU kernel's exact formulation)."""
    camera = FRONTEND_CAMERAS[cam]
    crops = camera.render_crops([[1.0, 3.5, 7.2, 9.9], [4.4, 6.6, 8.8, 1.1]])
    tmpl = camera.make_template()
    packed = _pack(crops)
    c1, c0 = t_fe.score_constants(tmpl)
    mv, mx, my = (x.numpy() for x in t_fe.frontend(
        torch.as_tensor(packed), torch.as_tensor(tmpl), c1, c0))

    tsum = int(tmpl.astype(np.int64).sum())
    tmean = np.float32(tsum) / np.float32(tmpl.size)
    L = np.asarray(j_color.lightness_from_planes(
        jnp.asarray(crops[..., 0]), jnp.asarray(crops[..., 1]),
        jnp.asarray(crops[..., 2])))
    scores = j_template.match_template_scores_matmul(
        jnp.asarray(L.astype(np.float32)), jnp.asarray(tmpl), tmean)
    j_mv, j_mx, j_my = (np.asarray(x) for x in j_template.locate(scores))
    np.testing.assert_array_equal(mx, j_mx)
    np.testing.assert_array_equal(my, j_my)
    assert np.allclose(mv, j_mv, rtol=1e-4)

    # exact reference (tests/test_ops.py:310-332)
    th, tw = tmpl.shape
    oh, ow = crops.shape[1] - th + 1, crops.shape[2] - tw + 1
    t64 = tmpl.astype(np.int64) - 128
    c1n = np.float32(np.float32(128.0) - tmean)
    c0n = np.float32(128.0 * (np.float64(tsum)
                              - tmpl.size * np.float64(tmean)))
    assert (np.float32(c1), np.float32(c0)) == (c1n, c0n)
    for b in range(len(crops)):
        lp = L[b].astype(np.int64) - 128
        view = np.lib.stride_tricks.sliding_window_view(lp, (th, tw))
        corr = np.einsum("yxij,ij->yx", view[:oh, :ow], t64)
        box = np.einsum("yxij->yx", view[:oh, :ow])
        ref = (corr.astype(np.float32)
               + (c1n * box.astype(np.float32)).astype(np.float32) + c0n)
        by, bx = np.unravel_index(np.argmax(ref), ref.shape)
        assert (int(my[b]), int(mx[b])) == (by, bx)
        assert np.float32(mv[b]).tobytes() == ref[by, bx].tobytes()


def test_frontend_first_max_tie_break():
    """A flat crop scores the same everywhere: the first offset in
    row-major order wins (cv2.minMaxLoc)."""
    tmpl = t_syn.DEFAULT_CAMERA.make_template()
    packed = np.full((2, 250, 250), 0x808080, np.int32)
    c1, c0 = t_fe.score_constants(tmpl)
    mv, mx, my = t_fe.frontend(torch.as_tensor(packed),
                               torch.as_tensor(tmpl), c1, c0)
    assert mx.tolist() == [0, 0] and my.tolist() == [0, 0]
    assert mv.dtype == torch.float32 and mx.dtype == torch.int32


# ----------------------------------------------------------- colour --

def _hls_inputs():
    rng = np.random.default_rng(2024)
    rand = rng.integers(0, 1 << 24, 1 << 20, dtype=np.int64)
    v = np.arange(1 << 24, dtype=np.int64)
    ch = [(v >> s) & 255 for s in (0, 8, 16)]
    edge = v[np.logical_or.reduce([(c == 0) | (c == 255) for c in ch])]
    return np.concatenate([rand, edge])


def test_hls_and_lightness_equal_jax():
    """Plain HLS (f32 IEEE division) equals color.bgr_planes_to_hls (the
    f64-division path) and lightness_from_planes exactly: 2^20 seeded
    BGR triples plus every triple with a channel at 0 or 255."""
    v = _hls_inputs()
    planes = [((v >> s) & 255) for s in (0, 8, 16)]
    u8 = [p.astype(np.uint8) for p in planes]
    tp = [torch.as_tensor(p.astype(np.int32)) for p in planes]
    for shift in (128, 0, 250):
        j = jax.jit(functools.partial(j_color.bgr_planes_to_hls,
                                      hue_shift=shift))(*u8)
        t = t_color.bgr_planes_to_hls(*tp, shift)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jl = jax.jit(j_color.lightness_from_planes)(*u8)
    np.testing.assert_array_equal(
        np.asarray(jl), t_color.lightness_from_planes(*tp).numpy())


# ---------------------------------------------------------------- K2 --

def _window_case(seed):
    """Crops mixing a rendered meter with speckle of grey pixels
    (vmax == vmin), near-red hues (wrap under the hue shift) and random
    colours, plus random valid match offsets."""
    rng = np.random.default_rng(seed)
    cam = t_syn.DEFAULT_CAMERA
    crops = cam.render_crops(rng.uniform(0, 10, (4, 4)).tolist())
    B, H, Wd, _ = crops.shape
    grey = rng.integers(0, 256, (B, H, Wd, 1)).repeat(3, axis=3)
    red = np.stack([rng.integers(0, 60, (B, H, Wd)),
                    rng.integers(0, 60, (B, H, Wd)),
                    rng.integers(150, 256, (B, H, Wd))], axis=-1)
    rand = rng.integers(0, 256, (B, H, Wd, 3))
    pick = rng.integers(0, 8, (B, H, Wd, 1))
    crops = np.where(pick == 0, grey, np.where(
        pick == 1, red, np.where(pick == 2, rand, crops))).astype(np.uint8)
    mx = rng.integers(0, Wd - 188 + 1, B).astype(np.int32)
    my = rng.integers(0, H - 119 + 1, B).astype(np.int32)
    return crops, mx, my


@pytest.mark.parametrize("hue_shift", [128, 0, 201])
def test_windows_plain_matches_pallas_interpret(hue_shift):
    """Plain window bits == pallas_windows.window_bits_quads
    (interpret=True), dequadded; the superwindow is the crop rotated to
    the match offset as in tests/test_ops.py:338-340."""
    pa = t_syn.DEFAULT_CAMERA.make_params().arrays()
    origins = tuple((int(x), int(y)) for x, y in pa.win_origin)
    centers = tuple((int(x), int(y)) for x, y in pa.centers_int)
    crops, mx, my = _window_case(hue_shift)
    packed = _pack(crops)
    sw = np.zeros((len(crops), j_fe.SW_H, j_fe.SW_W), np.int32)
    for b in range(len(crops)):
        pad = np.zeros((j_fe.H_PAD, j_fe.W_PAD), np.int32)
        pad[:250, :250] = packed[b]
        sw[b] = np.roll(np.roll(pad, -my[b], 0), -mx[b], 1)[
            :j_fe.SW_H, :j_fe.SW_W]
    disk_quad = np.concatenate(
        [pa.mask_full[i].astype(np.int32) for i in range(4)], axis=1)
    want = _dequad(jax.jit(functools.partial(
        j_win.window_bits_quads, origins=origins, centers=centers,
        interpret=True))(jnp.asarray(sw), jnp.asarray(disk_quad),
                         jnp.asarray(pa.color_range), hue_shift))

    geom = tuple((ox, oy, cx, cy, *map(int, cr)) for (ox, oy), (cx, cy), cr
                 in zip(origins, centers, pa.color_range))
    got = t_win.windows(torch.as_tensor(packed), torch.as_tensor(mx),
                        torch.as_tensor(my), geom,
                        torch.as_tensor(pa.mask_full.astype(np.uint8)),
                        hue_shift)
    assert got.shape == (len(crops), 4, W, W) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want & 1).any() and ((want >> 3) & 1).any()


# ---------------------------------------------------------------- K4 --

def _okey3_case(density, seed, B=9):
    """okey3 windows from the JAX reference propagation (tests/test_ops.py
    572-591 inputs, packed with the closed bit)."""
    rng = np.random.default_rng(seed)
    K = 4 * B
    yy, xx = np.mgrid[:W, :W]
    disk = (yy - 32) ** 2 + (xx - 32) ** 2 <= 23 ** 2
    closed = rng.random((K, W, W)) < density
    for k in range(K // 2):
        cy, cx = rng.integers(16, 48, 2)
        closed[k] |= ((yy - cy) ** 2 + (xx - cx) ** 2) <= 64
    masked = closed & disk
    okey, conv = j_comp._propagate_xla(
        jnp.asarray(masked), jnp.asarray(np.broadcast_to(disk, masked.shape)))
    okey = np.asarray(okey)
    okey3 = ((okey >> 2) * 8 + closed.astype(np.int32) * 4
             + (okey & 3)).astype(np.int32)
    return okey3, np.asarray(conv)


@pytest.mark.parametrize("density", [0.08, 0.3, 0.55])
def test_stats_plain_matches_pallas_interpret(density):
    okey3, _ = _okey3_case(density, int(density * 7919))
    km, ha = jax.jit(functools.partial(
        j_stats.stats_select_fused, interpret=True))(jnp.asarray(okey3))
    t_km, t_ha = t_stats.stats(torch.as_tensor(okey3))
    np.testing.assert_array_equal(t_km.numpy(), np.asarray(km))
    np.testing.assert_array_equal(t_ha.numpy(), np.asarray(ha))
    assert (np.asarray(km) >= 0).any()


# ------------------------------------------------------------ angles --

# f64 sums (angles.py: momentum, weighted mean) run in another order in
# torch than in XLA; positions may differ in the last bits only
ANGLE_TOL = 1e-9


def test_read_dials_and_value_match_jax():
    """read_dials == angles.read_dial_from_okey per window (readable
    exact, position within ANGLE_TOL), and assemble_value exact on the
    same positions, including the carry boundaries."""
    params = t_syn.DEFAULT_CAMERA.make_params()
    host = params.arrays()
    pa = t_params.to_device(host, "cpu")
    rng = np.random.default_rng(42)
    B, D = 6, 4
    yy, xx = np.mgrid[:W, :W]
    okey3 = np.zeros((B, D, W, W), np.int32)
    for b in range(B):
        closed = rng.random((D, W, W)) < (0.1 if b < 5 else 0.0)
        for d in range(D if b < 5 else 0):
            cx, cy = (int(v) for v in host.centers_int[d])
            ang = rng.uniform(0, 2 * np.pi)
            for t in np.linspace(0, 18, 40):
                px = int(round(cx + t * np.sin(ang)))
                py = int(round(cy - t * np.cos(ang)))
                closed[d, max(py - 1, 0):py + 2, max(px - 1, 0):px + 2] = True
        masked = closed & host.mask_full
        okey, _ = j_comp._propagate_xla(jnp.asarray(masked),
                                        jnp.asarray(host.mask_full))
        okey = np.asarray(okey)
        okey3[b] = (okey >> 2) * 8 + closed * 4 + (okey & 3)
    flat = okey3.reshape(B * D, W, W)
    km, _ = t_stats.stats(torch.as_tensor(flat))
    km = km.numpy().reshape(B, D)

    pos, readable = t_angles.read_dials(
        torch.as_tensor(okey3.reshape(B, D, W * W)), torch.as_tensor(km), pa)
    read = jax.jit(jax.vmap(j_angles.read_dial_from_okey))
    for d in range(D):
        args = [np.broadcast_to(getattr(host, f)[d],
                                (B,) + getattr(host, f)[d].shape)
                for f in ("disk_idx", "disk_valid", "disk_sx2", "disk_sy2",
                          "ann_idx", "ann_valid", "ann_x", "ann_y",
                          "ann_angle", "ann_sqd", "neg_sign", "zero_turn")]
        r = read(jnp.asarray(okey3[:, d].reshape(B, W * W)),
                 jnp.asarray(km[:, d]), *map(jnp.asarray, args))
        np.testing.assert_array_equal(readable[:, d].numpy(),
                                      np.asarray(r.readable))
        np.testing.assert_allclose(pos[:, d].numpy(), np.asarray(r.position),
                                   rtol=0, atol=ANGLE_TOL)
    assert readable[:5].all() and not readable[5].any()

    cases = np.concatenate([
        rng.uniform(0, 10, (64, 4)),
        np.array([[1.9, 2.44, 7.56, 0.5], [8.1, 3.56, 2.44, 9.99],
                  [2.0, 9.45, 0.55, 4.0], [8.0, 0.449, 9.551, 5.0]]),
    ])
    want = jax.jit(jax.vmap(
        lambda p: j_angles.assemble_value(p[host.value_perm])))(
            jnp.asarray(cases))
    got = t_angles.assemble_value(torch.as_tensor(cases), pa.value_perm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))



# ---------------------------------------------------- K12 readout ---

READOUT_CAMERAS = {"default": t_syn.DEFAULT_CAMERA, "alt": t_syn.ALT_CAMERA,
                   "five_dial": t_syn.FIVE_DIAL_CAMERA}


def _readout_case(cam, exact=True):
    """(host ParamArrays as the decoder ships them, DeviceParams on the
    CPU, hand-made needle regions, their okey3 and keymax)."""
    host = READOUT_CAMERAS[cam].make_params().arrays()
    if not exact:
        host = host._replace(**{k: getattr(host, k).astype(np.float32)
                                for k in FAST_F32})
    region = readout_windows.hand_regions(host, seed=len(cam))
    okey3, keymax = readout_windows.okey3_of(region, seed=len(cam) + 1)
    return host, t_params.to_device(host, "cpu"), region, okey3, keymax


@pytest.mark.parametrize("gather", ["okey3", "region"])
@pytest.mark.parametrize("cam", ["default", "five_dial"])
def test_readout_on_cpu_is_the_plain_stage(cam, gather):
    """On CPU tensors readout is read_dials (okey3 and keymax) or
    read_dials_region, then assemble_value (4 dials; zeros otherwise),
    exactly, and the kernel is not launched."""
    _, pa, region, okey3, keymax = _readout_case(cam)
    n = t_angles.readout.launches
    if gather == "okey3":
        src, km = torch.as_tensor(okey3), torch.as_tensor(keymax)
        want = t_angles.read_dials(src, km, pa)
    else:
        src, km = torch.as_tensor(region), None
        want = t_angles.read_dials_region(src, pa)
    pos, readable, value = t_angles.readout(src, km, pa)
    assert torch.equal(pos, want[0]) and torch.equal(readable, want[1])
    if pos.shape[1] == 4:
        assert torch.equal(value, t_angles.assemble_value(pos, pa.value_perm))
    else:
        assert torch.equal(value, torch.zeros(pos.shape[0],
                                              dtype=torch.float64))
    assert t_angles.readout.launches == n


@pytest.mark.parametrize("cam", ["default", "five_dial"])
def test_cpu_decode_takes_the_plain_angle_stage(cam, monkeypatch):
    """A decode on the CPU (quad fused branch; the five-dial camera's
    general branch) runs the angle stage as readout_plain, once, and
    launches no kernel."""
    camera = READOUT_CAMERAS[cam]
    dec = MeterDecoder(camera.make_params(), device="cpu")
    crops = camera.render_crops([[1.3, 4.6, 7.2, 9.8, 0.4][:len(
        camera.make_params().dial_names)]] * 2)
    calls = []
    plain = t_angles.readout_plain

    def spy(src, keymax, pa):
        calls.append(keymax is None)
        return plain(src, keymax, pa)

    monkeypatch.setattr(t_angles, "readout_plain", spy)
    n = t_angles.readout.launches
    res = dec.decode_numpy(crops)
    assert calls == [cam == "five_dial"]
    assert t_angles.readout.launches == n
    assert (res.err == 0).all()


GEOMETRY = ("disk_idx", "disk_valid", "disk_sx2", "disk_sy2", "ann_idx",
            "ann_valid", "ann_x", "ann_y", "ann_angle", "ann_sqd",
            "neg_sign", "zero_turn")


def _kept_counts(src, km, pa):
    """(n, k_tail): the kept and the tail annulus slots of each window [B,
    D] (the first half of _read_dial_core), to show which cases the
    hand-made windows reach."""
    kept, tail = _kept_tail(src, km, pa)
    return kept.sum(-1), tail.sum(-1)


def _kept_tail(src, km, pa):
    """(kept, tail) [B, D, n_ann] bool: the first half of
    _read_dial_core."""
    if km is None:
        gather = functools.partial(t_angles.read_dials_region, src)
    else:
        gather = functools.partial(t_angles.read_dials, src, km)
    counts = []

    def core(needle, tip, p):
        mom = t_angles.tree_sum(torch.stack([
            torch.where(needle, p.disk_sx2, 0.0),
            torch.where(needle, p.disk_sy2, 0.0)]).double())
        sign = p.neg_sign.double()
        dot = (p.ann_x.double() * (sign * mom[0])[..., None]
               + p.ann_y.double() * (sign * mom[1])[..., None])
        kept = tip & (dot > 0)
        amin = torch.where(kept, p.ann_angle, float("inf")).amin(
            -1, keepdim=True)
        tail = kept & ~(torch.abs(p.ann_angle - amin) < 0.75)
        counts.append((kept.numpy(), tail.numpy()))
        return None, None

    orig = t_angles._read_dial_core
    t_angles._read_dial_core = core
    try:
        gather(pa)
    finally:
        t_angles._read_dial_core = orig
    return counts[0]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("gather", ["okey3", "region"])
@pytest.mark.parametrize("cam", sorted(READOUT_CAMERAS))
def test_readout_plain_matches_jax(cam, gather, exact):
    """readout_plain on the hand-made windows (n = 0..6 on every dial, the
    0.75-turn tail, the whole annulus, keymax -1, small and big blobs)
    against the JAX package's read_dial_from_okey (okey3 gather) or
    read_dial (region gather), sums in float64 as its decoder takes them,
    and assemble_value: readable exact, position within ANGLE_TOL, value
    exact (zeros for other than 4 dials)."""
    host, pa, region, okey3, keymax = _readout_case(cam, exact)
    if gather == "okey3":
        src, km = okey3, keymax
        fn = j_angles.read_dial_from_okey
    else:
        src, km = region, None
        fn = j_angles.read_dial
    pos, readable, value = (t.numpy() for t in t_angles.readout_plain(
        torch.as_tensor(src), None if km is None else torch.as_tensor(km),
        pa))
    read = jax.jit(jax.vmap(functools.partial(fn, sum_dtype=jnp.float64)))
    B, D = pos.shape
    want_pos = np.zeros((B, D))
    for d in range(D):
        head = (src[:, d],) + (() if km is None else (km[:, d],))
        geom = [np.broadcast_to(getattr(host, f)[d],
                                (B,) + getattr(host, f)[d].shape)
                for f in GEOMETRY]
        r = read(*map(jnp.asarray, head + tuple(geom)))
        np.testing.assert_array_equal(readable[:, d], np.asarray(r.readable))
        want_pos[:, d] = np.asarray(r.position)
    np.testing.assert_allclose(pos, want_pos, rtol=0, atol=ANGLE_TOL)
    if D == 4:
        want = jax.jit(jax.vmap(
            lambda p: j_angles.assemble_value(p[host.value_perm])))(
                jnp.asarray(want_pos))
        np.testing.assert_array_equal(value, np.asarray(want))
    else:
        assert not value.any()
    # the cases the windows are made to reach
    n, k_tail = _kept_counts(
        torch.as_tensor(src), None if km is None else torch.as_tensor(km),
        pa)
    cases = np.array(readout_windows.CASES)
    case = cases[(np.arange(B)[:, None] + np.arange(D)[None]) % B]
    for k in readout_windows.ARCS:
        assert (n[case == f"arc{k}"] == k).all()
    assert (n[case == "empty"] == 0).all()
    assert (k_tail[case == "tail"] > 0).all()
    assert (readable == (n > 0)).all()


def _sequential_tree_sum(x):
    """XLA's CPU order for a long sum, spelled out: zero-pad evenly to a
    multiple of 32, each run of 32 from 0.0 in index order, again until 32
    or fewer partials are left, then those from 0.0 in order."""
    x = list(x)
    while len(x) > t_angles.RUN:
        pad = -len(x) % t_angles.RUN
        x = [0.0] * (pad // 2) + x + [0.0] * (pad - pad // 2)
        runs = []
        for r in range(0, len(x), t_angles.RUN):
            acc = 0.0
            for v in x[r:r + t_angles.RUN]:
                acc += v
            runs.append(acc)
        x = runs
    acc = 0.0
    for v in x:
        acc += v
    return acc


@pytest.mark.parametrize("n", [1, 20, 32, 33, 256, 1000, 1024, 1280, 1536,
                               4096])
def test_readout_sum_order_is_tree_sum(n):
    """angles.tree_sum, whose order K12 repeats, equals the order spelled
    out one IEEE add at a time, bit for bit, signed zeros included, for
    slot counts that pad at the first level, the second or none."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, 2, n)) * 10.0 ** rng.integers(-8, 9,
                                                               (3, 2, n))
    x[0] = -0.0
    x[1, :, ::3] = -0.0
    got = t_angles.tree_sum(torch.as_tensor(x)).numpy()
    want = np.array([[_sequential_tree_sum(r) for r in row] for row in x])
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


# K12 (csrc/angles.cu) spreads a window over the W = max(1, 16 // D) warps
# of its dial: thread t of the dial's 32 W sums first-level runs t, t +
# 32 W, ...; the kept words' prefix counts come from warp scans and warp
# totals. The models below repeat that in Python.

def _k12_warps(D):
    return max(1, 16 // D)


def _k12_tree_sum(x, on=None):
    """K12's order for one row: first-level runs of 32 (evenly zero-padded
    above one run), each summed from 0.0 on its own by one thread of the
    dial, adding its terms that are ``on`` (every term where on is None)
    in index order; the partials in run order, one more level of runs
    (one a thread) above 32 of them, then the partials from 0.0 in order;
    a single run is the sum. Which thread sums a run does not change it,
    so the model has no warps."""
    n = len(x)
    one = n <= t_angles.RUN
    lo = 0 if one else (-n % t_angles.RUN) // 2
    runs = 1 if one else -(-n // t_angles.RUN)
    part = []
    for r in range(runs):
        acc = 0.0
        for j in range(t_angles.RUN):
            k = r * t_angles.RUN + j - lo
            if 0 <= k < n and (on is None or on[k]):
                acc += x[k]
        part.append(acc)
    if one:
        return part[0]
    if runs > t_angles.RUN:
        pad = -runs % t_angles.RUN
        lo = pad // 2
        up = []
        for t in range(-(-runs // t_angles.RUN)):
            acc = 0.0
            for j in range(t_angles.RUN):
                k = t * t_angles.RUN + j - lo
                acc += part[k] if 0 <= k < runs else 0.0
            up.append(acc)
        part = up
    acc = 0.0
    for v in part:
        acc += v
    return acc


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("n", [1, 20, 32, 33, 256, 1000, 1024, 1280, 1536,
                               4096])
def test_readout_split_sum_is_tree_sum(n, skip):
    """K12's tree_sum, its first-level runs summed one a thread, equals
    the order spelled out one IEEE add at a time, bit for bit, signed
    zeros included; with ``skip``, the kernel's sum of the terms on the
    needle or in the trim alone does too, where the plain graph adds a
    zero of either sign for each other slot."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, 2, n)) * 10.0 ** rng.integers(-8, 9,
                                                               (3, 2, n))
    x[0] = -0.0
    x[1, :, ::3] = -0.0
    off = rng.random((3, 2, n)) < 0.7
    plain = np.where(off, np.where(rng.random((3, 2, n)) < 0.5, -0.0, 0.0),
                     x)
    for row, on in zip(plain.reshape(-1, n), ~off.reshape(-1, n)):
        want = np.float64(_sequential_tree_sum(list(row))).view(np.uint64)
        got = np.float64(_k12_tree_sum(list(row), on if skip else None))
        assert got.view(np.uint64) == want


def _words(bits):
    """[Q] bool -> the ballot words (bit l of word c: slot 32c + l)."""
    b = np.concatenate([bits, np.zeros(-len(bits) % 32, bool)])
    return [int(sum(1 << i for i in np.nonzero(w)[0]))
            for w in b.reshape(-1, 32)]


def _run_bits(words, s0):
    """csrc/angles.cu run_bits: bit j is slot s0 + j (s0 >= -31)."""
    c, sh = s0 >> 5, s0 & 31
    lo = words[c] if c >= 0 else 0
    if sh == 0:
        return lo
    hi = words[c + 1] if c + 1 < len(words) else 0
    return ((hi << 32 | lo) >> sh) & 0xffffffff


def _popc(x):
    return bin(x).count("1")


def _k12_ranks(kept, tail, D):
    """K12's n, k_tail and the inclusive rank - 1 of each kept slot of one
    window: each kept word's prefix count from warp scans, 32 W words at
    a time, warp totals summed in warp order; a run's first rank from
    its first word's count and a masked popcount, then popcounts within
    the run."""
    W = _k12_warps(D)
    threads = 32 * W
    kw, tw = _words(kept), _words(tail)
    na = len(kw)
    pc = [0] * na
    n = k_tail = 0
    for c0 in range(0, na, threads):
        cnt = [_popc(kw[c]) if c < na else 0 for c in range(c0, c0 + threads)]
        tails = [_popc(tw[c]) if c < na else 0
                 for c in range(c0, c0 + threads)]
        total = [sum(cnt[32 * i:32 * i + 32]) for i in range(W)]
        for t in range(threads):
            w = t // 32
            incl = sum(cnt[32 * w:t + 1])
            if c0 + t < na:
                pc[c0 + t] = n + sum(total[:w]) + incl - cnt[t]
        n += sum(total)
        k_tail += sum(tails)
    q = len(kept)
    lo = 0 if q <= 32 else (-q % 32) // 2
    rank = {}
    for r in range(1 if q <= 32 else na):
        s0 = r * 32 - lo
        kb = _run_bits(kw, s0)
        rank0 = (pc[s0 >> 5] + _popc(kw[s0 >> 5] & ((1 << (s0 & 31)) - 1))
                 if s0 > 0 else 0)
        for j in range(32):
            if kb >> j & 1:
                rank[s0 + j] = rank0 + _popc(kb & ((2 << j) - 1)) - 1
    return n, k_tail, rank


@pytest.mark.parametrize("slots", [None, 4096])
@pytest.mark.parametrize("D", [1, 3, 4, 5, 8])
def test_readout_split_ranks_match_plain(D, slots):
    """On the hand-made windows (okey3 gather; n = 0..6, the tail, the
    whole annulus), the kept annulus slots padded with invalid slots to
    ``slots`` (4096: more words than two warps' lanes): K12's cross-warp
    prefix counts give each kept slot the rank of the plain graph's
    cumulative sum, and n and k_tail its sums, for the warps a dial of D
    takes."""
    host, pa, _, okey3, keymax = _readout_case("five_dial")
    kept, tail = _kept_tail(torch.as_tensor(okey3), torch.as_tensor(keymax),
                            pa)
    if slots is not None:
        grow = ((0, 0), (0, 0), (0, slots - kept.shape[-1]))
        kept, tail = np.pad(kept, grow), np.pad(tail, grow)
    B, ND = kept.shape[:2]
    for b in range(B):
        for d in range(ND):
            n, k_tail, rank = _k12_ranks(kept[b, d], tail[b, d], D)
            assert (n, k_tail) == (kept[b, d].sum(), tail[b, d].sum())
            want = np.cumsum(kept[b, d]) - 1
            assert rank == {int(s): int(want[s])
                            for s in np.nonzero(kept[b, d])[0]}
