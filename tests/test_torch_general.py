"""The port's general-geometry decode branch against the JAX package on
the CPU: the copied gates, K6 (plain) against pallas_ccl.propagate, K8
(plain) against pallas_match2.match_scores_pallas_fused (both Pallas
kernels in interpret mode), the matmul scorer, finalize and read_dial on
the same masks, and whole decodes of FIVE_DIAL_CAMERA, of a camera with a
dial centre within 2 px of its window edge, of fuzz frames and of the
forced scorer-only branch, against the JAX MeterDecoder (which on the CPU
takes this very branch with the matmul scorer and the XLA CCL).

Tolerances: exact for the gates, K6's keys and flags, the matmul scorer,
finalize's outputs and every discrete decode field. K8 against the TPU
kernel: |difference| <= 1e-5 of the map's largest |score| (measured
5.6e-6 at the flagship geometry: the TPU kernel sums its 119 row
partials in f32, the port's corr is exact) with the same argmax. f64 dial
positions within 1e-9 (assert_port_equal of test_torch_decode), and
match_val within the rtol 1e-4 of tests/fuzz_frames.py where the two
packages score with different formulations (K1 or K8 against the XLA
matmul scorer)."""
import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fuzz_frames import fuzz_frames
from test_torch_decode import assert_port_equal

from meterelf_tpu import synthetic as j_syn
from meterelf_tpu.ops import angles as j_angles
from meterelf_tpu.ops import components as j_comp
from meterelf_tpu.ops import pallas_ccl, pallas_frontend, pallas_match2
from meterelf_tpu.ops import template as j_template
from meterelf_tpu.pipeline import decode as j_decode
from meterelf_tpu.pipeline.decode import MeterDecoder as JaxDecoder
from meterelf_tpu.pipeline.decode import make_coef_decode_fn as jax_coef_fn
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.errors import ErrCode
from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import angles, ccl, components, frontend, match
from meterelf_tpu_torch.ops import windows
from meterelf_tpu_torch.ops.color import lightness_from_planes, unpack_planes
from meterelf_tpu_torch.pipeline import decode as t_decode
from meterelf_tpu_torch.pipeline.decode import MeterDecoder
from meterelf_tpu_torch.pipeline.decode import make_coef_decode_fn

torch.set_num_threads(2)

FIVE_SPECS = tuple(j_syn.DIAL_SPECS) + (("1", (62.0, 24.0), 12),)
# dial "0.1" moved up until its centre sits 1 px below the template's top
# edge, and so 1 px inside its window (row 1 of 64): the 5x5 colour
# sample clamps
EDGE_SPECS = tuple(j_syn.DIAL_SPECS[:3]) + (("0.1", (160.9, 1.5), 12),)
CAMERAS = {
    "five": (j_syn.SyntheticCamera(dial_specs=FIVE_SPECS),
             t_syn.FIVE_DIAL_CAMERA),
    "edge": (j_syn.SyntheticCamera(dial_specs=EDGE_SPECS),
             t_syn.SyntheticCamera(dial_specs=EDGE_SPECS)),
}
W = 64


def _grid():
    return itertools.product((60, 120, 200, 250, 256, 260),
                             (60, 120, 210, 250, 256, 300),
                             (40, 63, 64, 90, 119, 128, 129, 136, 140),
                             (40, 63, 64, 141, 188, 192, 193, 256, 257))


def test_frontend_gate_matches_jax():
    """geom_for/fits equal pallas_frontend's over a grid of geometries;
    K1's shared memory never binds inside the gate."""
    n_fit = 0
    for h, w, th, tw in _grid():
        assert frontend.geom_for(h, w, th, tw) == pallas_frontend.geom_for(
            h, w, th, tw), (h, w, th, tw)
        assert frontend.fits(h, w, th, tw) == pallas_frontend.fits(
            h, w, th, tw)
        if frontend.fits(h, w, th, tw):
            n_fit += 1
            assert frontend.frontend_ok(h, w, th, tw)
    assert n_fit > 20
    # the staging size of csrc/corr_mma.cuh at the flagship shape
    assert frontend.smem_bytes(250, 250, 119, 188) == 162804


def test_scorer_gate_matches_jax_and_k8_reach():
    """match.fits equals pallas_match2.fits; every geometry K8's gate
    admits that the frontend's refuses has a template under 64 px in a
    dimension (K8's reach through the default decoder)."""
    for h, w, th, tw in _grid():
        ok = match.fits(h, w, th, tw)
        assert ok == pallas_match2.fits(h, w, th, tw), (h, w, th, tw)
        if ok and not frontend.fits(h, w, th, tw):
            assert th < 64 or tw < 64, (h, w, th, tw)


def test_small_template_fails_to_load_in_both(tmp_path):
    """A template under 64 px wide cannot load in either package: its dial
    window's origin clips to tw - 64 < 0 and the mask slice does not fill
    the 64 x 64 window (params.py:383-393), so the default decoder
    reaches K8 only when static_win_origin is None."""
    specs = (("0.0001", (30.0, 30.0), 12),)
    kw = dict(template_w=60, template_h=90, dial_specs=specs)
    with pytest.raises(ValueError, match="broadcast"):
        t_syn.SyntheticCamera(**kw).make_params().arrays()
    with pytest.raises(ValueError, match="broadcast"):
        j_syn.SyntheticCamera(**kw).make_params(str(tmp_path)).arrays()


def test_stats_bbox_matches_jax():
    rng = np.random.default_rng(3)
    masks = [np.asarray(c.make_params().arrays().mask_full)
             for c in (t_syn.DEFAULT_CAMERA, t_syn.ALT_CAMERA,
                       t_syn.FIVE_DIAL_CAMERA, CAMERAS["edge"][1])]
    masks += [rng.random((3, W, W)) < p for p in (0.0, 0.001, 0.3)]
    masks.append(np.pad(np.ones((2, 50, 20), bool), ((0, 0), (7, 7),
                                                     (0, 44))))
    for m in masks:
        assert t_decode._stats_bbox(m) == j_decode._stats_bbox(m)


def _masks(rng, K, density):
    yy, xx = np.mgrid[:W, :W]
    disk = (yy - 32) ** 2 + (xx - 32) ** 2 <= 23 ** 2
    masked = (rng.random((K, W, W)) < density) & disk
    return masked, np.broadcast_to(disk, masked.shape)


@pytest.mark.parametrize("density", [0.02, 0.15, 0.35, 0.6])
def test_k6_plain_matches_pallas(density):
    """K6's plain version (components.propagate, pack_closed=False) equals
    pallas_ccl.propagate bit for bit, under the default caps (dense
    windows stay non-converged there) and under RESCUE_CAPS."""
    masked, disk = _masks(np.random.default_rng(int(density * 100)), 16,
                          density)
    bits = torch.as_tensor((masked + 2 * disk).astype(np.int32))
    for caps in (None, components.RESCUE_CAPS):
        ref = pallas_ccl.propagate(jnp.asarray(masked), jnp.asarray(disk),
                                   interpret=True, caps=caps)
        got = ccl.propagate(bits, caps)
        assert np.array_equal(np.asarray(ref[0]), got[0].numpy())
        assert np.array_equal(np.asarray(ref[1]), got[1].numpy())
    assert got[1].all()


def _lightness(cam, n):
    crops = cam.render_crops(t_syn.dial_positions(n))
    packed = torch.as_tensor(tio.pack_crops(crops))
    return lightness_from_planes(*unpack_planes(packed)).to(torch.float32)


@pytest.mark.parametrize("camera", ["default", "alt"])
def test_k8_plain_matches_pallas(camera):
    """K8's plain version against match_scores_pallas_fused (interpret)
    where the gate admits the geometry (the flagship), with the stated
    tolerance and the same argmax; ALT_CAMERA's (ow = 70) is refused by
    both gates, and the decode scores it with the matmul scorer."""
    cam = {"default": t_syn.DEFAULT_CAMERA, "alt": t_syn.ALT_CAMERA}[camera]
    L = _lightness(cam, 2)
    T = cam.make_template()
    tm = float(np.float32(T.astype(np.int64).sum()) / np.float32(T.size))
    fits = match.fits(*L.shape[1:], *T.shape)
    assert fits == pallas_match2.fits(*L.shape[1:], *T.shape)
    assert fits == (camera == "default")
    if fits:
        ref = np.asarray(pallas_match2.match_scores_pallas_fused(
            jnp.asarray(L.numpy()), jnp.asarray(T), tm, interpret=True))
        got = match.match_scores(L, torch.as_tensor(T), tm).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        assert np.array_equal(got.reshape(2, -1).argmax(1),
                              ref.reshape(2, -1).argmax(1))


@pytest.mark.parametrize("camera", ["default", "alt"])
def test_matmul_scorer_and_locate_match_jax(camera):
    """scores_matmul and frontend.locate equal template.py's bit for
    bit."""
    cam = {"default": t_syn.DEFAULT_CAMERA, "alt": t_syn.ALT_CAMERA}[camera]
    L = _lightness(cam, 2)
    T = cam.make_template()
    tm = float(np.float32(T.astype(np.int64).sum()) / np.float32(T.size))
    ref = j_template.match_template_scores_matmul(jnp.asarray(L.numpy()),
                                                  jnp.asarray(T), tm)
    got = match.scores_matmul(L, torch.as_tensor(T), tm)
    assert np.array_equal(np.asarray(ref), got.numpy())
    for a, b in zip(j_template.locate(ref), frontend.locate(got)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_finalize_and_read_dial_match_jax():
    """On the FIVE_DIAL_CAMERA's window masks (K2 plain, with speckle):
    analyze_batch (K6 + finalize, with and without the static stats box)
    equals components.analyze_batch(impl="xla"), and read_dials_region
    equals angles.read_dial."""
    cam = t_syn.FIVE_DIAL_CAMERA
    dec = MeterDecoder(cam.make_params(), device="cpu")
    rng = np.random.default_rng(8)
    crops = cam.render_crops(t_syn.dial_positions(3, dials=5))
    crops[rng.random(crops.shape[:3]) < 0.01] = (40, 40, 200)
    packed = torch.as_tensor(tio.pack_crops(crops))
    _, mx, my = frontend.frontend(packed, dec.param_arrays.template_u8,
                                  dec.score_c1, dec.score_c0)
    bits = windows.windows(packed, mx, my, dec.geom, dec.disk,
                           dec.hue_shift).reshape(-1, W, W)
    b = bits.numpy()
    D = len(dec.geom)
    for bbox in (dec.static_kwargs["static_bbox"], None):
        ref = j_comp.analyze_batch(
            jnp.asarray((b & 1) != 0), jnp.asarray((b & 4) != 0),
            jnp.asarray((b & 2) != 0), static_bbox=bbox)
        got = ccl.analyze_batch(bits, bbox)
        for a, g in zip(ref, got):
            assert np.array_equal(np.asarray(a), g.numpy())
    pa = dec.params.arrays()
    region = got.needle_region.reshape(-1, D, W * W)
    pos, rd = angles.read_dials_region(region, dec.param_arrays)
    for i in range(region.shape[0]):
        for d in range(D):
            r = j_angles.read_dial(
                jnp.asarray(region[i, d].numpy()), pa.disk_idx[d],
                pa.disk_valid[d], pa.disk_sx2[d], pa.disk_sy2[d],
                pa.ann_idx[d], pa.ann_valid[d], pa.ann_x[d], pa.ann_y[d],
                pa.ann_angle[d], pa.ann_sqd[d], pa.neg_sign[d],
                pa.zero_turn[d], sum_dtype=jnp.float64)
            assert bool(r.readable) == bool(rd[i, d])
            if rd[i, d]:
                assert abs(float(r.position) - float(pos[i, d])) <= 1e-9


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def decoders(request, tmp_path_factory):
    jc, tc = CAMERAS[request.param]
    jdec = JaxDecoder(jc.make_params(str(tmp_path_factory.mktemp("p"))))
    return request.param, tc, jdec, MeterDecoder(tc.make_params(),
                                                 device="cpu")


def test_general_branch_decode_matches_jax(decoders):
    """Synthetic frames and fuzz frames through the port's non-quad
    frontend branch (K1, K2, K6, finalize) against the JAX decoder."""
    name, cam, jdec, tdec = decoders
    assert (name == "edge") == (tdec.static_kwargs["static_centers"] is None)
    D = len(cam.dial_specs)
    pos = t_syn.dial_positions(6, dials=D)
    crops = cam.render_crops(pos)
    res = tdec.decode_numpy(crops)
    assert_port_equal(jdec.decode_numpy(crops), res, name)
    if name == "five":
        assert (res.err == ErrCode.OK).all() and res.converged.all()
        err = np.abs((res.dial_pos - np.array(pos) + 5) % 10 - 5)
        assert err.max() < 0.1, err.max()
    (x0, y0), (x1, y1) = cam.meter_rect
    # (fuzz_frames paints 4 needles: a fifth dial stays empty)
    fuzz = np.stack([f[y0:y1, x0:x1] for f in fuzz_frames(cam, 10, seed=5)])
    assert_port_equal(jdec.decode_numpy(fuzz), tdec.decode_numpy(fuzz),
                      f"{name} fuzz")


def test_general_branch_rescue(decoders):
    """With the default caps cut to one pass, the general branch finds
    the non-converged rows and re-decodes them under RESCUE_CAPS."""
    _, cam, _, tdec = decoders
    crops = cam.render_crops(t_syn.dial_positions(2, 0.9, 3.3,
                                                  len(cam.dial_specs)))
    good = tdec.decode_numpy(crops)
    with mock.patch.object(components, "K_LABEL", 1), \
            mock.patch.object(components, "K_OUTSIDE", 1), \
            mock.patch.object(components, "K_FILL", 1):
        assert not tdec(crops).converged.all()
        res = tdec.decode_numpy(crops)
    for x, y in zip(good, res):
        np.testing.assert_array_equal(x, y)


def test_scorer_only_branch_matches_jax(tmp_path):
    """static_win_origin=None sends the flagship camera down the
    scorer-only branch (K8, locate, K2, K6), as it does the JAX decode;
    the JAX CPU decoder takes that branch with the matmul scorer."""
    cam = t_syn.DEFAULT_CAMERA
    jdec = JaxDecoder(j_syn.DEFAULT_CAMERA.make_params(str(tmp_path)))
    tdec = MeterDecoder(cam.make_params(), device="cpu")
    tdec.static_kwargs["static_win_origin"] = None
    pos = t_syn.dial_positions(4)
    crops = cam.render_crops(pos)
    n = match.match_scores.launches
    with mock.patch.object(match, "match_scores",
                           wraps=match.match_scores) as k8:
        res = tdec.decode_numpy(crops)
    assert k8.call_count == 1 and match.match_scores.launches == n
    assert_port_equal(jdec.decode_numpy(crops), res, "scorer-only")
    err = np.abs((res.dial_pos - np.array(pos) + 5) % 10 - 5)
    assert (res.err == 0).all() and err.max() < 0.1


def test_five_dial_coef_step_matches_jax(tmp_path):
    """make_coef_decode_fn on FIVE_DIAL_CAMERA: the JPEG feed through the
    general branch equals the JAX step."""
    jc, tc = CAMERAS["five"]
    jdec = JaxDecoder(jc.make_params(str(tmp_path)))
    jstep, _, pad = jax_coef_fn(jdec, (640, 480))
    tstep, _, tpad = make_coef_decode_fn(
        MeterDecoder(tc.make_params(), device="cpu"), (640, 480))
    assert pad == tpad
    pos = t_syn.dial_positions(4, dials=5)
    datas = [t_syn.encode_jpeg(f, 92) for f in tc.render_frames(pos)]
    jfeed = tio.load_coef_feed(datas, tc.meter_rect, (640, 480), pad)
    ref = jax.tree.map(np.asarray, jstep(
        jdec.param_arrays, *(np.asarray(a) for a in
                             tio.load_coef_feed_shard(
                                 datas, tuple(tio.coef_window(
                                     tc.meter_rect, 640, 480)), False,
                                 tc.meter_rect, (640, 480), pad))))
    res = tstep(None, *jfeed)
    res = type(res)(*[v.numpy() for v in res])
    assert_port_equal(ref, res, "five-dial coef step")
    err = np.abs((res.dial_pos - np.array(pos) + 5) % 10 - 5)
    assert (res.err == 0).all() and err.max() < 0.1
