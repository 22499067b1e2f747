"""The on-card fuzz gate (marked ``cuda``; each test skips where
torch.cuda.is_available() is False): adversarial frames of
tests/fuzz_frames.py (random angles, carry boundaries, stub needles,
speckle, needle-coloured blobs near the dials) from the port's DEFAULT,
ALT and FIVE_DIAL cameras. Run where the card is, without JAX
(``--noconftest`` skips tests/conftest.py, which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda_fuzz.py -q

METERELF_TPU_FUZZ_N sets the frames a camera (256 by default). The legs,
ports of tests/test_tpu_fuzz.py's:

- crop decodes, on the card and by the same decoder on the CPU (the
  plain versions, which the CPU suite holds equal to the JAX package),
  every field compared: the default decode (the quad branch; FIVE_DIAL
  takes the general branch) and the scorer-only branch (``static_win_origin=None``, as
  chip_smoke.py builds it: K8 where its gate admits the camera, then K2
  and K6);
- JPEG: the frames as quality-92 JPEGs (synthetic.encode_jpeg) through
  the coefficient feed and make_coef_decode_fn's step on the card,
  against the pixel path on the same bytes (load_packed_crops_from_bytes
  -> decode_numpy, on the card), every field: the plane feed (K10), and
  the camera's window sent down the block branch (the plain IDCT and
  K11) by load_coef_feed_shard(plane=False). That is the branch of the
  windows K10 refuses, taken here by a camera's window: K10 refuses no
  window of a camera-sized crop inside the valid chroma, its one refusal
  there being shared memory, from windows 4,848 luma px wide;
- K12 readout against the plain angle stage (ops/angles.readout_plain)
  on the card, bit for bit, on both gathers (okey3 with keymax, the
  needle region) and both geometry dtypes (``exact=False``): the fuzz
  frames' windows of every camera (K1, K2, then K3 and K4 or K6 and the
  sort finalize), the hand-made windows of tests/readout_windows.py,
  rendered crops on the value's carry edges, and slot counts that pad
  tree_sum at the first level, at the second or not at all, equal and
  unequal between the disk and the annulus; the hand-made windows and
  the slot counts also at 1, 3, 5 and 8 dials an image, so that each
  dial takes from 16 down to 2 warps;
- K13 result_pack against the plain result stage
  (ops/result.result_pack_plain) on the card and the reference's raise
  order, bit for bit: the seeded and hand-made rows of
  tests/result_cases.py at B = 0, 1, odd and 256+ and D = 4, 5, 8; each
  branch that ends in K12 (quad, general, scorer-only) decoding the fuzz
  frames with K13 and with the plain stage; the one copy to the host
  (to_host_later) against per-field copies, and kept arrays unchanged
  after later batches.
"""
import os

import numpy as np
import pytest
import torch

import readout_windows
import result_cases
from fuzz_frames import fuzz_frames
from meterelf_tpu_torch import synthetic
from meterelf_tpu_torch.errors import ErrCode
from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import (angles, ccl, frontend, jpeg_tail, jpegdec,
                                    match, result, stats, windows)
from meterelf_tpu_torch.pipeline import decode as decode_mod
from meterelf_tpu_torch.pipeline.decode import (FAST_F32, BatchResult,
                                                MeterDecoder,
                                                make_coef_decode_fn,
                                                to_host_later)

torch.set_num_threads(4)

pytestmark = pytest.mark.cuda

CAMERAS = {"default": synthetic.DEFAULT_CAMERA,
           "alt": synthetic.ALT_CAMERA,
           "five_dial": synthetic.FIVE_DIAL_CAMERA}
ANGLE_TOL = 1e-9   # f64 angle sums run in another order on the card
KERNELS = (frontend.frontend, windows.windows, ccl.ccl, stats.stats,
           frontend.frontend_windows, ccl.propagate, stats.stats_select,
           match.match_scores, jpeg_tail.backhalf_planes,
           jpeg_tail.upsample_color_pack, angles.readout)
QUALITY = 92


def n_frames() -> int:
    return int(os.environ.get("METERELF_TPU_FUZZ_N", "256"))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def crops():
    """{camera name: its fuzz crops}, rendered once for both legs."""
    cache = {}

    def get(cam):
        if cam not in cache:
            camera = CAMERAS[cam]
            (x0, y0), (x1, y1) = camera.meter_rect
            frames = fuzz_frames(camera, n_frames(), seed=len(cam) * 1009 + 7)
            cache[cam] = np.ascontiguousarray(
                np.stack([f[y0:y1, x0:x1] for f in frames]))
        return cache[cam]
    return get


def assert_decodes_equal(a, b, label):
    """Card result a against CPU result b: error codes, locations,
    readability and convergence exact; match_val bitwise; dial positions
    where a dial read within ANGLE_TOL; values where the row is OK equal
    as printed and within ANGLE_TOL; first_bad_dial where the error is
    NEEDLE_CONTOURS and unreadable_bits where it is DIAL_ANGLE exact."""
    for f in ("err", "match_x", "match_y", "readable", "converged"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{label}: {f}")
    np.testing.assert_array_equal(a.match_val.view(np.uint32),
                                  b.match_val.view(np.uint32),
                                  err_msg=f"{label}: match_val")
    rd = b.readable
    np.testing.assert_allclose(np.where(rd, a.dial_pos, 0),
                               np.where(rd, b.dial_pos, 0), rtol=0,
                               atol=ANGLE_TOL, err_msg=f"{label}: dial_pos")
    ok = b.err == int(ErrCode.OK)
    np.testing.assert_allclose(np.where(ok, a.value, 0),
                               np.where(ok, b.value, 0), rtol=0,
                               atol=ANGLE_TOL, err_msg=f"{label}: value")
    assert [f"{v:07.3f}" for v in a.value[ok]] == \
        [f"{v:07.3f}" for v in b.value[ok]], f"{label}: printed values"
    for code, f in ((ErrCode.NEEDLE_CONTOURS, "first_bad_dial"),
                    (ErrCode.DIAL_ANGLE, "unreadable_bits")):
        sel = b.err == int(code)
        np.testing.assert_array_equal(
            np.where(sel, getattr(a, f), 0), np.where(sel, getattr(b, f), 0),
            err_msg=f"{label}: {f}")


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_fuzz_frames_on_card_equal_cpu(dev, crops, cam):
    """n_frames() fuzz frames of the camera: the card's decode equals the
    CPU's in every field, and the card ran the branch's kernels (K5 and
    K7 never)."""
    camera, batch = CAMERAS[cam], crops(cam)
    decs = [MeterDecoder(camera.make_params(), device=d)
            for d in (dev, "cpu")]
    before = [k.launches for k in KERNELS]
    a = decs[0].decode_numpy(batch)
    ran = {k.__name__: k.launches - n for k, n in zip(KERNELS, before)}
    assert_decodes_equal(a, decs[1].decode_numpy(batch), cam)
    if cam == "five_dial":
        want = {"frontend", "windows", "propagate"}
    else:
        want = {"frontend", "windows", "ccl", "stats"}
    assert {k for k, n in ran.items() if n} == want | {"readout"}, ran
    assert ran["readout"] == ran["windows"]
    # the fuzz mix reaches past the easy rows
    assert (a.err != int(ErrCode.OK)).any() or n_frames() < 32


def launched(before) -> set:
    return {k.__name__ for k, n in zip(KERNELS, before) if k.launches > n}


def assert_same_bits(a, b, label):
    """Two decodes on the card: every field equal, floats bit for bit."""
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.dtype.kind == "f":
            x, y = x.view(f"u{x.itemsize}"), y.view(f"u{y.itemsize}")
        np.testing.assert_array_equal(x, y, err_msg=f"{label}: {f}")


@pytest.mark.parametrize("cam", ["alt", "default"])
def test_fuzz_scorer_only_on_card_equal_cpu(dev, crops, cam):
    """The scorer-only branch (static_win_origin=None) on n_frames() fuzz
    frames: the card's decode equals the CPU's in every field; the card
    ran K8 (where match.fits admits the camera: the flagship, not ALT,
    whose scores take the matmul scorer), K2 and K6 and nothing of the
    quad branch."""
    camera, batch = CAMERAS[cam], crops(cam)
    decs = [MeterDecoder(camera.make_params(), device=d)
            for d in (dev, "cpu")]
    for d in decs:
        d.static_kwargs["static_win_origin"] = None
    before = [k.launches for k in KERNELS]
    a = decs[0].decode_numpy(batch)
    ran = launched(before)
    assert_decodes_equal(a, decs[1].decode_numpy(batch), f"{cam} scorer")
    (x0, y0), (x1, y1) = camera.meter_rect
    k8 = match.fits(y1 - y0, x1 - x0, camera.template_h, camera.template_w)
    assert k8 == (cam == "default")
    assert ran == {"windows", "propagate", "readout"} | (
        {"match_scores"} if k8 else set()), ran
    assert (a.err != int(ErrCode.OK)).any() or n_frames() < 32


@pytest.mark.parametrize("layout", ["plane", "block"])
@pytest.mark.parametrize("cam", ["alt", "default"])
def test_fuzz_jpeg_on_card_equal_pixel_path(dev, cam, layout):
    """n_frames() fuzz frames as quality-92 JPEGs: the coefficient step on
    the card (K10 on the plane feed, the plain IDCT and K11 on the block
    feed) equals the pixel path's decode of the same bytes on the card,
    every field bit for bit; every frame loads and converges."""
    camera = CAMERAS[cam]
    rect, frame_wh = camera.meter_rect, (camera.frame_w, camera.frame_h)
    frames = fuzz_frames(camera, n_frames(), seed=len(cam) * 1013 + 23)
    datas = [synthetic.encode_jpeg(f, QUALITY) for f in frames]
    dec = MeterDecoder(camera.make_params(), device=dev)
    step, win, pad_hw = make_coef_decode_fn(dec, frame_wh)
    assert jpegdec.backhalf_ok(win, pad_hw)
    feed = tio.load_coef_feed_shard(datas, tuple(win), layout == "plane",
                                    rect, frame_wh, pad_hw, num_threads=4)
    assert feed[4].all() and (feed[6] == len(datas)).all()
    before = [k.launches for k in KERNELS]
    got = to_host_later(step(None, *feed))()
    ran = launched(before)
    packed, ok = tio.load_packed_crops_from_bytes(datas, rect, pad_hw,
                                                  num_threads=4)
    assert ok.all()
    ref = dec.decode_numpy(packed, ok)
    assert got.converged.all(), "CCL non-convergence under fuzz"
    assert_same_bits(got, ref, f"{cam} {layout} coef vs pixel")
    tail = "backhalf_planes" if layout == "plane" else "upsample_color_pack"
    assert ran == {"frontend", "windows", "ccl", "stats", "readout", tail}, ran
    assert (got.err != int(ErrCode.OK)).any() or n_frames() < 32


# ---------------------------------------------------------- K12 readout --

def readout_decoder(dev, cam, exact):
    return MeterDecoder(CAMERAS[cam].make_params(), device=dev, exact=exact)


def assert_readout_equals_plain(src, keymax, pa, label):
    """K12 on the card against the plain stage on the same card tensors:
    every output bit for bit; one launch."""
    n = angles.readout.launches
    got = angles.readout(src, keymax, pa)
    assert angles.readout.launches == n + 1
    want = angles.readout_plain(src, keymax, pa)
    for name, a, b in zip(("position", "readable", "value"), got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if a.dtype.kind == "f":
            a, b = a.view(np.uint64), b.view(np.uint64)
        np.testing.assert_array_equal(a, b, err_msg=f"{label}: {name}")
    return [t.cpu().numpy() for t in got]


def window_inputs(dec, batch, gather):
    """The decode's angle-stage inputs for crops ``batch``: K1 and K2,
    then K3 and K4 (okey3, keymax) or K6 and the sort finalize (needle
    region, keymax None), as [B, D, 4096]."""
    dev, pa = dec.device, dec.param_arrays
    packed = torch.as_tensor(tio.pack_crops(batch)).to(dev)
    mx, my = frontend.frontend(packed, pa.template_u8, dec.score_c1,
                               dec.score_c0)[1:]
    bits = windows.windows(packed, mx, my, dec.geom, dec.disk,
                           dec.hue_shift).reshape(-1, 64, 64)
    B, D = packed.shape[0], len(dec.geom)
    if gather == "okey3":
        okey3 = ccl.ccl(bits)[0]
        return okey3.reshape(B, D, -1), stats.stats(okey3)[0].reshape(B, D)
    comp = ccl.analyze_batch(bits, dec.static_kwargs["static_bbox"])
    return comp.needle_region.reshape(B, D, -1), None


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("gather", ["okey3", "region"])
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_readout_fuzz_windows_equal_plain(dev, crops, cam, gather, exact):
    """n_frames() fuzz frames' windows: K12 equals the plain stage on the
    card, bit for bit."""
    dec = readout_decoder(dev, cam, exact)
    src, keymax = window_inputs(dec, crops(cam), gather)
    _, readable, _ = assert_readout_equals_plain(
        src, keymax, dec.param_arrays, f"{cam} {gather} exact={exact}")
    assert readable.any()


def dial_subset(pa, dials):
    """pa's angle geometry for the windows of ``dials`` (dial indices,
    repeats allowed); value_perm kept (read only where D == 4)."""
    pick = torch.as_tensor(dials, device=pa.disk_idx.device)
    return pa._replace(**{k: getattr(pa, k)[pick].contiguous()
                          for k in pa._fields
                          if k.startswith(("disk_", "ann_"))
                          or k in ("neg_sign", "zero_turn")})


@pytest.mark.parametrize("D", [None, 1, 3, 5, 8])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("gather", ["okey3", "region"])
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_readout_hand_windows_equal_plain(dev, cam, gather, exact, D):
    """The hand-made windows (no needle, den = 0; n = 1..6 across the
    trim's cut steps; the 0.75-turn tail; the whole annulus; keymax -1,
    small and big blobs), with the camera's dials (D None) or its dials
    repeated or cut to D windows an image: K12 equals the plain stage on
    the card, bit for bit."""
    dec = readout_decoder(dev, cam, exact)
    host = dec.params.arrays()
    if not exact:
        host = host._replace(**{k: getattr(host, k).astype(np.float32)
                                for k in FAST_F32})
    region = readout_windows.hand_regions(host, seed=len(cam))
    okey3, keymax = readout_windows.okey3_of(region, seed=len(cam) + 1)
    if gather == "okey3":
        src, km = okey3, keymax
    else:
        src, km = region, None
    pa = dec.param_arrays
    if D is not None:
        dials = [i % src.shape[1] for i in range(D)]
        src = src[:, dials]
        km = None if km is None else km[:, dials]
        pa = dial_subset(pa, dials)
    assert_readout_equals_plain(
        torch.as_tensor(np.ascontiguousarray(src)).to(dev),
        None if km is None else torch.as_tensor(
            np.ascontiguousarray(km)).to(dev),
        pa, f"{cam} {gather} exact={exact} D={D}")


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("cam", ["alt", "default"])
def test_readout_carry_edges_equal_plain(dev, cam, exact):
    """Crops rendered on assemble_value's carry edges (r4 near 2 and 8,
    fractions near 0.45 and 0.55), both gathers: K12's positions and
    values equal the plain stage's on the card, bit for bit."""
    dec = readout_decoder(dev, cam, exact)
    batch = CAMERAS[cam].render_crops(readout_windows.CARRY_EDGES)
    for gather in ("okey3", "region"):
        src, keymax = window_inputs(dec, batch, gather)
        _, readable, _ = assert_readout_equals_plain(
            src, keymax, dec.param_arrays, f"{cam} {gather} carry")
        assert readable.all()


SLOT_COUNTS = [(1, 1), (20, 20), (32, 32), (33, 33), (1000, 1000),
               (1280, 1280), (1536, 1536), (4096, 4096), (20, 40),
               (1000, 33), (1536, 1024), (33, 4096)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("D", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("disk,ann", SLOT_COUNTS)
def test_readout_slot_counts_equal_plain(dev, crops, disk, ann, D, exact):
    """The flagship's geometry cut (or padded with invalid slots) to
    ``disk`` disk and ``ann`` annulus slots a dial, so that tree_sum pads
    at the first level (1000: 8 zeros), only at the second (1280: 40
    partials to 64), not at all (1536, 4096) or sums one short run (1,
    20, 32), or two runs (33); unequal counts, whose dials' shared
    buffers start at offsets that are no multiple of 8 unless rounded;
    and its dials repeated or cut to D windows an image, so that a dial
    takes 16 / D warps (D = 1: 16, D = 8: 2, first-level runs more than
    a dial's threads at 4096 slots; D = 3, 5: 15 warps a CTA), both
    geometry dtypes: K12 equals the plain stage on the card, bit for
    bit, on both gathers, the value too where D = 4."""
    dec = readout_decoder(dev, "default", exact)
    dials = [i % 4 for i in range(D)]
    pa = dial_subset(dec.param_arrays, dials)

    def fit(t, slots):
        t = t[:, :slots]
        pad = torch.zeros((t.shape[0], slots - t.shape[1]), dtype=t.dtype,
                          device=t.device)
        return torch.cat([t, pad], 1).contiguous()

    pa = pa._replace(**{k: fit(getattr(pa, k), disk if k.startswith("disk_")
                               else ann) for k in pa._fields
                        if k.startswith(("disk_", "ann_"))})
    for gather in ("okey3", "region"):
        src, keymax = window_inputs(dec, crops("default")[:64], gather)
        src = src[:, dials].contiguous()
        keymax = None if keymax is None else keymax[:, dials].contiguous()
        assert_readout_equals_plain(src, keymax, pa, f"{disk}/{ann} slots "
                                    f"D={D} {gather} exact={exact}")


# ------------------------------------------------------ K13 result_pack --

RESULT_SIZES = [(0, 4), (1, 4), (7, 4), (len(result_cases.HAND), 4),
                (256, 4), (0, 5), (1, 5), (7, 5), (257, 5), (300, 8)]
BRANCHES = {"quad": "default", "general": "five_dial", "scorer": "default"}


def pack_on(fn, x, dev):
    t = {k: torch.as_tensor(v).to(dev)
         for k, v in result_cases.flat(x).items()}
    return fn(t["load_ok"], t["max_val"], t["mx"], t["my"],
              result_cases.THRESHOLD, t["has_any"], t["conv"],
              t["position"], t["readable"], t["value"])


@pytest.mark.parametrize("B,D", RESULT_SIZES)
def test_result_pack_equals_plain(dev, B, D):
    """Seeded and hand-made rows (tests/result_cases.py): K13 equals the
    plain stage run on the card and the reference's order, every field
    bit for bit; one launch a call with rows, none without; the fields
    are views of one buffer in the layout of (B, D)."""
    for seed in range(3):
        x = result_cases.cases(B, D, seed)
        n = result.result_pack.launches
        got = BatchResult(*pack_on(result.result_pack, x, dev))
        assert result.result_pack.launches == n + (B > 0)
        want = pack_on(result.result_pack_plain, x, dev)
        assert result.result_pack.launches == n + (B > 0)
        label = f"B={B} D={D} seed={seed}"
        assert_same_bits(to_host_later(got)(),
                         BatchResult(*(v.cpu().numpy() for v in want)),
                         label)
        assert_same_bits(to_host_later(got)(),
                         BatchResult(*result_cases.expected(x)), label)
        fields, nbytes = result.layout(B, D)
        storage = got.err.untyped_storage()
        assert storage.nbytes() == nbytes
        for v, (off, dtype, shape) in zip(got, fields):
            assert v.untyped_storage().data_ptr() == storage.data_ptr()
            assert v.storage_offset() * v.element_size() == off
            assert v.dtype == dtype and tuple(v.shape) == shape


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_result_pack_in_decode_equals_plain(dev, crops, branch,
                                            monkeypatch):
    """n_frames() fuzz frames, one row in 7 not loaded, down each branch
    that ends in K12 (quad, general, scorer-only):
    the decode's BatchResult with K13 equals the one with the plain stage
    on the card, every field bit for bit; K13 launches once a decode."""
    cam = BRANCHES[branch]
    dec = MeterDecoder(CAMERAS[cam].make_params(), device=dev)
    if branch == "scorer":
        dec.static_kwargs["static_win_origin"] = None
    batch = crops(cam)
    ok = np.arange(len(batch)) % 7 != 3
    n, r = result.result_pack.launches, angles.readout.launches
    got = to_host_later(dec(batch, ok))()
    assert result.result_pack.launches == n + 1
    assert angles.readout.launches == r + 1
    monkeypatch.setattr(decode_mod, "result_pack", result.result_pack_plain)
    want = to_host_later(dec(batch, ok))()
    assert result.result_pack.launches == n + 1
    assert_same_bits(got, want, branch)
    assert len(set(got.err.tolist())) >= 2 or n_frames() < 32


def test_result_pack_refuses_bad_inputs(dev):
    """Inputs of another dtype, size or device, more dials than the
    kernel takes: refused before any launch; a good call still runs."""
    x = {k: torch.as_tensor(v).to(dev)
         for k, v in result_cases.flat(result_cases.cases(5, 4, 0)).items()}

    def call(**edits):
        t = {**x, **edits}
        return result.result_pack(
            t["load_ok"], t["max_val"], t["mx"], t["my"],
            result_cases.THRESHOLD, t["has_any"], t["conv"], t["position"],
            t["readable"], t["value"])

    n = result.result_pack.launches
    with pytest.raises(TypeError):
        call(max_val=x["max_val"].double())
    with pytest.raises(TypeError):
        call(mx=x["mx"].long())
    with pytest.raises(ValueError):
        call(has_any=x["has_any"][:-1])
    with pytest.raises(ValueError):
        call(load_ok=x["load_ok"].cpu())
    with pytest.raises(ValueError):
        call(conv=x["conv"].reshape(5, 4).t())
    nine = {k: torch.as_tensor(v).to(dev) for k, v in
            result_cases.flat(result_cases.cases(5, 9, 0)).items()}
    with pytest.raises(ValueError):
        call(**nine)
    assert result.result_pack.launches == n
    call()
    assert result.result_pack.launches == n + 1


def test_to_host_later_one_copy_keeps_arrays(dev, crops):
    """The packed result reaches the host as numpy views of one pinned
    buffer, equal to the per-field copies of the same tensors; arrays a
    caller keeps stay valid while later batches reuse the pinned cache."""
    dec = MeterDecoder(CAMERAS["default"].make_params(), device=dev)
    batch = crops("default")[:64]
    res = dec(batch)
    assert result.packed_recipe(res) is result.recipe(64, 4)
    kept = to_host_later(res)()
    loose = to_host_later(BatchResult(*(v.clone() for v in res)))()
    assert type(kept) is type(loose) is BatchResult
    assert_same_bits(kept, loose, "one copy vs per field")
    assert all(isinstance(v, np.ndarray) and v.base is kept.err.base
               for v in kept)
    snapshot = BatchResult(*(np.array(v) for v in kept))
    del res, loose
    for i in range(24):
        other = to_host_later(dec(np.roll(batch, i + 1, axis=0)))()
        del other
    torch.cuda.synchronize()
    assert_same_bits(kept, snapshot, "kept arrays after later batches")
