"""The port's calibration (meterelf_tpu_torch.calibration) against the JAX
package's (meterelf_tpu.calibration), side by side on the CPU: the host
helpers on seeded blobs, the averaged meter image byte for byte on
synthetic JPEGs of both cameras, the dial centres and the CLI's stdout.
The reference's corpus test (tests/test_calibration.py) waits for the
corpus; these run on synthetic frames."""
import contextlib
import io
import os
from fractions import Fraction
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from meterelf_tpu import calibration as j_cal
from meterelf_tpu.params import Params as JParams
from meterelf_tpu_torch import calibration as t_cal
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.params import Params as TParams

CAMERAS = {"default": t_syn.DEFAULT_CAMERA, "alt": t_syn.ALT_CAMERA}
N_FRAMES = 16


def _blob(seed):
    """A seeded mask: an ellipse at a random place, with a one-pixel spur
    and a separate speck (the trace revisits the spur's pixels)."""
    rng = np.random.default_rng(seed)
    m = np.zeros((48, 48), bool)
    yy, xx = np.mgrid[:48, :48]
    cy, cx = rng.integers(16, 32, 2)
    a, b = rng.integers(4, 12, 2)
    m[((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 <= 1.0] = True
    m[cy, cx:min(47, cx + b + 4)] = True
    m[int(rng.integers(0, 6)), int(rng.integers(0, 6))] = True
    return m


@pytest.mark.parametrize("seed", range(8))
def test_host_helpers_equal(seed):
    """_components_8, _boundary_points and fit_ellipse are the JAX
    package's, bit for bit."""
    m = _blob(seed)
    comps_j, comps_t = j_cal._components_8(m), t_cal._components_8(m)
    assert len(comps_j) == len(comps_t) >= 2
    for cj, ct in zip(comps_j, comps_t):
        assert np.array_equal(cj, ct)
        pj, pt = j_cal._boundary_points(cj), t_cal._boundary_points(ct)
        assert pj.dtype == pt.dtype and np.array_equal(pj, pt)
        if len(pt) >= 6:
            assert t_cal.fit_ellipse(pt) == j_cal.fit_ellipse(pj)


@pytest.mark.parametrize("seed", range(4))
def test_fma_rounds_once(seed):
    """calibration.fma gives x*y + z rounded once (the exact value by
    fractions, rounded to nearest), over magnitudes the running mean
    meets and far past them."""
    rng = np.random.default_rng(seed)
    n = 4000
    x = rng.random(n) * 10.0 ** rng.integers(-6, 3, n)
    z = rng.random(n) * 10.0 ** rng.integers(-9, 3, n)
    y = float(rng.random())
    got = t_cal.fma(torch.as_tensor(x), y, torch.as_tensor(z)).numpy()
    want = np.array([float(Fraction(a) * Fraction(y) + Fraction(c))
                     for a, c in zip(x, z)])
    assert np.array_equal(got, want)
    # the plain expression rounds twice and differs somewhere
    assert not np.array_equal(x * y + z, want)


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def cal(request, tmp_path_factory):
    """N_FRAMES frames of a camera at random offsets and positions, as
    quality-92 JPEGs (the port's encoder), with params.yml (the port's
    writer; both packages read it); the JAX average image, built once."""
    tc = CAMERAS[request.param]
    d = tmp_path_factory.mktemp(f"cal_{request.param}")
    yml = tc.write_params(str(d))
    rng = np.random.default_rng(12)
    (x0, y0), (x1, y1) = tc.meter_rect
    max_ox = (x1 - x0) - tc.template_w - 1
    max_oy = (y1 - y0) - tc.template_h - 1
    files = []
    for i in range(N_FRAMES):
        pos = rng.uniform(0, 10, 4).tolist()
        off = (int(rng.integers(0, max_ox)), int(rng.integers(0, max_oy)))
        files.append(str(d / f"c{i:02d}.jpg"))
        with open(files[-1], "wb") as fp:
            fp.write(t_syn.encode_jpeg(tc.render_frame(pos, offset=off), 92))
    r = SimpleNamespace(tc=tc, yml=yml, files=files)
    r.jp, r.tp = JParams.load(yml), TParams.load(yml)
    r.j_avg = j_cal.get_average_meter_image(r.jp, files)
    return r


def test_average_image_equal(cal):
    got = t_cal.get_average_meter_image(cal.tp, cal.files, device="cpu")
    assert got.dtype == np.uint8 and got.shape == cal.j_avg.shape
    assert np.array_equal(got, cal.j_avg)


def test_average_image_with_unusable_frames(cal, tmp_path):
    """Frames that do not load (a missing path) or do not match (an
    all-grey frame) are left out of the mean as the JAX package leaves
    them: the same bytes."""
    grey = str(tmp_path / "grey.jpg")
    with open(grey, "wb") as fp:
        fp.write(t_syn.encode_jpeg(np.full((480, 640, 3), 180, np.uint8),
                                   92))
    files = [str(tmp_path / "missing.jpg"), grey] + cal.files[:5]
    want = j_cal.get_average_meter_image(cal.jp, files)
    got = t_cal.get_average_meter_image(cal.tp, files, device="cpu")
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="empty sequence"):
        t_cal.get_average_meter_image(cal.tp, [grey], device="cpu")


def test_dial_centers_equal(cal):
    """find_dial_centers_from_image on the JAX average: the same centres
    and diameters in both packages, or the same error (ALT's small
    needle hubs average to shapes the circle check refuses)."""
    out = {}
    for pkg, mod, p in (("jax", j_cal, cal.jp), ("torch", t_cal, cal.tp)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        try:
            out[pkg] = mod.find_dial_centers_from_image(p, cal.j_avg, **kw)
        except ValueError as e:
            out[pkg] = ("error", str(e))
    assert out["torch"] == out["jax"]
    if cal.tc is t_syn.DEFAULT_CAMERA:
        assert len(out["torch"]) == 4
        for got, (_n, (cx, cy), _d) in zip(out["torch"],
                                            cal.tc.dial_specs):
            assert np.hypot(got.center[0] - cx, got.center[1] - cy) < 1.5


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_cli_stdout_equal(cal):
    """`calibration PARAMS FILE...` and `calibration PARAMS N` (a sample
    of the params' image_glob, drawn alike) print the same lines."""
    if cal.tc is not t_syn.DEFAULT_CAMERA:
        pytest.skip("ALT's centres fail the circle check in both packages")
    with mock.patch.dict(os.environ, {"METERELF_DEVICE": "cpu"}):
        a = _stdout(j_cal.main, [cal.yml, *cal.files])
        b = _stdout(t_cal.main, [cal.yml, *cal.files])
        assert a == b and a.startswith("# 4 dial centers (sorted by x)")
        outs = []
        for main in (j_cal.main, t_cal.main):
            with mock.patch("random.sample",
                            lambda seq, k: sorted(seq)[:k]):
                outs.append(_stdout(main, [cal.yml, str(N_FRAMES)]))
        assert outs[0] == outs[1] and outs[0].count("center: [") == 4


def test_cli_usage_error():
    for pkg, main in (("meterelf_tpu", j_cal.main),
                      ("meterelf_tpu_torch", t_cal.main)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code == 1
        assert err.getvalue() == (
            f"usage: python -m {pkg}.calibration PARAMS_FILE "
            "[N_SAMPLES | IMAGE_FILE...]\n")


def test_excluded_files_and_no_card(tmp_path):
    """The reference's two excluded frames stay excluded; without a card
    and without METERELF_DEVICE=cpu the device half raises."""
    assert t_cal._EXCLUDED_FILENAMES == j_cal._EXCLUDED_FILENAMES
    assert t_cal.STABILIZE_ANCHOR == j_cal.STABILIZE_ANCHOR
    tc = t_syn.DEFAULT_CAMERA
    yml = tc.write_params(str(tmp_path))
    for name in ("a.jpg", "20180814021309-01-e01.jpg",
                 "20180814021310-00-e02.jpg", "b.jpg"):
        (tmp_path / name).write_bytes(b"")
    got = sorted(os.path.basename(f)
                 for f in t_cal.get_image_filenames(TParams.load(yml)))
    want = sorted(os.path.basename(f)
                  for f in j_cal.get_image_filenames(JParams.load(yml)))
    assert got == want == ["a.jpg", "b.jpg"]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with mock.patch.dict(os.environ, {"METERELF_DEVICE": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_cal.find_dial_centers_from_image(
                TParams.load(yml), np.zeros((250, 250, 3), np.uint8))
