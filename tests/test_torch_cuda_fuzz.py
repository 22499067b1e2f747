"""The on-card fuzz gate, crop-decode legs (marked ``cuda``; each test
skips where torch.cuda.is_available() is False): adversarial frames of
tests/fuzz_frames.py (random angles, carry boundaries, stub needles,
speckle, needle-coloured blobs near the dials) from the port's DEFAULT,
ALT and FIVE_DIAL cameras, decoded on the card and by the same decoder on
the CPU (the plain versions, which the CPU suite holds equal to the JAX
package), every field compared. Legs: the default decode (the quad
branch; FIVE_DIAL takes the general branch) and the merged + hist_pallas
variant (K5, K6, K7 on the quad branch; the knobs leave the general branch
as it is). Run where the card is, without JAX (``--noconftest`` skips
tests/conftest.py, which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda_fuzz.py -q

METERELF_TPU_FUZZ_N sets the frames a camera (256 by default).
"""
import os

import numpy as np
import pytest
import torch

from fuzz_frames import fuzz_frames
from meterelf_tpu_torch import synthetic
from meterelf_tpu_torch.errors import ErrCode
from meterelf_tpu_torch.ops import ccl, frontend, stats, windows
from meterelf_tpu_torch.pipeline.decode import MeterDecoder

torch.set_num_threads(4)

pytestmark = pytest.mark.cuda

CAMERAS = {"default": synthetic.DEFAULT_CAMERA,
           "alt": synthetic.ALT_CAMERA,
           "five_dial": synthetic.FIVE_DIAL_CAMERA}
LEGS = {"default": {}, "merged_hist_pallas": {"frontend": "merged",
                                              "quad_stats": "hist_pallas"}}
ANGLE_TOL = 1e-9   # f64 angle sums run in another order on the card
KERNELS = (frontend.frontend, windows.windows, ccl.ccl, stats.stats,
           frontend.frontend_windows, ccl.propagate, stats.stats_select)


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


@pytest.mark.parametrize("leg", sorted(LEGS))
@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_fuzz_frames_on_card_equal_cpu(dev, crops, cam, leg):
    """n_frames() fuzz frames of the camera: the card's decode equals the
    CPU's in every field, and the card ran the leg's kernels."""
    camera, batch = CAMERAS[cam], crops(cam)
    decs = [MeterDecoder(camera.make_params(), device=d, **LEGS[leg])
            for d in (dev, "cpu")]
    before = [k.launches for k in KERNELS]
    a = decs[0].decode_numpy(batch)
    ran = {k.__name__: k.launches - n for k, n in zip(KERNELS, before)}
    assert_decodes_equal(a, decs[1].decode_numpy(batch), f"{cam} {leg}")
    if cam == "five_dial":
        want = {"frontend", "windows", "propagate"}
    elif leg == "default":
        want = {"frontend", "windows", "ccl", "stats"}
    else:
        want = {"frontend_windows", "propagate", "stats_select"}
    assert {k for k, n in ran.items() if n} == want, ran
    # the fuzz mix reaches past the easy rows
    assert (a.err != int(ErrCode.OK)).any() or n_frames() < 32
