"""The port's CUDA kernels against their plain torch versions on the
card (marked ``cuda``; each test skips where torch.cuda.is_available()
is False). Run them on a machine with a GPU, where JAX need not be
installed (``--noconftest`` skips tests/conftest.py, which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The first test builds the kernels with nvcc (meterelf_tpu_torch/_build).
"""
import numpy as np
import pytest
import torch

from meterelf_tpu_torch import synthetic
from meterelf_tpu_torch.ops import ccl, components, frontend, stats, windows
from meterelf_tpu_torch.pipeline.decode import MeterDecoder

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda
W = 64


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _pack(crops):
    c = crops.astype(np.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


@pytest.fixture(scope="module")
def case(dev):
    """Flagship decoder on the card and 8 synthetic crops with speckle."""
    cam = synthetic.DEFAULT_CAMERA
    rng = np.random.default_rng(3)
    crops = cam.render_crops(rng.uniform(0, 10, (8, 4)).tolist())
    speck = rng.random(crops.shape[:3]) < 0.01
    crops[speck] = (40, 40, 200)
    dec = MeterDecoder(cam.make_params(), device=dev)
    return dec, crops, torch.as_tensor(_pack(crops)).to(dev)


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
    with pytest.raises(ValueError):   # needs more shared memory than a block
        frontend.frontend(
            torch.zeros((1, 1024, 1024), dtype=torch.int32, device=dev),
            torch.zeros((119, 188), dtype=torch.uint8, device=dev), 0.0, 0.0)
