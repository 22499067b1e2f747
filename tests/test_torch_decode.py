"""The PyTorch port's decode path as a whole, MeterDecoder(device="cpu")
(every kernel stage runs its plain version), against the JAX package's
MeterDecoder on the CPU: synthetic frames at known positions, blank
frames, a load failure, a stub needle, fuzz frames, both cameras."""
from unittest import mock

import numpy as np
import pytest
import torch
from fuzz_frames import assert_results_equal, fuzz_frames

from meterelf_tpu import synthetic as j_syn
from meterelf_tpu.errors import ErrCode
from meterelf_tpu.pipeline.decode import MeterDecoder as JaxDecoder
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.ops import components as t_comp
from meterelf_tpu_torch.pipeline.decode import MeterDecoder

torch.set_num_threads(2)

CAMERAS = {
    "default": (j_syn.DEFAULT_CAMERA, t_syn.DEFAULT_CAMERA),
    "alt": (j_syn.ALT_CAMERA, t_syn.ALT_CAMERA),
}
# f64 sums in _read_dial_core (angles.py:116-147) run in another order in
# torch than in XLA: dial positions may differ in the last bits
POS_TOL = 1e-9


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def decoders(request, tmp_path_factory):
    jc, tc = CAMERAS[request.param]
    jdec = JaxDecoder(jc.make_params(str(tmp_path_factory.mktemp("p"))))
    return tc, jdec, MeterDecoder(tc.make_params(), device="cpu")


def assert_port_equal(ref, got, label):
    """assert_results_equal after the one stated tolerance: readable
    dial positions within POS_TOL, values of OK rows within POS_TOL with
    identical digits and identical golden renderings (%07.3f)."""
    rd = ref.readable
    np.testing.assert_allclose(np.where(rd, got.dial_pos, 0),
                               np.where(rd, ref.dial_pos, 0),
                               rtol=0, atol=POS_TOL, err_msg=label)
    ok = ref.err == int(ErrCode.OK)
    np.testing.assert_allclose(got.value[ok], ref.value[ok], rtol=0,
                               atol=POS_TOL, err_msg=label)
    np.testing.assert_array_equal(np.floor(got.value[ok]),
                                  np.floor(ref.value[ok]), err_msg=label)
    assert ([f"{v:07.3f}" for v in got.value[ok]]
            == [f"{v:07.3f}" for v in ref.value[ok]]), label
    got = got._replace(dial_pos=np.where(rd, ref.dial_pos, got.dial_pos),
                       value=np.where(ok, ref.value, got.value))
    assert_results_equal(ref, got, label)
    np.testing.assert_array_equal(got.converged, ref.converged)


def _crops(camera, frames):
    (x0, y0), (x1, y1) = camera.meter_rect
    return np.ascontiguousarray(np.stack([f[y0:y1, x0:x1] for f in frames]))


def test_synthetic_positions(decoders):
    cam, jdec, tdec = decoders
    true_pos = [[(i * 1.7 + d * 2.3) % 10 for d in range(4)]
                for i in range(8)]
    crops = cam.render_crops(true_pos)
    res = tdec.decode_numpy(crops)
    assert_port_equal(jdec.decode_numpy(crops), res, "synthetic")
    assert (res.err == ErrCode.OK).all() and res.converged.all()
    err = np.abs(((res.dial_pos - np.array(true_pos)) + 5) % 10 - 5)
    assert err.max() < 0.1
    assert res.dial_pos.dtype == np.float64
    assert res.match_val.dtype == np.float32


def test_blank_frames_and_load_failure(decoders):
    cam, jdec, tdec = decoders
    h, w = tdec.feed_pad_hw
    crops = np.concatenate([
        np.full((2, h, w, 3), 128, np.uint8),
        cam.render_crops([[1.0, 2.0, 3.0, 4.0]] * 2)])
    ok = np.array([True, True, True, False])
    res = tdec.decode_numpy(crops, ok)
    ref = jdec.decode_numpy(crops, ok)
    # a blank crop scores ~0 everywhere: the JAX CPU scorer's
    # corr - tmean*box cancels two f32 terms near th*tw*128*tmean and
    # keeps their rounding noise, where the port's exact decomposition
    # gives the residual c0. Both sit far below the threshold (err is
    # compared exactly); the tolerance is 4 ulp of the cancelled terms.
    atol = 4 * float(np.spacing(np.float32(
        cam.template_h * cam.template_w * 128 * 255)))
    np.testing.assert_allclose(res.match_val[:2], ref.match_val[:2],
                               rtol=0, atol=atol)
    res = res._replace(match_val=np.concatenate(
        [ref.match_val[:2], res.match_val[2:]]))
    assert_port_equal(ref, res, "blank/load")
    assert res.err.tolist() == [ErrCode.DIALS_NOT_FOUND] * 2 + [
        ErrCode.OK, ErrCode.LOAD]


def test_stub_needle_unreadable(decoders):
    cam, jdec, tdec = decoders
    crops = _crops(cam, [cam.render_frame([1.0, 2.0, 3.0, 4.0],
                                          stub_dials=(2,))])
    res = tdec.decode_numpy(crops)
    assert_port_equal(jdec.decode_numpy(crops), res, "stub")
    assert res.err[0] == ErrCode.DIAL_ANGLE
    assert res.unreadable_bits[0] == 1 << 2
    assert res.readable[0].tolist() == [True, True, False, True]


def test_fuzz_frames(decoders):
    cam, jdec, tdec = decoders
    crops = _crops(cam, fuzz_frames(cam, 16, seed=11))
    assert_port_equal(jdec.decode_numpy(crops), tdec.decode_numpy(crops),
                      "fuzz")


def test_packed_input_and_device_results(decoders):
    """Packed i32 crops decode as u8 ones do; __call__ returns tensors on
    the decoder's device."""
    cam, _, tdec = decoders
    crops = cam.render_crops([[3.3, 4.4, 5.5, 6.6]])
    c = crops.astype(np.int32)
    packed = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
    a, b = tdec.decode_numpy(crops), tdec.decode_numpy(packed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    res = tdec(packed)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in res)


def test_rescue_reruns_non_converged_rows(decoders):
    """With the default caps cut to one pass, decode_numpy finds the
    non-converged rows and re-decodes them under RESCUE_CAPS, matching an
    unsabotaged decode (decode.py:661-706 semantics)."""
    cam, _, tdec = decoders
    crops = cam.render_crops([[1.0, 3.5, 7.2, 9.9], [0.0, 2.5, 5.0, 7.5]])
    good = tdec.decode_numpy(crops)
    with mock.patch.object(t_comp, "K_LABEL", 1), \
            mock.patch.object(t_comp, "K_OUTSIDE", 1), \
            mock.patch.object(t_comp, "K_FILL", 1):
        assert not tdec(crops).converged.all()
        res = tdec.decode_numpy(crops)
    assert res.converged.all()
    for x, y in zip(good, res):
        np.testing.assert_array_equal(x, y)


def test_cuda_decoder_without_gpu_raises(decoders):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeterDecoder(decoders[2].params, device="cuda")
