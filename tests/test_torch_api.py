"""The port's public API against the JAX package's, on the CPU:
``get_meter_values`` records field by field (filename, value, error
class and message, meter_values) on the seeded JPEG set of
tests/test_torch_cli.py, exact and fast mode; ``result_to_data`` on a
hand-made BatchResult holding every ErrCode, with DEBUG off and on; and
``MeterDecoder(exact=False)`` against the JAX package's fast mode on
rendered crops. The dial positions are compared bit for bit: the port
sums them in the JAX graph's order (ops/angles.tree_sum)."""
from unittest import mock

import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from test_torch_cli import _frames

from meterelf_tpu import api as j_api
from meterelf_tpu import debugging as j_debugging
from meterelf_tpu import synthetic as j_syn
from meterelf_tpu.pipeline.decode import BatchResult as JResult
from meterelf_tpu.pipeline.decode import MeterDecoder as JaxDecoder
from meterelf_tpu_torch import api as t_api
from meterelf_tpu_torch import debugging as t_debugging
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.errors import ErrCode
from meterelf_tpu_torch.pipeline.decode import FAST_F32, BatchResult
from meterelf_tpu_torch.pipeline.decode import MeterDecoder

torch.set_num_threads(2)

CAMERAS = {"default": (j_syn.DEFAULT_CAMERA, t_syn.DEFAULT_CAMERA),
           "alt": (j_syn.ALT_CAMERA, t_syn.ALT_CAMERA)}


def assert_records_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.filename == y.filename
        assert type(x.value) is type(y.value) and x.value == y.value, x
        assert type(x.error).__name__ == type(y.error).__name__, x
        if x.error is not None:
            assert x.error.get_message() == y.error.get_message()
        assert x.meter_values == y.meter_values, x
        assert list(x.meter_values) == list(y.meter_values)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    jc, tc = CAMERAS["default"]
    d = tmp_path_factory.mktemp("api")
    jc.make_params(str(d))
    yml = str(d / "params.yml")
    with open(yml, "w") as fp:
        yaml.safe_dump(jc.params_dict(str(d / "synthetic_template.png")), fp)
    out = []
    for name, frame in _frames(tc, 9, seed=99):
        p = str(d / f"{name}.jpg")
        Image.fromarray(frame[..., ::-1]).save(p, "JPEG", quality=85)
        out.append(p)
    return yml, out + [str(d / "missing.jpg")]


@pytest.mark.parametrize("exact", [True, False])
def test_get_meter_values_equal(files, exact):
    yml, fns = files
    jdec = JaxDecoder(j_api.load_params(yml), exact=exact)
    ref = list(j_api.get_meter_values(yml, fns, batch_size=8, decoder=jdec))
    got = list(t_api.get_meter_values(yml, fns, batch_size=8, exact=exact,
                                      device="cpu"))
    assert_records_equal(ref, got)
    kinds = {type(r.error).__name__ for r in got}
    assert {"NoneType", "ImageLoadingError", "DialsNotFoundError",
            "NeedleContoursNotFoundError",
            "DialAngleDeterminingError"} <= kinds
    # a decoder passed in is used as is, at another batch size
    dec = MeterDecoder(t_api.load_params(yml), exact=exact, device="cpu")
    assert_records_equal(ref, list(t_api.get_meter_values(
        yml, fns, batch_size=3, decoder=dec)))


def test_get_meter_values_device_from_environment(files, monkeypatch):
    """device=None reads METERELF_DEVICE; unset, it means the card, and
    without one the decoder raises (no fallback to the CPU)."""
    yml, fns = files
    monkeypatch.setenv("METERELF_DEVICE", "cpu")
    assert next(t_api.get_meter_values(yml, fns[:1])).value is not None
    monkeypatch.delenv("METERELF_DEVICE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(t_api.get_meter_values(yml, fns[:1]))


def _hand_made(D):
    """One row per ErrCode, plus an OK row whose last dial is unreadable
    (no value) and a DIAL_ANGLE row with two unreadable dials."""
    codes = [ErrCode.OK, ErrCode.LOAD, ErrCode.DIALS_NOT_FOUND,
             ErrCode.NEEDLE_CONTOURS, ErrCode.DIAL_ANGLE, ErrCode.OK,
             ErrCode.DIAL_ANGLE]
    B = len(codes)
    rng = np.random.default_rng(2)
    readable = np.ones((B, D), bool)
    readable[5, -1] = False
    readable[6, [0, 2]] = False
    bits = (~readable).astype(np.int32) @ (1 << np.arange(D, dtype=np.int32))
    return dict(
        err=np.array(codes, np.int32),
        first_bad_dial=np.array([0, 0, 0, 2, 0, 0, 0], np.int32),
        unreadable_bits=bits.astype(np.int32),
        match_val=rng.uniform(0, 1e6, B).astype(np.float32),
        match_x=np.zeros(B, np.int32), match_y=np.zeros(B, np.int32),
        dial_pos=rng.uniform(0, 10, (B, D)), readable=readable,
        value=rng.uniform(0, 1000, B), converged=np.ones(B, bool))


@pytest.mark.parametrize("debug", [set(), {"1"}])
def test_result_to_data_every_errcode(debug, tmp_path):
    jc, tc = CAMERAS["default"]
    jp = jc.make_params(str(tmp_path))
    tp = tc.make_params()
    fields = _hand_made(len(tp.dial_names))
    jres, tres = JResult(**fields), BatchResult(**fields)
    with mock.patch.object(j_debugging, "DEBUG", debug), \
            mock.patch.object(t_debugging, "DEBUG", debug):
        for parity in (False, True):
            ref = [j_api.result_to_data(f"f{i}.jpg", jres, i, jp,
                                        parity_match_val=parity)
                   for i in range(len(fields["err"]))]
            got = [t_api.result_to_data(f"f{i}.jpg", tres, i, tp,
                                        parity_match_val=parity)
                   for i in range(len(fields["err"]))]
            assert_records_equal(ref, got)
    assert got[0].value == fields["value"][0] and got[5].value is None
    assert "dial positions" in str(got[4].error.get_message()) or not debug


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_fast_mode_equals_jax_fast_mode(cam, tmp_path):
    jc, tc = CAMERAS[cam]
    rng = np.random.default_rng(7)
    crops = tc.render_crops(rng.uniform(0, 10, (8, 4)).tolist())
    speck = rng.random(crops.shape[:3]) < 0.003
    crops[speck] = (40, 40, 200)
    jdec = JaxDecoder(jc.make_params(str(tmp_path)), exact=False)
    tdec = MeterDecoder(tc.make_params(), exact=False, device="cpu")
    for f in FAST_F32:
        assert getattr(tdec.param_arrays, f).dtype == torch.float32, f
    assert MeterDecoder(tc.make_params(), device="cpu"
                        ).param_arrays.ann_angle.dtype == torch.float64
    ref = jdec.decode_numpy(crops)
    got = tdec.decode_numpy(crops)
    for f in ("err", "first_bad_dial", "unreadable_bits", "match_x",
              "match_y", "readable", "converged"):
        assert np.array_equal(np.asarray(getattr(ref, f)), getattr(got, f)), f
    rd = got.readable
    np.testing.assert_array_equal(np.where(rd, got.dial_pos, 0),
                                  np.where(rd, np.asarray(ref.dial_pos), 0))
    ok = got.err == int(ErrCode.OK)
    np.testing.assert_array_equal(got.value[ok], np.asarray(ref.value)[ok])
    assert ok.sum() >= 6
