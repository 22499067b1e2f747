"""The PyTorch port's numpy host copies (params, synthetic, errors,
types, colors) against the JAX package's originals, and the port's
import boundary (no jax, no yaml/PIL at import time)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from meterelf_tpu import colors as j_colors
from meterelf_tpu import errors as j_errors
from meterelf_tpu import params as j_params
from meterelf_tpu import synthetic as j_syn
from meterelf_tpu import types as j_types
from meterelf_tpu_torch import colors as t_colors
from meterelf_tpu_torch import errors as t_errors
from meterelf_tpu_torch import params as t_params
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch import types as t_types

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERAS = {
    "default": (j_syn.DEFAULT_CAMERA, t_syn.DEFAULT_CAMERA),
    "alt": (j_syn.ALT_CAMERA, t_syn.ALT_CAMERA),
}


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_build_param_arrays_equal(cam, tmp_path):
    """Field by field, bit for bit (dtype, shape and bytes)."""
    jc, tc = CAMERAS[cam]
    ja = j_params.build_param_arrays(jc.make_params(str(tmp_path)))
    ta = t_params.build_param_arrays(tc.make_params())
    assert ja._fields == ta._fields
    for f in ja._fields:
        assert _same_array(getattr(ja, f), getattr(ta, f)), f


def test_params_load_reads_yaml_and_png(tmp_path):
    """Params.load (lazy yaml + PIL) builds the same arrays as the JAX
    package's loader from the same files."""
    import yaml

    jp = j_syn.DEFAULT_CAMERA.make_params(str(tmp_path))
    path = tmp_path / "params.yml"
    path.write_text(yaml.safe_dump(
        j_syn.DEFAULT_CAMERA.params_dict(jp.dials_file)))
    ja = j_params.load(str(path)).arrays()
    ta = t_params.load(str(path)).arrays()
    for f in ja._fields:
        assert _same_array(getattr(ja, f), getattr(ta, f)), f


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_render_crops_equal(cam):
    jc, tc = CAMERAS[cam]
    pos = [[1.0, 3.5, 7.2, 9.9], [0.0, 2.2, 5.5, 8.8],
           [9.95, 0.05, 4.44, 6.56], [5.0, 5.0, 5.0, 5.0]]
    assert _same_array(jc.render_crops(pos), tc.render_crops(pos))
    stub = dict(offset=(11, 17), stub_dials=(1, 3))
    assert _same_array(jc.render_frame(pos[0], **stub),
                       tc.render_frame(pos[0], **stub))
    assert jc.params_dict("t.png") == tc.params_dict("t.png")


def test_errcodes_and_messages_equal():
    assert ({e.name: int(e) for e in j_errors.ErrCode}
            == {e.name: int(e) for e in t_errors.ErrCode})
    for code in j_errors.ErrCode:
        if code == j_errors.ErrCode.OK:
            continue
        j_err = j_errors.error_class_for(code)("f.jpg", extra_info={"a": 1})
        t_err = t_errors.error_class_for(code)("f.jpg", extra_info={"a": 1})
        assert type(j_err).__name__ == type(t_err).__name__
        assert str(j_err) == str(t_err)


def test_host_types_equal():
    rect = ((50, 160), (300, 410))
    assert j_types.Rect(*rect).width == t_types.Rect(*rect).width == 250
    assert j_types.Rect(*rect).height == t_types.Rect(*rect).height
    jc = j_colors.HlsColor(125, 80, 130)
    tc = t_colors.HlsColor(125, 80, 130)
    rng = j_colors.HlsColor(9, 45, 135)
    assert jc.get_range(rng) == tc.get_range(t_colors.HlsColor(*rng))
    with pytest.raises(ValueError):
        t_colors.HlsColor(256, 0, 0).validate()


_TORCH_DTYPES = {
    np.dtype(np.float64): torch.float64, np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_to_device_carries_jax_param_arrays(cam, tmp_path):
    """to_device takes the JAX package's ParamArrays as they are and gives
    the same tensors as the port's own build_param_arrays: dtypes kept,
    static geometry as Python ints."""
    jc, tc = CAMERAS[cam]
    j_host = jc.make_params(str(tmp_path)).arrays()
    from_jax = t_params.to_device(j_host, "cpu")
    own = t_params.to_device(tc.make_params().arrays(), "cpu")
    for f in t_params.DeviceParams._fields:
        a, b = getattr(from_jax, f), getattr(own, f)
        if f in ("win_origin", "centers_int", "value_perm"):
            flat = [v for item in a
                    for v in (item if isinstance(item, tuple) else (item,))]
            assert a == b and isinstance(a, tuple)
            assert all(type(v) is int for v in flat)
            assert np.array_equal(np.asarray(a), np.asarray(getattr(j_host, f)))
            continue
        assert a.dtype == b.dtype == _TORCH_DTYPES[
            np.asarray(getattr(j_host, f)).dtype], f
        assert torch.equal(a, b), f
        assert a.numpy().tobytes() == np.asarray(
            getattr(j_host, f)).tobytes(), f


def test_port_imports_without_jax():
    """Importing every port module pulls in neither jax nor the JAX
    package, and no yaml or PIL (those load only with a params file)."""
    mods = ["meterelf_tpu_torch", "meterelf_tpu_torch.params",
            "meterelf_tpu_torch.synthetic", "meterelf_tpu_torch._build",
            "meterelf_tpu_torch.ops.frontend", "meterelf_tpu_torch.ops.windows",
            "meterelf_tpu_torch.ops.ccl", "meterelf_tpu_torch.ops.stats",
            "meterelf_tpu_torch.ops.angles", "meterelf_tpu_torch.ops.match",
            "meterelf_tpu_torch.ops.components",
            "meterelf_tpu_torch.ops.jpegdec", "meterelf_tpu_torch.ops.jpeg_tail",
            "meterelf_tpu_torch.io.jpeg",
            "meterelf_tpu_torch.pipeline.decode"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'meterelf_tpu', 'yaml', 'PIL')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "clean", (
        r.stdout + r.stderr[-2000:])
