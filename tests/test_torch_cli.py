"""The two CLIs side by side: ``meterelf_tpu.cli.main`` (the JAX package
on the CPU) and ``meterelf_tpu_torch.cli.main`` (METERELF_DEVICE=cpu:
every kernel's plain version) on the same JPEG files and params.yml,
stdout equal byte for byte.

The files come from a seed, as tests/test_cli_fuzz.py builds them
(PIL-written quality-85 JPEGs, params.yml by yaml.safe_dump, the
template by the JAX package): frames of DEFAULT_CAMERA or ALT_CAMERA at
random offsets and positions, stubbed dials (DIAL_ANGLE), speckle, a
dial whose centre colour matches no pixel (synthetic.blind_dial:
NEEDLE_CONTOURS), a noise frame and an all-zero frame (DIALS_NOT_FOUND,
the latter the "match val = 0.0" string), garbage bytes and a missing
path (LOAD). One module-scoped fixture per camera runs each CLI once in
each mode: default, METERELF_EXACT=0, and DEBUG=1 on the files that read
without error (DEBUG re-raises on the others, checked one error kind at
a time with the same decoders)."""
import contextlib
import io
import os
import runpy
import subprocess
import sys
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import yaml
from PIL import Image

import meterelf_tpu.api as j_api
import meterelf_tpu_torch
from meterelf_tpu import cli as j_cli
from meterelf_tpu import debugging as j_debugging
from meterelf_tpu import synthetic as j_syn
from meterelf_tpu.pipeline.decode import MeterDecoder as JaxDecoder
from meterelf_tpu_torch import cli as t_cli
from meterelf_tpu_torch import debugging as t_debugging
from meterelf_tpu_torch import synthetic as t_syn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERAS = {"default": (j_syn.DEFAULT_CAMERA, t_syn.DEFAULT_CAMERA),
           "alt": (j_syn.ALT_CAMERA, t_syn.ALT_CAMERA)}
N_FRAMES = 10


def _frames(camera, n, seed):
    """(name, BGR frame) of n rendered frames, a blind dial, noise and
    zeros (tests/test_cli_fuzz.py's mix, plus the blind dial)."""
    rng = np.random.default_rng(seed)
    (x0, y0), (x1, y1) = camera.meter_rect
    max_ox = (x1 - x0) - camera.template_w - 1
    max_oy = (y1 - y0) - camera.template_h - 1
    out = []
    for i in range(n):
        pos = [float(p) for p in rng.uniform(0, 10, 4)]
        off = (int(rng.integers(5, max_ox)), int(rng.integers(5, max_oy)))
        stub = (1,) if i % 6 == 3 else ()
        f = camera.render_frame(pos, offset=off, stub_dials=stub)
        if i % 4 == 2:
            m = rng.random(f.shape[:2]) < 0.002
            f[m] = (40, 40, 200)
        out.append((f"f{i:02d}", f))
    off = (int(rng.integers(5, max_ox)), int(rng.integers(5, max_oy)))
    stubbed = camera.render_frame([2.0, 4.0, 6.0, 8.0], offset=off,
                                  stub_dials=(2,))
    out.append(("blind", t_syn.blind_dial(stubbed, camera, off, 2)))
    # dark noise: full-range noise can pass the flagship's match
    # threshold (it then reads as a meter, in both packages)
    out.append(("noise", rng.integers(0, 64, stubbed.shape, np.uint8)))
    out.append(("zeros", np.zeros_like(stubbed)))
    return out


def _capture(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def run(request, tmp_path_factory):
    jc, tc = CAMERAS[request.param]
    d = tmp_path_factory.mktemp(f"cli_{request.param}")
    jc.make_params(str(d))                 # the template PNG (PIL)
    yml = str(d / "params.yml")
    with open(yml, "w") as fp:
        yaml.safe_dump(jc.params_dict(str(d / "synthetic_template.png")), fp)
    r = SimpleNamespace(yml=yml, dir=d, files=[])   # files and outputs
    for name, frame in _frames(tc, N_FRAMES, seed=424242):
        p = str(d / f"{name}.jpg")
        Image.fromarray(frame[..., ::-1]).save(p, "JPEG", quality=85,
                                               subsampling=2)
        r.files.append(p)
    with open(d / "garbage.jpg", "wb") as fp:
        fp.write(np.random.default_rng(1).integers(
            0, 256, 4000, np.uint8).tobytes())
    r.files += [str(d / "garbage.jpg"), str(d / "missing.jpg")]

    # the JAX decoders are built once (a build compiles the graph)
    jdecs = {e: JaxDecoder(j_api.load_params(yml), exact=e)
             for e in (True, False)}
    r.patch_jax = mock.patch.object(
        j_api, "MeterDecoder", lambda params, exact=True: jdecs[exact])

    def both(files, env=(), debug=None):
        out = {}
        for pkg, main, dbg in (("jax", j_cli.main, j_debugging),
                               ("torch", t_cli.main, t_debugging)):
            dirs = {"METERELF_DEBUG_DIR": str(d / f"debug_{pkg}")}
            with mock.patch.dict(os.environ, {**dict(env), **dirs}), \
                    mock.patch.object(dbg, "DEBUG", debug or set()), \
                    r.patch_jax:
                out[pkg] = _capture(main, ["meterelf", yml] + files)
        return out

    with mock.patch.dict(os.environ, {"METERELF_DEVICE": "cpu"}):
        r.default = both(r.files)
        r.fast = both(r.files, {"METERELF_EXACT": "0"})
        lines = r.default["jax"].splitlines()
        r.ok_files = [f for f, line in zip(r.files, lines)
                      if "UNKNOWN" not in line]
        r.debug = both(r.ok_files, debug={"1"})
    return r


def test_cli_stdout_equal(run):
    assert run.default["torch"] == run.default["jax"]
    lines = run.default["jax"].splitlines()
    assert len(lines) == len(run.files)
    # every error kind is in the set, and most frames read
    by_name = {os.path.basename(f)[:-4]: line
               for f, line in zip(run.files, lines)}
    for name, msg in (
            ("missing", "Unable to load image"),
            ("garbage", "Unable to load image"),
            ("zeros", "Dials not found (match val = "),
            ("noise", "Dials not found (match val = "),
            ("blind", "Cannot find needle contours of a dial (dial = 0.01)"),
            ("f03", "Cannot determine angle of a dial (unreadable dials = ")):
        assert f"UNKNOWN {msg}" in by_name[name], (name, by_name[name])
    # OpenCV's rounding: 0.0 on the flagship, -0.0 on ALT (both packages)
    assert by_name["zeros"].endswith(("(match val = 0.0)",
                                      "(match val = -0.0)"))
    assert len(run.ok_files) >= N_FRAMES - 3


def test_cli_fast_mode_stdout_equal(run):
    assert run.fast["torch"] == run.fast["jax"]
    assert run.fast["jax"] == run.default["jax"]


def test_cli_debug_stdout_and_overlays_equal(run):
    """DEBUG=1: the per-dial dict suffix on every line, and the overlay
    PNGs of both packages pixel for pixel (decoded by PIL)."""
    assert run.debug["torch"] == run.debug["jax"]
    assert run.debug["jax"].count("{'0.0001': ") == len(run.ok_files)
    for f in run.ok_files:
        name = os.path.basename(f)[:-4] + "_debug.png"
        a, b = (Image.open(run.dir / f"debug_{p}" / name)
                for p in ("jax", "torch"))
        assert a.mode == b.mode == "RGB"
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


@pytest.mark.parametrize("name", ["missing", "zeros", "noise", "blind",
                                  "f03"])
def test_cli_debug_reraises_same_message(run, name):
    """DEBUG re-raises each error kind from both CLIs with the same
    class and get_message() (DIAL_ANGLE's carries the readable dials'
    positions under DEBUG), nothing printed."""
    f = next(p for p in run.files if os.path.basename(p)[:-4] == name)
    errors = {}
    for pkg, main, dbg in (("jax", j_cli.main, j_debugging),
                           ("torch", t_cli.main, t_debugging)):
        with mock.patch.dict(os.environ, {"METERELF_DEVICE": "cpu"}), \
                mock.patch.object(dbg, "DEBUG", {"1"}), run.patch_jax:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    pytest.raises(Exception) as e:
                main(["meterelf", run.yml, f])
            assert buf.getvalue() == ""
            errors[pkg] = e.value
    assert type(errors["jax"]).__name__ == type(errors["torch"]).__name__
    assert errors["jax"].get_message() == errors["torch"].get_message()


def test_cli_usage_error():
    for main in (j_cli.main, t_cli.main):
        with pytest.raises(SystemExit) as e:
            main(["meterelf"])
        assert str(e.value) == "Usage: meterelf PARAMETERS_FILE [IMAGE_FILE...]"
    assert t_cli.USAGE == j_cli.USAGE


def test_format_result_zero_prints_empty():
    from meterelf_tpu.api import MeterImageData as JData
    from meterelf_tpu_torch.api import MeterImageData as TData

    for debug in (False, True):
        for value in (0.0, 12.5):
            a = j_cli.format_result(JData("x.jpg", value, None, {}), debug)
            b = t_cli.format_result(TData("x.jpg", value, None, {}), debug)
            assert a == b
    assert t_cli.format_result(TData("x.jpg", 0.0, None, {})) == "x.jpg: "


def test_run_as_module():
    with mock.patch.object(t_cli, "main") as main_mock:
        sys.modules.pop("meterelf_tpu_torch.__main__", None)
        runpy.run_module(meterelf_tpu_torch.__name__, run_name="__main__")
        main_mock.assert_called_with()


def test_python_dash_m(run):
    """``python -m meterelf_tpu_torch`` in a subprocess: the usage error
    (exit 1), the same lines as in process on two files with
    METERELF_DEVICE=cpu, and without a card and without that request a
    non-zero exit with the decoder's message (no fallback)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEBUG", "METERELF_DEVICE")}
    env["PYTHONPATH"] = REPO
    cmd = [sys.executable, "-m", "meterelf_tpu_torch"]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1 and "Usage:" in r.stderr
    files = [run.files[0], run.files[-1]]
    r = subprocess.run(cmd + [run.yml] + files,
                       env={**env, "METERELF_DEVICE": "cpu"},
                       capture_output=True, text=True, timeout=120)
    lines = run.default["jax"].splitlines()
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines() == [lines[0], lines[-1]]
    import torch

    if not torch.cuda.is_available():
        r = subprocess.run(cmd + [run.yml] + files, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and r.stdout == ""
        assert "no CUDA device is available" in r.stderr
