"""The port's streaming runtime (meterelf_tpu_torch.stream, profiling and
debugviz.serve_overlays) against the JAX package's, side by side on the
CPU (METERELF_DEVICE=cpu: every kernel's plain version).

Frames are synthetic, from a seed: DEFAULT_CAMERA and ALT_CAMERA frames
whose value rises RISE_STEP litres a frame, with capture times in their
names, so that flow and the leak flag run on recorded time. Reports are
compared field by field, floats bit for bit, images_per_sec aside; the
CLIs' lines with ``rate=`` masked. One module-scoped fixture a camera
builds the JAX decoder once (a build compiles the graph)."""
import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from types import SimpleNamespace
from typing import Any, NamedTuple
from unittest import mock

import numpy as np
import pytest
import torch

from meterelf_tpu import stream as j_stream
from meterelf_tpu import synthetic as j_syn
from meterelf_tpu.params import Params as JParams
from meterelf_tpu.pipeline.decode import MeterDecoder as JaxDecoder
from meterelf_tpu_torch import debugviz as t_viz
from meterelf_tpu_torch import stream as t_stream
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.io import jpeg as t_jio
from meterelf_tpu_torch.ops.jpegdec import backhalf_ok, coef_window
from meterelf_tpu_torch.params import Params as TParams
from meterelf_tpu_torch.pipeline.decode import MeterDecoder as TorchDecoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERAS = {"default": (j_syn.DEFAULT_CAMERA, t_syn.DEFAULT_CAMERA),
           "alt": (j_syn.ALT_CAMERA, t_syn.ALT_CAMERA)}
FRAME_WH = (640, 480)
RISE_START, RISE_STEP = 417.2, 0.31
T0 = 1792238400            # 2026-10-18 00:00:00 UTC
CPU = {"METERELF_DEVICE": "cpu"}
RATE = re.compile(r"rate=\d+img/s")


def _rising(n):
    """Dial positions [n, 4] of a value rising RISE_STEP a frame."""
    v = RISE_START + RISE_STEP * np.arange(n)
    return np.stack([(v * 10) % 10, v % 10, (v / 10) % 10, (v / 100) % 10],
                    axis=1)


def _name(i):
    return time.strftime("%Y%m%d%H%M%S",
                         time.gmtime(T0 + 60 * i)) + f"-{i:02d}.jpg"


def _fields(reports):
    return [dataclasses.asdict(r) | {"images_per_sec": None}
            for r in reports]


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def cam(request, tmp_path_factory):
    """One camera: 32 rising frames (frame 11 all zeros: an error) as
    crops and as quality-92 JPEGs (the port's encoder), their names and
    stamps, params.yml of the port's writer (both packages read it), and
    the JAX decoder."""
    jc, tc = CAMERAS[request.param]
    d = tmp_path_factory.mktemp(f"stream_{request.param}")
    yml = tc.write_params(str(d))
    frames = tc.render_frames(_rising(32).tolist())
    frames[11] = np.zeros_like(frames[11])
    r = SimpleNamespace(name=request.param, tc=tc, yml=yml, dir=d)
    r.names = [_name(i) for i in range(len(frames))]
    r.ts = [float(T0 + 60 * i) for i in range(len(frames))]
    r.jpegs = [t_syn.encode_jpeg(f, 92) for f in frames]
    r.crops, ok = t_jio.load_crop_bytes_u8(r.jpegs, tc.meter_rect)
    assert ok.all()
    r.jparams = JParams.load(yml)
    r.tparams = TParams.load(yml)
    r.jdec = JaxDecoder(r.jparams, exact=True)
    r.tdec = TorchDecoder(r.tparams, device="cpu")
    return r


def _with_flushes(items):
    """Three full batches of 8, flush markers (one on an empty buffer,
    one that sends a partial batch of 5) and a partial batch at the end:
    8, 8, flush, 5, flush, 8, 3."""
    out = list(items[:16]) + [("<flush>", None)] + list(items[16:21])
    return out + [("<flush>", None)] + list(items[21:])


def test_stream_decode_equal(cam):
    """stream_decode on crops: every report field of the port equals the
    JAX stream's, and the leak flag trips on the rising frames."""
    frames = _with_flushes(list(zip(cam.names, cam.crops)))
    got = list(t_stream.stream_decode(cam.tparams, frames, decoder=cam.tdec,
                                      batch_size=8, timestamps=cam.ts))
    ref = list(j_stream.stream_decode(cam.jparams, frames, decoder=cam.jdec,
                                      batch_size=8, timestamps=cam.ts))
    assert _fields(got) == _fields(ref)
    assert len(got) == 5
    last = got[-1]
    assert last.frames_total == 32 and last.frames_error == 1
    assert last.leak_suspected and last.flow_lph == pytest.approx(
        RISE_STEP * 60, rel=0.05)


def test_stream_bytes_equal(cam):
    """stream_decode_bytes on the JPEG bytes, with a garbage frame and a
    4:4:4 frame (the coefficient reader rejects it: a fallback slot),
    equals stream_decode of the port and of the JAX package on the same
    bytes, and the JAX stream_decode_bytes."""
    jpegs = list(cam.jpegs)
    jpegs[5] = np.random.default_rng(5).integers(
        0, 256, 3000, np.uint8).tobytes()
    frame = cam.tc.render_frames(_rising(8)[7:8].tolist())[0]
    jpegs[7] = t_syn.encode_jpeg(frame, 92, subsampling="4:4:4")
    win = coef_window(cam.tc.meter_rect, *FRAME_WH)
    feed = t_jio.load_coef_feed(jpegs[:8], cam.tc.meter_rect, FRAME_WH,
                                cam.tdec.feed_pad_hw)
    # the garbage frame takes slot 0 and does not decode; the 4:4:4 frame
    # decodes into slot 1
    assert list(feed[6]) == [8, 7] + [8] * 6
    assert backhalf_ok(win, cam.tdec.feed_pad_hw)
    crops, ok = t_jio.load_crop_bytes_u8(jpegs, cam.tc.meter_rect)
    assert not ok[5] and ok[7]
    items = _with_flushes(list(zip(cam.names, jpegs)))
    got = list(t_stream.stream_decode_bytes(
        cam.tparams, items, FRAME_WH, decoder=cam.tdec, batch_size=8,
        timestamps=cam.ts))
    t_crops = list(t_stream.stream_decode(
        cam.tparams, _with_flushes(list(zip(cam.names, crops))),
        decoder=cam.tdec, batch_size=8, timestamps=cam.ts))
    j_bytes = list(j_stream.stream_decode_bytes(
        cam.jparams, items, FRAME_WH, decoder=cam.jdec, batch_size=8,
        timestamps=cam.ts))
    assert _fields(got) == _fields(j_bytes)
    # the crop stream reads the garbage frame's zero crop as "dials not
    # found" where the bytes stream has a load error: both are errors
    assert _fields(got) == _fields(t_crops)
    assert got[-1].frames_error == 2          # garbage and the zero frame


def _stub_result(b, converged=True):
    return _Res(err=np.zeros(b, np.int32), value=np.zeros(b),
                converged=np.full(b, converged))


class _Res(NamedTuple):
    err: Any
    value: Any
    converged: Any


class _Stub:
    """A decoder whose batch results are scripted: values rise 0.5 a
    frame; row 2 of the second batch does not converge, and rescue_numpy
    gives it the value 900.0 (a jump the stream must see)."""

    def __init__(self, rescue=True):
        self.calls = 0
        self.rescued = []
        if rescue:
            self.rescue_numpy = self._rescue

    def __call__(self, crops):
        b = crops.shape[0]
        res = _stub_result(b)
        res.value[:] = 100.0 + 0.5 * (self.calls * b + np.arange(b))
        if self.calls == 1:
            res.converged[2] = False
        self.calls += 1
        return res

    def _rescue(self, crops, res):
        self.rescued.append(np.asarray(res.converged).copy())
        value = np.asarray(res.value).copy()
        value[~np.asarray(res.converged)] = 900.0
        return res._replace(value=value, converged=np.ones_like(
            res.converged))


def _dummy(n):
    return [(f"f{i:03d}", np.zeros((2, 2, 3), np.uint8)) for i in range(n)]


def test_stream_rescue_equal():
    """A non-converged row is rescued through rescue_numpy and its
    reading emitted, in both packages alike; without rescue_numpy the
    stream raises."""
    out = {}
    for pkg, mod in (("jax", j_stream), ("torch", t_stream)):
        stub = _Stub()
        out[pkg] = (list(mod.stream_decode(
            None, _dummy(12), decoder=stub, batch_size=4,
            timestamps=np.arange(0.0, 1200.0, 60.0))), stub.rescued)
    assert _fields(out["torch"][0]) == _fields(out["jax"][0])
    for rescued in (out["torch"][1], out["jax"][1]):
        assert len(rescued) == 1 and not rescued[0][2]
    assert out["torch"][0][1].last_value == 101.5 + 2.0   # after row 2
    for mod in (j_stream, t_stream):
        with pytest.raises(RuntimeError, match="rescue"):
            list(mod.stream_decode(None, _dummy(8), decoder=_Stub(False),
                                   batch_size=4))


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_state_resumes_across_packages(first, second, tmp_path):
    """A checkpoint written by one package resumes in the other, and the
    resumed run ends on the uninterrupted run's report; both write the
    same JSON."""
    mods = {"jax": j_stream, "torch": t_stream}

    class Scripted:
        def __init__(self, start):
            self.i = start

        def __call__(self, crops):
            b = crops.shape[0]
            v = 998.0 + 0.7 * (self.i + np.arange(b))   # rolls over 1000
            self.i += b
            return _Res(np.zeros(b, np.int32), v % 1000.0, np.ones(b, bool))

    ts = np.arange(0.0, 60.0 * 24, 60.0)
    kw = dict(batch_size=4, window_seconds=600.0)
    whole = list(t_stream.stream_decode(None, _dummy(24), decoder=Scripted(0),
                                        timestamps=ts, **kw))
    path = str(tmp_path / "state.json")
    st = mods[first].load_state(path)
    list(mods[first].stream_decode(None, _dummy(12), decoder=Scripted(0),
                                   timestamps=ts[:12], state=st, **kw))
    mods[first].save_state(st, path)
    st2 = mods[second].load_state(path)
    assert dataclasses.asdict(st2) == dataclasses.asdict(st)
    rest = list(mods[second].stream_decode(
        None, _dummy(12), decoder=Scripted(12), timestamps=ts[12:],
        state=st2, **kw))
    a, b = dataclasses.asdict(rest[-1]), dataclasses.asdict(whole[-1])
    a["images_per_sec"] = b["images_per_sec"] = None
    assert a == b and b["cumulative_liters"] > 0
    other = str(tmp_path / "other.json")
    mods[second].save_state(st, other)
    with open(path) as f1, open(other) as f2:
        assert f1.read() == f2.read()
    assert t_stream.load_state(str(tmp_path / "missing.json")) \
        == t_stream._StreamState()


@pytest.mark.parametrize("as_bytes", [True, False])
def test_watch_files_equal(as_bytes, tmp_path):
    """watch_files in both packages on the same spool: a file written
    without its EOI (bytes mode) or cut short (pixel mode) is retried,
    the finished file is emitted whole; a file never finished is given
    up after max_retries polls as one error frame; idle_exit ends the
    watch. Both packages yield the same sequence."""
    tc = t_syn.DEFAULT_CAMERA
    params = {"jax": j_syn.DEFAULT_CAMERA.make_params(str(tmp_path / "jp")),
              "torch": tc.make_params()}
    data = t_syn.encode_jpeg(tc.render_frames([[1.0, 2.0, 3.0, 4.0]])[0], 92)
    seqs = {}
    for pkg, mod in (("jax", j_stream), ("torch", t_stream)):
        spool = tmp_path / pkg
        spool.mkdir()
        part = spool / "a.jpg"
        # mid-write: no EOI yet (bytes), or not even the headers (pixels:
        # a frame cut inside its scan still decodes, as in libjpeg)
        part.write_bytes(data[:len(data) // 2] if as_bytes else data[:100])
        gen = mod.watch_files(params[pkg], str(spool), poll_seconds=0.01,
                              as_bytes=as_bytes, max_retries=3, idle_exit=6)
        seq = [next(gen)]
        part.write_bytes(data)                 # the writer finishes
        seq.append(next(gen))
        (spool / "b.jpg").write_bytes(data[:100])   # never finished
        seq += list(gen)
        seqs[pkg] = seq
    for seq in seqs.values():
        kinds = [(os.path.basename(n), None if x is None else
                  (bytes(x) if as_bytes else x.shape)) for n, x in seq]
        assert kinds[0] == ("<flush>", None)
        assert kinds[1][0] == "a.jpg"
        if as_bytes:
            assert kinds[1][1] == data
        gave_up = [k for k in kinds if k[0] == "b.jpg"]
        assert len(gave_up) == 1
        assert gave_up[0][1] == (b"" if as_bytes else (250, 250, 3))
        assert kinds[-1] == ("<flush>", None)   # then idle_exit ends it
    ja, tb = seqs["jax"], seqs["torch"]
    assert len(ja) == len(tb)
    for (na, xa), (nb, xb) in zip(ja, tb):
        assert os.path.basename(na) == os.path.basename(nb)
        assert (xa is None) == (xb is None)
        if xa is not None:
            assert np.array_equal(np.frombuffer(xa, np.uint8) if as_bytes
                                  else xa,
                                  np.frombuffer(xb, np.uint8) if as_bytes
                                  else xb)


def test_feed_worker_pool_equal():
    """FeedWorkerPool(2).load equals load_coef_feed bit for bit, with
    rejected (4:4:4) frames in both shards and more of them than slots:
    the first fb_slots in batch order take the slots, the rest load
    as errors."""
    tc = t_syn.DEFAULT_CAMERA
    rect = tc.meter_rect
    pos = _rising(10)
    frames = tc.render_frames(pos.tolist())
    datas = [t_syn.encode_jpeg(f, 92, subsampling="4:4:4" if i in (1, 3, 6, 8)
                               else "4:2:0") for i, f in enumerate(frames)]
    pad_hw = (rect.height, rect.width)
    win = coef_window(rect, *FRAME_WH)
    plane = backhalf_ok(win, pad_hw)
    for compact in (True, False):
        ref = t_jio.load_coef_feed(datas, rect, FRAME_WH, pad_hw, fb_slots=3,
                                   compact=compact)
        pool = t_stream.FeedWorkerPool(2, rect, FRAME_WH, pad_hw, tuple(win),
                                       plane, fb_slots=3, compact=compact)
        try:
            got = pool.load(datas)
        finally:
            pool.close()
        for i, (a, b) in enumerate(zip(got, ref)):
            assert a.dtype == b.dtype, i
            np.testing.assert_array_equal(a, b, err_msg=f"field {i}")
        assert list(ref[6]) == [1, 3, 6] and not ref[4][8]
        assert ref[0].dtype == (np.int8 if compact else np.int16)


def _main_lines(main, argv, env=None):
    out, err = io.StringIO(), io.StringIO()
    with mock.patch.dict(os.environ, env or {}), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return RATE.sub("rate=*", out.getvalue()).splitlines(), err.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The flagship's rising JPEG files with capture-time names, and a
    patch that hands the JAX CLI a decoder built once."""
    d = tmp_path_factory.mktemp("stream_cli")
    tc = t_syn.DEFAULT_CAMERA
    yml = tc.write_params(str(d))
    frames = tc.render_frames(_rising(12).tolist())
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(d / _name(i)))
        with open(paths[-1], "wb") as fp:
            fp.write(t_syn.encode_jpeg(f, 92))
    jdec = JaxDecoder(JParams.load(yml), exact=True)
    patch = mock.patch.object(j_stream, "MeterDecoder",
                              lambda params, exact=True: jdec)
    return SimpleNamespace(dir=d, yml=yml, paths=paths, patch=patch)


@pytest.mark.parametrize("coef", [True, False])
def test_main_lines_equal(files, coef, tmp_path):
    """`--repeat 2 --batch 8 --state F` (and `--coef 640x480`): the
    report lines of both CLIs are equal with rate= masked, and so are
    their checkpoints; a second run resumes from its checkpoint."""
    states = {}
    lines = {}
    for pkg, main in (("jax", j_stream.main), ("torch", t_stream.main)):
        states[pkg] = str(tmp_path / f"{pkg}.json")
        argv = [files.yml, *files.paths, "--repeat", "2", "--batch", "8",
                "--state", states[pkg]]
        if coef:
            argv += ["--coef", "640x480"]
        with files.patch:
            lines[pkg] = [_main_lines(main, argv, CPU)[0] for _ in range(2)]
    assert lines["torch"] == lines["jax"]
    first, second = lines["torch"]
    assert len(first) == 3 and first[-1].startswith("frames=24 ok=24 err=0 ")
    assert second[-1].startswith("frames=48 ")
    assert "leak=YES" in first[-1]
    with open(states["jax"]) as a, open(states["torch"]) as b:
        assert a.read() == b.read()


def test_main_usage_and_mesh(files):
    """A usage error exits 1 with the JAX package's usage line (the
    module name aside); `--mesh 2 --repeat 2 --batch 8` over 10 files
    prints, with rate= masked, the JAX CLI's lines on two of its virtual
    CPU devices (the port's: two replicas of the CPU device), the
    ` mesh[ok= err= mean=]` suffix on the two full batches and not on
    the padded third."""
    errs = {}
    for pkg, main in (("jax", j_stream.main), ("torch", t_stream.main)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                pytest.raises(SystemExit) as e:
            main([files.yml])
        assert e.value.code == 1
        errs[pkg] = err.getvalue()
    assert errs["torch"].replace("meterelf_tpu_torch", "meterelf_tpu") \
        == errs["jax"]
    lines = {}
    for pkg, main in (("jax", j_stream.main), ("torch", t_stream.main)):
        with files.patch:
            lines[pkg] = _main_lines(main, [
                files.yml, *files.paths[:10], "--repeat", "2", "--batch",
                "8", "--mesh", "2"], CPU)[0]
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 3
    assert all(" mesh[ok=8 err=0 mean=" in x for x in lines["torch"][:2])
    assert "mesh[" not in lines["torch"][2]


_MESH_REFS: dict = {}


@pytest.mark.parametrize("kind", ["crops", "bytes", "bytes_workers"])
def test_stream_mesh_equal(cam, kind):
    """stream_decode(mesh=) and stream_decode_bytes(mesh=) (also with
    feed_workers=2) on two CPU replicas: every report equals the
    single-device stream's but for device_agg, which full batches alone
    carry (batches 8, 8, 5, 8, 3: the first, second and fourth), and
    every report equals the JAX stream's on two virtual CPU devices,
    device_agg included (the JAX feed-worker mesh stream equals its
    in-process one: tests/test_stream.py)."""
    from meterelf_tpu.parallel import mesh as j_mesh
    from meterelf_tpu_torch.parallel import mesh as t_mesh

    import jax

    tmesh = t_mesh.make_mesh(["cpu"] * 2)
    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:2])
    if kind == "crops":
        frames = _with_flushes(list(zip(cam.names, cam.crops)))

        def run(mod, params, dec, **kw):
            return list(mod.stream_decode(params, frames, decoder=dec,
                                          batch_size=8, timestamps=cam.ts,
                                          **kw))
    else:
        items = _with_flushes(list(zip(cam.names, cam.jpegs)))

        def run(mod, params, dec, **kw):
            return list(mod.stream_decode_bytes(
                params, items, FRAME_WH, decoder=dec, batch_size=8,
                timestamps=cam.ts, **kw))
    workers = {"feed_workers": 2} if kind == "bytes_workers" else {}
    got = run(t_stream, cam.tparams, cam.tdec, mesh=tmesh, **workers)
    key = (cam.name, kind == "crops")   # the references a feed shares
    if key not in _MESH_REFS:
        _MESH_REFS[key] = (run(t_stream, cam.tparams, cam.tdec),
                           run(j_stream, cam.jparams, cam.jdec, mesh=jmesh))
    single, ref = _MESH_REFS[key]
    assert _fields(got) == _fields(ref)
    assert [f | {"device_agg": None} for f in _fields(got)] \
        == _fields(single)
    assert [i for i, r in enumerate(got) if r.device_agg is not None] \
        == [0, 1, 3]
    n_ok, n_err, mean = got[0].device_agg
    assert (n_ok, n_err) == (8, 0) and got[1].device_agg[:2] == (7, 1)


def test_main_profile_and_trace(files, tmp_path):
    """METERELF_PROFILE=1 sends the stage timers to stderr in both CLIs;
    --trace DIR writes the port's torch.profiler trace (Chrome JSON)."""
    err = {}
    for pkg, main in (("jax", j_stream.main), ("torch", t_stream.main)):
        with files.patch:
            lines, err[pkg] = _main_lines(
                main, [files.yml, *files.paths[:4], "--batch", "8"],
                {**CPU, "METERELF_PROFILE": "1"})
        assert lines and lines[-1].startswith("frames=4 ")
    for text in err.values():
        assert re.search(r"^dispatch .* ms/call  x1$", text, re.M)
        assert re.search(r"^drain .* ms/call  x1$", text, re.M)
    trace = tmp_path / "trace"
    lines, _ = _main_lines(t_stream.main, [
        files.yml, *files.paths[:2], "--batch", "8", "--trace", str(trace)],
        CPU)
    assert lines[-1].startswith("frames=2 ")
    made = os.listdir(trace)
    assert len(made) == 1 and made[0].endswith(".json")
    with open(trace / made[0]) as fp:
        assert '"traceEvents"' in fp.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serve_overlays(files, tmp_path):
    """serve_overlays on port 0: 404 before the first frame; the page
    escapes the name; /frame.png is render_overlay's PNG of the newest
    file, rendered once however often it is asked for; a new file is
    rendered anew."""
    params = TParams.load(files.yml)
    weird = tmp_path / "a<b>&c.jpg"
    weird.write_bytes(open(files.paths[3], "rb").read())
    latest = {"fn": None}
    calls = []
    real = t_viz.render_overlay

    def counting(fn, *a, **kw):
        calls.append(os.path.basename(fn))
        return real(fn, *a, **kw)

    with mock.patch.object(t_viz, "render_overlay", counting):
        srv = t_viz.serve_overlays(params, lambda: latest["fn"], 0)
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            assert srv.server_address[0] == "127.0.0.1"
            assert _get(base + "/frame.png")[0] == 404
            code, page = _get(base + "/")
            assert code == 200 and b"(no frame yet)" in page
            latest["fn"] = str(weird)
            code, page = _get(base + "/")
            assert code == 200 and b"a&lt;b&gt;&amp;c.jpg" in page
            assert b"a<b>" not in page
            pngs = [_get(base + "/frame.png?t=1"), _get(base + "/frame.png")]
            assert calls == ["a<b>&c.jpg"]
            want = open(real(str(weird), params, str(tmp_path / "o")),
                        "rb").read()
            assert pngs == [(200, want), (200, want)]
            latest["fn"] = files.paths[5]
            code, png = _get(base + "/frame.png")
            assert code == 200 and png != want and png[:4] == b"\x89PNG"
            assert calls == ["a<b>&c.jpg", os.path.basename(files.paths[5])]
        finally:
            srv.shutdown()
            srv.server_close()


def test_debug_http_flag(files):
    """--debug-http 0 serves the viewer while the stream runs and says
    where on stderr; the port shuts it down when the stream ends."""
    seen = {}
    real = t_viz.serve_overlays

    def spy(*a, **kw):
        seen["srv"] = real(*a, **kw)
        return seen["srv"]

    with mock.patch.object(t_viz, "serve_overlays", spy):
        lines, err = _main_lines(t_stream.main, [
            files.yml, *files.paths[:2], "--batch", "8", "--debug-http",
            "0"], CPU)
    port = seen["srv"].server_address[1]
    assert f"debug viewer: http://localhost:{port}/" in err
    assert lines[-1].startswith("frames=2 ")
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5)


def test_port_imports_no_jax():
    """The stream, calibration and profiling modules import neither jax
    nor the JAX package, in a process where importing either fails."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['meterelf_tpu'] = None\n"
            "import meterelf_tpu_torch.stream, meterelf_tpu_torch.calibration\n"
            "import meterelf_tpu_torch.profiling, meterelf_tpu_torch.debugviz\n"
            "bad = [m for m, v in sys.modules.items() if v is not None\n"
            "       and m.split('.')[0] in ('jax', 'meterelf_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0 and r.stdout == "ok\n", r.stderr


def test_no_card_raises():
    """Without a card and without METERELF_DEVICE=cpu the stream raises
    (the decoder is never built on the CPU unasked)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    params = t_syn.DEFAULT_CAMERA.make_params()
    with mock.patch.dict(os.environ, {"METERELF_DEVICE": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_stream.stream_decode(params, [])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_stream.stream_decode_bytes(params, [], FRAME_WH)


@pytest.mark.cuda
def test_stream_dispatch_does_not_wait_on_card():
    """On the card: warm dispatches of the crop decode and of the
    coefficient step (with and without fallback slots) raise nothing
    under set_sync_debug_mode("error")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tc = t_syn.DEFAULT_CAMERA
    dec = TorchDecoder(tc.make_params(), device="cuda")
    frames = tc.render_frames(_rising(8).tolist())
    datas = [t_syn.encode_jpeg(f, 92) for f in frames]
    datas[3] = t_syn.encode_jpeg(frames[3], 92, subsampling="4:4:4")
    from meterelf_tpu_torch.pipeline.decode import make_coef_decode_fn

    step, _win, pad_hw = make_coef_decode_fn(dec, FRAME_WH)
    crops, _ = t_jio.load_crop_bytes_u8(datas, tc.meter_rect)
    feeds = [t_jio.load_coef_feed(d, tc.meter_rect, FRAME_WH, pad_hw)
             for d in (datas[:3] + datas[4:], datas)]
    for fn in [lambda: dec(crops)] + [lambda f=f: step(None, *f)
                                      for f in feeds]:
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
