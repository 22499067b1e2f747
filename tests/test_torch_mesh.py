"""The port's data parallelism (meterelf_tpu_torch.parallel.mesh) against
the JAX package's (meterelf_tpu.parallel.mesh), side by side on the CPU.

The JAX mesh runs on the first k of the conftest's 8 virtual CPU
devices, the port's on k replicas of the torch CPU device
(``make_mesh(["cpu"] * k)``), for k = 1, 2, 4 and 8. Crops are
synthetic, from a seed: DEFAULT_CAMERA and ALT_CAMERA frames at random
positions and tests/fuzz_frames.py's adversarial frames, one row not
loaded. Every BatchResult field is compared bit for bit (floats by
their bit patterns) with the port's own single decoder; with the JAX
package, every field but match_val likewise, and match_val within
tests/fuzz_frames.py's rtol 1e-4 (MATCH_RTOL): the JAX mesh scores with
its CPU matmul formulation (data_parallel_decoder picks it on the CPU),
the port with the exact score its kernels compute, as every other
decode test of the port states. n_ok and n_err are exact, and the mean
bit for bit: each shard sums in XLA's CPU order (ops/angles.tree_sum)
and the shard sums are added in device order, as the JAX package's
shard_map psum adds them on the CPU.
"""
import os
import subprocess
import sys
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from fuzz_frames import fuzz_frames

from meterelf_tpu import stream as j_stream
from meterelf_tpu.params import Params as JParams
from meterelf_tpu.parallel import mesh as j_mesh
from meterelf_tpu.pipeline.decode import MeterDecoder as JaxDecoder
from meterelf_tpu.pipeline.decode import make_coef_decode_fn as jax_coef_fn
from meterelf_tpu_torch import stream as t_stream
from meterelf_tpu_torch import synthetic as t_syn
from meterelf_tpu_torch.io import jpeg as t_jio
from meterelf_tpu_torch.parallel import mesh as t_mesh
from meterelf_tpu_torch.params import Params as TParams
from meterelf_tpu_torch.pipeline.decode import MeterDecoder as TorchDecoder

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERAS = {"default": t_syn.DEFAULT_CAMERA, "alt": t_syn.ALT_CAMERA}
MESH_SIZES = (1, 2, 4, 8)
B = 16
FRAME_WH = (640, 480)
NOT_LOADED = 5
MATCH_RTOL = 1e-4


def _j_mesh(k):
    return j_mesh.make_mesh(jax.devices("cpu")[:k])


def _t_mesh(k):
    return t_mesh.make_mesh(["cpu"] * k)


def _host(res):
    return type(res)(*[np.asarray(v) for v in res])


def assert_bits_equal(a, b, label, jax_ref=False):
    """Every field of two BatchResults equal, floats bit for bit (the
    JAX package's unreadable_bits is int64 under x64, the port's int32:
    integers compare by value); against a JAX result (``jax_ref``),
    match_val within MATCH_RTOL."""
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if jax_ref and f == "match_val":
            np.testing.assert_allclose(x, y, rtol=MATCH_RTOL,
                                       err_msg=f"{label}: {f}")
            continue
        assert x.dtype.kind == y.dtype.kind and x.shape == y.shape, \
            f"{label}: {f}"
        if x.dtype.kind == "f":
            assert x.dtype == y.dtype, f"{label}: {f}"
            x, y = x.view(f"u{x.itemsize}"), y.view(f"u{y.itemsize}")
        np.testing.assert_array_equal(x, y, err_msg=f"{label}: {f}")


def assert_agg_equal(t_agg, j_agg, label):
    n_ok, n_err, mean = (np.asarray(v) for v in j_agg)
    assert (int(t_agg.n_ok), int(t_agg.n_err)) == (int(n_ok), int(n_err)), \
        label
    assert float(t_agg.mean).hex() == float(mean).hex(), \
        f"{label}: mean {float(t_agg.mean)!r} != {float(mean)!r}"


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def cam(request, tmp_path_factory):
    """One camera: B crops (half at random positions, half fuzz frames),
    load flags with row NOT_LOADED off, params.yml of the port's writer,
    and both packages' decoders."""
    tc = CAMERAS[request.param]
    d = tmp_path_factory.mktemp(f"mesh_{request.param}")
    yml = tc.write_params(str(d))
    rng = np.random.default_rng(len(request.param) * 31 + 3)
    (x0, y0), (x1, y1) = tc.meter_rect
    frames = tc.render_frames(rng.uniform(0, 10, (B // 2, 4)).tolist())
    frames += fuzz_frames(tc, B // 2, seed=len(request.param) * 7 + 1)
    r = SimpleNamespace(name=request.param, tc=tc, yml=yml, frames=frames)
    r.crops = np.ascontiguousarray(np.stack([f[y0:y1, x0:x1]
                                             for f in frames]))
    r.ok = np.ones(B, bool)
    r.ok[NOT_LOADED] = False
    r.jdec = JaxDecoder(JParams.load(yml), exact=True)
    r.tdec = TorchDecoder(TParams.load(yml), device="cpu")
    return r


@pytest.mark.parametrize("k", MESH_SIZES)
def test_mesh_decoder_equal_jax(cam, k):
    """data_parallel_decoder and MeshDecoder on k replicas: every field
    of the JAX data_parallel_decoder's result on k devices, bit for bit
    (match_val within MATCH_RTOL), and of the port's single decoder, bit
    for bit; aggregate equal to JAX's aggregate_metrics, bit for bit, and
    to a numpy reduction."""
    jmesh, tmesh = _j_mesh(k), _t_mesh(k)
    jres = j_mesh.data_parallel_decoder(cam.jdec, jmesh)(cam.crops, cam.ok)
    run = t_mesh.data_parallel_decoder(cam.tdec, tmesh)
    tres = run(cam.crops, cam.ok)
    assert_bits_equal(_host(tres), _host(jres), f"{cam.name} k={k}", True)
    assert_bits_equal(_host(tres), cam.tdec.decode_numpy(cam.crops, cam.ok),
                      f"{cam.name} k={k} vs one decoder")
    md = t_mesh.MeshDecoder(cam.tdec, tmesh)
    mres = md(cam.crops, cam.ok)
    assert_bits_equal(_host(mres), _host(tres), f"{cam.name} MeshDecoder")
    j_agg = j_mesh.aggregate_metrics(jres.value, jres.err, jmesh)
    assert_agg_equal(md.aggregate(mres), j_agg, f"{cam.name} k={k}")
    # the per-device path and the split of a gathered result agree
    assert_agg_equal(t_mesh.aggregate_metrics(mres.value, mres.err, tmesh),
                     j_agg, f"{cam.name} k={k} split")
    err, val = np.asarray(jres.err), np.asarray(jres.value)
    ok = err == 0
    assert int(md.aggregate(mres).n_ok) == int(ok.sum())
    assert float(md.aggregate(mres).mean) == pytest.approx(val[ok].mean())
    assert not ok[NOT_LOADED]


@pytest.mark.parametrize("k", MESH_SIZES)
def test_aggregate_metrics_equal_jax(k):
    """aggregate_metrics on values of spread magnitudes (shards of 1 to
    64 rows: one run of tree_sum and several) and on an all-error batch
    (mean 0.0, a guarded divide) equals the JAX package's, bit for bit."""
    rng = np.random.default_rng(k)
    jmesh, tmesh = _j_mesh(k), _t_mesh(k)
    # compiled once a shape (an eager shard_map compiles at every call)
    j_agg = jax.jit(lambda v, e: j_mesh.aggregate_metrics(v, e, jmesh))
    for n in (k, 8 * k, 64 * k):
        for _ in range(4):
            vals = rng.uniform(0, 1000, n) * np.exp(rng.uniform(-20, 20, n))
            errs = (rng.random(n) < 0.2).astype(np.int32) * 3
            assert_agg_equal(t_mesh.aggregate_metrics(vals, errs, tmesh),
                             j_agg(vals, errs), f"k={k} n={n}")
    vals = np.arange(8 * k, dtype=np.float64)
    all_err = np.full(8 * k, 3, np.int32)
    got = t_mesh.aggregate_metrics(vals, all_err, tmesh)
    assert_agg_equal(got, j_agg(vals, all_err), "all errors")
    assert (int(got.n_ok), int(got.n_err), float(got.mean)) == (0, 8 * k, 0.0)


def test_shard_host_batch_row_order(cam):
    """shard_host_batch on 4 replicas: device d holds rows [4d, 4d + 4),
    as the JAX array's shards on 4 devices do; the global shape is the
    batch's; the sharded batch decodes as the numpy one does."""
    tmesh, jmesh = _t_mesh(4), _j_mesh(4)
    arr = t_mesh.shard_host_batch(cam.crops, tmesh)
    jarr = j_mesh.shard_host_batch(cam.crops, jmesh)
    assert arr.shape == jarr.shape == cam.crops.shape
    jshards = sorted(jarr.addressable_shards,
                     key=lambda s: s.index[0].start or 0)
    assert len(arr.shards) == len(jshards) == 4
    for d, (s, js) in enumerate(zip(arr.shards, jshards)):
        np.testing.assert_array_equal(s.numpy(), cam.crops[4 * d:4 * d + 4])
        np.testing.assert_array_equal(s.numpy(), np.asarray(js.data))
    run = t_mesh.data_parallel_decoder(cam.tdec, tmesh)
    ok = t_mesh.shard_host_batch(cam.ok, tmesh)
    assert_bits_equal(_host(run(arr, ok)), _host(run(cam.crops, cam.ok)),
                      "sharded vs numpy feed")


@pytest.fixture(scope="module")
def coef(tmp_path_factory):
    """The flagship's B frames as quality-92 JPEGs through the port's
    coefficient feed (the JAX step reads the same arrays), fallback
    payload rows from other frames, and both packages' steps."""
    tc = t_syn.DEFAULT_CAMERA
    yml = tc.write_params(str(tmp_path_factory.mktemp("mesh_coef")))
    frames = tc.render_frames(
        np.random.default_rng(9).uniform(0, 10, (B // 2, 4)).tolist())
    frames += fuzz_frames(tc, B // 2, seed=41)
    datas = [t_syn.encode_jpeg(f, 92) for f in frames]
    tdec = TorchDecoder(TParams.load(yml), device="cpu")
    jdec = JaxDecoder(JParams.load(yml), exact=True)
    jstep, _win, jpad = jax_coef_fn(jdec, FRAME_WH)
    assert tuple(jpad) == tdec.feed_pad_hw
    feed = t_jio.load_coef_feed(datas, tc.meter_rect, FRAME_WH,
                                tdec.feed_pad_hw)
    assert feed[4].all()
    # 8 slots of other frames' pixel-path crops
    other = fuzz_frames(tc, 8, seed=43)
    fb_packed, ok = t_jio.load_packed_crops_from_bytes(
        [t_syn.encode_jpeg(f, 92) for f in other], tc.meter_rect,
        tdec.feed_pad_hw)
    assert ok.all()
    return SimpleNamespace(tc=tc, tdec=tdec, jdec=jdec, jstep=jstep,
                           feed=feed, fb_packed=fb_packed)


# fallback slots: -1 (row B-1), past the end, the last row of the first
# half and the first of the second (either side of the k=2 boundary; of
# k=4's, with rows 3/4 and 11/12), -B-1 (dropped), rows 11 and 12, and
# -B (row 0)
FB_IDX = np.array([-1, B, B // 2 - 1, B // 2, -B - 1, 11, 12, -B], np.int32)


@pytest.mark.parametrize("k", MESH_SIZES)
def test_mesh_coef_step_equal_jax(coef, k):
    """MeshCoefStep on k replicas with fallback slots that are negative,
    out of range and on either side of shard boundaries: every field of
    the JAX MeshCoefStep's result (match_val within MATCH_RTOL) and of the
    port's plain step, bit for bit; the fallback rows really decode in
    place of the frames."""
    from meterelf_tpu_torch.pipeline.decode import make_coef_decode_fn

    cy, cb, cr, qt, ok = coef.feed[:5]
    jms = j_mesh.MeshCoefStep(coef.jstep, _j_mesh(k))
    jres = _host(jms(coef.jdec.param_arrays, cy, cb, cr, qt, ok,
                     coef.fb_packed, FB_IDX))
    tms = t_mesh.MeshCoefStep(coef.tdec, FRAME_WH, _t_mesh(k))
    tres = tms(None, cy, cb, cr, qt, ok, coef.fb_packed, FB_IDX)
    assert_bits_equal(_host(tres), jres, f"coef k={k}", True)
    step = make_coef_decode_fn(coef.tdec, FRAME_WH)[0]
    plain = _host(step(None, cy, cb, cr, qt, ok, coef.fb_packed, FB_IDX))
    assert_bits_equal(_host(tres), plain, f"coef k={k} vs plain step")
    nofb = _host(step(None, *coef.feed[:5], coef.fb_packed,
                      np.full(8, B, np.int32)))
    for row in (B - 1, B // 2 - 1, B // 2, 11, 12, 0):
        assert (plain.match_x[row], plain.match_y[row]) != \
            (nofb.match_x[row], nofb.match_y[row]) or \
            plain.value[row] != nofb.value[row], row
    assert_agg_equal(tms.aggregate(tres),
                     j_mesh.aggregate_metrics(jres.value, jres.err,
                                              _j_mesh(k)), f"coef k={k}")


def test_not_divisible_raises(cam):
    """A batch the mesh size does not divide raises before anything is
    decoded: the port with the JAX package's assertion text (its
    device_put refuses the numpy batch first, with its own), the load
    flags' length check with the JAX text, and the streams with the JAX
    streams' ValueError."""
    crops = cam.crops[:12]
    msg = "batch 12 not divisible by mesh size 8"
    with pytest.raises(ValueError, match="should be divisible by 8"):
        j_mesh.data_parallel_decoder(cam.jdec, _j_mesh(8))(crops)
    with pytest.raises(AssertionError, match=msg):
        t_mesh.data_parallel_decoder(cam.tdec, _t_mesh(8))(crops)
    with pytest.raises(AssertionError, match=msg):
        t_mesh.MeshCoefStep(cam.tdec, FRAME_WH, _t_mesh(8))(
            None, *(np.zeros((12, 1)),) * 5, np.zeros((0, 1, 1)),
            np.zeros(0, np.int32))
    errs = {}
    for pkg, mod, run in (
            ("jax", j_mesh, j_mesh.data_parallel_decoder(cam.jdec,
                                                         _j_mesh(4))),
            ("torch", t_mesh, t_mesh.data_parallel_decoder(cam.tdec,
                                                           _t_mesh(4)))):
        with pytest.raises(AssertionError) as e:
            run(cam.crops, np.ones(B - 1, bool))
        errs[pkg] = str(e.value)
    assert errs["torch"] == errs["jax"] == (
        f"load_ok holds {B - 1} flags, expected the process-local batch of "
        f"{B}")
    for fn, args in ((("stream_decode"), ([],)),
                     (("stream_decode_bytes"), ([], FRAME_WH))):
        texts = {}
        for pkg, mod, params, dec, mesh in (
                ("jax", j_stream, cam.jdec.params, cam.jdec, _j_mesh(8)),
                ("torch", t_stream, cam.tdec.params, cam.tdec, _t_mesh(8))):
            with pytest.raises(ValueError) as e:
                getattr(mod, fn)(params, *args, decoder=dec, mesh=mesh,
                                 batch_size=12)
            texts[pkg] = str(e.value)
        assert texts["torch"] == texts["jax"] == (
            "batch_size 12 not divisible by mesh size 8"), fn


def test_initialize_distributed_is_gated(monkeypatch):
    """Without METERELF_DISTRIBUTED, joining is a no-op returning False
    in both packages; with it, the METERELF_* contract reaches
    init_process_group (mocked, as the JAX test mocks
    jax.distributed.initialize) as the JAX package's reaches its own,
    over gloo for a CPU process."""
    monkeypatch.delenv("METERELF_DISTRIBUTED", raising=False)
    called = {"jax": [], "torch": []}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: called["jax"].append(kw))
    monkeypatch.setattr(t_mesh.dist, "init_process_group",
                        lambda *a, **kw: called["torch"].append((a, kw)))
    assert j_mesh.initialize_distributed() is False
    assert t_mesh.initialize_distributed() is False
    assert called == {"jax": [], "torch": []}
    for k, v in (("METERELF_DISTRIBUTED", "1"),
                 ("METERELF_COORDINATOR", "10.0.0.1:8476"),
                 ("METERELF_NUM_PROCS", "4"), ("METERELF_PROC_ID", "2"),
                 ("METERELF_DEVICE", "cpu")):
        monkeypatch.setenv(k, v)
    assert j_mesh.initialize_distributed() is True
    assert t_mesh.initialize_distributed() is True
    assert called["jax"] == [{"coordinator_address": "10.0.0.1:8476",
                              "num_processes": 4, "process_id": 2}]
    assert called["torch"] == [(("gloo",), {
        "init_method": "tcp://10.0.0.1:8476", "world_size": 4, "rank": 2})]
    # an explicit address alone opens the gate, the rest from the env
    assert t_mesh.initialize_distributed("10.0.0.2:1234") is True
    assert called["torch"][-1][1]["init_method"] == "tcp://10.0.0.2:1234"
    if not torch.cuda.is_available():
        # a CUDA process (the default device) without a card: no fallback
        monkeypatch.delenv("METERELF_DEVICE")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_mesh.initialize_distributed()
        assert len(called["torch"]) == 2


def test_make_mesh_without_card_raises():
    """make_mesh() over every CUDA device raises without a card (no
    quiet CPU mesh); CPU meshes are asked for by name, and their size
    counts the replicas."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_mesh(["cuda"])
    mesh = t_mesh.make_mesh(["cpu"] * 3)
    assert (mesh.size, mesh.world, mesh.rank, mesh.group) == (3, 1, 0, None)
    assert mesh.devices == (torch.device("cpu"),) * 3


def test_mesh_imports_no_jax():
    """parallel.mesh imports neither jax nor the JAX package, in a
    process where importing either fails."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['meterelf_tpu'] = None\n"
            "import meterelf_tpu_torch.parallel.mesh\n"
            "bad = [m for m, v in sys.modules.items() if v is not None\n"
            "       and m.split('.')[0] in ('jax', 'meterelf_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0 and r.stdout == "ok\n", r.stderr


def test_mesh_decoder_rescue(cam):
    """MeshDecoder.rescue_numpy hands the batch to the replica on the
    first device over host arrays: a batch whose rows are marked
    non-converged comes back as the single decoder's rescue decode."""
    md = t_mesh.MeshDecoder(cam.tdec, _t_mesh(2))
    res = _host(md(cam.crops))
    forced = res._replace(converged=np.zeros_like(res.converged))
    with mock.patch.object(TorchDecoder, "decode",
                           wraps=cam.tdec.decode) as seen:
        got = md.rescue_numpy(cam.crops, forced)
    assert seen.call_count == 1
    assert_bits_equal(got, cam.tdec.rescue_numpy(cam.crops, forced),
                      "rescue")


def test_stream_mesh_rescue_aggregates_again(cam):
    """A mesh stream batch with a non-converged row (forced here: its
    value spoiled, converged cleared) takes the rescue decode, and its
    device_agg is reduced again from the rescued result: the reports
    equal an unspoiled mesh stream's, device_agg included, as the JAX
    stream reduces after its rescue."""
    frames = [(f"f{i:02d}", c) for i, c in enumerate(cam.crops)]
    stamps = [60.0 * i for i in range(B)]
    mesh = _t_mesh(2)
    want = list(t_stream.stream_decode(cam.tdec.params, frames,
                                       decoder=cam.tdec, mesh=mesh,
                                       batch_size=8, timestamps=stamps))
    real = t_mesh._DataParallel.__call__

    def spoiled(self, crops, load_ok=None):
        real(self, crops, load_ok)
        first = self.last[1][0]            # rows 0-3 of the batch
        value, conv = first.value.clone(), first.converged.clone()
        value[3], conv[3] = 12345.0, False
        parts = [first._replace(value=value, converged=conv)]
        parts += self.last[1][1:]
        bad = t_mesh._gather(parts, self.mesh.devices[0])
        self.last = (bad, parts)
        return bad

    with mock.patch.object(t_mesh._DataParallel, "__call__", spoiled):
        got = list(t_stream.stream_decode(cam.tdec.params, frames,
                                          decoder=cam.tdec, mesh=mesh,
                                          batch_size=8, timestamps=stamps))
    assert [r.device_agg for r in got] == [r.device_agg for r in want]
    assert all(r.device_agg is not None for r in got)
    assert [dict(vars(r), images_per_sec=0) for r in got] == \
        [dict(vars(r), images_per_sec=0) for r in want]
