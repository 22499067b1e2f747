"""The coefficient step's CUDA graphs off the card (pipeline/graphs.py):
the step on the CPU captures nothing; ``StepGraphs``'s placement, its key
and its bound, held as plain Python with ``Graph`` stubbed; ``Graph``'s
capture, launch counting and the decoder's replay of its crops, with
torch.cuda's graph API stubbed. tests/test_torch_cuda_graph.py holds the
graphs themselves on the card."""
import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from meterelf_tpu_torch import synthetic
from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import jpeg_tail, launch, result
from meterelf_tpu_torch.ops.components import RESCUE_CAPS
from meterelf_tpu_torch.pipeline import graphs
from meterelf_tpu_torch.pipeline.decode import (MeterDecoder,
                                                make_coef_decode_fn)
from meterelf_tpu_torch.profiling import counts

CPU = torch.device("cpu")


def _counter(name):
    return counts().get(name, 0)


@pytest.fixture(scope="module")
def feed():
    """The host coefficient feed of 3 flagship frames."""
    cam = synthetic.DEFAULT_CAMERA
    datas = [synthetic.encode_jpeg(f, 92)
             for f in cam.render_frames(synthetic.dial_positions(3))]
    return tio.load_coef_feed(datas, cam.meter_rect, (640, 480), (250, 250))


def _decoder():
    return MeterDecoder(synthetic.DEFAULT_CAMERA.make_params(), device="cpu")


def test_step_on_cpu_captures_nothing(feed):
    """Two steps on the CPU: no capture, no replay, no staging, no graph
    registered with the decoder; the step's result is the decoder's."""
    dec = _decoder()
    step, _, _ = make_coef_decode_fn(dec, (640, 480))
    names = ("step_graph_captures", "step_graph_replays",
             "step_graph_staged")
    before = [_counter(n) for n in names]
    for _ in range(2):
        res = step(None, *feed)
    assert [_counter(n) for n in names] == before
    assert dec._graphs == {}
    assert (res.err.numpy() == 0).all() and res.converged.numpy().all()


def _inputs(seed=0, B=3, dtype=torch.int8):
    """A stand-in for the step's five inputs (cy, cb, cr, qt, ok) on the
    CPU, with the feed's dtypes."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(-9, 9, (B, 6, 8), generator=g).to(dtype),
            torch.randint(-9, 9, (B, 3, 4), generator=g).to(dtype),
            torch.randint(-9, 9, (B, 3, 4), generator=g).to(dtype),
            torch.randint(0, 99, (B, 3, 64), generator=g).to(torch.uint16),
            torch.ones(B, dtype=torch.bool)]


class Stub:
    """graphs.Graph stubbed: records the inputs of each graph made and
    returns a stand-in holding them."""

    def __init__(self):
        self.made = []

    def __call__(self, device, fn, args):
        self.made.append(list(args))
        return SimpleNamespace(args=tuple(args), n=len(self.made))


@pytest.fixture
def stub(monkeypatch):
    s = Stub()
    monkeypatch.setattr(graphs, "Graph", s)
    return s


def _edit(kind, ts):
    """The inputs ``ts`` again, with cy changed as ``kind`` says: the
    same tensors, a new view of the same memory, or another address,
    shape, dtype or stride."""
    cy = ts[0]
    new = {"same": cy,
           "same_view": cy.view(cy.shape),
           "other_address": cy.clone(),
           "other_shape": cy.reshape(cy.shape[0], -1),
           "other_dtype": cy.view(torch.uint8),
           "other_stride": cy.as_strided(cy.shape, (1,) + cy.stride()[1:])
           }[kind]
    return [new] + list(ts[1:])


@pytest.mark.parametrize("kind,hit", [
    ("same", True), ("same_view", True), ("other_address", False),
    ("other_shape", False), ("other_dtype", False),
    ("other_stride", False)])
def test_key_is_address_shape_dtype_and_stride(stub, kind, hit):
    """Inputs on the step's device key their graph by every input's
    address, shape, dtype and stride: equal in all four, the graph is
    found again; another in any one, a new graph is made, and on those
    inputs themselves (no staging copy)."""
    sg = graphs.StepGraphs(CPU, None)
    ts = _inputs()
    first = sg.place(ts)
    again = _edit(kind, ts)
    staged = _counter("step_graph_staged")
    second = sg.place(again)
    assert (second is first) == hit
    assert len(stub.made) == (1 if hit else 2)
    assert all(a is b for a, b in zip(stub.made[-1], ts if hit else again))
    assert _counter("step_graph_staged") == staged


@pytest.mark.parametrize("bound", [1, graphs.BOUND])
def test_bound_then_staging(stub, monkeypatch, bound):
    """Distinct inputs of one shape: the first BOUND each get a graph on
    themselves; the next are copied into the shape's one staged graph,
    made once on its own buffers (counted as staged); a known set still
    finds its own graph; another shape has its own bound."""
    monkeypatch.setattr(graphs, "BOUND", bound)
    sg = graphs.StepGraphs(CPU, None)
    sets = [_inputs(seed) for seed in range(bound + 3)]
    made = [sg.place(ts) for ts in sets[:bound]]
    assert len(stub.made) == bound
    staged = _counter("step_graph_staged")
    for i, ts in enumerate(sets[bound:]):
        g = sg.place(ts)
        assert len(stub.made) == bound + 1
        assert all(b is not t and torch.equal(b, t)
                   for b, t in zip(g.args, ts))
        assert _counter("step_graph_staged") == staged + i + 1
    assert g is sg.place(sets[-2])
    assert all(sg.place(ts) is m for ts, m in zip(sets, made))
    assert len(stub.made) == bound + 1
    other = sg.place(_inputs(B=5))
    assert other is not g and len(stub.made) == bound + 2


def test_inputs_off_the_device_are_staged(stub):
    """Inputs not on the step's device (here numpy on the host, for a
    step on the meta device) are never keyed by address: they go to the
    shape's staged graph, made once on buffers of the step's device and
    found again for other inputs of the shape, and count as no staging of
    device inputs."""
    meta = torch.device("meta")
    sg = graphs.StepGraphs(meta, None)
    staged = _counter("step_graph_staged")
    host = [t.numpy() for t in _inputs(0)]
    g = sg.place(host)
    assert len(stub.made) == 1
    assert [(b.device, tuple(b.shape), b.dtype) for b in g.args] == [
        (meta, a.shape, torch.as_tensor(a).dtype) for a in host]
    assert sg.place([t.numpy() for t in _inputs(1)]) is g
    assert len(stub.made) == 1
    assert _counter("step_graph_staged") == staged


def test_step_graphs_index_a_bare_cuda_device(monkeypatch):
    """A step built for "cuda" keys its inputs by the device they report,
    which has an index."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    sg = graphs.StepGraphs(torch.device("cuda"), None)
    assert sg.device == torch.device("cuda", 0)


def test_every_launch_counter_is_registered():
    """ops/launch.COUNTED holds every kernel wrapper of ops/ with a
    ``launches`` counter, each once: what a graph's replay adds to."""
    import importlib
    import pkgutil

    import meterelf_tpu_torch.ops as ops
    found = set()
    for m in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{m.name}")
        found |= {f for f in vars(mod).values()
                  if callable(f) and hasattr(f, "launches")}
    assert len(launch.COUNTED) == len(set(launch.COUNTED)) == len(found)
    assert set(launch.COUNTED) == found and len(found) >= 13


class FakeGraph:
    """torch.cuda.CUDAGraph's stand-in: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class FakeStream:
    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _nothing(*a, **k):
    yield


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's stream and graph API stubbed: a capture runs its call
    eagerly, a replay runs nothing."""
    for name, fake in (("Stream", FakeStream), ("stream", _nothing),
                       ("graph", _nothing), ("CUDAGraph", FakeGraph),
                       ("device", _nothing),
                       ("current_stream", lambda *a: FakeStream())):
        monkeypatch.setattr(torch.cuda, name, fake)


def test_graph_counts_only_what_replays_launch(fake_cuda):
    """A Graph captures at its first replay, not before; the warm-up and
    the capture leave every launch counter as it was; each replay adds
    what the capture launched, and returns what the captured call
    returned."""
    k = launch.COUNTED
    ran = [k[0], k[2], k[2]]
    out = torch.zeros(3)

    def fn(a, b):
        for f in ran:
            f.launches += 1
        return out

    before = [f.launches for f in k]
    c0 = [_counter(n) for n in ("step_graph_captures", "step_graph_replays")]
    try:
        g = graphs.Graph(CPU, fn, _inputs()[:2])
        assert _counter("step_graph_captures") == c0[0]
        assert g.replay() is out
        assert [f.launches - n for f, n in zip(k, before)] == [
            1, 0, 2] + [0] * (len(k) - 3)
        assert g.replay() is out
        added = [f.launches - n for f, n in zip(k, before)]
    finally:
        for f, n in zip(k, before):
            f.launches = n
    assert added == [2, 0, 4] + [0] * (len(k) - 3)
    assert g._graph.replays == 2
    assert [_counter("step_graph_captures") - c0[0],
            _counter("step_graph_replays") - c0[1]] == [1, 2]


def test_decoder_replays_the_graph_of_its_graph_crops(fake_cuda, feed):
    """Crops and a load mask handed to ``graph_crops``: each ``decode`` of
    those very tensors at the default caps replays one graph, captured at
    the first, and returns the eager decode's fields in a fresh buffer
    each time; under other caps, or with another load mask, the decode
    runs eagerly."""
    dec = _decoder()
    _, win, pad_hw = make_coef_decode_fn(dec, (640, 480))
    crops = jpeg_tail.backhalf_planes(
        *(torch.as_tensor(a) for a in feed[:4]), win, pad_hw)
    ok = torch.as_tensor(feed[4])
    want = dec.decode(crops, ok)
    dec.graph_crops(crops, ok)
    dec.graph_crops(crops, ok)
    assert len(dec._graphs) == 1
    c0 = [_counter(n) for n in ("step_graph_captures", "step_graph_replays")]
    got = [dec.decode(crops, ok) for _ in range(2)]
    assert [_counter("step_graph_captures") - c0[0],
            _counter("step_graph_replays") - c0[1]] == [1, 2]
    (g,) = dec._graphs.values()
    bufs = {g.out[0].untyped_storage().data_ptr()}
    for r in got:
        for f in r._fields:
            assert torch.equal(getattr(r, f), getattr(want, f)), f
        bufs.add(r.err.untyped_storage().data_ptr())
    assert len(bufs) == 3
    dec.decode(crops, ok, caps=RESCUE_CAPS)
    dec.decode(crops, ok.clone())
    assert _counter("step_graph_replays") - c0[1] == 2


def test_views_equal_packed_layout():
    """result.views of a buffer lays the ten fields where result.packed
    does."""
    a = result.packed(5, 4, CPU)
    buf = torch.zeros(result.layout(5, 4)[1], dtype=torch.uint8)
    b = result.views(buf, 5, 4)
    for x, y in zip(a, b):
        assert (x.dtype, x.shape, x.stride(), x.storage_offset()) == (
            y.dtype, y.shape, y.stride(), y.storage_offset())
        assert y.untyped_storage().data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(b[8].numpy(), np.zeros(5))


def test_copied_is_a_fresh_copy_of_the_buffer():
    """result.copied gives the ten fields as views of a new buffer that
    holds the same bytes, laid out as the fields it copies."""
    n = result.layout(5, 4)[1]
    buf = torch.randint(0, 256, (n,), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(3))
    a = result.views(buf, 5, 4)
    b = result.copied(a)
    new = b[0].untyped_storage()
    assert new.data_ptr() != buf.data_ptr() and new.nbytes() == n
    assert torch.equal(torch.empty(0, dtype=torch.uint8).set_(new), buf)
    for x, y in zip(a, b):
        assert (x.dtype, x.shape, x.stride(), x.storage_offset()) == (
            y.dtype, y.shape, y.stride(), y.storage_offset())
        assert y.untyped_storage().data_ptr() == new.data_ptr()
