"""The coefficient step's CUDA graphs on the card (pipeline/graphs.py,
marked ``cuda``; each test skips where torch.cuda.is_available() is
False): every replayed step held bit for bit against the eager path
called directly (K10 ``backhalf_planes``, the fallback scatter, then
``_decode_batch``), and every other branch capturing nothing. Run on a
machine with a GPU:

    python -m pytest --noconftest tests/test_torch_cuda_graph.py -q
"""
import numpy as np
import pytest
import torch

from fuzz_frames import fuzz_frames
from meterelf_tpu_torch import synthetic
from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import angles, frontend, jpeg_tail, launch, result
from meterelf_tpu_torch.ops.components import RESCUE_CAPS
from meterelf_tpu_torch.parallel.mesh import MeshCoefStep, make_mesh
from meterelf_tpu_torch.pipeline import decode as decode_mod
from meterelf_tpu_torch.pipeline import graphs
from meterelf_tpu_torch.pipeline.decode import (MeterDecoder,
                                                make_coef_decode_fn,
                                                to_host_later)
from meterelf_tpu_torch.profiling import counts

torch.set_num_threads(4)

pytestmark = pytest.mark.cuda

FRAME_WH = (640, 480)
B = 256
COUNTERS = ("step_graph_captures", "step_graph_replays", "step_graph_staged")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graphs run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def feed(dev):
    """The host coefficient feed of 128 flagship fuzz frames as
    quality-92 JPEGs, tiled to B rows."""
    cam = synthetic.DEFAULT_CAMERA
    frames = fuzz_frames(cam, B // 2, seed=4241)
    datas = [synthetic.encode_jpeg(f, 92) for f in frames] * 2
    out = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, (250, 250))
    assert out[4].all() and (out[6] == B).all()
    return out


def _counters():
    c = counts()
    return np.array([c.get(n, 0) for n in COUNTERS])


def _cut(feed, n, shift=0):
    """The feed's first n rows after rolling the rows by ``shift``; the
    fallback slots as they are."""
    return [np.roll(a, shift, axis=0)[:n] for a in feed[:5]] + list(feed[5:])


def _on(dev, feed):
    """The feed's five arrays as tensors on the card."""
    return [torch.as_tensor(a).to(dev) for a in feed[:5]] + list(feed[5:])


def _step(dev, cam=synthetic.DEFAULT_CAMERA, **kw):
    dec = MeterDecoder(cam.make_params(), device=dev, **kw)
    step, win, pad_hw = make_coef_decode_fn(dec, FRAME_WH)
    return dec, step, win, pad_hw


def _eager(dec, win, pad_hw, feed, caps=None):
    """The step's stages called directly, eagerly, on the card: K10, the
    kept fallback slots, then _decode_batch; on the host."""
    cy, cb, cr, qt, ok = (torch.as_tensor(a).to(dec.device)
                          for a in feed[:5])
    packed = jpeg_tail.backhalf_planes(cy, cb, cr, qt, win, pad_hw)
    slots = decode_mod._slots(feed[6], packed.shape[0])
    if slots is not None:
        decode_mod._scatter(packed, feed[5], *slots)
    return to_host_later(decode_mod._decode_batch(
        dec, packed, ok.to(torch.bool), caps=caps, **dec.static_kwargs))()


def _same_bits(a, b, label):
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.dtype.kind == "f":
            x, y = x.view(f"u{x.itemsize}"), y.view(f"u{y.itemsize}")
        np.testing.assert_array_equal(x, y, err_msg=f"{label}: {f}")


@pytest.mark.parametrize("front,rows,where", [
    ("split", B, "device"), ("split", 100, "device"),
    ("merged", B, "device"), ("split", B, "host"), ("merged", 100, "host")])
def test_graph_step_equals_eager(dev, feed, front, rows, where):
    """The quad step (either frontend, the full and a partial batch,
    inputs on the card or from the host): the first call captures the
    two graphs, every call replays both, and each result equals the
    eager stages bit for bit; a replay counts one launch of each of its
    kernels, K12 and K13 once a decode."""
    dec, step, win, pad_hw = _step(dev, frontend=front)
    host = _cut(feed, rows)
    inputs = _on(dev, host) if where == "device" else host
    k1 = frontend.frontend if front == "split" else frontend.frontend_windows
    kernels = (jpeg_tail.backhalf_planes, k1, angles.readout,
               result.result_pack)
    c0 = _counters()
    first = to_host_later(step(None, *inputs))()
    assert list(_counters() - c0) == [2, 2, 0]
    before = [k.launches for k in kernels + tuple(launch.COUNTED)]
    got = [to_host_later(step(None, *inputs))() for _ in range(3)]
    ran = [k.launches - n
           for k, n in zip(kernels + tuple(launch.COUNTED), before)]
    assert list(_counters() - c0) == [2, 8, 0]
    assert ran[:4] == [3, 3, 3, 3]
    assert sum(ran[4:]) == 3 * (7 if front == "split" else 6)
    want = _eager(dec, win, pad_hw, host)
    for i, g in enumerate([first] + got):
        _same_bits(g, want, f"{front} B={rows} {where} call {i}")
    assert (want.err == 0).any() and (want.err != 0).any()


def test_graph_step_with_fallback_slots(dev):
    """A feed whose fallback slots hold 4:4:4 and truncated frames: the
    slots are written between the two replays, and the result equals the
    eager stages bit for bit, call after call."""
    cam = synthetic.DEFAULT_CAMERA
    frames = cam.render_frames(synthetic.dial_positions(6))
    datas = [synthetic.encode_jpeg(f, 92, subsampling="4:4:4" if i % 2
                                   else "4:2:0")
             for i, f in enumerate(frames)]
    datas[4] = datas[4][:len(datas[4]) // 2]
    feed = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH, (250, 250))
    assert sorted(feed[6][:3].tolist()) == [1, 3, 5]
    dec, step, win, pad_hw = _step(dev)
    c0, rows0 = _counters(), counts().get("fallback_rows", 0)
    got = [to_host_later(step(None, *feed))() for _ in range(2)]
    assert list(_counters() - c0) == [2, 4, 0]
    assert counts()["fallback_rows"] - rows0 == 6
    want = _eager(dec, win, pad_hw, feed)
    for i, g in enumerate(got):
        _same_bits(g, want, f"fallback call {i}")


def test_device_feeds_past_the_bound_are_staged(dev, feed):
    """BOUND + 1 distinct feeds on the card: the first BOUND each capture
    a back-half graph that reads them in place and a decode graph, the
    last goes to the staging buffers (one copy a call, counted); a known
    feed captures nothing again; a feed's
    tensors written in place are read by the next replay; a held result
    survives later replays. Each result equals the eager stages."""
    dec, step, win, pad_hw = _step(dev)
    hosts = [_cut(feed, B, 37 * k) for k in range(graphs.BOUND + 1)]
    feeds = [_on(dev, h) for h in hosts]
    wants = [_eager(dec, win, pad_hw, h) for h in hosts]
    c0 = _counters()
    held = step(None, *feeds[0])
    first = to_host_later(held)()
    got = [to_host_later(step(None, *f))() for f in feeds[1:]]
    n = graphs.BOUND + 1
    assert list(_counters() - c0) == [2 * n, 2 * n, 1]
    for k, g in enumerate([first] + got):
        _same_bits(g, wants[k], f"feed {k}")
    again = [to_host_later(step(None, *feeds[k]))() for k in (0, n - 1)]
    assert list(_counters() - c0) == [2 * n, 2 * n + 4, 2]
    _same_bits(again[0], wants[0], "feed 0 again")
    _same_bits(again[1], wants[n - 1], "staged feed again")
    # the replay reads the inputs where they lie: feed 0's tensors now
    # hold feed 1's rows
    for a, b in zip(feeds[0][:5], feeds[1][:5]):
        a.copy_(b)
    _same_bits(to_host_later(step(None, *feeds[0]))(), wants[1],
               "feed 0 overwritten")
    assert list(_counters() - c0) == [2 * n, 2 * n + 6, 2]
    torch.cuda.synchronize()
    _same_bits(to_host_later(held)(), first, "held result")
    assert held.err.untyped_storage().data_ptr() not in {
        g.out[0].untyped_storage().data_ptr() for g in dec._graphs.values()}


@pytest.mark.parametrize("branch", ["five_dial", "scorer_only",
                                    "hist_pallas", "block", "rescue"])
def test_other_branches_capture_nothing(dev, feed, branch):
    """The general five-dial branch, the scorer-only branch, the quad
    branch's other stats and the block layout run the step eagerly, and
    so does a decode under RESCUE_CAPS, even of a graph's own buffers: no
    capture, no replay; K12 and K13 once a decode."""
    cam = (synthetic.FIVE_DIAL_CAMERA if branch == "five_dial"
           else synthetic.DEFAULT_CAMERA)
    dec, step, win, pad_hw = _step(
        dev, cam, **({"quad_stats": "hist_pallas"}
                     if branch == "hist_pallas" else {}))
    if branch == "scorer_only":
        dec.static_kwargs["static_win_origin"] = None
    host = _cut(feed, 16)
    if branch in ("five_dial", "block"):
        datas = [synthetic.encode_jpeg(f, 92)
                 for f in cam.render_frames(synthetic.dial_positions(16))]
        host = tio.load_coef_feed_shard(datas, tuple(win),
                                        branch == "five_dial",
                                        cam.meter_rect, FRAME_WH, pad_hw)
    if branch == "rescue":
        step(None, *_on(dev, host))
        (g,) = dec._graphs.values()
        crops, ok = g.args
    c0 = _counters()
    r0, p0 = angles.readout.launches, result.result_pack.launches
    if branch == "rescue":
        got = to_host_later(dec.decode(crops, ok, caps=RESCUE_CAPS))()
        want = to_host_later(decode_mod._decode_batch(
            dec, crops.clone(), ok, caps=RESCUE_CAPS,
            **dec.static_kwargs))()
        _same_bits(got, want, "rescue of a graph's buffers")
    else:
        got = to_host_later(step(None, *_on(dev, host)))()
    assert list(_counters() - c0) == [0, 0, 0]
    n = 2 if branch == "rescue" else 1
    assert angles.readout.launches - r0 == n
    assert result.result_pack.launches - p0 == n
    assert (got.err == 0).any()


def test_mesh_step_on_one_card_equals_plain_step(dev, feed):
    """MeshCoefStep over a one-card mesh, on host shards, equals the plain
    step bit for bit; each captures its own graphs."""
    dec, step, _, _ = _step(dev)
    mesh_step = MeshCoefStep(dec, FRAME_WH, make_mesh([dev]))
    host = _cut(feed, B)
    c0 = _counters()
    a = [to_host_later(mesh_step(None, *host))() for _ in range(2)]
    b = to_host_later(step(None, *host))()
    assert list(_counters() - c0) == [4, 6, 0]
    for i, x in enumerate(a):
        _same_bits(x, b, f"mesh call {i}")

