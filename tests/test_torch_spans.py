"""The port's spans and counters (meterelf_tpu_torch/profiling.py), on the
CPU at a small batch: with no profiler the span is the shared no-op and
nothing reaches a profiler; under torch.profiler the coefficient step
opens its seven compute spans once each, flat, with every operator of
the step inside one; the result's copy and wait, the general branch's
CCL and stats, and the stream's stage timers open theirs; the fallback
and rescue counters count rows."""
from contextlib import contextmanager, nullcontext

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meterelf_tpu_torch import profiling, synthetic
from meterelf_tpu_torch.io import jpeg as jio
from meterelf_tpu_torch.pipeline.decode import (MeterDecoder,
                                                 make_coef_decode_fn,
                                                 to_host_later)

torch.set_num_threads(2)

B = 2
FRAME_WH = (640, 480)
STEP_SPANS = ["meterelf.step.backhalf", "meterelf.decode.frontend",
              "meterelf.decode.windows", "meterelf.decode.ccl",
              "meterelf.decode.stats", "meterelf.decode.angles",
              "meterelf.decode.errors"]
# the step's only operators outside its spans, in order: decode's input
# checks on tensors already in place, no-ops that launch nothing
OUTSIDE = ["aten::to", "aten::to",     # MeterDecoder._packed: upload
           "aten::alias",              # its [:, :h, :w] view
           "aten::to",                 # its .to(torch.int32)
           "aten::to", "aten::to",     # MeterDecoder._load_ok: upload
           "aten::to"]                 # its .to(torch.bool)


@pytest.fixture(scope="module")
def coef():
    cam = synthetic.DEFAULT_CAMERA
    dec = MeterDecoder(cam.make_params(), device="cpu")
    step, _win, pad_hw = make_coef_decode_fn(dec, FRAME_WH)
    frames = cam.render_frames(synthetic.dial_positions(B))
    feed = jio.load_coef_feed([synthetic.encode_jpeg(f, 92) for f in frames],
                              dec.params.meter_rect, FRAME_WH, pad_hw)
    feed = tuple(torch.as_tensor(a) for a in feed)
    return dec, step, feed


@contextmanager
def traced():
    box = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield box
    box["events"] = list(prof.events())


def _ours(events):
    return [e for e in events if e.name.startswith("meterelf.")]


def _off(coef, monkeypatch):
    """No profiler: one shared no-op, no profiler range opened anywhere
    in the step, and a profiler started afterwards holds no span."""
    assert profiling.span("meterelf.a") is profiling.span("meterelf.b")
    assert isinstance(profiling.span("meterelf.a"), nullcontext)
    opened = []

    def ranges(name):
        opened.append(name)
        raise AssertionError(f"range {name} opened with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", ranges)
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    dec, step, feed = coef
    to_host_later(step(None, *feed))()
    assert opened == []
    with traced() as box:
        pass
    assert _ours(box["events"]) == []


def _step(coef, monkeypatch):
    """Seven flat root spans, once each; every aten operator of the step
    inside one of them but the input checks' no-ops (OUTSIDE)."""
    dec, step, feed = coef
    with traced() as box:
        step(None, *feed)
    ev = box["events"]
    ours = _ours(ev)
    assert sorted(e.name for e in ours) == sorted(STEP_SPANS)
    assert all(e.cpu_parent is None for e in ours)
    iv = sorted((e.time_range.start, e.time_range.end) for e in ours)
    assert all(a[1] <= b[0] for a, b in zip(iv, iv[1:]))
    outside = []
    for e in ev:
        if not e.name.startswith("aten::"):
            continue
        top = e
        while top.cpu_parent is not None:
            top = top.cpu_parent
        if not top.name.startswith("meterelf."):
            outside.append(top.name)
    assert outside == OUTSIDE


def _result(coef, monkeypatch):
    dec, step, feed = coef
    res = step(None, *feed)
    with traced() as box:
        fetch = to_host_later(res)
        out = fetch()
    names = [e.name for e in _ours(box["events"])]
    assert names.count("meterelf.result.copy") == 1
    assert names.count("meterelf.result.wait") == 1
    assert isinstance(out.value, np.ndarray)


def _general(coef, monkeypatch):
    """FIVE_DIAL_CAMERA takes the general branch: ops/ccl.analyze_batch
    opens the CCL and stats spans."""
    cam = synthetic.FIVE_DIAL_CAMERA
    dec = MeterDecoder(cam.make_params(), device="cpu")
    crops = cam.render_crops(synthetic.dial_positions(B))
    with traced() as box:
        dec.decode(crops)
    names = [e.name for e in _ours(box["events"])]
    for s in ("meterelf.decode.ccl", "meterelf.decode.stats"):
        assert names.count(s) == 1, names
    assert "meterelf.step.backhalf" not in names


def _stage_timers(coef, monkeypatch):
    tm = profiling.StageTimers()
    with traced() as box:
        for name in ("dispatch", "drain", "drain", "rescue"):
            with tm.stage(name):
                pass
    assert set(tm.totals) == {"dispatch", "drain", "rescue"}
    assert dict(tm.counts) == {"dispatch": 1, "drain": 2, "rescue": 1}
    names = [e.name for e in _ours(box["events"])]
    assert sorted(names) == ["meterelf.stream.dispatch",
                             "meterelf.stream.drain",
                             "meterelf.stream.drain",
                             "meterelf.stream.rescue"]
    assert "drain" in tm.report()


def _fallback_rows(coef, monkeypatch):
    """One slot pointed at row 1 counts one fallback row; the unused
    slots (fb_idx = B) count none."""
    dec, step, feed = coef
    cy, cb, cr, qt, ok, fb_packed, fb_idx = feed
    idx = torch.full_like(fb_idx, B)
    before = profiling.counts().get("fallback_rows", 0)
    step(None, cy, cb, cr, qt, ok, fb_packed, idx)
    assert profiling.counts().get("fallback_rows", 0) == before
    idx[0] = 1
    step(None, cy, cb, cr, qt, ok, fb_packed, idx)
    assert profiling.counts()["fallback_rows"] == before + 1
    assert "fallback_rows" in profiling.StageTimers().report()


def _rescued_rows(coef, monkeypatch):
    """A host result with one row marked non-converged: rescue_numpy
    decodes again and counts one rescued row."""
    dec = MeterDecoder(synthetic.DEFAULT_CAMERA.make_params(), device="cpu")
    crops = synthetic.DEFAULT_CAMERA.render_crops(
        synthetic.dial_positions(B))
    res = dec.decode_numpy(crops)
    before = profiling.counts().get("rescued_rows", 0)
    assert dec.rescue_numpy(crops, res) is res
    assert profiling.counts().get("rescued_rows", 0) == before
    conv = np.asarray(res.converged).copy()
    conv[0] = False
    out = dec.rescue_numpy(crops, res._replace(converged=conv))
    assert profiling.counts()["rescued_rows"] == before + 1
    assert np.asarray(out.converged).all()


CASES = {"off": _off, "step": _step, "result": _result,
         "general": _general, "stage_timers": _stage_timers,
         "fallback_rows": _fallback_rows, "rescued_rows": _rescued_rows}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans(case, coef, monkeypatch):
    CASES[case](coef, monkeypatch)
