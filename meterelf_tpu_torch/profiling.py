"""Observability: spans, counters, stage timers and the device profiler.

Port of meterelf_tpu/profiling.py, plus the port's span API:

- ``span(name)`` marks a stage on the profiler's own timeline, beside the
  kernels and copies the stage issues. With no ``torch.profiler`` active
  it is one shared no-op (a single check, no allocation); under a
  profiler (the stream's ``--trace DIR``, ``device_trace``, a caller's
  own ``torch.profiler.profile``) it is a profiler range of that name.
  The ranges are of the operator kind and not user annotations: the
  profiler mirrors a user annotation onto the device timeline as an
  interval from its first kernel to its last, which a reader of that
  timeline would count as a kernel and as busy time.
- ``count(name, n)`` adds to a process-level integer counter, always on;
  ``counts()`` reads them.
- ``StageTimers`` is the JAX package's wall-clock accumulator; each stage
  also opens the span ``meterelf.stream.<name>``, and ``report()`` prints
  the counters under the timers.
- ``device_trace`` records with ``torch.profiler`` in place of
  ``jax.profiler`` and writes a Chrome trace (open it in Perfetto or
  chrome://tracing).

The spans the port opens, all flat within one batch of the step:

| Span | Where |
| --- | --- |
| ``meterelf.step.backhalf`` | the coefficient step's uploads, JPEG back-half and fallback scatter (pipeline/decode.make_coef_decode_fn); on its graphs' path the input placement (pipeline/graphs.StepGraphs) and the slot choice |
| ``meterelf.step.graph`` | the graphs' path: the back-half and decode graphs' replays, the fallback scatter between them and the result's copy out of the graph |
| ``meterelf.decode.frontend`` | K1, or the scorer-only branch's lightness, score and locate |
| ``meterelf.decode.windows`` | K2 and its reshape |
| ``meterelf.decode.ccl`` | K3, or K6 (ops/ccl.analyze_batch) |
| ``meterelf.decode.stats`` | K4, or components.finalize |
| ``meterelf.decode.angles`` | the angle statistics and the value (ops/angles.py) |
| ``meterelf.decode.errors`` | K13 result_pack: the error codes, the converged reduction and the BatchResult in one buffer (ops/result.py) |
| ``meterelf.result.copy`` | to_host_later's copy (one of a packed result's buffer into pinned memory, else one a field) and event record |
| ``meterelf.result.wait`` | the host waiting for those copies, and the numpy views |
| ``meterelf.stream.{dispatch,drain,rescue}`` | the stream's StageTimers stages, around the spans above |
| ``meterelf.stream.feed`` | the stream's host entropy decode (bytes stream) |
| ``meterelf.api.host_decode``, ``meterelf.api.decode_numpy`` | get_meter_values's host decode and decode |

Counters: ``fallback_rows`` (rows the coefficient step overwrote with a
fallback slot), ``rescued_rows`` (non-converged rows that
``MeterDecoder.rescue_numpy`` decoded again under the rescue caps),
``step_graph_captures`` and ``step_graph_replays`` (CUDA graphs of the
coefficient step captured and replayed, pipeline/graphs.py) and
``step_graph_staged`` (steps whose device inputs were copied into a
graph's staging buffers).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

_profiling = torch._C._autograd._profiler_enabled
_OFF: ContextManager[None] = contextlib.nullcontext()
_COUNTS: Dict[str, int] = defaultdict(int)


def span(name: str) -> ContextManager[None]:
    """A profiler range named ``name`` while a profiler is active, else
    the shared no-op."""
    if not _profiling():
        return _OFF
    return _RecordFunctionFast(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process's counter ``name``."""
    _COUNTS[name] += n


def counts() -> Dict[str, int]:
    """The process's counters so far."""
    return dict(_COUNTS)


class StageTimers:
    """Accumulating wall-clock timers keyed by stage name; each stage is
    also the span ``meterelf.stream.<name>``."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span("meterelf.stream." + name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:24s} {t*1e3:9.1f} ms total  "
                         f"{t/n*1e3:8.2f} ms/call  x{n}")
        lines.extend(f"{name:24s} {n:9d}"
                     for name, n in sorted(counts().items()))
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler scope over the host's operators, the port's spans
    and, when a card is present, its kernels and copies; on exit writes
    ``<log_dir>/trace_<pid>_<time>.json`` (Chrome trace format). None
    traces nothing."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
