"""Observability: stage timers and the device profiler.

Port of meterelf_tpu/profiling.py. ``StageTimers`` is the JAX package's,
unchanged; ``device_trace`` records with ``torch.profiler`` in place of
``jax.profiler`` and writes a Chrome trace (open it in Perfetto or
chrome://tracing).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class StageTimers:
    """Accumulating wall-clock timers keyed by stage name."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler scope over the host's operators and, when a card is
    present, its kernels and copies; on exit writes
    ``<log_dir>/trace_<pid>_<time>.json`` (Chrome trace format). None
    traces nothing."""
    if log_dir is None:
        yield
        return
    import torch
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
