"""The program's own spans in a traced window (meterelf_tpu_torch/
profiling.py: ``meterelf.*`` ranges on the profiler's clock, read from
``Window.host``): each span's self time and the kernels launched inside
it, for the per-layer readers of bench_torch/metrics/.

A span's self time is its duration less the part its child ``meterelf.*``
spans cover (the stream's stage spans hold the step's). A kernel belongs
to the innermost span whose interval holds its launch's host runtime
event (``cudaLaunchKernel``, ``cuLaunchKernel`` and their variants): the
launch is synchronous on the thread that opened the span. The spans are
opened on one thread, so two of them nest or are disjoint."""
from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from typing import Any, Dict, NamedTuple, Optional

PREFIX = "meterelf."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel",
            "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")


class Table(NamedTuple):
    self_us: Dict[str, float]   # summed over the window
    runs: Dict[str, int]
    kernels: Dict[str, int]     # launches whose innermost span it is
    outside: int                # launches inside no span


def table(w: Any) -> Table:
    """The window's span table, computed once a window."""
    t = getattr(w, "_program_spans", None)
    if t is None:
        t = w._program_spans = _table(w.host)
    return t


def _table(host: Any) -> Table:
    # parents first where two spans start together
    spans = sorted(((s, e, n) for n, s, e, _ in host
                    if n.startswith(PREFIX)), key=lambda x: (x[0], -x[1]))
    parent = []
    stack: list = []
    for s, e, _ in spans:
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(len(parent) - 1)
    covered = [0.0] * len(spans)
    for i, (s, e, _) in enumerate(spans):
        p = parent[i]
        if p >= 0:
            ps, pe, _ = spans[p]
            covered[p] += min(e, pe) - max(s, ps)
    self_us: Dict[str, float] = defaultdict(float)
    runs: Dict[str, int] = defaultdict(int)
    for (s, e, n), c in zip(spans, covered):
        self_us[n] += (e - s) - c
        runs[n] += 1
    starts = [s for s, _, _ in spans]
    kernels: Dict[str, int] = defaultdict(int)
    outside = 0
    for n, t, _, _ in host:
        if not n.startswith(LAUNCHES):
            continue
        j = bisect_right(starts, t) - 1
        while j >= 0 and spans[j][1] < t:
            j = parent[j]
        if j < 0:
            outside += 1
        else:
            kernels[spans[j][2]] += 1
    return Table(dict(self_us), dict(runs), dict(kernels), outside)


def host_ms(w: Any, name: str) -> Optional[float]:
    """Self time of span ``name`` a unit of the window, in ms; None where
    it did not run."""
    t = table(w)
    if not t.runs.get(name):
        return None
    return t.self_us[name] / 1e3 / w.units


def kernels(w: Any, name: str) -> Optional[float]:
    """Kernels launched inside span ``name`` a unit of the window; None
    where it did not run or the window has no device events."""
    t = table(w)
    if not w.device or not t.runs.get(name):
        return None
    return t.kernels.get(name, 0) / w.units
