"""Reading a torch.profiler window: device intervals, kernel times by
name, host operators, the busy share and the breakdown, and the spans
the entries record. Per-layer readers (bench_torch/metrics/)
get a ``Window`` and return a number or None."""
from __future__ import annotations

import contextlib
import importlib
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

Interval = Tuple[float, float]
NAME_CHARS = 160   # of a kernel's name in the breakdown (templates run long)


class Spans:
    """Named spans (host seconds) that the entries record from the
    benchmark's own files, around calls into the program."""

    def __init__(self) -> None:
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t)

    def mean_ms(self, name: str) -> Optional[float]:
        s = self.spans.get(name)
        return 1e3 * sum(s) / len(s) if s else None


@contextlib.contextmanager
def host_labels(paths: List[str]) -> Iterator[None]:
    """Wrap each program function ``module:name`` in a profiler label
    while the block runs (trace runs only), so that idle gaps name what
    the host was doing; restored on exit."""
    import torch

    saved = []
    for p in paths:
        mod_name, attr = p.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        def wrapped(*a: Any, _fn: Any = fn, _name: str = attr,
                    **k: Any) -> Any:
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)

        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _union(iv: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Window:
    """One traced window: ``units`` batches in ``window_s`` seconds of
    host time, with the profiler's device and host events (microseconds,
    the profiler's clock)."""

    def __init__(self, prof: Any, window_s: float, units: int,
                 context: Dict[str, Any], spans: Spans) -> None:
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.units = units
        self.context = context
        self.spans = spans
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float, bool]] = []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                self.device.append((e.name, tr.start, tr.end))
            elif e.device_type == DeviceType.CPU:
                self.host.append((e.name, tr.start, tr.end,
                                  e.cpu_parent is None))
        self.busy = _union([(s, e) for _, s, e in self.device])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def kernel_s(self, key: str) -> Optional[float]:
        """Device seconds of the kernels whose name holds ``key``; None
        when none ran."""
        t = [e - s for n, s, e in self.device if key in n]
        return sum(t) / 1e6 if t else None

    def n_kernels(self) -> int:
        return sum(1 for n, _, _ in self.device
                   if not n.startswith(("Memcpy", "Memset")))

    def n_host(self, prefix: str) -> int:
        return sum(1 for n, *_ in self.host if n.startswith(prefix))

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        """The ten device operations that took most time, and the ten
        longest idle stretches summed by the host operator running at
        their middle."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.device:
            n = n[:NAME_CHARS]
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        top = sorted((s, e, n) for n, s, e, root in self.host if root)
        gaps: Dict[str, float] = {}
        for (_, a), (b, _) in zip(self.busy, self.busy[1:]):
            mid = (a + b) / 2
            label = "host, no profiled operator"
            for s, e, n in top:
                if s <= mid <= e:
                    label = n
                if s > mid:
                    break
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}
