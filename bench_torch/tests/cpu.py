"""One run of the benchmark on the CPU, at a size a test run holds, for
the self-checks: for the length of the run, a stand-in takes the card's
place in run.py, the cell's traffic takes smaller parameters, and two
processes render the frames. A measured run has none of this."""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Any, Dict, Iterator, Optional
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import run  # noqa: E402

# cells whose entry, traffic and readers are in bench_torch/ but that
# BENCHMARK.json does not list (PERF.md, Open questions)
PARKED = [{"name": "flagship.stream", "config": "flagship",
           "traffic": "stream", "chips": 1},
          {"name": "flagship.api", "config": "flagship", "traffic": "api",
           "chips": 1}]

SMALL = {
    "flagship.stream": {"batch": 8, "pool": 16, "warm_reports": 1,
                        "trace_reports": 3, "probe_batches": 2},
    "flagship.resident": {"batch": 8, "pool": 16, "warm_batches": 1,
                          "trace_batches": 3, "keep_every": 1,
                          "num_threads": 2},
    "flagship.api": {"batch": 8, "pool": 16, "empty": 1, "truncated": 1,
                     "warm_records": 8, "trace_records": 16,
                     "probe_reps": 1},
}


class HostCard:
    """The CPU in the card's place: nothing to build, sync or free."""

    device = "cpu"

    def __init__(self, torch: Any, chips: int) -> None:
        from torch.profiler import ProfilerActivity

        self.activities = [ProfilerActivity.CPU]

    def build(self) -> None:
        pass

    sync = reset_peak = free = build

    def peak(self) -> int:
        return 0

    def describe(self) -> Dict[str, Any]:
        return {"platform": "cpu", "kind": "cpu", "power": ""}


@contextlib.contextmanager
def small(cell: str) -> Iterator[None]:
    bench = run.benchmark()
    listed = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [w for w in PARKED if w["name"] not in listed]
    cell_files = run.cell_files

    def smaller(name: str) -> Dict[str, Any]:
        files = cell_files(name)
        files["traffic"] = dict(files["traffic"], **SMALL[cell])
        return files

    with mock.patch.object(run, "Card", HostCard), \
            mock.patch.object(run, "benchmark", lambda: bench), \
            mock.patch.object(run, "cell_files", smaller), \
            mock.patch.object(run, "RENDER_WORKERS", 2):
        yield


def run_small(cell: str, seed: int = 2**34 + 9, trace: int = 0,
              seconds: Optional[float] = 2) -> Dict[str, Any]:
    with small(cell):
        return run.run(["--workload", cell, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)])
