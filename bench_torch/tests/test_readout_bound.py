"""CPU self-check of K12's bound (harness/readout_bound.py), run with the
benchmark's other self-checks (``python -m pytest bench_torch/tests
-q``): the flagship's K12 bytes at B = 256 take within 1 % of the
0.001618 ms that chip_smoke.py's count over the program's padded
geometry gives."""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

from control import config as cfg_of  # noqa: E402
from harness import readout_bound  # noqa: E402

CHIP_SMOKE_BOUND_MS = 0.001618


def test_readout_bound_is_chip_smokes():
    got = readout_bound.readout_ms(cfg_of("flagship"), 256)
    assert abs(got - CHIP_SMOKE_BOUND_MS) <= 0.01 * CHIP_SMOKE_BOUND_MS
