"""decode.ccl.kernels (kernels): kernels launched a batch inside the
program's span ``meterelf.decode.ccl``: K3 ccl (or K6 propagate,
ops/ccl.analyze_batch); None where the span did not run or the window
has no device events."""
from harness import spans


def read(w):
    return spans.kernels(w, "meterelf.decode.ccl")
