"""decode.stats.kernels (kernels): kernels launched a batch inside the
program's span ``meterelf.decode.stats``: K4 stats (or
components.finalize, ops/ccl.analyze_batch); None where the span did not
run or the window has no device events."""
from harness import spans


def read(w):
    return spans.kernels(w, "meterelf.decode.stats")
