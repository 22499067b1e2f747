"""decode.ccl.host_ms (ms): the host's self time a batch in the
program's span ``meterelf.decode.ccl``: K3 ccl (or K6 propagate,
ops/ccl.analyze_batch); None where the span did not run."""
from harness import spans


def read(w):
    return spans.host_ms(w, "meterelf.decode.ccl")
