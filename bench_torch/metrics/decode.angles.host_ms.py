"""decode.angles.host_ms (ms): the host's self time a batch in the
program's span ``meterelf.decode.angles``: the f64 angle statistics and
the value (ops/angles.py read_dials or read_dials_region,
assemble_value); None where the span did not run."""
from harness import spans


def read(w):
    return spans.host_ms(w, "meterelf.decode.angles")
