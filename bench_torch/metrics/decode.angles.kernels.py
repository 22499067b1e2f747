"""decode.angles.kernels (kernels): kernels launched a batch inside the
program's span ``meterelf.decode.angles``: the f64 angle statistics and
the value (ops/angles.py read_dials or read_dials_region,
assemble_value); None where the span did not run or the window has no
device events."""
from harness import spans


def read(w):
    return spans.kernels(w, "meterelf.decode.angles")
