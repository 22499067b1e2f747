"""decode.windows.kernels (kernels): kernels launched a batch inside the
program's span ``meterelf.decode.windows``: K2 windows and its reshape
in _decode_batch; None where the span did not run or the window has no
device events."""
from harness import spans


def read(w):
    return spans.kernels(w, "meterelf.decode.windows")
