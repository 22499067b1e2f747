"""decode.frontend.kernels (kernels): kernels launched a batch inside
the program's span ``meterelf.decode.frontend``: K1 frontend (or K5, or
the scorer-only branch's lightness, score and locate) in
pipeline/decode.py _decode_batch; None where the span did not run or the
window has no device events."""
from harness import spans


def read(w):
    return spans.kernels(w, "meterelf.decode.frontend")
