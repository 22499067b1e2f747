"""step.backhalf.kernels (kernels): kernels launched a batch inside the
program's span ``meterelf.step.backhalf``: the coefficient step's
uploads, JPEG back-half (K10, or the plain IDCT and K11) and fallback
scatter (pipeline/decode.py make_coef_decode_fn); None where the span
did not run or the window has no device events."""
from harness import spans


def read(w):
    return spans.kernels(w, "meterelf.step.backhalf")
