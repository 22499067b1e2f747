"""step.backhalf.host_ms (ms): the host's self time a batch in the
program's span ``meterelf.step.backhalf``: the coefficient step's
uploads, JPEG back-half (K10, or the plain IDCT and K11) and fallback
scatter (pipeline/decode.py make_coef_decode_fn); None where the span
did not run."""
from harness import spans


def read(w):
    return spans.host_ms(w, "meterelf.step.backhalf")
