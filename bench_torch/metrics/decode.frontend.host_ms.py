"""decode.frontend.host_ms (ms): the host's self time a batch in the
program's span ``meterelf.decode.frontend``: K1 frontend (or K5, or the
scorer-only branch's lightness, score and locate) in pipeline/decode.py
_decode_batch; None where the span did not run."""
from harness import spans


def read(w):
    return spans.host_ms(w, "meterelf.decode.frontend")
