"""decode.windows.host_ms (ms): the host's self time a batch in the
program's span ``meterelf.decode.windows``: K2 windows and its reshape
in _decode_batch; None where the span did not run."""
from harness import spans


def read(w):
    return spans.host_ms(w, "meterelf.decode.windows")
