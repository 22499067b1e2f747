"""result.copy_ms (ms): the host's self time a batch in the program's
span ``meterelf.result.copy``: the result's non-blocking copies to the
host and the event record (pipeline/decode.py to_host_later); None where
the span did not run."""
from harness import spans


def read(w):
    return spans.host_ms(w, "meterelf.result.copy")
