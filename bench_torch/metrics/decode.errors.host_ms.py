"""decode.errors.host_ms (ms): the host's self time a batch in the
program's span ``meterelf.decode.errors``: the error codes, the
converged reduction and the BatchResult (_decode_batch, _error_codes);
None where the span did not run."""
from harness import spans


def read(w):
    return spans.host_ms(w, "meterelf.decode.errors")
