"""decode.errors.kernels (kernels): kernels launched a batch inside the
program's span ``meterelf.decode.errors``: the error codes, the
converged reduction and the BatchResult (_decode_batch, _error_codes);
None where the span did not run or the window has no device events."""
from harness import spans


def read(w):
    return spans.kernels(w, "meterelf.decode.errors")
