"""result.wait_ms (ms): the host's self time a batch in the program's
span ``meterelf.result.wait``: the host blocked until the result's
copies end, and the numpy views (to_host_later's fetch); None where the
span did not run."""
from harness import spans


def read(w):
    return spans.host_ms(w, "meterelf.result.wait")
