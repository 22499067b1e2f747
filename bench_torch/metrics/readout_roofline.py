"""readout_roofline (%): K12, the angle stage (ops/angles.py readout,
csrc/angles.cu): the least time of its work at the cell's shapes
(harness/readout_bound.py) over its profiler time a batch in the traced
window; None where it did not run."""
from harness import readout_bound


def read(w):
    s = w.kernel_s("readout_kernel")
    if s is None:
        return None
    bound = readout_bound.readout_ms(w.context["cfg"], w.context["batch"])
    return 100.0 * bound / (1e3 * s / w.units)
