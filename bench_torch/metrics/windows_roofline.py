"""windows_roofline (%): K2, the dial windows (ops/windows.py,
csrc/windows.cu): the least time of its work at the cell's shapes
(harness/roofline.py) over its profiler time a batch in the traced
window; None where it did not run."""
from harness import roofline


def read(w):
    s = w.kernel_s("windows_kernel")
    if s is None:
        return None
    bound = roofline.windows_ms(w.context["cfg"], w.context["batch"])
    return 100.0 * bound / (1e3 * s / w.units)
