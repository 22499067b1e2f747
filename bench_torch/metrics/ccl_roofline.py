"""ccl_roofline (%): K3 on the quad branch, K6 on the general branch
(ops/ccl.py, csrc/ccl.cu, one kernel body): the least time of its work
at the cell's shapes (harness/roofline.py) over its profiler time a
batch in the traced window; None where it did not run."""
from harness import roofline


def read(w):
    s = w.kernel_s("ccl_kernel")
    if s is None:
        return None
    bound = roofline.ccl_ms(w.context["cfg"], w.context["batch"])
    return 100.0 * bound / (1e3 * s / w.units)
