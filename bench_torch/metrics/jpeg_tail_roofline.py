"""jpeg_tail_roofline (%): K10, the JPEG back-half (ops/jpeg_tail.py,
csrc/jpeg.cu backhalf_planes): the least time of its work at the cell's
shapes (harness/roofline.py) over its profiler time a batch in the
traced window; None where it did not run. The bound counts the feed's
wire: compact int8 unless METERELF_COEF_COMPACT=0."""
from harness import roofline


def read(w):
    s = w.kernel_s("backhalf_planes_kernel")
    if s is None:
        return None
    bound = roofline.jpeg_tail_ms(w.context["cfg"], w.context["batch"],
                                  w.context.get("compact", True))
    return 100.0 * bound / (1e3 * s / w.units)
