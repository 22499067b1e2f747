"""The least time of K12's work (csrc/angles.cu, the angle stage) at a
cell's shapes, beside harness/roofline.py's bounds of the other kernels
and with its peaks: chip_smoke.py's K12 byte count, the slots taken from
the configuration (harness/reference.geometry), never from the
program."""
from __future__ import annotations

from typing import Dict

import numpy as np

from . import reference
from .roofline import INT32_OPS_PER_S, bound_ms

# bytes of the angle geometry as the program's C entry takes it: a disk
# slot's index (i32), valid flag (u8), sx2 and sy2 (f64); an annulus
# slot's index, flag, x, y, angle and squared distance; a dial's sign
# (i32) and zero turn (f64)
DISK_SLOT_BYTES = 4 + 1 + 2 * 8
ANN_SLOT_BYTES = 4 + 1 + 4 * 8
DIAL_BYTES = 4 + 8


def readout_ms(cfg: Dict, B: int) -> float:
    """K12: the okey3 pixels the dials' disk and annulus slots gather,
    each once (the annulus lies in the disk), and keymax read; the
    geometry of the dials' slots read once; the positions (f64), readable
    flags and values (f64) written. Its f64 adds take far less than the
    bytes."""
    g = reference.geometry(cfg)
    D = g.disk_idx.shape[0]
    px = sum(len(np.union1d(g.disk_idx[d][g.disk_ok[d]],
                            g.ann_idx[d][g.ann_ok[d]])) for d in range(D))
    geom = (int(g.disk_ok.sum()) * DISK_SLOT_BYTES
            + int(g.ann_ok.sum()) * ANN_SLOT_BYTES + D * DIAL_BYTES)
    return bound_ms(B * (px * 4 + D * 4) + geom + B * (D * 9 + 8), 0,
                    INT32_OPS_PER_S)
