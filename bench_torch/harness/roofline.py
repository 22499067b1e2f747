"""The least time each kernel's work can take on the card, from the
cell's shapes and what the algorithm needs (never from what a kernel
executes), so that a redesign is read against the same work.

Copy of chip_smoke.py's arithmetic (``bound``, ``backhalf_blocks_needed``,
``OPS_PER_*`` and the per-kernel byte and operation counts of its k1-k4
and k10 phases); chip_smoke.py keeps its own.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity), which assumes
the full 700 W power limit: HBM3 at 3.35 TB/s, int8 tensor cores at 1,979
TOP/s, fp32 at 67 TFLOP/s; int32: the CUDA C++ Programming Guide's
throughput for compute capability 9.0, 64 results a clock an SM for
32-bit add, shift, compare and logic and 64 for 32-bit multiply-add,
both full: 128 a clock on 132 SMs at the 1.98 GHz boost clock. The run
prints the card's power limit beside every share.
"""
from __future__ import annotations

from typing import Dict

from . import gen

HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9

# int32 operations the JPEG back-half needs (chip_smoke.py): per 8x8 block
# 16 ISLOW butterflies of 62 ops and per coefficient 1 dequantising
# multiply and 3 for the level shift and clamp, 4 more to unpack the
# compact wire; per crop pixel 2 x (1 + 4) for the chroma filter and 26
# for colour, clamp and pack
OPS_PER_BLOCK = 16 * 62 + (1 + 3) * 64
OPS_PER_BLOCK_COMPACT_UNPACK = 4 * 64
OPS_PER_PIXEL_TAIL = 2 * (1 + 4) + 26
K2_FP32_OPS_PX = 30      # exact HLS, colour sample, inRange, close
K4_INT32_OPS_PX = 8      # the 2x2 cell minimum and its corner count
WIN = 64


def bound_ms(nbytes: float, ops: float, ops_per_s: float) -> float:
    """max(bytes over the HBM rate, operations over their peak) in ms:
    each input byte read once, each output byte written once."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s) * 1e3


def _crop(cfg: Dict):
    x0, y0, x1, y1 = gen.rect_of(cfg)
    return y1 - y0, x1 - x0


def frontend_ms(cfg: Dict, B: int) -> float:
    """K1: the template match's int8 MACs at every valid offset; the
    packed crops read, the template, and (max, x, y) written."""
    H, W = _crop(cfg)
    th, tw = cfg["template"]["height"], cfg["template"]["width"]
    macs = B * (H - th + 1) * (W - tw + 1) * th * tw
    return bound_ms(B * H * W * 4 + th * tw + 12 * B, 2 * macs,
                    INT8_TC_OPS_PER_S)


def windows_ms(cfg: Dict, B: int) -> float:
    """K2: the dial windows' pixels read and their bits written, the
    disks, the offsets; K2_FP32_OPS_PX a window pixel."""
    D = len(cfg["dials"])
    px = B * D * WIN * WIN
    return bound_ms(px * 8 + D * WIN * WIN + 8 * B, K2_FP32_OPS_PX * px,
                    FP32_OPS_PER_S)


def ccl_ms(cfg: Dict, B: int) -> float:
    """K3 (and K6 on the general branch): window bits read, keys written,
    a flag a window. The operations of the passes each window needs lie
    below this at these shapes (chip_smoke.py's ccl phase counts them
    from the passes the windows run), so the bytes bound it."""
    K = B * len(cfg["dials"])
    return bound_ms(K * WIN * WIN * 8 + K, 0, INT32_OPS_PER_S)


def stats_ms(cfg: Dict, B: int) -> float:
    """K4: okey3 read, keymax and has_any written."""
    K = B * len(cfg["dials"])
    px = K * WIN * WIN
    return bound_ms(px * 4 + 5 * K, K4_INT32_OPS_PX * px, INT32_OPS_PER_S)


def backhalf_blocks_needed(cfg: Dict) -> int:
    """The 8x8 blocks (luma and both chroma planes) that the crop's
    pixels depend on: the luma blocks under the crop, and the chroma
    blocks under its chroma rows and columns plus the one-sample filter
    halo, clamped at the valid chroma."""
    cy0, cx0, cy1, cx1 = gen.coef_window(cfg)
    x0, y0, x1, y1 = gen.rect_of(cfg)
    fw, fh = cfg["frame"]["width"], cfg["frame"]["height"]
    oy, ox, rh, rw = y0 - 16 * cy0, x0 - 16 * cx0, y1 - y0, x1 - x0
    ch_valid = min(8 * (cy1 - cy0), (fh + 1) // 2 - 8 * cy0)
    cw_valid = min(8 * (cx1 - cx0), (fw + 1) // 2 - 8 * cx0)

    def span(lo: int, hi: int) -> int:
        return (hi >> 3) - (lo >> 3) + 1

    luma = span(oy, oy + rh - 1) * span(ox, ox + rw - 1)
    chroma = (span(max((oy >> 1) - 1, 0),
                   min(((oy + rh - 1) >> 1) + 1, ch_valid - 1))
              * span(max((ox >> 1) - 1, 0),
                     min(((ox + rw - 1) >> 1) + 1, cw_valid - 1)))
    return luma + 2 * chroma


def feed_bytes(cfg: Dict, compact: bool = True) -> int:
    """Bytes of one frame's feed as K10 reads it: the window's three
    frequency planes (compact int8 wire: 3/2 bytes a coefficient; dense:
    2) and three i16 quantisation tables."""
    cy0, cx0, cy1, cx1 = gen.coef_window(cfg)
    coefs = 6 * 64 * (cy1 - cy0) * (cx1 - cx0)
    return (coefs * 3 // 2 if compact else coefs * 2) + 3 * 64 * 2


def jpeg_tail_ms(cfg: Dict, B: int, compact: bool = True) -> float:
    """K10: the int32 operations of the blocks the crop needs and of the
    crop's pixels; the feed read and the packed crops written."""
    rh, rw = _crop(cfg)
    per_block = OPS_PER_BLOCK + (OPS_PER_BLOCK_COMPACT_UNPACK if compact
                                 else 0)
    ops = B * (backhalf_blocks_needed(cfg) * per_block
               + rh * rw * OPS_PER_PIXEL_TAIL)
    nbytes = B * (feed_bytes(cfg, compact) + rh * rw * 4)
    return bound_ms(nbytes, ops, INT32_OPS_PER_S)

