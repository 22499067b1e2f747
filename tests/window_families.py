"""Window inputs of the K2/K5 and K4/K7 tests, in numpy: the CPU model
(test_torch_window_words.py) and the card cases (test_torch_cuda.py) use
the same ones. Imports nothing of JAX (the card's machine has none).

Window families for K2 (each window 64x64, its dial colour sample at
(cx, cy)), with the dial centres at 0, 1, 2, 61, 62 and 63 (sample starts
that wrap and clamp), and okey3 windows for K4/K7: one owner over the
whole window (worst contention; area2 and bcount at their maxima), 4096
owners, only the sentinel, owners alternating along the rows, blocks of
owners, and windows of the plain propagation.
"""
import numpy as np
import torch

from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import components

W = 64
N = W * W
SENT = N   # the sentinel owner


def sample_start(c):
    """Start of the 5x5 colour sample around centre c (csrc/window_bits.cuh
    sample_start): a negative start wraps by +64, then clamps."""
    s = c - 2
    return min(max(s + W if s < 0 else s, 0), W - 5)


RED, NEAR, WHITE, BLACK = (40, 40, 200), (50, 45, 190), (235, 235, 235), \
    (0, 0, 0)
# (cx, cy) of dials 0-3: centres 0, 1, 2 wrap the sample to the far edge,
# 61-63 clamp it
CENTRES = ((0, 63), (1, 62), (2, 61), (63, 0))
INNER = ((2, 61), (31, 32), (61, 2), (10, 50))
FAMILIES = ("all_in", "none_in", "checkerboard", "edges", "layers",
            "random")
GREY = (120, 120, 120)   # red's lightness, no saturation
PALE = (78, 78, 162)     # red's lightness, S = 89: one below red's range


def family_window(name, cx, cy, rng):
    """One 64x64 BGR window: every pixel in range (uniform red), none (a
    black and white checkerboard: a grey mean in no pixel's range), a red
    and white checkerboard, red on every window edge, layers of white
    (lightness out), grey (saturation out), pale red (saturation one unit
    below the range) and near-red rows, random colours with 30 % near-red;
    the last four with a solid red 5x5 sample."""
    w = np.empty((W, W, 3), np.uint8)
    yy, xx = np.mgrid[:W, :W]
    even = ((yy + xx) % 2 == 0)[..., None]
    if name == "all_in":
        w[:] = RED
    elif name == "none_in":
        w[:] = np.where(even, WHITE, BLACK)
    elif name == "checkerboard":
        w[:] = np.where(even, RED, WHITE)
    elif name == "edges":
        w[:] = WHITE
        w[[0, -1], :] = RED
        w[:, [0, -1]] = RED
    elif name == "layers":
        w[:16] = WHITE
        w[16:32] = GREY
        w[32:48] = PALE
        w[48:] = NEAR
    else:
        w[:] = rng.integers(0, 256, (W, W, 3))
        w[rng.random((W, W)) < 0.3] = NEAR
    if name in ("checkerboard", "edges", "layers", "random"):
        sx, sy = sample_start(cx), sample_start(cy)
        w[sy:sy + 5, sx:sx + 5] = RED
    return w


def family_case(name, B, seed, D=4, centres=CENTRES):
    """Packed crops [B, 64 * ceil(D / 3) + 2, 194] holding D disjoint
    windows of the family ("mixed": family (b + d) % 6 in window (b, d))
    at (mx + ox, my + oy), mx, my in {0, 1}; the geometry tuples (ox, oy,
    cx, cy, cr_h, cr_l, cr_s), mx, my and the dials' disks [D, 64, 64]."""
    rng = np.random.default_rng(seed)
    H = W * -(-D // 3) + 2
    crops = rng.integers(0, 256, (B, H, 3 * W + 2, 3)).astype(np.uint8)
    mx = rng.integers(0, 2, B).astype(np.int32)
    my = rng.integers(0, 2, B).astype(np.int32)
    geom = []
    for d in range(D):
        ox, oy = W * (d % 3), W * (d // 3)
        cx, cy = centres[d % 4]
        geom.append((ox, oy, cx, cy, 15, 60, 80))
        for b in range(B):
            fam = FAMILIES[(b + d) % len(FAMILIES)] if name == "mixed" \
                else name
            crops[b, my[b] + oy:my[b] + oy + W, mx[b] + ox:mx[b] + ox + W] = \
                family_window(fam, cx, cy, rng)
    yy, xx = np.mgrid[:W, :W]
    disk = np.stack([(yy - 32) ** 2 + (xx - 32) ** 2 <= (20 + d) ** 2
                     for d in range(D)]).astype(np.uint8)
    return tio.pack_crops(crops), mx, my, tuple(geom), disk


def _okey3(owner, boundary, closed=None, masked=None):
    closed = np.ones_like(owner) if closed is None else closed
    masked = closed if masked is None else masked
    return (owner * 8 + closed * 4 + masked * 2 + boundary).astype(np.int32)


def _propagated(density, seed, K=6):
    """okey3 windows of the port's plain propagation (tests/test_ops.py
    572-591 inputs: random closed masks, half with a blob, in a disk)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:W, :W]
    disk = (yy - 32) ** 2 + (xx - 32) ** 2 <= 23 ** 2
    closed = rng.random((K, W, W)) < density
    for k in range(K // 2):
        cy, cx = rng.integers(16, 48, 2)
        closed[k] |= ((yy - cy) ** 2 + (xx - cx) ** 2) <= 64
    masked = closed & disk
    bits = masked + 2 * disk + 4 * closed.astype(np.int32)
    return components.propagate(torch.as_tensor(bits.astype(np.int32)))[0] \
        .numpy()


STATS_CASES = ("alternating", "blocks", "one_owner", "owners_4096",
               "propagated", "sentinel_only")


def stats_cases():
    yy, xx = np.mgrid[:W, :W]
    rng = np.random.default_rng(11)
    one = np.ones((1, W, W), np.int64)
    zero = np.zeros((1, W, W), np.int64)
    blocks = np.where(((xx // 3) + (yy // 5)) % 3 == 0, SENT,
                      100 + (xx // 3) % 7 + 10 * ((yy // 5) % 4))[None]
    return {
        # worst contention and both fields at their maxima: area2 7938
        # (63 x 63 cells x 2), bcount 4096
        "one_owner": _okey3(np.full((1, W, W), 77), one),
        "owners_4096": _okey3(np.arange(N).reshape(1, W, W), one),
        "sentinel_only": _okey3(np.full((1, W, W), SENT), zero, zero),
        # owners alternating along the rows: every lane meets two keys
        "alternating": _okey3(np.where(xx % 2 == 0, 5, 9)[None],
                              (rng.random((1, W, W)) < 0.5).astype(int)),
        "blocks": _okey3(blocks, (rng.random((1, W, W)) < 0.3)
                         * (blocks < SENT)),
        "propagated": _propagated(0.3, 7),
    }
