"""Connected-component propagation and marching-squares cell
contributions per 64x64 window, in plain torch.

Port of meterelf_tpu/ops/components.py ``_propagate_xla`` and
``_cell_contrib`` (see that module for why these reproduce
cv2.findContours(RETR_EXTERNAL) / contourArea / drawContours). The pass
schedule, the segmented-scan offset trick and the convergence flags are
the same:

- labels: each half-pass is a 3x3 min glue then segmented cummin sweeps
  along rows, then columns, forward on even halves and backward on odd
  ones, at most k_label halves;
- outside: the background 4-connected to beyond the dial disk, the same
  halves with any4 glue and segmented OR sweeps, at most k_outside;
- fill: enclosed holes take the min label around them, at most k_fill;
- a phase converged when its last pass changed nothing. The loops stop
  once a pass changes no window of the batch: the passes are monotone,
  so that is the state and the flag of running every pass.

``propagate`` is the plain version of K3 (ops/ccl.py); ``cell_contrib``
feeds the plain version of K4 (ops/stats.py).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

W = 64
N = W * W

# pass caps (components.K_LABEL_HYBRID, K_OUTSIDE_HYBRID, K_FILL)
K_LABEL = 10
K_OUTSIDE = 6
K_FILL = 8
# generous caps for windows the default caps leave non-converged
# (components.RESCUE_CAPS)
RESCUE_CAPS = (192, 96, 192)

_SEG_BASE = 8192  # > any label value
# half-pass sweep directions: (axis, reverse) for rows then columns
_ALT_DIRS = (((-1, False), (-2, False)), ((-1, True), (-2, True)))

Walls = Dict[Tuple[int, bool], torch.Tensor]


def _scan(op: Callable, x: torch.Tensor, dim: int, reverse: bool
          ) -> torch.Tensor:
    if reverse:
        return torch.flip(op(torch.flip(x, [dim]), dim), [dim])
    return op(x, dim)


def _cummax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cummax(x, dim).values


def _make_walls(wall: torch.Tensor) -> Walls:
    """Run ids for segmented scans: rid[i] = walls at-or-before i in
    scan order, per (axis, reverse)."""
    w = wall.to(torch.int32)
    return {(axis, rev): _scan(torch.cumsum, w, axis, rev).to(torch.int32)
            for axis in (-1, -2) for rev in (False, True)}


def _seg_min_sweep(vals: torch.Tensor, walls: Walls, dirs: Sequence
                   ) -> torch.Tensor:
    for axis, rev in dirs:
        rid = walls[(axis, rev)]
        vp = rid * _SEG_BASE + (_SEG_BASE - 1 - vals)
        m = _scan(_cummax, vp, axis, rev)
        vals = (_SEG_BASE - 1) - (m - rid * _SEG_BASE)
    return vals


def _seg_or_sweep(vals: torch.Tensor, walls: Walls, dirs: Sequence
                  ) -> torch.Tensor:
    for axis, rev in dirs:
        rid = walls[(axis, rev)]
        vp = rid * 2 + vals.to(torch.int32)
        m = _scan(_cummax, vp, axis, rev)
        vals = (m - rid * 2) > 0
    return vals


def _shifts3(x: torch.Tensor, fill: int) -> list:
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return [p[..., dy:dy + W, dx:dx + W] for dy in range(3)
            for dx in range(3)]


def _min3x3(x: torch.Tensor, big: int) -> torch.Tensor:
    out = x
    for v in _shifts3(x, big):
        out = torch.minimum(out, v)
    return out


def _any8(x: torch.Tensor) -> torch.Tensor:
    return torch.stack(_shifts3(x.to(torch.uint8), 0)).amax(0) > 0


def _any4(x: torch.Tensor) -> torch.Tensor:
    s = _shifts3(x.to(torch.uint8), 0)
    return (s[1] | s[3] | s[5] | s[7]) > 0


def _iterate(k_max: int, body: Callable, x0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to k_max passes of body(i, x) -> (x, per-window "the last pass
    changed nothing")."""
    x = x0
    eq = torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device)
    for i in range(k_max):
        nx = body(i, x)
        eq = (nx == x).flatten(1).all(1)
        x = nx
        if bool(eq.all()):
            break
    return x, eq


def propagate(bits: torch.Tensor, caps: Optional[Sequence[int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, 64, 64] i32 window bits (masked | disk<<1 | closed<<2) ->
    (okey3 i32 [K, 64, 64], converged bool [K]), okey3 = owner*8 +
    closed*4 + masked*2 + boundary with owner = 4096 off the support."""
    k_label, k_outside, k_fill = caps or (K_LABEL, K_OUTSIDE, K_FILL)
    dev = bits.device
    masked = (bits & 1) != 0
    disk = (bits & 2) != 0
    closed = (bits >> 2) & 1
    big = torch.tensor(N, dtype=torch.int32, device=dev)
    idx = torch.arange(N, dtype=torch.int32, device=dev).reshape(W, W)

    label_walls = _make_walls(~masked)

    def label_half(i: int, lab: torch.Tensor) -> torch.Tensor:
        lab = torch.where(masked, torch.minimum(lab, _min3x3(lab, N)), big)
        lab = _seg_min_sweep(lab, label_walls, _ALT_DIRS[i % 2])
        return torch.where(masked, lab, big)

    labels, lab_eq = _iterate(k_label, label_half,
                              torch.where(masked, idx, big))

    bg = ~masked
    bg_walls = _make_walls(masked)

    def out_half(i: int, out: torch.Tensor) -> torch.Tensor:
        out = out | (bg & _any4(out))
        out = _seg_or_sweep(out, bg_walls, _ALT_DIRS[i % 2])
        return out & bg

    outside, out_eq = _iterate(k_outside, out_half, bg & ~disk)
    enclosed = bg & ~outside
    support = masked | enclosed

    def fill(i: int, own: torch.Tensor) -> torch.Tensor:
        return torch.where(enclosed, torch.minimum(own, _min3x3(own, N)),
                           own)

    owner, fill_eq = _iterate(k_fill, fill, labels)
    boundary = masked & _any8(outside)
    okey3 = (torch.where(support, owner, big) * 8 + closed * 4
             + masked.to(torch.int32) * 2 + boundary.to(torch.int32))
    return okey3, lab_eq & out_eq & fill_eq


def cell_contrib(owner: torch.Tensor) -> torch.Tensor:
    """Per-pixel marching-squares area contributions (2x scale): each
    2x2 cell whose corner minimum m is an owner (< 4096) adds 2 when all
    four corners equal m and 1 when three do, to its first corner equal
    to m in raster order. owner: [..., 64, 64] i32 -> i32 same shape."""
    o00 = owner[..., :-1, :-1]
    o01 = owner[..., :-1, 1:]
    o10 = owner[..., 1:, :-1]
    o11 = owner[..., 1:, 1:]
    m = torch.minimum(torch.minimum(o00, o01), torch.minimum(o10, o11))
    e00, e01, e10, e11 = (o00 == m), (o01 == m), (o10 == m), (o11 == m)
    i32 = torch.int32
    k = e00.to(i32) + e01.to(i32) + e10.to(i32) + e11.to(i32)
    has = m < N
    cls = torch.where(has & (k == 4), 2, torch.where(has & (k == 3), 1, 0))
    cls = cls.to(i32)
    a01 = e01 & ~e00
    a10 = e10 & ~e00 & ~e01
    a11 = e11 & ~e00 & ~e01 & ~e10
    return (F.pad(cls * e00, (0, 1, 0, 1)) + F.pad(cls * a01, (1, 0, 0, 1))
            + F.pad(cls * a10, (0, 1, 1, 0))
            + F.pad(cls * a11, (1, 0, 1, 0)))
