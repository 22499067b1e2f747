"""Needle angles and the 4-dial value, in plain torch (f64 sums on the
device).

Port of meterelf_tpu/ops/angles.py read_dial_from_okey, read_dial,
_read_dial_core and assemble_value, batched over [B, D] windows instead
of vmapped. On the quad branch the needle region is derived at the
static disk and annulus slots straight from okey3 and the stats key (big
blob: owner == selected, else the closed mask); on the general branch it
is gathered from components.finalize's needle region. Then the
momentum, the half-plane tip filter, the cyclic trim over the static
(angle, sqdist) slot order and the weighted mean, in float64 as the
reference computes them (see the original module for why each step is
exact). As in the JAX package, the geometry's own dtype ``f`` (float64,
or float32 for ``MeterDecoder(exact=False)``) carries the minimum angle,
the 0.75-turn test, the rebasing by one turn and the trim weights; every
sum is taken in float64.

The float64 sums run in the order in which the JAX package's graph sums
them on the CPU (``tree_sum``: XLA's tree-reduction rewrite, runs of 32
in index order), so a dial position has the JAX package's bits, on the
card as on the CPU: the DEBUG output prints them in full.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..params import DeviceParams

RUN = 32   # XLA CPU's tree-reduction window


def _run_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order, from 0.0: the last row of a
    cumulative sum along a leading axis. torch scans a dimension that is
    not the innermost with one sequential loop a column (0.0 + x0, then
    + x1, ...), on the CPU and on the card alike (its outer-dimension
    scan kernel: one launch); with a single column the card would take
    another, parallel scan, so x must have more than one."""
    if x.numel() == x.shape[-1]:
        raise ValueError("_run_sum needs more than one column")
    return torch.cumsum(x.movedim(-1, 0), dim=0)[-1]


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of XLA's CPU backend for a long
    float reduction (its tree-reduction rewrite): zero-padded, evenly on
    both sides, to a multiple of RUN, each run of RUN summed in index
    order, again until RUN or fewer partial sums are left, which are
    summed in order. Every step is one IEEE add, so the card and the CPU
    give the same bits as the JAX package's graph. x holds at least two
    sums (the callers stack two)."""
    while x.shape[-1] > RUN:
        n = x.shape[-1]
        pad = -n % RUN
        x = F.pad(x, (pad // 2, pad - pad // 2)).unflatten(-1, (-1, RUN))
        x = _run_sum(x)
    return _run_sum(x)


def read_dials(okey3: torch.Tensor, keymax: torch.Tensor,
               pa: DeviceParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """okey3 [B, D, 4096] i32, keymax [B, D] i32 -> (position f64 [B, D],
    readable bool [B, D])."""
    B, D = keymax.shape
    valid = keymax >= 0
    big = (valid & ((keymax >> 12) > 200))[..., None]   # contourArea > 100
    sel = (keymax & 4095)[..., None]

    def region(idx: torch.Tensor) -> torch.Tensor:
        ok = okey3.gather(2, idx.long()[None].expand(B, D, -1))
        return torch.where(big, (ok >> 3) == sel, (ok & 4) != 0)

    needle = region(pa.disk_idx) & pa.disk_valid
    tip = region(pa.ann_idx) & pa.ann_valid
    return _read_dial_core(needle, tip, pa)


def read_dials_region(region: torch.Tensor, pa: DeviceParams
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """angles.read_dial per window: needle region [B, D, 4096] bool ->
    (position f64 [B, D], readable bool [B, D])."""
    B, D = region.shape[:2]

    def at(idx: torch.Tensor) -> torch.Tensor:
        return region.gather(2, idx.long()[None].expand(B, D, -1))

    return _read_dial_core(at(pa.disk_idx) & pa.disk_valid,
                           at(pa.ann_idx) & pa.ann_valid, pa)


def _read_dial_core(needle: torch.Tensor, tip: torch.Tensor,
                    pa: DeviceParams) -> Tuple[torch.Tensor, torch.Tensor]:
    f = pa.disk_sx2.dtype       # the geometry's dtype (module docstring)
    acc = torch.float64         # the sums'
    zero = torch.zeros((), dtype=f, device=needle.device)
    mom_x, mom_y = tree_sum(torch.stack([
        torch.where(needle, pa.disk_sx2, zero),
        torch.where(needle, pa.disk_sy2, zero)]).to(acc))
    sign = pa.neg_sign.to(acc)
    msx = (sign * mom_x)[..., None]
    msy = (sign * mom_y)[..., None]

    dot = pa.ann_x.to(acc) * msx + pa.ann_y.to(acc) * msy
    kept = tip & (dot > 0)
    n = kept.sum(-1)
    readable = n > 0

    inf = torch.tensor(float("inf"), dtype=f, device=needle.device)
    angle = pa.ann_angle
    min_angle = torch.where(kept, angle, inf).amin(-1, keepdim=True)
    is_tail = kept & ~(torch.abs(angle - min_angle) < 0.75)
    k_tail = is_tail.sum(-1, keepdim=True)

    n_ = n[..., None]
    rank = torch.cumsum(kept.to(torch.int64), -1) - 1
    pos = torch.where(is_tail, rank - (n_ - k_tail), rank + k_tail)
    cut = torch.where(n_ >= 5, torch.clamp(torch.div(
        n_ - 3, 2, rounding_mode="floor"), max=2), torch.zeros_like(n_))
    in_trim = kept & (pos >= cut) & (pos < n_ - cut)

    rebased = torch.where(is_tail, angle - 1.0, angle)
    w = torch.where(in_trim, pa.ann_sqd, zero).to(acc)
    num, den = tree_sum(torch.stack([rebased.to(acc) * w, w]))
    mean = num / torch.where(den == 0, torch.ones_like(den), den)
    position = torch.remainder(10.0 * (mean - pa.zero_turn.to(acc)), 10.0)
    return position, readable


def assemble_value(positions: torch.Tensor, value_perm: Tuple[int, ...]
                   ) -> torch.Tensor:
    """Carry-corrected 4-dial value (reference _reading.py:163-182) from
    positions [B, 4]; value_perm lists the dials in name-sorted order
    (r4, r3, r2, r1) = ("0.0001", "0.001", "0.01", "0.1")."""
    p = positions[:, list(value_perm)]
    r4, r3, r2, r1 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    i64 = torch.int64

    def digit(r: torch.Tensor, lower_le2: torch.Tensor,
              lower_ge8: torch.Tensor) -> torch.Tensor:
        fl = torch.floor(r)
        frac = r - fl
        up = (frac > 0.55) & lower_le2
        down = (frac < 0.45) & lower_ge8
        return torch.remainder(fl.to(i64) + up.to(i64) - down.to(i64), 10)

    # d3's carry compares the raw float r4 (_reading.py:174-175); the
    # coarser dials compare corrected digits
    d3 = digit(r3, r4 <= 2, r4 >= 8)
    d2 = digit(r2, d3 <= 2, d3 >= 8)
    d1 = digit(r1, d2 <= 2, d2 >= 8)
    f = positions.dtype
    return d1.to(f) * 100.0 + d2.to(f) * 10.0 + d3.to(f) + r4 / 10.0
