"""Needle angles and the 4-dial value, in plain torch (f64 on the
device).

Port of meterelf_tpu/ops/angles.py read_dial_from_okey, read_dial,
_read_dial_core and assemble_value, batched over [B, D] windows instead
of vmapped. On the quad branch the needle region is derived at the
static disk and annulus slots straight from okey3 and the stats key (big
blob: owner == selected, else the closed mask); on the general branch it
is gathered from components.finalize's needle region. Then the
momentum, the half-plane tip filter, the cyclic trim over the static
(angle, sqdist) slot order and the weighted mean, all in float64 as the
reference computes them (see the original module for why each step is
exact).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..params import DeviceParams


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
    f64 = torch.float64
    zero = torch.zeros((), dtype=f64, device=needle.device)
    mom_x = torch.where(needle, pa.disk_sx2, zero).sum(-1)
    mom_y = torch.where(needle, pa.disk_sy2, zero).sum(-1)
    sign = pa.neg_sign.to(f64)
    msx = (sign * mom_x)[..., None]
    msy = (sign * mom_y)[..., None]

    dot = pa.ann_x * msx + pa.ann_y * msy
    kept = tip & (dot > 0)
    n = kept.sum(-1)
    readable = n > 0

    inf = torch.tensor(float("inf"), dtype=f64, device=needle.device)
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
    w = torch.where(in_trim, pa.ann_sqd, zero)
    num = (rebased * w).sum(-1)
    den = w.sum(-1)
    mean = num / torch.where(den == 0, torch.ones_like(den), den)
    position = torch.remainder(10.0 * (mean - pa.zero_turn), 10.0)
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
