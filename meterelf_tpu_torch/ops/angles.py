"""Needle angles and the 4-dial value: the plain torch graph (f64 sums on
the device) and K12 ``readout``, its CUDA kernel.

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

``readout`` is the decode's angle stage: on the CPU the plain graph
(``readout_plain``); on the card K12 (csrc/angles.cu), the whole stage in
one launch, bit-equal to the plain graph run on the card: the needle
gathered from okey3 and keymax (quad branch) or from the needle
region (the other branches), the momentum, the tip filter and trim, the
weighted mean in ``tree_sum``'s order, and the value for 4 dials.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from ..params import DeviceParams
from .launch import check_cuda, counted, raise_on_error, stream_of

RUN = 32   # XLA CPU's tree-reduction window
N = 64 * 64        # pixels of a dial window; K12 takes 1..N slots a dial
MAX_DIALS = 8      # csrc/angles.cu kMaxDials


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

    angle = pa.ann_angle
    min_angle = torch.where(kept, angle, float("inf")).amin(-1,
                                                           keepdim=True)
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
    # one column at a time: indexing by a list would copy it to the device
    r4, r3, r2, r1 = (positions[:, i] for i in value_perm)
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
    # a tensor divisor: a Python scalar's quotient is computed on the card
    # as the product with its reciprocal, which can differ in the last bit
    # from the division (the JAX package's, and K12's)
    return (d1.to(f) * 100.0 + d2.to(f) * 10.0 + d3.to(f)
            + r4 / torch.full_like(r4, 10.0))


def readout_plain(src: torch.Tensor, keymax: Optional[torch.Tensor],
                  pa: DeviceParams
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain angle stage: ``read_dials`` on okey3 [B, D, 4096] i32
    and keymax [B, D] i32, or ``read_dials_region`` on the needle region
    [B, D, 4096] bool (keymax None), then the value (``assemble_value``
    for 4 dials, else zeros) -> (position f64 [B, D], readable bool [B,
    D], value f64 [B])."""
    if keymax is None:
        positions, readable = read_dials_region(src, pa)
    else:
        positions, readable = read_dials(src, keymax, pa)
    if positions.shape[1] == 4:
        value = assemble_value(positions, pa.value_perm)
    else:
        value = torch.zeros(positions.shape[0], dtype=positions.dtype,
                            device=positions.device)
    return positions, readable, value


def c_args(src: torch.Tensor, keymax: Optional[torch.Tensor],
           pa: DeviceParams
           ) -> Tuple[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The arguments of K12's C entry meterelf_readout
    (csrc/meterelf_kernels.h) and the outputs they write: (position f64
    [B, D], readable bool [B, D], value f64 [B])."""
    B, D = src.shape[:2]
    dev = src.device
    position = torch.empty((B, D), dtype=torch.float64, device=dev)
    readable = torch.empty((B, D), dtype=torch.bool, device=dev)
    value = torch.empty(B, dtype=torch.float64, device=dev)
    perm = pa.value_perm if D == 4 else (0, 0, 0, 0)
    return (src.data_ptr(), int(keymax is None),
            None if keymax is None else keymax.data_ptr(), B, D,
            pa.disk_idx.data_ptr(), pa.disk_valid.data_ptr(),
            pa.disk_sx2.data_ptr(), pa.disk_sy2.data_ptr(),
            pa.disk_idx.shape[1], pa.ann_idx.data_ptr(),
            pa.ann_valid.data_ptr(), pa.ann_x.data_ptr(),
            pa.ann_y.data_ptr(), pa.ann_angle.data_ptr(),
            pa.ann_sqd.data_ptr(), pa.ann_idx.shape[1],
            pa.neg_sign.data_ptr(), pa.zero_turn.data_ptr(),
            int(pa.disk_sx2.dtype == torch.float32), *perm,
            position.data_ptr(), readable.data_ptr(), value.data_ptr(),
            stream_of(dev)), (position, readable, value)


def _check_geometry(src: torch.Tensor, pa: DeviceParams) -> None:
    """Raise unless pa's angle geometry is on src's card, contiguous, of
    the kernel's dtypes (one floating dtype, f32 or f64) and shapes."""
    D = src.shape[1]
    f = pa.disk_sx2.dtype
    if f not in (torch.float32, torch.float64):
        raise TypeError(f"readout kernel: geometry dtype {f}, expected "
                        "float32 or float64")
    nd, na = pa.disk_idx.shape[-1], pa.ann_idx.shape[-1]
    disk, ann = (D, nd), (D, na)
    for name, dtype, shape in (
            ("disk_idx", torch.int32, disk), ("disk_valid", torch.bool, disk),
            ("disk_sx2", f, disk), ("disk_sy2", f, disk),
            ("ann_idx", torch.int32, ann), ("ann_valid", torch.bool, ann),
            ("ann_x", f, ann), ("ann_y", f, ann), ("ann_angle", f, ann),
            ("ann_sqd", f, ann), ("neg_sign", torch.int32, (D,)),
            ("zero_turn", f, (D,))):
        t = getattr(pa, name)
        check_cuda("readout", t, dtype, len(shape), like=src)
        if tuple(t.shape) != shape:
            raise ValueError(f"readout kernel: {name} of shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if not (1 <= nd <= N and 1 <= na <= N):
        raise ValueError(f"readout kernel takes 1..{N} slots a "
                         f"dial, got {nd} disk and {na} annulus slots")


def readout(src: torch.Tensor, keymax: Optional[torch.Tensor],
            pa: DeviceParams
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K12 wrapper: the angle stage on okey3 [B, D, 4096] i32 and keymax
    [B, D] i32, or on the needle region [B, D, 4096] bool (keymax None)
    -> (position f64 [B, D], readable bool [B, D], value f64 [B]), as
    ``readout_plain``."""
    if src.device.type == "cpu":
        return readout_plain(src, keymax, pa)
    check_cuda("readout", src, torch.int32 if keymax is not None
               else torch.bool, 3)
    B, D = src.shape[:2]
    if src.shape[2] != N or not 1 <= D <= MAX_DIALS:
        raise ValueError(f"readout kernel takes [B, 1..{MAX_DIALS}, {N}] "
                         f"windows, got {tuple(src.shape)}")
    if keymax is not None:
        check_cuda("readout", keymax, torch.int32, 2, like=src)
        if tuple(keymax.shape) != (B, D):
            raise ValueError(f"readout kernel: keymax of shape "
                             f"{tuple(keymax.shape)}, expected {(B, D)}")
    _check_geometry(src, pa)
    args, out = c_args(src, keymax, pa)
    if B == 0:
        return out
    with torch.cuda.device(src.device):
        rc = _build.library().meterelf_readout(*args)
    raise_on_error("readout", rc)
    readout.launches += 1
    return out


counted(readout)
