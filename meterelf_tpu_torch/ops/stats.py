"""K4 `stats` and K7 `stats_select`: largest-contour selection per window.

Port of meterelf_tpu/ops/pallas_stats.py stats_select_fused. From okey3
(owner*8 + closed*4 + masked*2 + boundary, owner 4096 off the support):
per owner the boundary-pixel count (> 0 marks a top-level component,
the contours RETR_EXTERNAL lists) and the doubled contourArea (the
marching-squares cell contributions of ``cell_contrib``);
keymax = max(area2*4096 + owner) over those owners, -1 when none
(larger owner on area ties, Python's stable sorted()[-1]); has_any =
any masked pixel. The TPU kernel's one-hot matmuls and row_spans
restriction are matrix-unit devices and are not carried over: the CUDA
kernel (csrc/stats.cu) builds both histograms as one packed counter a
bin (area2 << 16 | bcount) with shared-memory atomics, one a run of equal
owners across a warp, and writes has_any straight into the bool
output.

K7 ``stats_select`` ports pallas_stats.stats_select, which the JAX
decode runs under METERELF_QUAD_STATS=hist_pallas (components._finalize):
okey (owner*4 + masked*2 + boundary, K6's key) and contrib, the cell
contributions computed outside the kernel as the JAX graph does, in; per
owner the boundary count and area2 = sum (contrib & 3), both binned under
each pixel's own owner (owner 4096 drops out); keymax as K4's. The CUDA
kernel is K4's with a template flag (csrc/stats.cu), so the two
histogram bodies cannot drift.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import _build
from .launch import check_cuda, counted, raise_on_error, stream_of

W = 64
N = W * W


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


def stats_plain(okey3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch stats: okey3 [K, 64, 64] or [K, 4096] i32 ->
    (keymax i32 [K], has_any bool [K])."""
    K = okey3.shape[0]
    ok = okey3.reshape(K, W, W)
    owner = ok >> 3
    own = owner.reshape(K, N).long()       # sentinel 4096 -> extra bin
    zeros = torch.zeros((K, N + 1), dtype=torch.int32, device=ok.device)
    bcount = zeros.scatter_add(1, own, (ok & 1).reshape(K, N))
    area2 = zeros.scatter_add(1, own, cell_contrib(owner).reshape(K, N))
    cell = torch.arange(N, dtype=torch.int32, device=ok.device)
    key = torch.where(bcount[:, :N] > 0, area2[:, :N] * N + cell, -1)
    keymax = key.amax(dim=1).to(torch.int32)
    has_any = ((ok >> 1) & 1).reshape(K, N).amax(dim=1) > 0
    return keymax, has_any


def c_args(okey: torch.Tensor, contrib: Optional[torch.Tensor] = None
           ) -> Tuple[tuple, Union[torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]]:
    """The arguments of K4's C entry meterelf_stats on okey3 (contrib
    None) or of K7's meterelf_stats_select on okey and contrib
    (csrc/meterelf_kernels.h), and the outputs they write: (keymax i32
    [K], has_any bool [K]) or keymax."""
    K, dev = okey.shape[0], okey.device
    keymax = torch.empty(K, dtype=torch.int32, device=dev)
    if contrib is None:
        has_any = torch.empty(K, dtype=torch.bool, device=dev)
        return (okey.data_ptr(), K, keymax.data_ptr(), has_any.data_ptr(),
                stream_of(dev)), (keymax, has_any)
    return (okey.data_ptr(), contrib.data_ptr(), K, keymax.data_ptr(),
            stream_of(dev)), keymax


def stats(okey3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 wrapper -> (keymax i32 [K], has_any bool [K])."""
    if okey3.device.type == "cpu":
        return stats_plain(okey3)
    # the kernel reads two pixels at a time (int2)
    check_cuda("stats", okey3, torch.int32, okey3.dim(), align=8)
    K = okey3.shape[0]
    if okey3.numel() != K * N:
        raise ValueError(f"stats kernel takes [K, {W}, {W}] windows, got "
                         f"{tuple(okey3.shape)}")
    args, out = c_args(okey3)
    if K == 0:
        return out
    with torch.cuda.device(okey3.device):
        rc = _build.library().meterelf_stats(*args)
    raise_on_error("stats", rc)
    stats.launches += 1
    return out


counted(stats)


def stats_select_plain(okey: torch.Tensor, contrib: torch.Tensor
                       ) -> torch.Tensor:
    """Plain K7: okey and contrib [K, 64, 64] or [K, 4096] i32 -> keymax
    i32 [K]."""
    K = okey.shape[0]
    ok = okey.reshape(K, N)
    # owners outside [0, 4096) -> an extra bin, dropped
    own = torch.where((ok >= 0) & (ok < 4 * N), ok >> 2, N).long()
    zeros = torch.zeros((K, N + 1), dtype=torch.int32, device=ok.device)
    bcount = zeros.scatter_add(1, own, ok & 1)
    area2 = zeros.scatter_add(1, own,
                            (contrib.reshape(K, N) & 3).to(torch.int32))
    cell = torch.arange(N, dtype=torch.int32, device=ok.device)
    key = torch.where(bcount[:, :N] > 0, area2[:, :N] * N + cell, -1)
    return key.amax(dim=1).to(torch.int32)


def stats_select(okey: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """K7 wrapper -> keymax i32 [K]."""
    if okey.device.type == "cpu":
        return stats_select_plain(okey, contrib)
    # the kernel reads two pixels of each at a time (int2)
    check_cuda("stats_select", okey, torch.int32, okey.dim(), align=8)
    check_cuda("stats_select", contrib, torch.int32, contrib.dim(),
               like=okey, align=8)
    K = okey.shape[0]
    if okey.numel() != K * N or contrib.numel() != K * N:
        raise ValueError(f"stats_select kernel takes [K, {W}, {W}] okey and "
                         f"contrib, got {tuple(okey.shape)} and "
                         f"{tuple(contrib.shape)}")
    args, keymax = c_args(okey, contrib)
    if K == 0:
        return keymax
    with torch.cuda.device(okey.device):
        rc = _build.library().meterelf_stats_select(*args)
    raise_on_error("stats_select", rc)
    stats_select.launches += 1
    return keymax


counted(stats_select)
