"""K4 `stats`: largest-contour selection per window.

Port of meterelf_tpu/ops/pallas_stats.py stats_select_fused. From okey3
(owner*8 + closed*4 + masked*2 + boundary, owner 4096 off the support):
per owner the boundary-pixel count (> 0 marks a top-level component,
the contours RETR_EXTERNAL lists) and the doubled contourArea (the
marching-squares cell contributions of components.cell_contrib);
keymax = max(area2*4096 + owner) over those owners, -1 when none
(larger owner on area ties, Python's stable sorted()[-1]); has_any =
any masked pixel. The TPU kernel's one-hot matmuls and row_spans
restriction are matrix-unit devices and are not carried over: the CUDA
kernel (csrc/stats.cu) builds both histograms with shared-memory
atomics.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .components import N, W, cell_contrib
from .launch import check_cuda, raise_on_error, stream_of


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


def stats(okey3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 wrapper -> (keymax i32 [K], has_any bool [K])."""
    if okey3.device.type == "cpu":
        return stats_plain(okey3)
    check_cuda("stats", okey3, torch.int32, okey3.dim())
    K = okey3.shape[0]
    if okey3.numel() != K * N:
        raise ValueError(f"stats kernel takes [K, {W}, {W}] windows, got "
                         f"{tuple(okey3.shape)}")
    keymax = torch.empty(K, dtype=torch.int32, device=okey3.device)
    has_any = torch.empty(K, dtype=torch.uint8, device=okey3.device)
    if K == 0:
        return keymax, has_any.to(torch.bool)
    with torch.cuda.device(okey3.device):
        rc = _build.library().meterelf_stats(
            okey3.data_ptr(), K, keymax.data_ptr(), has_any.data_ptr(),
            stream_of(okey3.device))
    raise_on_error("stats", rc)
    stats.launches += 1
    return keymax, has_any.to(torch.bool)


stats.launches = 0  # type: ignore[attr-defined]
