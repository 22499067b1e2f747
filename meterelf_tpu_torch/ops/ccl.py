"""K3 `ccl`: connected components of the per-window needle masks.

Port of meterelf_tpu/ops/pallas_ccl.py propagate_quads(pack_closed=True)
-- the findContours replacement. Same contract as its plain version,
ops/components.propagate: window bits [K, 64, 64] i32 -> (okey3 i32
[K, 64, 64] = owner*8 + closed*4 + masked*2 + boundary, converged bool
[K]), under pass caps (k_label, k_outside, k_fill) given at run time
(components.K_* by default, components.RESCUE_CAPS for the rescue).
The TPU kernel's pair/quad layouts, lockstep phases and emit_flat
relayout are not carried over: the CUDA kernel (csrc/ccl.cu) runs one
window per CTA and writes okey3 once.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from . import components
from .components import W, propagate
from .launch import check_cuda, raise_on_error, stream_of


def ccl(bits: torch.Tensor, caps: Optional[Sequence[int]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper -> (okey3 i32 [K, 64, 64], converged bool [K])."""
    if bits.device.type == "cpu":
        return propagate(bits, caps)
    check_cuda("ccl", bits, torch.int32, 3)
    if tuple(bits.shape[1:]) != (W, W):
        raise ValueError(f"ccl kernel takes [K, {W}, {W}] windows, got "
                         f"{tuple(bits.shape)}")
    k_label, k_outside, k_fill = (int(c) for c in caps or (
        components.K_LABEL, components.K_OUTSIDE, components.K_FILL))
    K = bits.shape[0]
    okey3 = torch.empty_like(bits)
    conv = torch.empty(K, dtype=torch.uint8, device=bits.device)
    if K == 0:
        return okey3, conv.to(torch.bool)
    with torch.cuda.device(bits.device):
        rc = _build.library().meterelf_ccl(
            bits.data_ptr(), K, k_label, k_outside, k_fill,
            okey3.data_ptr(), conv.data_ptr(), stream_of(bits.device))
    raise_on_error("ccl", rc)
    ccl.launches += 1
    return okey3, conv.to(torch.bool)


ccl.launches = 0  # type: ignore[attr-defined]
