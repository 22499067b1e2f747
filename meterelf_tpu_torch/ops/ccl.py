"""K3 `ccl` and K6 `propagate`: connected components of the per-window
needle masks, the findContours replacement.

K3 ports meterelf_tpu/ops/pallas_ccl.py propagate_quads(pack_closed=
True), the quad branch's CCL: window bits [K, 64, 64] i32 -> (okey3 i32
[K, 64, 64] = owner*8 + closed*4 + masked*2 + boundary, converged bool
[K]). K6 ports pallas_ccl.propagate, the CCL of the general-geometry
branch: the same propagation with no closed bit, okey = owner*4 +
masked*2 + boundary. It reads the low two bits of K2's output (masked |
disk<<1), which are exactly the JAX package's bits = masked + 2*disk.
Both take pass caps (k_label, k_outside, k_fill) at run time
(components.K_* by default, components.RESCUE_CAPS for the rescue), and
their plain versions are components.propagate (pack_closed=True, False).
The TPU kernel's pair/quad layouts, lockstep phases and emit_flat
relayout are not carried over: one CUDA kernel body (csrc/ccl.cu, a
compile-time flag for the key) runs one window per CTA and writes the key
once.

``analyze_batch`` is components.analyze_batch on this branch: K6, then
components.finalize (the quad branch under METERELF_QUAD_STATS != fused
runs it too), in the spans ``meterelf.decode.ccl`` and
``meterelf.decode.stats``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from ..profiling import span
from . import components
from .components import W
from .launch import check_cuda, counted, raise_on_error, stream_of


def c_args(bits: torch.Tensor, caps: Optional[Sequence[int]],
           okey: torch.Tensor, conv: torch.Tensor) -> tuple:
    """The arguments of the C entries meterelf_ccl / meterelf_propagate
    (csrc/meterelf_kernels.h): window bits [K, 64, 64] i32, the caps
    (components.K_* when None), okey [K, 64, 64] i32 and conv [K] u8."""
    k_label, k_outside, k_fill = (int(c) for c in caps or (
        components.K_LABEL, components.K_OUTSIDE, components.K_FILL))
    return (bits.data_ptr(), bits.shape[0], k_label, k_outside, k_fill,
            okey.data_ptr(), conv.data_ptr(), stream_of(bits.device))


def _launch(name: str, entry: str, bits: torch.Tensor,
            caps: Optional[Sequence[int]]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_cuda(name, bits, torch.int32, 3)
    if tuple(bits.shape[1:]) != (W, W):
        raise ValueError(f"{name} kernel takes [K, {W}, {W}] windows, got "
                         f"{tuple(bits.shape)}")
    okey = torch.empty_like(bits)
    conv = torch.empty(bits.shape[0], dtype=torch.uint8, device=bits.device)
    if bits.shape[0]:
        with torch.cuda.device(bits.device):
            rc = getattr(_build.library(), entry)(
                *c_args(bits, caps, okey, conv))
        raise_on_error(name, rc)
    return okey, conv.to(torch.bool)


def ccl(bits: torch.Tensor, caps: Optional[Sequence[int]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper -> (okey3 i32 [K, 64, 64], converged bool [K])."""
    if bits.device.type == "cpu":
        return components.propagate(bits, caps)
    out = _launch("ccl", "meterelf_ccl", bits, caps)
    if bits.shape[0]:
        ccl.launches += 1
    return out


def propagate(bits: torch.Tensor, caps: Optional[Sequence[int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 wrapper -> (okey i32 [K, 64, 64] = owner*4 + masked*2 +
    boundary, converged bool [K])."""
    if bits.device.type == "cpu":
        return components.propagate(bits, caps, pack_closed=False)
    out = _launch("propagate", "meterelf_propagate", bits, caps)
    if bits.shape[0]:
        propagate.launches += 1
    return out


counted(ccl)
counted(propagate)


def analyze_batch(bits: torch.Tensor,
                  static_bbox: Optional[components.StatsBox] = None,
                  caps: Optional[Sequence[int]] = None, stats: str = "sort"
                  ) -> components.ComponentResult:
    """components.analyze_batch(impl="pallas") on K2's window bits [K, 64,
    64]: K6, then the largest-component selection under ``stats`` and the
    needle region (components.finalize). On the quad branch under
    METERELF_QUAD_STATS != fused the JAX graph runs
    propagate_quads(pack_closed=False), which is K6's function, and then
    the same _finalize."""
    with span("meterelf.decode.ccl"):
        okey, conv = propagate(bits, caps)
    with span("meterelf.decode.stats"):
        return components.finalize(okey, (bits & 1) != 0, (bits & 4) != 0,
                                   conv, static_bbox, stats)
