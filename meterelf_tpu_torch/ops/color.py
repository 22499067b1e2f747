"""Exact uint8 BGR -> HLS_FULL and lightness in plain torch.

The counterpart of meterelf_tpu/ops/color.py bgr_planes_to_hls and
lightness_from_planes: OpenCV 3.4's float-path 8u conversion,
u8 * (1/255) -> RGB2HLS_f in float32 -> H*(256/360), L*255, S*255 ->
saturate_cast (round half to even, clamp), then the reference's
wrapping hue shift. Eager torch rounds every float32 operation once, and
float32 division is IEEE, so no f64 emulation is needed (the JAX package
divides in f64 only because the TPU's divide is not correctly rounded).
The CUDA kernels compute the same chain (csrc/exact_color.cuh).
"""
from __future__ import annotations

from typing import Tuple

import torch

_F = torch.float32


def _scale() -> torch.Tensor:
    return torch.tensor(1.0, dtype=_F) / torch.tensor(255.0, dtype=_F)


def _saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """cv::saturate_cast<uchar>(float) as int32: round half to even,
    then clamp."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.int32)


def unpack_planes(packed: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed i32 (b | g<<8 | r<<16) -> (b, g, r) int32 planes."""
    return packed & 255, (packed >> 8) & 255, (packed >> 16) & 255


def _unit_planes(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    sc = _scale().to(b.device)
    return b.to(_F) * sc, g.to(_F) * sc, r.to(_F) * sc


def lightness_from_planes(b: torch.Tensor, g: torch.Tensor,
                          r: torch.Tensor) -> torch.Tensor:
    """cv2 L channel of integer B, G, R planes (0..255) -> int32."""
    bf, gf, rf = _unit_planes(b, g, r)
    vmax = torch.maximum(torch.maximum(rf, gf), bf)
    vmin = torch.minimum(torch.minimum(rf, gf), bf)
    l_ = (vmax + vmin) * 0.5
    return _saturate_u8(l_ * 255.0)


def bgr_planes_to_hls(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                      hue_shift: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer B, G, R planes (0..255) -> int32 (h, l, s) planes, FULL hue
    range, hue shifted with uint8 wraparound."""
    bf, gf, rf = _unit_planes(b, g, r)
    vmax = torch.maximum(torch.maximum(rf, gf), bf)
    vmin = torch.minimum(torch.minimum(rf, gf), bf)
    l_ = (vmax + vmin) * 0.5
    diff = vmax - vmin
    nonzero = vmax != vmin
    safe = torch.where(nonzero, diff, torch.ones_like(diff))
    s = torch.where(l_ < 0.5, diff / (vmax + vmin),
                    diff / ((2.0 - vmax) - vmin))
    diff60 = 60.0 / safe
    h = torch.where(
        vmax == rf, (gf - bf) * diff60,
        torch.where(vmax == gf, (bf - rf) * diff60 + 120.0,
                    (rf - gf) * diff60 + 240.0))
    h = torch.where(h < 0, h + 360.0, h)
    zero = torch.zeros_like(h)
    h = torch.where(nonzero, h, zero)
    s = torch.where(nonzero, s, zero)
    hscale = (torch.tensor(256.0, dtype=_F)
              / torch.tensor(360.0, dtype=_F)).to(h.device)
    h_u8 = torch.remainder(_saturate_u8(h * hscale) + int(hue_shift), 256)
    return h_u8, _saturate_u8(l_ * 255.0), _saturate_u8(s * 255.0)
