"""Binary 3x3 morphology with OpenCV border semantics, in plain torch.

The counterpart of meterelf_tpu/ops/morphology.py (reference
meterelf/_reading.py:128-130): dilate reads 0 and erode reads 1 beyond
the border of the array, which here is one 64x64 dial window, so no
window sees its neighbour.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _window3(mask: torch.Tensor, fill: int, reduce_and: bool
             ) -> torch.Tensor:
    H, W = mask.shape[-2:]
    p = F.pad(mask.to(torch.uint8), (1, 1, 1, 1), value=fill)
    out = p[..., 1:H + 1, 1:W + 1].clone()
    for dy in range(3):
        for dx in range(3):
            v = p[..., dy:dy + H, dx:dx + W]
            out = out & v if reduce_and else out | v
    return out.to(torch.bool)


def dilate3(mask: torch.Tensor) -> torch.Tensor:
    """[..., H, W] bool -> 3x3 dilation (border = False)."""
    return _window3(mask, 0, reduce_and=False)


def erode3(mask: torch.Tensor) -> torch.Tensor:
    """[..., H, W] bool -> 3x3 erosion (border = True)."""
    return _window3(mask, 1, reduce_and=True)


def close3(mask: torch.Tensor) -> torch.Tensor:
    """Morphological close: dilate then erode (reference order)."""
    return erode3(dilate3(mask))
