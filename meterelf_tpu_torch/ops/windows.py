"""K2 `windows`: per-dial needle masks of the located dial cluster.

Port of meterelf_tpu/ops/pallas_windows.py window_bits_quads and of the
window stage it replaced (pipeline/decode.py
_dial_masks_from_packed_window). For every (image, dial) 64x64 window at
(mx + ox, my + oy) of the crop:

- exact HLS_FULL with the wrapping hue shift (ops/color.py);
- the dial color: the 5x5 sample at the dial center, integer-rounded
  mean (2S + 25) // 50 (a center within 2 px of the window edge moves
  the sample as the reference path's lax.dynamic_slice does: a negative
  start wraps by +64, then clamps into the window, so a center at row 0
  or 1 samples the window's bottom rows);
- inRange +-color_range, bounds clipped to [0, 255];
- a 3x3 close with cv2 borders per window (ops/morphology.py).

Output per window, as the TPU kernel writes it: i32 bits =
masked | disk<<1 | closed<<2 | raw<<3, masked = closed & disk. Shapes
are per window, [B, D, 64, 64] (the TPU's [B, 64, 256] quad layout
existed for its lane width only).

``geom`` holds one (ox, oy, cx, cy, cr_h, cr_l, cr_s) tuple of Python
ints per dial: window origin in template coordinates, dial center in
window coordinates, color range.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import _build
from .color import bgr_planes_to_hls, unpack_planes
from .launch import check_cuda, counted, raise_on_error, stream_of
from .morphology import close3

WIN = 64
MAX_DIALS = 8  # csrc/windows.cu kMaxDials

Geom = Sequence[Tuple[int, int, int, int, int, int, int]]


def _sample_start(c: int) -> int:
    """Start of the 5x5 sample around centre c as lax.dynamic_slice takes
    it in the JAX graph: a negative start wraps (+64), then clamps into
    the window."""
    s = c - 2
    return min(max(s + WIN if s < 0 else s, 0), WIN - 5)


def host_geom(geom: Geom) -> ctypes.c_void_p:
    """``geom`` as the HOST int32 array [D, 7] that K2 and K5 take."""
    flat = [int(v) for g in geom for v in g]
    if len(flat) != 7 * len(geom):
        raise ValueError("geom needs 7 ints per dial")
    return ctypes.cast((ctypes.c_int32 * len(flat))(*flat), ctypes.c_void_p)


def windows_plain(packed: torch.Tensor, mx: torch.Tensor, my: torch.Tensor,
                  geom: Geom, disk: torch.Tensor, hue_shift: int
                  ) -> torch.Tensor:
    """Plain torch window stage -> bits i32 [B, D, 64, 64]."""
    B = packed.shape[0]
    D = len(geom)
    dev = packed.device
    ar = torch.arange(WIN, device=dev)
    ox = torch.tensor([g[0] for g in geom], device=dev)
    oy = torch.tensor([g[1] for g in geom], device=dev)
    rows = my.long()[:, None, None] + oy[None, :, None] + ar   # [B, D, W]
    cols = mx.long()[:, None, None] + ox[None, :, None] + ar
    bidx = torch.arange(B, device=dev)[:, None, None, None]
    win = packed[bidx, rows[:, :, :, None], cols[:, :, None, :]]
    h, l_, s = bgr_planes_to_hls(*unpack_planes(win), hue_shift)
    planes = torch.stack([h, l_, s], dim=2)            # [B, D, 3, W, W]

    sums = []
    for d, (_, _, cx, cy, *_cr) in enumerate(geom):
        sx, sy = _sample_start(cx), _sample_start(cy)
        sums.append(planes[:, d, :, sy:sy + 5, sx:sx + 5].sum(dim=(-2, -1)))
    color = torch.div(2 * torch.stack(sums, dim=1) + 25, 50,
                      rounding_mode="floor")           # [B, D, 3]
    cr = torch.tensor([list(g[4:7]) for g in geom], dtype=torch.int32,
                      device=dev)
    lo = torch.clamp(color - cr, 0, 255)[..., None, None]
    hi = torch.clamp(color + cr, 0, 255)[..., None, None]
    raw = ((planes >= lo) & (planes <= hi)).all(dim=2)  # [B, D, W, W]
    closed = close3(raw)
    dk = disk.to(torch.bool)[None]
    i32 = torch.int32
    return ((closed & dk).to(i32) | (dk.to(i32) << 1)
            | (closed.to(i32) << 2) | (raw.to(i32) << 3))


def c_args(packed: torch.Tensor, mx: torch.Tensor, my: torch.Tensor,
           geom: Geom, disk: torch.Tensor, hue_shift: int
           ) -> Tuple[tuple, torch.Tensor]:
    """The arguments of K2's C entry meterelf_windows
    (csrc/meterelf_kernels.h) on the wrapper's inputs, and the bits
    tensor i32 [B, D, 64, 64] they write."""
    B, H, W = packed.shape
    bits = torch.empty((B, len(geom), WIN, WIN), dtype=torch.int32,
                       device=packed.device)
    return (packed.data_ptr(), B, H, W, mx.data_ptr(), my.data_ptr(),
            host_geom(geom), len(geom), disk.data_ptr(), int(hue_shift),
            bits.data_ptr(), stream_of(packed.device)), bits


def windows(packed: torch.Tensor, mx: torch.Tensor, my: torch.Tensor,
            geom: Geom, disk: torch.Tensor, hue_shift: int) -> torch.Tensor:
    """K2 wrapper -> bits i32 [B, D, 64, 64]. Every window must lie
    inside the crop (it does whenever (mx, my) is a valid template
    offset: windows are clipped into the template box)."""
    if packed.device.type == "cpu":
        return windows_plain(packed, mx, my, geom, disk, hue_shift)
    check_cuda("windows", packed, torch.int32, 3)
    check_cuda("windows", mx, torch.int32, 1, like=packed)
    check_cuda("windows", my, torch.int32, 1, like=packed)
    # the kernel reads the disk two bytes at a time
    check_cuda("windows", disk, torch.uint8, 3, like=packed, align=2)
    B = packed.shape[0]
    D = len(geom)
    if not 1 <= D <= MAX_DIALS:
        raise ValueError(f"windows kernel takes 1..{MAX_DIALS} dials, got {D}")
    if tuple(disk.shape) != (D, WIN, WIN):
        raise ValueError(f"disk shape {tuple(disk.shape)} != {(D, WIN, WIN)}")
    if mx.shape[0] != B or my.shape[0] != B:
        raise ValueError("mx/my must hold one offset per image")
    args, bits = c_args(packed, mx, my, geom, disk, hue_shift)
    if B == 0:
        return bits
    with torch.cuda.device(packed.device):
        rc = _build.library().meterelf_windows(*args)
    raise_on_error("windows", rc)
    windows.launches += 1
    return bits


counted(windows)
