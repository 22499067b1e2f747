"""K10 `backhalf_planes` and K11 `upsample_color_pack`: the device half of
the JPEG coefficient feed.

Ports of meterelf_tpu/ops/pallas_jpeg.py fused_backhalf_planes (K10) and
upsample_color_pack (K11). Both write [B, PH, PW] packed-BGR i32 crops
(b | g<<8 | r<<16), the crop at [0:rh, 0:rw] and zeros elsewhere.

- ``backhalf_planes``: frequency-plane coefficients (compact int8 wire or
  dense i16) -> crops: dequantise, ISLOW IDCT, upsample, colour, crop in
  one kernel. Plain version: jpegdec.backhalf_planes_to_packed.
- ``upsample_color_pack``: spatial u8 planes -> crops: upsample, colour,
  crop. Plain version: jpegdec.tail_to_packed.
- ``backhalf_blocks``: block-layout coefficients -> crops, the feed's
  block branch, which io/jpeg.load_coef_feed takes for the windows K10
  refuses (K11's gate, jpegdec.tail_ok, is looser than K10's
  jpegdec.backhalf_ok): the IDCT in plain torch (int64 butterfly with
  i32 wrap; torch has no int32 matrix product on CUDA), then K11.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (csrc/jpeg.cu) or raises. ``backhalf_c_args`` and
``upsample_c_args`` give a kernel's C-entry arguments, to time it
without its wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from . import jpegdec
from .jpegdec import CoefWindow
from .launch import check_cuda, counted, raise_on_error, stream_of


def _geom(kernel: str, gate, win: CoefWindow,
          pad_hw: Optional[Tuple[int, int]]) -> np.ndarray:
    """The kernels' host geometry array (csrc/meterelf_kernels.h), after
    the kernel's geometry gate (ops/jpegdec.backhalf_ok or tail_ok)."""
    if not gate(win, pad_hw):
        raise ValueError(
            f"the {kernel} kernel does not take window {win} with staging "
            f"{pad_hw} (ops/jpegdec.{gate.__name__})")
    ph, pw = pad_hw if pad_hw is not None else (win.rh, win.rw)
    return np.array([8 * win.lbh, 8 * win.lbw, win.oy, win.ox, win.rh,
                     win.rw, win.ch_valid, win.cw_valid, ph, pw], np.int32)


def _check_shape(kernel: str, t: torch.Tensor, shape: Tuple[int, ...]
                 ) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel} kernel: shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if t.data_ptr() % 16:
        raise ValueError(f"{kernel} kernel: tensor not 16-byte aligned")


def backhalf_c_args(fy: torch.Tensor, fcb: torch.Tensor, fcr: torch.Tensor,
                    qt: torch.Tensor, win: CoefWindow,
                    pad_hw: Optional[Tuple[int, int]] = None
                    ) -> Tuple[tuple, torch.Tensor]:
    """The arguments of K10's C entry meterelf_backhalf_planes
    (csrc/meterelf_kernels.h) on the wrapper's inputs, and the output
    tensor i32 [B, PH, PW] they write."""
    geom = _geom("backhalf_planes", jpegdec.backhalf_ok, win, pad_hw)
    out = torch.empty((fy.shape[0], int(geom[8]), int(geom[9])),
                      dtype=torch.int32, device=fy.device)
    return (fy.data_ptr(), fcb.data_ptr(), fcr.data_ptr(),
            int(fy.dtype == torch.int8), qt.data_ptr(), fy.shape[0],
            geom.ctypes.data_as(ctypes.c_void_p), out.data_ptr(),
            stream_of(fy.device)), out


def backhalf_planes(fy: torch.Tensor, fcb: torch.Tensor, fcr: torch.Tensor,
                    qt: torch.Tensor, win: CoefWindow,
                    pad_hw: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """K10 wrapper: frequency-plane coefficients fy [B, lh, lw] /
    fcb, fcr [B, lh/2, lw/2] i16, or their compact int8 wire ([B, lh*3/2,
    lw] / [B, lh*3/4, lw/2]), and qt [B, 3, 64] u16 -> [B, PH, PW] i32."""
    if fy.device.type == "cpu":
        return jpegdec.backhalf_planes_to_packed(fy, fcb, fcr, qt, win,
                                                 pad_hw)
    compact = fy.dtype == torch.int8
    dtype = torch.int8 if compact else torch.int16
    B = fy.shape[0]
    lh, lw = 8 * win.lbh, 8 * win.lbw
    rows = (lh * 3 // 2, lh * 3 // 4) if compact else (lh, lh // 2)
    for t, shape in ((fy, (B, rows[0], lw)), (fcb, (B, rows[1], lw // 2)),
                     (fcr, (B, rows[1], lw // 2))):
        check_cuda("backhalf_planes", t, dtype, 3, like=fy)
        _check_shape("backhalf_planes", t, shape)
    check_cuda("backhalf_planes", qt, torch.uint16, 3, like=fy)
    _check_shape("backhalf_planes", qt, (B, 3, 64))
    args, out = backhalf_c_args(fy, fcb, fcr, qt, win, pad_hw)
    if B == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(fy.device):
        rc = lib.meterelf_backhalf_planes(*args)
    raise_on_error("backhalf_planes", rc)
    backhalf_planes.launches += 1
    return out


counted(backhalf_planes)


def backhalf_bands(win: CoefWindow) -> Tuple[int, int, int]:
    """K10's work per image (csrc/jpeg.cu backhalf_planes_kernel): its
    bands, one CTA each (a chroma block row k, window rows 16k..16k+15,
    that holds crop rows), the full 8x8 IDCTs they run (the luma blocks
    under the crop, and each band's chroma blocks of row k under the
    crop's chroma columns and their one-sample halo), and the single
    chroma sample rows (halo rows 8k-1 and 8k+8, where a crop pixel reads
    them: the filter's clamps) they run for their halos."""
    if win.rh <= 0:
        return 1, 0, 0
    k0, k1 = win.oy >> 4, (win.oy + win.rh - 1) >> 4
    nlx = ((win.ox + win.rw - 1) >> 3) - (win.ox >> 3) + 1
    ncx = ((min(((win.ox + win.rw - 1) >> 1) + 1, win.cw_valid - 1) >> 3)
           - (max((win.ox >> 1) - 1, 0) >> 3) + 1)
    full = single = 0
    for k in range(k0, k1 + 1):
        wy0 = max(16 * k, win.oy)
        wy1 = min(16 * k + 16, win.oy + win.rh)
        up = k > 0 and wy0 == 16 * k
        down = wy1 == 16 * k + 16 and 8 * k + 8 <= win.ch_valid - 1
        full += (((wy1 - 1) >> 3) - (wy0 >> 3) + 1) * nlx + 2 * ncx
        single += (up + down) * 2 * ncx
    return k1 - k0 + 1, full, single


def upsample_c_args(sy: torch.Tensor, scb: torch.Tensor, scr: torch.Tensor,
                    win: CoefWindow,
                    pad_hw: Optional[Tuple[int, int]] = None
                    ) -> Tuple[tuple, torch.Tensor]:
    """The arguments of K11's C entry meterelf_upsample_color_pack
    (csrc/meterelf_kernels.h) on the wrapper's inputs, and the output
    tensor i32 [B, PH, PW] they write."""
    geom = _geom("upsample_color_pack", jpegdec.tail_ok, win, pad_hw)
    out = torch.empty((sy.shape[0], int(geom[8]), int(geom[9])),
                      dtype=torch.int32, device=sy.device)
    return (sy.data_ptr(), scb.data_ptr(), scr.data_ptr(), sy.shape[0],
            geom.ctypes.data_as(ctypes.c_void_p), out.data_ptr(),
            stream_of(sy.device)), out


def upsample_color_pack(sy: torch.Tensor, scb: torch.Tensor,
                        scr: torch.Tensor, win: CoefWindow,
                        pad_hw: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """K11 wrapper: spatial u8 planes sy [B, lh, lw], scb/scr
    [B, lh/2, lw/2] -> [B, PH, PW] i32."""
    if sy.device.type == "cpu":
        return jpegdec.tail_to_packed(sy, scb, scr, win, pad_hw)
    B = sy.shape[0]
    lh, lw = 8 * win.lbh, 8 * win.lbw
    for t, shape in ((sy, (B, lh, lw)), (scb, (B, lh // 2, lw // 2)),
                     (scr, (B, lh // 2, lw // 2))):
        check_cuda("upsample_color_pack", t, torch.uint8, 3, like=sy)
        _check_shape("upsample_color_pack", t, shape)
    args, out = upsample_c_args(sy, scb, scr, win, pad_hw)
    if B == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(sy.device):
        rc = lib.meterelf_upsample_color_pack(*args)
    raise_on_error("upsample_color_pack", rc)
    upsample_color_pack.launches += 1
    return out


counted(upsample_color_pack)


def backhalf_blocks(coef_y: torch.Tensor, coef_cb: torch.Tensor,
                    coef_cr: torch.Tensor, qt: torch.Tensor,
                    win: CoefWindow,
                    pad_hw: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """Block-layout coefficients [B, NB, 64] i16 -> [B, PH, PW] i32: the
    plain IDCT, then K11 (the plain tail on the CPU)."""
    return upsample_color_pack(
        *jpegdec.idct_planes(coef_y, coef_cb, coef_cr, qt, win), win, pad_hw)
