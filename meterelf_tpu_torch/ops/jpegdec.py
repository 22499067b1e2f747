"""JPEG back-half, plain torch: dequantise, ISLOW IDCT, fancy h2v2 chroma
upsampling, fixed-point YCbCr->BGR, crop and pack.

Port of meterelf_tpu/ops/jpegdec.py, bit-identical to it. The host
reader (io/jpeg.py) entropy-decodes a block-aligned window of DCT
coefficients; these functions finish the decode with libjpeg's default
numerics (jidctint.c ISLOW IDCT, jdsample.c h2v2_fancy_upsample,
jdcolor.c fixed-point colour conversion). They are the plain versions of
the two CUDA kernels in ops/jpeg_tail.py (csrc/jpeg.cu): the CPU runs
them, and the card's kernels are held equal to them.

Integer semantics: JAX computes the IDCT in int32, where adds and
multiplies wrap mod 2^32. Here the butterfly runs in int64, exactly, and
is wrapped to int32 where the JAX graph's value is observed through a
non-ring operation: after the descale's rounding add, before the
arithmetic shift (``_descale``). Every other step stays below 2^31 in
magnitude (the dequantised coefficient |coef*qt| < 2^31, samples and
colour terms below 2^24), so no further wrap is needed. Nothing relies
on torch's int32 overflow.

Supported layout: 8-bit baseline YCbCr 4:2:0.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..types import Rect

# ---- ISLOW IDCT constants (jidctint.c; FIX(x) at CONST_BITS=13) ----
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


# ---- fixed-point YCbCr->BGR (jdcolor.c build_ycc_rgb_table) ----
_FIX_1_40200 = _fix(1.40200)
_FIX_1_77200 = _fix(1.77200)
_FIX_0_71414 = _fix(0.71414)
_FIX_0_34414 = _fix(0.34414)

# bytes of shared memory one block may use on Hopper; the fused kernel
# stages 3 luma and 2 x 3 chroma block rows of u8 samples (48 B a luma
# column) beside the image's three quant tables (384 B)
SMEM_LIMIT = 232448


class CoefWindow(NamedTuple):
    """Static geometry of a chroma-block-aligned coefficient window
    covering ``meter_rect`` plus the >=2 px margin that preserves fancy
    upsampling's neighbor context (block units are luma 8x8 blocks)."""
    lbx0: int   # window origin, luma blocks (even)
    lby0: int
    lbw: int    # window size, luma blocks (even)
    lbh: int
    ox: int     # crop origin inside the window, luma px
    oy: int
    rw: int     # crop size, luma px
    rh: int
    cw_valid: int  # valid (non-block-padding) chroma samples in window
    ch_valid: int  # — the upsampling clamp bound (= image edge)


def coef_window(rect: Rect, frame_w: int, frame_h: int) -> CoefWindow:
    """Window for ``rect`` in a frame_w x frame_h 4:2:0 frame: a margin of
    2 luma px (1 chroma sample) on every side keeps the triangle filter's
    context; at image edges the filter replicates, which the back-half
    reproduces by clamping sample indices to the image bounds mapped into
    window coordinates."""
    (rx, ry) = rect.top_left
    rw, rh = rect.width, rect.height
    img_cbw = math.ceil(frame_w / 16)   # chroma blocks across the image
    img_cbh = math.ceil(frame_h / 16)
    cx0 = min(max((rx - 2) // 16, 0), img_cbw - 1)
    cy0 = min(max((ry - 2) // 16, 0), img_cbh - 1)
    cx1 = max(min(math.ceil((rx + rw + 2) / 16), img_cbw), cx0 + 1)
    cy1 = max(min(math.ceil((ry + rh + 2) / 16), img_cbh), cy0 + 1)
    img_cw = (frame_w + 1) // 2         # valid chroma samples (image)
    img_ch = (frame_h + 1) // 2
    return CoefWindow(
        lbx0=2 * cx0, lby0=2 * cy0,
        lbw=2 * (cx1 - cx0), lbh=2 * (cy1 - cy0),
        ox=rx - 16 * cx0, oy=ry - 16 * cy0, rw=rw, rh=rh,
        cw_valid=min(8 * (cx1 - cx0), img_cw - 8 * cx0),
        ch_valid=min(8 * (cy1 - cy0), img_ch - 8 * cy0),
    )


def tail_ok(win: CoefWindow, pad_hw: Optional[Tuple[int, int]]) -> bool:
    """Whether the tail kernel (K11, csrc/jpeg.cu upsample_color_pack)
    takes this window and staging shape: the crop lies inside the decoded
    window and the staging shape holds it. Geometry only; pad_hw=None
    stands for the bare crop."""
    ph, pw = pad_hw if pad_hw is not None else (win.rh, win.rw)
    return (win.oy + win.rh <= 8 * win.lbh and win.ox + win.rw <= 8 * win.lbw
            and ph >= win.rh and pw >= win.rw)


def backhalf_ok(win: CoefWindow,
                pad_hw: Optional[Tuple[int, int]]) -> bool:
    """Whether the fused back-half kernel (K10, csrc/jpeg.cu
    backhalf_planes) takes this window and staging shape: what K11 needs,
    and besides the crop lies inside the valid chroma samples (so every
    kept pixel's chroma neighbours lie within one block row of its own)
    and the staged block rows fit a block's shared memory. The feed
    (io/jpeg.load_coef_feed) sends the windows K10 refuses down the block
    branch, to K11."""
    return (tail_ok(win, pad_hw)
            and win.oy + win.rh <= 2 * win.ch_valid
            and win.ox + win.rw <= 2 * win.cw_valid
            and 48 * 8 * win.lbw + 384 <= SMEM_LIMIT)


def uncompact_plane(arr: torch.Tensor) -> torch.Tensor:
    """Compact wire plane -> dense i16 coefficient plane.

    arr [..., R*3/2, C] int8: rows [0, R) are the lo bytes (v & 0xFF),
    rows [R, 3R/2) pack the 4-bit hi parts two plane rows per byte
    (plane row 2r in the low nibble of hi row r, 2r+1 in the high).
    v = sign-extend-12(hi << 8 | lo), written as v - 2 * (v & 0x800)."""
    i32 = torch.int32
    R = arr.shape[-2] * 2 // 3
    lo = arr[..., :R, :].to(i32) & 255
    hi2 = torch.repeat_interleave(arr[..., R:, :].to(i32) & 255, 2, dim=-2)
    par = (torch.arange(R, device=arr.device) & 1).reshape(R, 1)
    hv = torch.where(par == 0, hi2 & 15, (hi2 >> 4) & 15)
    v = (hv << 8) | lo
    return (v - ((v & 0x800) << 1)).to(torch.int16)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it wraps to mod 2^32 (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """jidctint.c DESCALE on int32 wraparound: (x + 2^(n-1)) >> n."""
    return _wrap_i32(x + (1 << (n - 1))) >> n


def _idct_1d(d: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
    """One ISLOW butterfly over 8 same-shape int64 arrays; returns the 8
    outputs descaled by ``shift`` (jidctint.c, both passes)."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F_0_541196100
    t2 = z1 - z3 * _F_1_847759065
    t3 = z1 + z2 * _F_0_765366865
    z2, z3 = d[0], d[4]
    e0 = (z2 + z3) << 13
    e1 = (z2 - z3) << 13
    t10, t13 = e0 + t3, e0 - t3
    t11, t12 = e1 + t2, e1 - t2

    o0, o1, o2, o3 = d[7], d[5], d[3], d[1]
    z1 = o0 + o3
    z2 = o1 + o2
    z3 = o0 + o2
    z4 = o1 + o3
    z5 = (z3 + z4) * _F_1_175875602
    o0 = o0 * _F_0_298631336
    o1 = o1 * _F_2_053119869
    o2 = o2 * _F_3_072711026
    o3 = o3 * _F_1_501321110
    z1 = -z1 * _F_0_899976223
    z2 = -z2 * _F_2_562915447
    z3 = -z3 * _F_1_961570560 + z5
    z4 = -z4 * _F_0_390180644 + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4

    return [_descale(t10 + o3, shift), _descale(t11 + o2, shift),
            _descale(t12 + o1, shift), _descale(t13 + o0, shift),
            _descale(t13 - o0, shift), _descale(t12 - o1, shift),
            _descale(t11 - o2, shift), _descale(t10 - o3, shift)]


def idct_blocks(coef: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """coef [B, NB, 64] i16 (natural order), qt [B, 64] -> samples
    (level-shifted +128, clamped to [0, 255]) as u8 [B, NB, 64]. Pass 1
    runs over the rows of each block (one column at a time), pass 2 over
    the columns, as jidctint.c does."""
    B, NB = coef.shape[0], coef.shape[1]
    i64 = torch.int64
    d = (coef.reshape(B, NB, 8, 8).to(i64)
         * qt.to(i64).reshape(B, 1, 8, 8))
    ws = torch.stack(_idct_1d([d[:, :, r, :] for r in range(8)], 11),
                     dim=2)                               # [B, NB, 8r, 8c]
    out = torch.stack(_idct_1d([ws[:, :, :, c] for c in range(8)], 18),
                      dim=3)
    return (out + 128).clamp(0, 255).to(torch.uint8).reshape(B, NB, 64)


def _blocks_to_plane(s: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """[B, bh*bw, 64] -> [B, bh*8, bw*8]."""
    B = s.shape[0]
    return (s.reshape(B, bh, bw, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(B, bh * 8, bw * 8))


def _plane_to_blocks(fp: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """[B, bh*8, bw*8] frequency plane -> [B, bh*bw, 64] block layout."""
    B = fp.shape[0]
    return (fp.reshape(B, bh, 8, bw, 8).permute(0, 1, 3, 2, 4)
            .reshape(B, bh * bw, 64))


def idct_to_plane(coef: torch.Tensor, qt: torch.Tensor, bh: int,
                  bw: int) -> torch.Tensor:
    """coef [B, bh*bw, 64] i16 + qt [B, 64] -> spatial u8 plane
    [B, bh*8, bw*8]. (The JAX package evaluates the same linear map as
    an i32 dot_general; both are exact mod 2^32.)"""
    return _blocks_to_plane(idct_blocks(coef, qt), bh, bw)


def _upsample_h2v2_fancy(c: torch.Tensor, ch_valid: int,
                         cw_valid: int) -> torch.Tensor:
    """[B, ch, cw] u8 chroma plane -> [B, 2*ch, 2*cw] u8, libjpeg's
    triangle filter (jdsample.c h2v2_fancy_upsample): vertical 3:1
    colsums, then horizontal 3:1 with the +8/+7 rounding pair by output
    column parity. Neighbour indices clamp at (ch_valid, cw_valid), the
    image edge in window coordinates, where the filter replicates the
    edge sample."""
    B, ch, cw = c.shape
    dev = c.device
    ci = c.to(torch.int32)
    rows = torch.arange(ch, device=dev)
    up = (rows - 1).clamp(min=0)
    dn = torch.minimum(rows + 1, torch.tensor(ch_valid - 1, device=dev))
    cs = torch.stack([3 * ci + ci.index_select(1, up),
                      3 * ci + ci.index_select(1, dn)],
                     dim=2).reshape(B, 2 * ch, cw)
    cols = torch.arange(cw, device=dev)
    lf = (cols - 1).clamp(min=0)
    rt = torch.minimum(cols + 1, torch.tensor(cw_valid - 1, device=dev))
    o_even = (3 * cs + cs.index_select(2, lf) + 8) >> 4
    o_odd = (3 * cs + cs.index_select(2, rt) + 7) >> 4
    return (torch.stack([o_even, o_odd], dim=3)
            .reshape(B, 2 * ch, 2 * cw).to(torch.uint8))


def _ycc_to_packed_bgr(y: torch.Tensor, cb: torch.Tensor,
                       cr: torch.Tensor) -> torch.Tensor:
    """u8 planes -> packed BGR i32 (b | g<<8 | r<<16)."""
    i32 = torch.int32
    y = y.to(i32)
    cbi = cb.to(i32) - 128
    cri = cr.to(i32) - 128
    r = y + ((_FIX_1_40200 * cri + _ONE_HALF) >> _SCALEBITS)
    b = y + ((_FIX_1_77200 * cbi + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_FIX_0_34414 * cbi - _FIX_0_71414 * cri + _ONE_HALF)
             >> _SCALEBITS)
    r = r.clamp(0, 255)
    g = g.clamp(0, 255)
    b = b.clamp(0, 255)
    return b | (g << 8) | (r << 16)


def tail_to_packed(sy: torch.Tensor, scb: torch.Tensor, scr: torch.Tensor,
                   win: CoefWindow,
                   pad_hw: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
    """Spatial u8 planes sy [B, LH, LW], scb/scr [B, LH/2, LW/2] ->
    [B, rh, rw] packed-BGR i32 crops, zero-padded to pad_hw when given:
    upsample, colour, crop (the plain version of the K11 kernel)."""
    ucb = _upsample_h2v2_fancy(scb, win.ch_valid, win.cw_valid)
    ucr = _upsample_h2v2_fancy(scr, win.ch_valid, win.cw_valid)
    oy, ox, rh, rw = win.oy, win.ox, win.rh, win.rw
    packed = _ycc_to_packed_bgr(
        sy[:, oy:oy + rh, ox:ox + rw],
        ucb[:, oy:oy + rh, ox:ox + rw],
        ucr[:, oy:oy + rh, ox:ox + rw])
    if pad_hw is not None and (rh, rw) != tuple(pad_hw):
        packed = torch.nn.functional.pad(
            packed, (0, pad_hw[1] - rw, 0, pad_hw[0] - rh))
    return packed


def backhalf_to_packed(
    coef_y: torch.Tensor,    # [B, lbh*lbw, 64] i16
    coef_cb: torch.Tensor,   # [B, (lbh//2)*(lbw//2), 64] i16
    coef_cr: torch.Tensor,
    qt: torch.Tensor,        # [B, 3, 64] per-image quant tables
    win: CoefWindow,
    pad_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Block-layout coefficients -> [B, rh, rw] packed-BGR i32 crops
    (zero-padded to pad_hw when given)."""
    return tail_to_packed(*idct_planes(coef_y, coef_cb, coef_cr, qt, win),
                          win, pad_hw)


def idct_planes(coef_y: torch.Tensor, coef_cb: torch.Tensor,
                coef_cr: torch.Tensor, qt: torch.Tensor, win: CoefWindow
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-layout coefficients -> the window's spatial u8 planes
    (sy [B, lh, lw], scb and scr [B, lh/2, lw/2])."""
    if tuple(coef_y.shape[1:]) != (win.lbh * win.lbw, 64):
        raise ValueError(f"block layout expected, got {tuple(coef_y.shape)}")
    cbh, cbw = win.lbh // 2, win.lbw // 2
    return (idct_to_plane(coef_y, qt[:, 0], win.lbh, win.lbw),
            idct_to_plane(coef_cb, qt[:, 1], cbh, cbw),
            idct_to_plane(coef_cr, qt[:, 2], cbh, cbw))


def backhalf_planes_to_packed(
    fy: torch.Tensor,        # [B, lbh*8, lbw*8] i16, or compact int8
    fcb: torch.Tensor,       # [B, lbh*4, lbw*4] i16, or compact int8
    fcr: torch.Tensor,
    qt: torch.Tensor,        # [B, 3, 64]
    win: CoefWindow,
    pad_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """backhalf_to_packed for the frequency-plane layout, dense or
    compact (the plain version of the K10 kernel)."""
    if fy.dtype == torch.int8:
        fy, fcb, fcr = (uncompact_plane(a) for a in (fy, fcb, fcr))
    cbh, cbw = win.lbh // 2, win.lbw // 2
    return backhalf_to_packed(
        _plane_to_blocks(fy, win.lbh, win.lbw),
        _plane_to_blocks(fcb, cbh, cbw),
        _plane_to_blocks(fcr, cbh, cbw),
        qt, win, pad_hw=pad_hw)
