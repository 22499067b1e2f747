"""K1 `frontend`: dial-cluster localisation (template match + argmax).

Port of meterelf_tpu/ops/pallas_frontend.py frontend_pallas with
ops/template.py locate. Per image: the exact cv2 lightness L of the
packed-BGR crop, the TM_CCOEFF score of the template at every valid
offset, and the first maximum in row-major order (cv2.minMaxLoc):
-> (max_val f32, mx i32, my i32).

The score is the TPU kernel's exact decomposition (its module
docstring, item 3): corr8 = sum (L-128)(T-128) and box' = sum (L-128)
are exact integers, and

    score = (f32(corr8) + c1 * f32(box')) + c0

with c1 = 128 - tmean and c0 the residual of the f32-rounded template
mean, both from ``score_constants`` in f64 on the host. No superwindow
is produced: the windows stage reads the crop at (mx, my) directly.

``frontend`` is the wrapper: on a CPU tensor it runs ``frontend_plain``;
on a CUDA tensor it launches the CUDA kernel (csrc/frontend.cu) or
raises.

K5 ``frontend_windows`` ports pallas_frontend.frontend_windows_pallas,
the JAX decode's METERELF_FRONTEND=merged variant of the quad branch: K1
and then, in the same CUDA block, K2's 4 dial windows at the located
offset (csrc/frontend.cu with csrc/window_bits.cuh, K2's body). Its plain
version is ``frontend_plain`` followed by ``windows.windows_plain``, the
same function; it takes exactly 4 dials, as the TPU kernel does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .color import lightness_from_planes, unpack_planes
from .launch import check_cuda, counted, raise_on_error, stream_of
from .windows import WIN, Geom, host_geom, windows_plain

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

# The JAX package's frontend gate (pallas_frontend.py:132-168), copied
# with its constants: the decode takes the frontend branches for exactly
# the geometries the JAX decode does. XG is the TPU kernel's default
# correlation x-group.
XG = 32
STAGE = 256
SW_H = 136
SW_W = 256


class FrontendGeom(NamedTuple):
    """pallas_frontend.FrontendGeom: the TPU kernel's per-camera geometry
    (kept whole so that the gate is held equal field by field)."""

    crop_h: int
    crop_w: int
    th: int
    tw: int
    oh: int
    ow: int
    blk: int
    bank_k: int
    nx: int
    ow_pad: int
    xg: int


def geom_for(crop_h: int, crop_w: int,
             th: int, tw: int) -> Optional[FrontendGeom]:
    """pallas_frontend.geom_for: the geometry, or None when the crop and
    template cannot ride the TPU kernel's layout (staging inside
    [STAGE, STAGE], ow <= 128, ceil8(th) <= 128, every x-group slice
    inside the transposed image, 64 <= th <= SW_H and 64 <= tw <= SW_W so
    that the dial windows lie inside the superwindow)."""
    oh, ow = crop_h - th + 1, crop_w - tw + 1
    if oh < 1 or not (1 <= ow <= 128):
        return None
    xg = XG
    blk = -(-th // 8) * 8
    bank_k = -(-(tw + xg) // 32) * 32
    nx = -(-ow // xg)
    ow_pad = -(-ow // 8) * 8
    if not (crop_h <= STAGE and crop_w <= STAGE
            and blk <= 128
            and (nx - 1) * xg + bank_k <= STAGE + 64
            and 64 <= th <= SW_H and 64 <= tw <= SW_W):
        return None
    return FrontendGeom(crop_h, crop_w, th, tw, oh, ow,
                        blk, bank_k, nx, ow_pad, xg)


def fits(crop_h: int, crop_w: int, th: int, tw: int) -> bool:
    """pallas_frontend.fits."""
    return geom_for(crop_h, crop_w, th, tw) is not None


def smem_bytes(H: int, W: int, th: int, tw: int) -> int:
    """Shared memory the correlation stages for one image in K1, K8 and
    K9 (K5 takes the larger of this and its window stage;
    corr8::layout in csrc/corr_mma.cuh): the L - 128 rows of every
    (16 x, 8 y) tile's reach, 8 * ceil(oh / 8) + th - 1 rows of 16 * odd
    bytes covering the nj = ceil((tw + 15) / 32) k32 steps of the last x
    tile; the template rows with 16-byte zero margins, 32 * nj + 32
    bytes; and the column prefix of the row-window sums, [H + 1, ow]
    i32."""
    oh, ow = H - th + 1, W - tw + 1
    nj = -(-(tw + 15) // 32)
    ls = 16 * (-(-ow // 16) - 1) + 32 * nj
    if ls % 32 == 0:
        ls += 16
    lrows = 8 * -(-oh // 8) + th - 1
    return lrows * ls + th * (32 * nj + 32) + (H + 1) * ow * 4


def frontend_ok(crop_h: int, crop_w: int, th: int, tw: int) -> bool:
    """The frontend branches' gate: the JAX package's, and K1's staging
    within a block's shared memory (never the binding condition inside
    the JAX gate: its largest geometries stage under 228 KB)."""
    return (fits(crop_h, crop_w, th, tw)
            and smem_bytes(crop_h, crop_w, th, tw) <= SMEM_LIMIT)


def score_constants(template_u8: np.ndarray) -> Tuple[float, float]:
    """(c1, c0) as f32 values: c1 = 128 - tmean, c0 = the f64-computed
    residual 128*(Tsum - N*tmean) of the f32-rounded template mean
    tmean = f32(Tsum) / f32(N) (pallas_frontend._c1_for)."""
    t = np.asarray(template_u8)
    n = t.shape[0] * t.shape[1]
    tsum = int(t.astype(np.int64).sum())
    tmean = np.float32(tsum) / np.float32(n)
    c1 = np.float32(128.0) - tmean
    c0 = np.float32(np.float64(128.0) * (np.float64(tsum)
                                         - np.float64(n) * np.float64(tmean)))
    return float(c1), float(c0)


def _corr8(lp: torch.Tensor, tp: torch.Tensor) -> torch.Tensor:
    """Exact sum_{r,c} lp[y+r, x+c] * tp[r, c] for int32 operands in
    [-128, 127] -> int32 [B, oh, ow].

    Row correlations R[y', x, r] = sum_c lp[y', x+c] tp[r, c] go through
    an f32 matrix product: every partial sum is an integer below
    tw * 128^2 < 2^24, so f32 holds it exactly in any order (no TF32 on
    the card). The sum over template rows then runs in int32."""
    B, H, W = lp.shape
    th, tw = tp.shape
    oh, ow = H - th + 1, W - tw + 1
    if lp.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tf = tp.to(torch.float32).t()
    out = torch.empty((B, oh, ow), dtype=torch.int32, device=lp.device)
    chunk = max(1, (1 << 26) // (H * ow * tw))
    for b0 in range(0, B, chunk):
        u = lp[b0:b0 + chunk].to(torch.float32).unfold(2, tw, 1)
        rows = torch.matmul(u, tf).to(torch.int32)    # [b, H, ow, th]
        acc = torch.zeros((rows.shape[0], oh, ow), dtype=torch.int32,
                          device=lp.device)
        for r in range(th):
            acc += rows[:, r:r + oh, :, r]
        out[b0:b0 + chunk] = acc
    return out


def corr_box8(lp: torch.Tensor, tp: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corr8 i32, box' i64) [B, oh, ow] of L' = lp and T' = tp (int32 in
    [-128, 127]): sum L'T' and sum L' over the template window at every
    offset, both exact (box' from an integral image)."""
    th, tw = tp.shape
    ii = F.pad(lp.to(torch.int64).cumsum(1).cumsum(2), (1, 0, 1, 0))
    box = (ii[:, th:, tw:] - ii[:, :-th, tw:] - ii[:, th:, :-tw]
           + ii[:, :-th, :-tw])
    return _corr8(lp, tp), box


def frontend_plain(packed: torch.Tensor, template_u8: torch.Tensor,
                   c1: float, c0: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch frontend: [B, H, W] i32 packed crops, [th, tw] u8
    template -> (max_val f32 [B], mx i32 [B], my i32 [B])."""
    lp = lightness_from_planes(*unpack_planes(packed)) - 128
    tp = template_u8.to(torch.int32) - 128
    corr, box = corr_box8(lp, tp)
    f32 = torch.float32
    c1t = torch.tensor(c1, dtype=f32, device=packed.device)
    c0t = torch.tensor(c0, dtype=f32, device=packed.device)
    return locate((corr.to(f32) + c1t * box.to(f32)) + c0t)


def locate(scores: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """template.locate: scores [B, oh, ow] -> (max_val f32 [B], x i32
    [B], y i32 [B]), the first maximum in row-major order (cv2's
    minMaxLoc)."""
    B, oh, ow = scores.shape
    flat = scores.reshape(B, oh * ow)
    idx = torch.argmax(flat, dim=1)
    return (flat.gather(1, idx[:, None])[:, 0],
            (idx % ow).to(torch.int32), (idx // ow).to(torch.int32))


def _check_kernel_args(name: str, packed: torch.Tensor,
                       template_u8: torch.Tensor) -> int:
    """The checks K1 and K5 share on CUDA tensors: dtypes, a template that
    fits the crop, and K1's shared memory within a block's limit -> B."""
    check_cuda(name, packed, torch.int32, 3)
    check_cuda(name, template_u8, torch.uint8, 2, like=packed)
    B, H, W = packed.shape
    th, tw = template_u8.shape
    if not (1 <= th <= H and 1 <= tw <= W):
        raise ValueError(f"template {(th, tw)} does not fit crop {(H, W)}")
    smem = smem_bytes(H, W, th, tw)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"crop {(H, W)} with template {(th, tw)} needs {smem} B of "
            f"shared memory, above the {SMEM_LIMIT} B a block may use")
    return B


def c_args(packed: torch.Tensor, template_u8: torch.Tensor, c1: float,
           c0: float, geom: Optional[Geom] = None,
           disk: Optional[torch.Tensor] = None, hue_shift: int = 0
           ) -> Tuple[tuple, List[torch.Tensor]]:
    """The arguments of K1's C entry meterelf_frontend (geom None) or of
    K5's meterelf_frontend_windows (csrc/meterelf_kernels.h), and the
    outputs they write: [max_val f32 [B], mx i32 [B], my i32 [B]], then
    K5's bits i32 [B, 4, 64, 64]."""
    B, H, W = packed.shape
    dev = packed.device
    out = [torch.empty(B, dtype=t, device=dev)
           for t in (torch.float32, torch.int32, torch.int32)]
    head = (packed.data_ptr(), B, H, W, template_u8.data_ptr(),
            *template_u8.shape, float(c1), float(c0))
    tail = tuple(t.data_ptr() for t in out)
    if geom is None:
        return head + tail + (stream_of(dev),), out
    out.append(torch.empty((B, 4, WIN, WIN), dtype=torch.int32, device=dev))
    return (head + (host_geom(geom), disk.data_ptr(), int(hue_shift)) + tail
            + (out[3].data_ptr(), stream_of(dev))), out


def frontend(packed: torch.Tensor, template_u8: torch.Tensor,
             c1: float, c0: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 wrapper -> (max_val f32 [B], mx i32 [B], my i32 [B])."""
    if packed.device.type == "cpu":
        return frontend_plain(packed, template_u8, c1, c0)
    B = _check_kernel_args("frontend", packed, template_u8)
    args, out = c_args(packed, template_u8, c1, c0)
    if B == 0:
        return tuple(out)
    with torch.cuda.device(packed.device):
        rc = _build.library().meterelf_frontend(*args)
    raise_on_error("frontend", rc)
    frontend.launches += 1
    return tuple(out)


counted(frontend)


def frontend_windows_plain(packed: torch.Tensor, template_u8: torch.Tensor,
                           c1: float, c0: float, geom: Geom,
                           disk: torch.Tensor, hue_shift: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Plain K5: K1's then K2's plain versions -> (max_val f32 [B], mx
    i32 [B], my i32 [B], bits i32 [B, 4, 64, 64])."""
    max_val, mx, my = frontend_plain(packed, template_u8, c1, c0)
    return max_val, mx, my, windows_plain(packed, mx, my, geom, disk,
                                          hue_shift)


def frontend_windows(packed: torch.Tensor, template_u8: torch.Tensor,
                     c1: float, c0: float, geom: Geom, disk: torch.Tensor,
                     hue_shift: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """K5 wrapper -> (max_val f32 [B], mx i32 [B], my i32 [B], bits i32
    [B, 4, 64, 64]); ``geom``, ``disk`` and ``hue_shift`` as
    windows.windows takes them, for exactly 4 dials."""
    if len(geom) != 4:
        raise ValueError(f"frontend_windows takes 4 dials, got {len(geom)}")
    if packed.device.type == "cpu":
        return frontend_windows_plain(packed, template_u8, c1, c0, geom,
                                      disk, hue_shift)
    B = _check_kernel_args("frontend_windows", packed, template_u8)
    # the kernel reads the disk two bytes at a time
    check_cuda("frontend_windows", disk, torch.uint8, 3, like=packed,
               align=2)
    if tuple(disk.shape) != (4, WIN, WIN):
        raise ValueError(f"disk shape {tuple(disk.shape)} != {(4, WIN, WIN)}")
    args, out = c_args(packed, template_u8, c1, c0, geom, disk, hue_shift)
    if B == 0:
        return tuple(out)
    with torch.cuda.device(packed.device):
        rc = _build.library().meterelf_frontend_windows(*args)
    raise_on_error("frontend_windows", rc)
    frontend_windows.launches += 1
    return tuple(out)


counted(frontend_windows)
