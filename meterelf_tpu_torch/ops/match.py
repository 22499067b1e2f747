"""K8 `match_scores`: the full TM_CCOEFF score map, for the scorer-only
decode branch; and the torch ports of that branch's other scorer and of
its argmax.

- ``match_scores`` (K8) ports meterelf_tpu/ops/pallas_match2.py
  match_scores_pallas_fused: lightness [B, H, W] f32 (integer values),
  template [th, tw] u8, tmean f32 -> scores = corr - tmean * box, f32
  [B, oh, ow]. corr = sum L*T and box = sum L are exact integers (the
  int8 decomposition of K1), and the score is f32(corr) - tmean *
  f32(box), each operation rounded once. Its bound on the H100 is its
  int8 multiply-adds (47.63 G a flagship batch of 256); it runs them
  on the int8 tensor cores as K5 does, an implicit GEMM of
  mma.sync.m16n8k32 instructions against a band matrix built from each
  template row in registers, with the image staged once in shared
  memory (csrc/corr_mma.cuh; csrc/frontend.cu notes what bounds the
  loop as measured). The TPU
  kernel sums its row partials in f32, so its map agrees with this one
  within a relative tolerance, not bit for bit (tests state it).
  ``match_scores_plain`` computes the same map in torch, bit-equal to the
  kernel.
- ``match_corr`` (K9) ports meterelf_tpu/ops/pallas_match.py
  match_scores_pallas, the v1 scorer (only the JAX package's tests and
  experiments call it): K8's kernel without the score, corr = sum L*T
  exact in i32, written as f32 [B, oh, ow]. ``match_scores_v1`` adds
  what the JAX function does outside its kernel: an f32 integral-image
  box sum (exact: every partial sum is an integer below 2^24) and corr -
  tmean * box. It equals K8's map bit for bit (the JAX package's own
  contract, tests/test_ops.py test_fused_matcher_matches_v1_plus_boxsum).
  ``match_corr_plain`` is K9's plain version.
- ``fits`` is pallas_match2.fits, the gate of the JAX decode: geometries
  past it take ``scores_matmul``.
- ``scores_matmul`` ports template.match_template_scores_matmul, the
  JAX package's XLA scorer: row correlations R[r, y', x] (exact f32
  integers), then corr = sum_r R[r, y + r, x] and box likewise, summed in
  f32 in the order r = 0, 1, ... as the JAX graph adds them. No TF32.
The first-max argmax after either scorer is frontend.locate
(template.locate).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .frontend import SMEM_LIMIT, corr_box8, smem_bytes
from .launch import check_cuda, counted, raise_on_error, stream_of

# pallas_match.py:32-35: the TPU kernels' padded shapes
H_PAD = 256
W_PAD = 256
R_PAD = 128
K_PAD = 192


def fits(h: int, w: int, th: int, tw: int) -> bool:
    """pallas_match2.fits: can (h, w) lightness maps with a (th, tw)
    template ride the TPU scorer's padded geometry?"""
    oh, ow = h - th + 1, w - tw + 1
    if oh < 1 or ow < 1:
        return False
    oh_pad = -(-oh // 8) * 8
    return (h <= H_PAD and w <= W_PAD
            and th <= min(R_PAD, 128) and tw <= K_PAD
            and ow - 1 + K_PAD <= W_PAD
            and th - 1 + oh_pad <= H_PAD
            and oh_pad + th - 1 <= H_PAD)


def match_scores_plain(lightness: torch.Tensor, template_u8: torch.Tensor,
                       tmean: float) -> torch.Tensor:
    """Plain torch K8 -> scores f32 [B, oh, ow]."""
    th, tw = template_u8.shape
    lp = lightness.to(torch.int32) - 128
    corr8, boxp = corr_box8(lp, template_u8.to(torch.int32) - 128)
    tsum = int(template_u8.to(torch.int64).sum())
    corr = corr8.to(torch.int64) + 128 * boxp + 128 * tsum
    box = boxp + 128 * th * tw
    f32 = torch.float32
    tm = torch.tensor(tmean, dtype=f32, device=lightness.device)
    return corr.to(f32) - tm * box.to(f32)


def match_scores(lightness: torch.Tensor, template_u8: torch.Tensor,
                 tmean: float) -> torch.Tensor:
    """K8 wrapper -> scores f32 [B, oh, ow]."""
    if lightness.device.type == "cpu":
        return match_scores_plain(lightness, template_u8, tmean)
    check_cuda("match_scores", lightness, torch.float32, 3)
    check_cuda("match_scores", template_u8, torch.uint8, 2, like=lightness)
    B, H, W = lightness.shape
    th, tw = template_u8.shape
    if not fits(H, W, th, tw) or smem_bytes(H, W, th, tw) > SMEM_LIMIT:
        raise ValueError(f"match_scores kernel: map {(H, W)} with template "
                         f"{(th, tw)} is outside its gate")
    dev = lightness.device
    scores = torch.empty((B, H - th + 1, W - tw + 1), dtype=torch.float32,
                         device=dev)
    if B == 0:
        return scores
    tsum = int(template_u8.to(torch.int64).sum())
    with torch.cuda.device(dev):
        rc = _build.library().meterelf_match_scores(
            lightness.data_ptr(), B, H, W, template_u8.data_ptr(), th, tw,
            tsum, float(tmean), scores.data_ptr(), stream_of(dev))
    raise_on_error("match_scores", rc)
    match_scores.launches += 1
    return scores


counted(match_scores)


def match_corr_plain(lightness: torch.Tensor, template_u8: torch.Tensor
                     ) -> torch.Tensor:
    """Plain K9 -> corr = sum L*T as f32 [B, oh, ow] (exact integers,
    rounded to f32 once)."""
    lp = lightness.to(torch.int32) - 128
    corr8, boxp = corr_box8(lp, template_u8.to(torch.int32) - 128)
    tsum = int(template_u8.to(torch.int64).sum())
    return (corr8.to(torch.int64) + 128 * boxp + 128 * tsum).to(torch.float32)


def match_corr(lightness: torch.Tensor, template_u8: torch.Tensor
               ) -> torch.Tensor:
    """K9 wrapper -> corr f32 [B, oh, ow]."""
    if lightness.device.type == "cpu":
        return match_corr_plain(lightness, template_u8)
    check_cuda("match_corr", lightness, torch.float32, 3)
    check_cuda("match_corr", template_u8, torch.uint8, 2, like=lightness)
    B, H, W = lightness.shape
    th, tw = template_u8.shape
    if not fits(H, W, th, tw) or smem_bytes(H, W, th, tw) > SMEM_LIMIT:
        raise ValueError(f"match_corr kernel: map {(H, W)} with template "
                         f"{(th, tw)} is outside its gate")
    dev = lightness.device
    corr = torch.empty((B, H - th + 1, W - tw + 1), dtype=torch.float32,
                       device=dev)
    if B == 0:
        return corr
    tsum = int(template_u8.to(torch.int64).sum())
    with torch.cuda.device(dev):
        rc = _build.library().meterelf_match_corr(
            lightness.data_ptr(), B, H, W, template_u8.data_ptr(), th, tw,
            tsum, corr.data_ptr(), stream_of(dev))
    raise_on_error("match_corr", rc)
    match_corr.launches += 1
    return corr


counted(match_corr)


def match_scores_v1(lightness: torch.Tensor, template_u8: torch.Tensor,
                    tmean: float) -> torch.Tensor:
    """pallas_match.match_scores_pallas: K9's corr, then an f32
    integral-image box sum and corr - tmean * box -> scores f32 [B, oh,
    ow]. Specialised to the meterelf shape family, as the TPU function
    asserts."""
    B, H, W = lightness.shape
    th, tw = template_u8.shape
    if (H, W, th, tw) != (250, 250, 119, 188):
        raise ValueError("the v1 matcher is specialised to the meterelf "
                         f"shape family, got {(H, W, th, tw)}")
    corr = match_corr(lightness, template_u8)
    cs = F.pad(lightness.to(torch.float32).cumsum(1).cumsum(2), (1, 0, 1, 0))
    box = (cs[:, th:, tw:] - cs[:, :-th, tw:]
           - cs[:, th:, :-tw] + cs[:, :-th, :-tw])
    tm = torch.tensor(tmean, dtype=torch.float32, device=lightness.device)
    return corr - tm * box


def scores_matmul(lightness: torch.Tensor, template_u8: torch.Tensor,
                  tmean: float) -> torch.Tensor:
    """template.match_template_scores_matmul -> scores f32 [B, oh, ow]."""
    B, H, W = lightness.shape
    th, tw = template_u8.shape
    oh = H - th + 1
    if lightness.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    f32 = torch.float32
    t_aug = torch.cat([template_u8.to(f32),
                       torch.ones((1, tw), dtype=f32,
                                  device=template_u8.device)])
    chunk = max(1, (1 << 26) // (H * (W - tw + 1) * tw))
    out = []
    for b0 in range(0, B, chunk):
        u = lightness[b0:b0 + chunk].to(f32).unfold(2, tw, 1)
        R = torch.matmul(u, t_aug.t())          # [b, H, ow, th + 1], exact
        corr = R[:, 0:oh, :, 0].clone()
        box = R[:, 0:oh, :, th].clone()
        for r in range(1, th):
            corr = corr + R[:, r:r + oh, :, r]
            box = box + R[:, r:r + oh, :, th]
        tm = torch.tensor(tmean, dtype=f32, device=lightness.device)
        out.append(corr - tm * box)
    return torch.cat(out)

