"""The batched decode path: packed-BGR meter crops in, per-image readings
and error codes out.

Port of meterelf_tpu/pipeline/decode.py ``_decode_batch`` and
``MeterDecoder``, with the JAX graph's three branches, chosen by the same
gates (copied: ops/frontend.fits, ops/match.fits, ``_stats_bbox``) and
the same static arguments (``MeterDecoder.static_kwargs``):

- **quad** (the frontend fits, 4 dials, every dial centre at least 2 px
  inside its window): K1 frontend (template match and first-max
  location, ops/frontend.py) -> K2 windows (exact HLS, 5x5 colour
  sample, inRange, 3x3 close per dial window at the match location,
  ops/windows.py) -> K3 ccl (ops/ccl.py) -> K4 stats (ops/stats.py) ->
  angles from okey3;
- **frontend, non-quad** (another dial count, or a centre within 2 px of
  its window edge): K1 -> K2 -> K6 propagate -> components.finalize
  (largest component and needle region) -> angles from the region;
- **scorer-only** (the frontend gate refuses the geometry, or
  ``static_win_origin`` is None): the lightness map, K8 match_scores
  (ops/match.py) where pallas_match2's gate admits it, else the JAX
  package's matmul scorer in torch -> first-max locate -> K2 -> K6 ->
  finalize -> angles.

Every branch ends in f64 angle statistics, the carry-corrected value
(4 dials) and the reference's error priority (decode.py:440-467). On a
CUDA device every kernel stage launches its CUDA kernel; on the CPU the
same code runs each kernel's plain torch version.

The quad branch takes the JAX decode's two variant knobs, read when the
decoder is built (``MeterDecoder(frontend=, quad_stats=)``, else the
environment, with the JAX package's names and defaults):

- ``METERELF_FRONTEND``: ``split`` (default: K1, then K2) or ``merged``
  (K5 frontend_windows, ops/frontend.py: both in one CUDA block);
- ``METERELF_QUAD_STATS``: ``fused`` (default: K3 with the closed bit,
  K4, angles from okey3) or ``hist_pallas``, ``sort``, ``hist`` (K6, the
  JAX graph's propagate_quads(pack_closed=False), then
  components.finalize with K7 for hist_pallas or the torch sort for sort
  and hist, two XLA formulations of K7's selection; angles from the
  needle region). A ``_interpret`` suffix, the JAX package's switch to
  Pallas interpret mode, is accepted and means nothing here.

``MeterDecoder(exact=False)`` is the JAX package's fast mode: the
geometry of the angle statistics (``FAST_F32``) goes to the device as
float32, and ops/angles.py works in that dtype where the JAX package
does, summing in float64 as before.

The other branches read neither knob, as in JAX. ``METERELF_STATS_SLICED``,
``METERELF_CCL_DEQUAD`` and ``METERELF_STATS_GW`` change only the TPU
kernels' layouts and give the same results: they select nothing in the
port.

``make_coef_decode_fn`` puts the JPEG back-half of the coefficient feed
(ops/jpeg_tail.py: K10, or the plain IDCT and K11 on the block layout)
and the fallback slots in front of the same decode.
"""
from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import ErrCode
from ..params import Params, to_device
from ..ops import match
from ..ops.angles import assemble_value, read_dials, read_dials_region
from ..ops.ccl import analyze_batch, ccl
from ..ops.color import lightness_from_planes, unpack_planes
from ..ops.components import RESCUE_CAPS, StatsBox
from ..ops.frontend import (frontend, frontend_ok, frontend_windows, locate,
                            score_constants)
from ..ops.jpeg_tail import backhalf_blocks, backhalf_planes
from ..ops.jpegdec import CoefWindow, coef_window
from ..ops.stats import stats
from ..ops.windows import windows

W = 64
FRONTENDS = ("split", "merged")
QUAD_STATS = ("fused", "hist_pallas", "sort", "hist")
# the ParamArrays fields exact=False demotes to float32 (JAX decode.py:607)
FAST_F32 = ("zero_turn", "disk_sx2", "disk_sy2", "ann_x", "ann_y",
            "ann_angle", "ann_sqd")


def _variant(value: Optional[str], env: str, default: str,
             choices: Tuple[str, ...]) -> str:
    """A knob's value: the argument, else the environment variable, else
    the JAX package's default; a ``_interpret`` suffix is dropped. An
    unknown value raises."""
    v = os.environ.get(env, default) if value is None else value
    base = v[:-len("_interpret")] if v.endswith("_interpret") else v
    if base not in choices:
        raise ValueError(f"{env}={v!r}: expected one of {choices}")
    return base


class BatchResult(NamedTuple):
    err: Any              # [B] i32 ErrCode
    first_bad_dial: Any   # [B] i32 (valid when err == NEEDLE_CONTOURS)
    unreadable_bits: Any  # [B] i32 bitmask (valid when err == DIAL_ANGLE)
    match_val: Any        # [B] f32
    match_x: Any          # [B] i32
    match_y: Any          # [B] i32
    dial_pos: Any         # [B, D] f64
    readable: Any         # [B, D] bool
    value: Any            # [B] f64
    converged: Any        # [B] bool: CCL propagation fixpoint check


class MeterDecoder:
    """Batched decoder for one camera configuration on one torch device.

    Duck-types meterelf_tpu.pipeline.decode.MeterDecoder: ``__call__``
    returns a BatchResult of device tensors (asynchronously on CUDA),
    ``decode_numpy`` and ``rescue_numpy`` return numpy fields, and
    ``feed_pad_hw`` is the (H, W) packed crops should have (the true
    crop: the TPU's 256x256 staging pad has no use here). ``exact=False``
    is the JAX package's fast mode (module docstring). A CUDA device
    without a GPU raises; nothing falls back to the CPU.
    """

    def __init__(self, params: Params, *, exact: bool = True,
                 device: Any = "cuda", frontend: Optional[str] = None,
                 quad_stats: Optional[str] = None) -> None:
        # the quad branch's variants (module docstring); None reads the
        # environment, as the JAX package does at import
        self.frontend = _variant(frontend, "METERELF_FRONTEND", "split",
                                 FRONTENDS)
        self.quad_stats = _variant(quad_stats, "METERELF_QUAD_STATS",
                                   "fused", QUAD_STATS)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MeterDecoder(device='cuda'): no CUDA device is available")
        self.params = params
        self.exact = exact
        host = params.arrays()
        if not exact:
            host = host._replace(**{k: getattr(host, k).astype(np.float32)
                                    for k in FAST_F32})
        self.param_arrays = to_device(host, self.device)
        h, w = params.meter_rect.height, params.meter_rect.width
        self.crop_shape = (h, w, 3)
        self.feed_pad_hw = (h, w)
        self.score_c1, self.score_c0 = score_constants(host.template_u8)
        self._threshold = float(host.threshold)
        self.hue_shift = int(host.hue_shift)
        # per dial (ox, oy, cx, cy, cr_h, cr_l, cr_s): ops/windows.py geom
        self.geom = tuple(
            (ox, oy, cx, cy, *(int(c) for c in cr))
            for (ox, oy), (cx, cy), cr in zip(
                self.param_arrays.win_origin, self.param_arrays.centers_int,
                np.asarray(host.color_range)))
        self.disk = self.param_arrays.mask_full.to(torch.uint8)
        th, tw = host.template_u8.shape
        self.tmean = float(np.float32(np.asarray(host.template_u8, np.int64)
                                      .sum()) / np.float32(th * tw))
        # the JAX decoder's static arguments (decode.py:629-651): centres
        # are static only when the 5x5 sample stays inside every window
        centers = self.param_arrays.centers_int
        safe = all(2 <= cx <= W - 3 and 2 <= cy <= W - 3
                   for cx, cy in centers)
        self.static_kwargs = dict(
            static_win_origin=self.param_arrays.win_origin,
            static_centers=centers if safe else None,
            static_crop_hw=(h, w),
            static_bbox=_stats_bbox(np.asarray(host.mask_full)),
        )

    def _packed(self, crops: Any) -> torch.Tensor:
        x = torch.as_tensor(crops).to(self.device)
        h, w = self.feed_pad_hw
        if x.dim() == 4:          # [B, H, W, 3] u8 BGR -> packed i32
            c = x.to(torch.int32)
            x = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
        if x.dim() != 3 or x.shape[1] < h or x.shape[2] < w:
            raise ValueError(f"crops of shape {tuple(x.shape)}: expected "
                             f"[B, {h}, {w}] packed i32 or [B, {h}, {w}, 3]")
        return x[:, :h, :w].to(torch.int32).contiguous()

    def _load_ok(self, load_ok: Any, B: int) -> torch.Tensor:
        if load_ok is None:
            return torch.ones(B, dtype=torch.bool, device=self.device)
        return torch.as_tensor(load_ok).to(self.device, torch.bool)

    def decode(self, crops: Any, load_ok: Any = None,
               caps: Optional[Sequence[int]] = None) -> BatchResult:
        """One batch under the given CCL caps (default caps when None),
        as device tensors."""
        packed = self._packed(crops)
        return _decode_batch(self, packed, self._load_ok(load_ok,
                                                         packed.shape[0]),
                             caps=caps, **self.static_kwargs)

    def __call__(self, crops: Any, load_ok: Any = None) -> BatchResult:
        return self.decode(crops, load_ok)

    def decode_numpy(self, crops: Any,
                     load_ok: Optional[np.ndarray] = None) -> BatchResult:
        """Decode and pull results to host numpy. Rows whose component
        propagation did not converge under the default caps are decoded
        again under RESCUE_CAPS (see rescue_numpy)."""
        res = _to_numpy(self(crops, load_ok))
        return self.rescue_numpy(crops, res, load_ok)

    def rescue_numpy(self, crops: Any, res: BatchResult,
                     load_ok: Optional[np.ndarray] = None) -> BatchResult:
        """Replace the non-converged rows of a host BatchResult for
        ``crops`` by a decode under RESCUE_CAPS; raise if rows are still
        non-converged then (no mislabeled reading is ever returned)."""
        if bool(np.asarray(res.converged).all()):
            return res
        res2 = _to_numpy(self.decode(crops, load_ok, caps=RESCUE_CAPS))
        if not bool(res2.converged.all()):
            bad = np.nonzero(~res2.converged)[0].tolist()
            raise RuntimeError(
                "component propagation failed to converge even under "
                f"rescue caps for batch rows {bad}; refusing to emit "
                "potentially mislabeled readings")
        take = np.asarray(res.converged)
        return BatchResult(*[
            np.where(take.reshape(take.shape + (1,) * (a.ndim - 1)), a, b)
            for a, b in zip((np.asarray(v) for v in res), res2)])


def _decode_batch(dec: MeterDecoder, packed: torch.Tensor,
                  load_ok: torch.Tensor, *, static_win_origin: Any,
                  static_centers: Any, static_crop_hw: Tuple[int, int],
                  static_bbox: Optional[StatsBox],
                  caps: Optional[Sequence[int]]) -> BatchResult:
    """decode.py _decode_batch: packed [B, H, W] i32 crops -> BatchResult
    of device tensors, on the branch the static arguments and gates pick,
    and on the quad branch the decoder's variant (module docstring)."""
    B = packed.shape[0]
    D = len(dec.geom)
    pa = dec.param_arrays
    th, tw = pa.template_u8.shape
    use_frontend = (frontend_ok(*static_crop_hw, th, tw)
                    and static_win_origin is not None
                    and len(static_win_origin) == D)
    use_quad = use_frontend and D == 4 and static_centers is not None

    bits = None
    if use_quad and dec.frontend == "merged":
        max_val, mx, my, bits = frontend_windows(
            packed, pa.template_u8, dec.score_c1, dec.score_c0, dec.geom,
            dec.disk, dec.hue_shift)
    elif use_frontend:
        max_val, mx, my = frontend(packed, pa.template_u8, dec.score_c1,
                                   dec.score_c0)
    else:
        lightness = lightness_from_planes(*unpack_planes(packed)).to(
            torch.float32)
        score = (match.match_scores
                 if match.fits(*lightness.shape[1:], th, tw)
                 else match.scores_matmul)
        max_val, mx, my = locate(score(lightness, pa.template_u8,
                                       dec.tmean))
    if bits is None:
        bits = windows(packed, mx, my, dec.geom, dec.disk, dec.hue_shift)
    if use_quad and dec.quad_stats == "fused":
        okey3, conv = ccl(bits.reshape(B * D, W, W), caps)
        keymax, has_any = stats(okey3)
        positions, readable = read_dials(
            okey3.reshape(B, D, W * W), keymax.reshape(B, D), pa)
    else:
        comp = analyze_batch(bits.reshape(B * D, W, W), static_bbox, caps,
                             dec.quad_stats if use_quad else "sort")
        has_any, conv = comp.has_any, comp.converged
        positions, readable = read_dials_region(
            comp.needle_region.reshape(B, D, W * W), pa)
    if D == 4:
        value = assemble_value(positions, pa.value_perm)
    else:
        value = torch.zeros(B, dtype=positions.dtype, device=packed.device)
    err, first_bad, unreadable_bits = _error_codes(
        load_ok, max_val >= dec._threshold, has_any.reshape(B, D), readable)
    return BatchResult(
        err=err,
        first_bad_dial=first_bad,
        unreadable_bits=unreadable_bits,
        match_val=max_val,
        match_x=mx,
        match_y=my,
        dial_pos=positions,
        readable=readable,
        value=value,
        converged=conv.reshape(B, D).all(dim=1),
    )


def _stats_bbox(mask_full: np.ndarray, sb: int = 48
                ) -> Optional[StatsBox]:
    """decode.py _stats_bbox: the static per-dial SB x SB box holding every
    disk pixel, for the component-stats sort; None when a dial's disk does
    not fit one (the stats then cover the whole window)."""
    D, W_, _ = mask_full.shape
    origins = []
    for i in range(D):
        ys, xs = np.nonzero(np.asarray(mask_full[i]))
        if len(xs) == 0:
            return None
        ox = int(min(xs.min(), W_ - sb))
        oy = int(min(ys.min(), W_ - sb))
        if xs.max() >= ox + sb or ys.max() >= oy + sb:
            return None
        origins.append((ox, oy))
    return (tuple(origins), sb)


def make_coef_decode_fn(dec: MeterDecoder, frame_wh: Tuple[int, int]
                        ) -> Tuple[Callable[..., BatchResult], CoefWindow,
                                   Tuple[int, int]]:
    """The coefficient feed's decode step (port of
    meterelf_tpu/pipeline/decode.py make_coef_decode_fn).

    Returns (step, win, pad_hw). ``step(pa, coef_y, coef_cb, coef_cr, qt,
    load_ok, fb_packed, fb_idx) -> BatchResult`` (device tensors) takes
    the arrays of io.jpeg.load_coef_feed, host or device: it finishes the
    JPEG decode on ``dec``'s device (K10 on compact int8 or dense i16
    frequency planes, the plain IDCT and K11 on i16 blocks, dispatched on
    dtype and shape), writes the fallback rows ``fb_packed[j]`` over row
    ``fb_idx[j]`` for the slots with -B <= fb_idx[j] < B, a negative
    index counting from the end as in numpy (the others are dropped: the
    scatter of JAX's mode="drop"), and decodes the [B, rh, rw] crops.
    ``pa`` is accepted for the JAX package's signature; the decoder's own
    device arrays are used. ``win`` is the CoefWindow the feed must
    match, ``pad_hw`` the crop shape (``dec.feed_pad_hw``) at which the
    back-half writes the crops and the fallback slots are staged."""
    rect = dec.params.meter_rect
    win = coef_window(rect, frame_wh[0], frame_wh[1])
    pad_hw = dec.feed_pad_hw
    plane_shape = (win.lbh * 8, win.lbw * 8)
    block_shape = (win.lbh * win.lbw, 64)
    if plane_shape == block_shape:
        raise ValueError(f"ambiguous coefficient layouts for window {win}")
    dev = dec.device

    def step(pa: Any, cy: Any, cb: Any, cr: Any, qt: Any, ok: Any,
             fb_packed: Any, fb_idx: Any) -> BatchResult:
        del pa
        cy, cb, cr, qt = (torch.as_tensor(a).to(dev) for a in (cy, cb, cr, qt))
        rows, cols = cy.shape[1:]
        if cy.dtype == torch.int8:
            rows = rows * 2 // 3      # compact wire: 3/2 stored rows a row
        if (rows, cols) == plane_shape:
            packed = backhalf_planes(cy, cb, cr, qt, win, pad_hw)
        elif tuple(cy.shape[1:]) == block_shape:
            packed = backhalf_blocks(cy, cb, cr, qt, win, pad_hw)
        else:
            raise ValueError(f"coefficients of shape {tuple(cy.shape)} fit "
                             f"neither layout of window {win}")
        # the slot choice runs on the host (the feed's fb_idx is numpy):
        # no device sync, and unused slots never cross to the device
        B = packed.shape[0]
        idx = torch.as_tensor(fb_idx).cpu().to(torch.int64)
        idx = torch.where(idx < 0, idx + B, idx)
        keep = (idx >= 0) & (idx < B)
        if bool(keep.any()):
            fb = torch.as_tensor(fb_packed)
            packed[idx[keep].to(dev)] = fb[keep.to(fb.device)].to(
                dev, torch.int32)
        return dec.decode(packed, ok)

    return step, win, pad_hw


def _to_numpy(res: BatchResult) -> BatchResult:
    return BatchResult(*[v.cpu().numpy() for v in res])


def _error_codes(load_ok: torch.Tensor, match_ok: torch.Tensor,
                 has_any: torch.Tensor, readable: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's raise order (decode.py:440-467): load failure,
    then template match below threshold, then the first dial with no
    needle contours, then any unreadable dial."""
    i32 = torch.int32
    D = has_any.shape[1]
    no_contours = ~has_any
    first_bad = torch.argmax(no_contours.to(i32), dim=1).to(i32)
    unreadable = ~readable
    weights = torch.tensor([1 << d for d in range(D)], dtype=i32,
                           device=readable.device)
    bits = (unreadable.to(i32) * weights).sum(dim=1).to(i32)

    def code(c: ErrCode) -> torch.Tensor:
        return torch.tensor(int(c), dtype=i32, device=readable.device)

    err = torch.where(
        ~load_ok, code(ErrCode.LOAD),
        torch.where(
            ~match_ok, code(ErrCode.DIALS_NOT_FOUND),
            torch.where(
                no_contours.any(dim=1), code(ErrCode.NEEDLE_CONTOURS),
                torch.where(unreadable.any(dim=1), code(ErrCode.DIAL_ANGLE),
                            code(ErrCode.OK)))))
    return err, first_bad, bits
