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

Every branch ends in f64 angle statistics and the carry-corrected value
(4 dials; K12 readout, ops/angles.py), then the reference's error
priority (decode.py:440-467) and the BatchResult, whose ten fields are
views of one buffer (K13 result_pack, ops/result.py), so that
``to_host_later`` copies a result to the host once. On a CUDA device
every kernel stage launches its CUDA kernel; on the CPU the same code
runs each kernel's plain torch version.

``MeterDecoder(exact=False)`` is the JAX package's fast mode: the
geometry of the angle statistics (``FAST_F32``) goes to the device as
float32, and ops/angles.py works in that dtype where the JAX package
does, summing in float64 as before.

The JAX package's decode knobs (``METERELF_FRONTEND``,
``METERELF_QUAD_STATS``, ``METERELF_CCL_SKIPREV``, ``_CCL_GLUE``,
``_CCL_GQ``, ``_STATS_GW``, ``_STATS_SLICED``, ``_CCL_DEQUAD``,
``_FE_SHEAR``, ``_FE_XG`` and ``_CCL_RIDMM``) change only its TPU program
and give the same readings, so the port reads none of them.

``make_coef_decode_fn`` puts the JPEG back-half of the coefficient feed
(ops/jpeg_tail.py: K10, or the plain IDCT and K11 on the block layout)
and the fallback slots in front of the same decode.

The step replays CUDA graphs (pipeline/graphs.py) where it can see that
capture is safe: a CUDA device, the plane layout (K10), a load mask
given, and the decoder on the quad branch at the default caps, which
launch only the port's kernels and glue with no host sync. There K10 is
one graph, the step's, and the decode from its crops to K13's buffer
another, the decoder's (``MeterDecoder.graph_crops``), each captured
once a step shape and input placement and replayed every batch after;
the fallback slots are written between the two replays, eagerly. The
result is copied out of the graph's memory into a fresh buffer, so that
no result aliases graph memory. Everything else runs eagerly: the CPU,
the block layout, the general and scorer-only branches, the rescue under
RESCUE_CAPS and ``MeterDecoder.decode`` on the caller's own crops.

Each stage of the step and of ``_decode_batch``, and the result's copy
and wait (``to_host_later``), runs in one flat span of profiling.py
(``meterelf.step.backhalf``, ``meterelf.decode.*``, ``meterelf.result.*``;
on the graphs' path ``meterelf.step.backhalf`` holds the input placement
and the slot choice, and ``meterelf.step.graph`` the two replays, the
slots' scatter and the result's copy out of the graph): a profiler range
under an active torch.profiler, a shared no-op otherwise.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..params import Params, to_device
from ..profiling import count, span
from ..ops import match
from ..ops.angles import readout
from ..ops.ccl import analyze_batch, ccl
from ..ops.color import lightness_from_planes, unpack_planes
from ..ops.components import RESCUE_CAPS, StatsBox
from ..ops.frontend import frontend, frontend_ok, locate, score_constants
from ..ops.jpeg_tail import backhalf_blocks, backhalf_planes
from ..ops.jpegdec import CoefWindow, coef_window
from ..ops.result import buffer_of, copied, packed_recipe, result_pack
from ..ops.stats import stats
from ..ops.windows import windows
from . import graphs

W = 64
# the ParamArrays fields exact=False demotes to float32 (JAX decode.py:607)
FAST_F32 = ("zero_turn", "disk_sx2", "disk_sy2", "ann_x", "ann_y",
            "ann_angle", "ann_sqd")


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
    returns a BatchResult of device tensors; on CUDA it returns before
    the card has run it, and the quad branch's call never waits for the
    card (host inputs go up through pinned, non-blocking copies; no
    tensor is built from host values per call), so the host can prepare
    the next batch meanwhile; ``decode_numpy`` and ``rescue_numpy``
    return numpy fields, and
    ``feed_pad_hw`` is the (H, W) packed crops should have (the true
    crop: the TPU's 256x256 staging pad has no use here). ``exact=False``
    is the JAX package's fast mode (module docstring). A CUDA device
    without a GPU raises; nothing falls back to the CPU.
    """

    def __init__(self, params: Params, *, exact: bool = True,
                 device: Any = "cuda") -> None:
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
        # decode graphs (graph_crops), by id of the crops buffer they read;
        # a replay returns the whole u8 buffer of K13's result
        self._graphs: Dict[int, graphs.Graph] = {}

    def _packed(self, crops: Any) -> torch.Tensor:
        x = upload(crops, self.device)
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
        return upload(load_ok, self.device).to(torch.bool)

    def decode(self, crops: Any, load_ok: Any = None,
               caps: Optional[Sequence[int]] = None) -> BatchResult:
        """One batch under the given CCL caps (default caps when None),
        as device tensors; at the default caps on buffers handed to
        ``graph_crops``, a replay of their decode graph."""
        g = self._graphs.get(id(crops))
        if (g is not None and caps is None and g.args[0] is crops
                and g.args[1] is load_ok):
            return BatchResult(*copied(g.replay(), crops.shape[0],
                                       len(self.geom)))
        return self._decode(crops, load_ok, caps)

    def _decode(self, crops: Any, load_ok: Any,
                caps: Optional[Sequence[int]]) -> BatchResult:
        packed = self._packed(crops)
        return _decode_batch(self, packed, self._load_ok(load_ok,
                                                         packed.shape[0]),
                             caps=caps, **self.static_kwargs)

    def graph_crops(self, crops: torch.Tensor, load_ok: torch.Tensor
                    ) -> None:
        """Have each later ``decode(crops, load_ok)`` at the default caps
        replay one CUDA graph of that decode (pipeline/graphs.Graph,
        captured at the first such call) and return a fresh copy of its
        result, which no later replay overwrites. ``crops`` [B, h, w] i32
        and ``load_ok`` [B] bool lie on the decoder's CUDA device, and the
        caller rewrites them in place between calls: the coefficient
        step's back-half graph's output and load mask
        (make_coef_decode_fn)."""
        if id(crops) not in self._graphs:
            self._graphs[id(crops)] = graphs.Graph(
                self.device,
                lambda c, ok: buffer_of(self._decode(c, ok, None)),
                (crops, load_ok))

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
        conv = np.asarray(res.converged)
        if bool(conv.all()):
            return res
        count("rescued_rows", int(conv.size - np.count_nonzero(conv)))
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
    of device tensors, on the branch the static arguments and gates pick
    (module docstring)."""
    B = packed.shape[0]
    D = len(dec.geom)
    pa = dec.param_arrays
    th, tw = pa.template_u8.shape
    use_frontend, use_quad = _gates(dec, static_win_origin, static_centers,
                                    static_crop_hw)

    # one flat span a stage (profiling.py)
    with span("meterelf.decode.frontend"):
        if use_frontend:
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
    with span("meterelf.decode.windows"):
        bits = windows(packed, mx, my, dec.geom, dec.disk,
                       dec.hue_shift).reshape(B * D, W, W)
    if use_quad:
        with span("meterelf.decode.ccl"):
            okey3, conv = ccl(bits, caps)
        with span("meterelf.decode.stats"):
            keymax, has_any = stats(okey3)
    else:
        # analyze_batch opens the ccl and stats spans
        comp = analyze_batch(bits, static_bbox, caps)
        has_any, conv = comp.has_any, comp.converged
    with span("meterelf.decode.angles"):
        src, km = ((okey3, keymax.view(B, D)) if use_quad
                   else (comp.needle_region, None))
        positions, readable, value = readout(src.view(B, D, W * W), km, pa)
    with span("meterelf.decode.errors"):
        # K13: the error codes, the converged reduction and the ten
        # fields, views of one buffer (ops/result.py)
        return BatchResult(*result_pack(
            load_ok, max_val, mx, my, dec._threshold, has_any, conv,
            positions, readable, value))


def _gates(dec: MeterDecoder, static_win_origin: Any, static_centers: Any,
           static_crop_hw: Tuple[int, int], **_: Any) -> Tuple[bool, bool]:
    """(use_frontend, use_quad): the JAX graph's branch gates on the
    decoder's static arguments (module docstring)."""
    th, tw = dec.param_arrays.template_u8.shape
    D = len(dec.geom)
    use_frontend = (frontend_ok(*static_crop_hw, th, tw)
                    and static_win_origin is not None
                    and len(static_win_origin) == D)
    return use_frontend, use_frontend and D == 4 and static_centers is not None


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
    back-half writes the crops and the fallback slots are staged.

    On a CUDA device, on the plane layout with a load mask, and while the
    decoder takes the quad branch, the step replays its back-half graph
    for the inputs' shape and placement, then the decoder's graph of the
    decode of that graph's crops (pipeline/graphs.py, each captured on
    first sight), writing the kept fallback slots between the two
    replays; it returns a fresh copy of the result, which no later replay
    overwrites. Otherwise every stage runs eagerly, as the module
    docstring says."""
    rect = dec.params.meter_rect
    win = coef_window(rect, frame_wh[0], frame_wh[1])
    pad_hw = dec.feed_pad_hw
    plane_shape = (win.lbh * 8, win.lbw * 8)
    block_shape = (win.lbh * win.lbw, 64)
    if plane_shape == block_shape:
        raise ValueError(f"ambiguous coefficient layouts for window {win}")
    dev = dec.device

    def planes(cy: torch.Tensor) -> bool:
        """True on the plane layout, False on the block layout."""
        rows, cols = cy.shape[1:]
        if cy.dtype == torch.int8:
            rows = rows * 2 // 3  # compact wire: 3/2 stored rows a row
        if (rows, cols) == plane_shape:
            return True
        if tuple(cy.shape[1:]) == block_shape:
            return False
        raise ValueError(f"coefficients of shape {tuple(cy.shape)} fit "
                         f"neither layout of window {win}")

    def tail(cy: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
             qt: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        return backhalf_planes(cy, cb, cr, qt, win, pad_hw)

    step_graphs = (graphs.StepGraphs(dev, tail) if dev.type == "cuda"
                   else None)

    def step(pa: Any, cy: Any, cb: Any, cr: Any, qt: Any, ok: Any,
             fb_packed: Any, fb_idx: Any) -> BatchResult:
        del pa
        g = None
        with span("meterelf.step.backhalf"):
            if not torch.is_tensor(cy):   # as_tensor of one is an aten::to
                cy = torch.as_tensor(cy)
            B = cy.shape[0]
            on_planes = planes(cy)
            slots = _slots(fb_idx, B)
            if (step_graphs is not None and on_planes and B and ok is not None
                    and _gates(dec, **dec.static_kwargs)[1]):
                g = step_graphs.place((cy, cb, cr, qt, ok))
            else:
                cy, cb, cr, qt = (upload(a, dev) for a in (cy, cb, cr, qt))
                packed = (backhalf_planes if on_planes else backhalf_blocks)(
                    cy, cb, cr, qt, win, pad_hw)
                if slots is not None:
                    _scatter(packed, fb_packed, *slots)
        if g is None:
            return dec.decode(packed, ok)
        with span("meterelf.step.graph"):
            crops, ok = g.replay(), g.args[4]
            if slots is not None:
                _scatter(crops, fb_packed, *slots)
            dec.graph_crops(crops, ok)
            return dec.decode(crops, ok)

    return step, win, pad_hw


def _slots(fb_idx: Any, B: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The fallback slots that land in a batch of B rows, those with -B <=
    fb_idx[j] < B: (the rows they overwrite, a negative index counting
    from the end; the slots j), int64 numpy, or None when no slot is
    kept. The choice runs in numpy on the host (the feed's fb_idx is
    numpy): no device sync, and unused slots never cross to the
    device."""
    idx = (fb_idx.cpu().numpy() if torch.is_tensor(fb_idx)
           else np.asarray(fb_idx))
    keep = (idx >= -B) & (idx < B)
    if not keep.any():
        return None
    kept = np.flatnonzero(keep)
    rows = idx[kept].astype(np.int64)
    rows[rows < 0] += B
    count("fallback_rows", len(kept))
    return rows, kept


def _scatter(packed: torch.Tensor, fb_packed: Any, rows: np.ndarray,
             kept: np.ndarray) -> None:
    """Write the kept fallback slots ``kept`` of ``fb_packed`` over the
    rows ``rows`` of the crops ``packed``."""
    fb = torch.as_tensor(fb_packed)
    src = fb[upload(kept, fb.device)].to(torch.int32)
    packed[upload(rows, packed.device)] = upload(src, packed.device)


def upload(a: Any, dev: torch.device) -> torch.Tensor:
    """``a`` (numpy or a tensor) on ``dev``. A host array bound for a
    card goes through pinned memory with a non-blocking copy: a copy from
    pageable memory would make the host wait for the card."""
    t = torch.as_tensor(a)
    if dev.type != "cuda" or t.device.type != "cpu":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def to_host_later(res: Any) -> Callable[[], Any]:
    """Start copying a result (a BatchResult, or any tuple of tensors and
    arrays) to the host behind the work queued so far, without waiting;
    returns a function that waits for those copies alone and gives every
    field as numpy.

    A decode's packed BatchResult on a card (ten views of one buffer as
    ops/result.packed lays them, ``packed_recipe``) is copied once into
    a fresh pinned buffer, and its fields are numpy views of it from the
    layout's recipe; a fresh buffer a call, so that arrays a caller keeps
    stay valid. Otherwise each tensor is copied on its own."""
    with span("meterelf.result.copy"):
        r = packed_recipe(res) if res and _is_cuda(res[0]) else None
        if r is not None:
            buf = _pinned_bytes(r.nbytes)
            buf.copy_(buffer_of(res), non_blocking=True)
            host = None
            dev = res[0].device
        else:
            buf = None
            host = [v.to("cpu", non_blocking=True) if torch.is_tensor(v)
                    else v for v in res]
            dev = next((v.device for v in res if _is_cuda(v)), None)
        done = None
        if dev is not None:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))

    def fetch() -> Any:
        with span("meterelf.result.wait"):
            if done is not None:
                done.synchronize()
            if buf is not None:
                raw = buf.numpy()
                return type(res)(*[np.ndarray(f.shape, f.np_dtype, raw,
                                              f.offset) for f in r.fields])
            return type(res)(*[v.numpy() if torch.is_tensor(v)
                               else np.asarray(v) for v in host])

    return fetch


def _is_cuda(v: Any) -> bool:
    return torch.is_tensor(v) and v.is_cuda


def _pinned_bytes(n: int) -> torch.Tensor:
    """A fresh u8 buffer of ``n`` bytes in pinned host memory."""
    return torch.empty(n, dtype=torch.uint8, pin_memory=True)


def _to_numpy(res: Any) -> Any:
    """``res`` on the host as numpy, with one wait for all its fields."""
    return to_host_later(res)()
