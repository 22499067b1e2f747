"""Connected-component propagation and marching-squares cell
contributions per 64x64 window, in plain torch.

Port of meterelf_tpu/ops/components.py ``_propagate_xla`` and
``_cell_contrib`` (see that module for why these reproduce
cv2.findContours(RETR_EXTERNAL) / contourArea / drawContours). The pass
schedule, the segmented-scan offset trick and the convergence flags are
the same:

- labels: each half-pass is a 3x3 min glue then segmented cummin sweeps
  along rows, then columns, forward on even halves and backward on odd
  ones, at most k_label halves;
- outside: the background 4-connected to beyond the dial disk, the same
  halves with any4 glue and segmented OR sweeps, at most k_outside;
- fill: enclosed holes take the min label around them, at most k_fill;
- a phase converged when its last pass changed nothing. The loops stop
  once a pass changes no window of the batch: the passes are monotone,
  so that is the state and the flag of running every pass.

``propagate`` is the plain version of K3 and, with pack_closed=False,
of K6 (ops/ccl.py).

``finalize`` ports ``_finalize`` (components.py:408-499), the stage after
K6 on the general-geometry and scorer-only branches: the largest
top-level component per window and the reference's needle region.
``stats`` names the selection:

- "sort" (the decode's; the JAX package's ``_stats_sort``, :553-595)
  selects the key area2*4096 + owner over owners with a boundary pixel,
  with K7's tie-break (tests/test_ops.py holds hist_pallas equal to
  sort), by the port's sort, in torch, over the static per-dial stats
  box when there is one. JAX sorts the keys as u16 when they fit; the
  port sorts the same non-negative keys as i32, which orders them alike.
- "hist_pallas" runs K7 (ops/stats.py ``stats_select``, the port of
  pallas_stats.stats_select) over the whole window, with no box remap,
  as :422-444 does. No decode takes it: it stays as the candidate
  finalize of the general branch, to be measured there.

``cell_contrib``, the marching-squares cell contributions, lives in
ops/stats.py beside K4 and K7, which read it.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .stats import N, W, cell_contrib, stats_select

# pass caps (components.K_LABEL_HYBRID, K_OUTSIDE_HYBRID, K_FILL)
K_LABEL = 10
K_OUTSIDE = 6
K_FILL = 8
# generous caps for windows the default caps leave non-converged
# (components.RESCUE_CAPS)
RESCUE_CAPS = (192, 96, 192)

_SEG_BASE = 8192  # > any label value
# half-pass sweep directions: (axis, reverse) for rows then columns
_ALT_DIRS = (((-1, False), (-2, False)), ((-1, True), (-2, True)))

Walls = Dict[Tuple[int, bool], torch.Tensor]


def _scan(op: Callable, x: torch.Tensor, dim: int, reverse: bool
          ) -> torch.Tensor:
    if reverse:
        return torch.flip(op(torch.flip(x, [dim]), dim), [dim])
    return op(x, dim)


def _cummax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cummax(x, dim).values


def _make_walls(wall: torch.Tensor) -> Walls:
    """Run ids for segmented scans: rid[i] = walls at-or-before i in
    scan order, per (axis, reverse)."""
    w = wall.to(torch.int32)
    return {(axis, rev): _scan(torch.cumsum, w, axis, rev).to(torch.int32)
            for axis in (-1, -2) for rev in (False, True)}


def _seg_min_sweep(vals: torch.Tensor, walls: Walls, dirs: Sequence
                   ) -> torch.Tensor:
    for axis, rev in dirs:
        rid = walls[(axis, rev)]
        vp = rid * _SEG_BASE + (_SEG_BASE - 1 - vals)
        m = _scan(_cummax, vp, axis, rev)
        vals = (_SEG_BASE - 1) - (m - rid * _SEG_BASE)
    return vals


def _seg_or_sweep(vals: torch.Tensor, walls: Walls, dirs: Sequence
                  ) -> torch.Tensor:
    for axis, rev in dirs:
        rid = walls[(axis, rev)]
        vp = rid * 2 + vals.to(torch.int32)
        m = _scan(_cummax, vp, axis, rev)
        vals = (m - rid * 2) > 0
    return vals


def _shifts3(x: torch.Tensor, fill: int) -> list:
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return [p[..., dy:dy + W, dx:dx + W] for dy in range(3)
            for dx in range(3)]


def _min3x3(x: torch.Tensor, big: int) -> torch.Tensor:
    out = x
    for v in _shifts3(x, big):
        out = torch.minimum(out, v)
    return out


def _any8(x: torch.Tensor) -> torch.Tensor:
    return torch.stack(_shifts3(x.to(torch.uint8), 0)).amax(0) > 0


def _any4(x: torch.Tensor) -> torch.Tensor:
    s = _shifts3(x.to(torch.uint8), 0)
    return (s[1] | s[3] | s[5] | s[7]) > 0


def _iterate(k_max: int, body: Callable, x0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to k_max passes of body(i, x) -> (x, per-window "the last pass
    changed nothing")."""
    x = x0
    eq = torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device)
    for i in range(k_max):
        nx = body(i, x)
        eq = (nx == x).flatten(1).all(1)
        x = nx
        if bool(eq.all()):
            break
    return x, eq


def propagate(bits: torch.Tensor, caps: Optional[Sequence[int]] = None,
              pack_closed: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, 64, 64] i32 window bits (masked | disk<<1 | closed<<2) ->
    (okey3 i32 [K, 64, 64], converged bool [K]), okey3 = owner*8 +
    closed*4 + masked*2 + boundary with owner = 4096 off the support.
    pack_closed=False: okey = owner*4 + masked*2 + boundary (the key of
    components._propagate_xla and pallas_ccl.propagate; bit 2 of the
    input is not read)."""
    k_label, k_outside, k_fill = caps or (K_LABEL, K_OUTSIDE, K_FILL)
    dev = bits.device
    masked = (bits & 1) != 0
    disk = (bits & 2) != 0
    closed = (bits >> 2) & 1
    big = torch.tensor(N, dtype=torch.int32, device=dev)
    idx = torch.arange(N, dtype=torch.int32, device=dev).reshape(W, W)

    label_walls = _make_walls(~masked)

    def label_half(i: int, lab: torch.Tensor) -> torch.Tensor:
        lab = torch.where(masked, torch.minimum(lab, _min3x3(lab, N)), big)
        lab = _seg_min_sweep(lab, label_walls, _ALT_DIRS[i % 2])
        return torch.where(masked, lab, big)

    labels, lab_eq = _iterate(k_label, label_half,
                              torch.where(masked, idx, big))

    bg = ~masked
    bg_walls = _make_walls(masked)

    def out_half(i: int, out: torch.Tensor) -> torch.Tensor:
        out = out | (bg & _any4(out))
        out = _seg_or_sweep(out, bg_walls, _ALT_DIRS[i % 2])
        return out & bg

    outside, out_eq = _iterate(k_outside, out_half, bg & ~disk)
    enclosed = bg & ~outside
    support = masked | enclosed

    def fill(i: int, own: torch.Tensor) -> torch.Tensor:
        return torch.where(enclosed, torch.minimum(own, _min3x3(own, N)),
                           own)

    owner, fill_eq = _iterate(k_fill, fill, labels)
    boundary = masked & _any8(outside)
    low = masked.to(torch.int32) * 2 + boundary.to(torch.int32)
    own = torch.where(support, owner, big)
    okey = own * 8 + closed * 4 + low if pack_closed else own * 4 + low
    return okey, lab_eq & out_eq & fill_eq


class ComponentResult(NamedTuple):
    has_any: torch.Tensor        # [K] bool: masked window nonempty
    needle_region: torch.Tensor  # [K, 64, 64] bool: the reference's mask
    converged: torch.Tensor      # [K] bool: propagation reached fixpoint


StatsBox = Tuple[Tuple[Tuple[int, int], ...], int]


def _stats_sort(ol: torch.Tensor, bbit: torch.Tensor, contrib: torch.Tensor,
                sent: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The largest component through one sort of key = owner*16 +
    boundary*4 + contrib and prefix sums over its runs
    (components._stats_sort) -> (sel, area2_sel, sel_valid) per row."""
    K = ol.shape[0]
    dev = ol.device
    spk = torch.sort(ol * 16 + bbit * 4 + contrib, dim=1).values
    sk = spk >> 4
    nxt = torch.cat([sk[:, 1:], torch.full((K, 1), -1, dtype=sk.dtype,
                                           device=dev)], 1)
    run_end = sk != nxt
    cum = torch.cumsum((spk & 3) + (((spk >> 2) & 1) << 16), dim=1)
    m = torch.cummax(torch.where(run_end, cum, torch.zeros_like(cum)),
                     dim=1).values
    prev = torch.cat([torch.zeros((K, 1), dtype=m.dtype, device=dev),
                      m[:, :-1]], 1)
    tot = cum - prev
    area2 = tot & 0xFFFF
    bc = tot >> 16
    valid = run_end & (sk < sent) & (bc > 0)
    key2 = torch.where(valid, area2 * (sent + 1) + sk,
                       torch.full_like(area2, -1))
    i_sel = torch.argmax(key2, dim=1, keepdim=True)    # first maximum
    return (sk.gather(1, i_sel)[:, 0], area2.gather(1, i_sel)[:, 0],
            valid.gather(1, i_sel)[:, 0])


def finalize(okey: torch.Tensor, masked: torch.Tensor, closed: torch.Tensor,
             converged: torch.Tensor, static_bbox: Optional[StatsBox] = None,
             stats: str = "sort") -> ComponentResult:
    """okey [K, 64, 64] i32 (owner*4 + masked*2 + boundary), masked and
    closed [K, 64, 64] bool, converged [K] -> ComponentResult
    (components._finalize). ``stats`` is "sort" or "hist_pallas" (module
    docstring). Under sort, with ``static_bbox`` ((ox, oy) per dial, SB)
    the stats cover each dial's SB x SB box (K a multiple of the dial
    count) and labels remap to box-local indices, a monotone map that
    keeps the selection and its tie-break."""
    if stats not in ("sort", "hist_pallas"):
        raise ValueError(f"finalize: unknown stats {stats!r}")
    K = okey.shape[0]
    dev = okey.device
    owner = okey >> 2                          # N at non-support pixels
    contrib = cell_contrib(owner)
    bbit = okey & 1
    if stats == "hist_pallas":
        keymax = stats_select(okey, contrib)   # K7
        sel_valid = keymax >= 0
        area2_sel = keymax >> 12
        sel = torch.where(sel_valid, keymax & (N - 1),
                          torch.full_like(keymax, N))
    elif static_bbox is not None:
        origins, sb = static_bbox
        D = len(origins)
        sent = sb * sb

        def pack(x: torch.Tensor) -> torch.Tensor:
            x4 = x.reshape(K // D, D, W, W)
            return torch.stack([x4[:, i, oy:oy + sb, ox:ox + sb]
                                for i, (ox, oy) in enumerate(origins)],
                               dim=1).reshape(K, sent)

        oy_r = torch.tensor([origins[k % D][1] for k in range(K)],
                            dtype=torch.int32, device=dev)
        ox_r = torch.tensor([origins[k % D][0] for k in range(K)],
                            dtype=torch.int32, device=dev)
        ow = pack(owner)
        ol = torch.where(ow < N, (ow // W - oy_r[:, None]) * sb
                         + (ow % W - ox_r[:, None]),
                         torch.full_like(ow, sent))
        sel_l, area2_sel, sel_valid = _stats_sort(ol, pack(bbit),
                                                  pack(contrib), sent)
        sel = (sel_l // sb + oy_r) * W + sel_l % sb + ox_r
    else:
        sel, area2_sel, sel_valid = _stats_sort(
            owner.reshape(K, N), bbit.reshape(K, N), contrib.reshape(K, N),
            N)
    sel = torch.where(sel_valid, sel, torch.full_like(sel, N))
    big_blob = sel_valid & (area2_sel > 200)      # contourArea > 100
    fill_sel = (owner == sel[:, None, None]) & (sel[:, None, None] < N)
    return ComponentResult(
        has_any=masked.flatten(1).any(1),
        needle_region=torch.where(big_blob[:, None, None], fill_sel, closed),
        converged=converged)
