"""A model, in numpy, of the designs of K2 `windows` (csrc/window_bits.cuh,
whose body K5 runs too) and of K4 `stats` / K7 `stats_select`
(csrc/stats.cu). The kernels run only on the card (tests/test_torch_cuda.py
holds them there); this model lets their layouts, border fills, early-outs,
packing and run aggregation be checked on the CPU, against the plain
versions and, through those, the JAX Pallas kernels in interpret mode.

K2, as a warp of the kernel runs it on its window: the 5x5 colour sample
converted first (two sums across lanes), then the rows of its band, each
as two 32-lane halves whose inRange bits become one 64-bit row word
(bit x = column x); a half-row whose lanes all fail the lightness test
skips the saturation and the hue, one failing the saturation skips the
hue; the saturation's denominator is chosen before its one division.
The close runs on the row words, rows rolling as the kernel's registers
do: dilate ORs (w | w<<1 | w>>1) of rows r-1..r+1 with zero rows and
bits outside, erode ANDs the same shape with all-ones rows outside and a
1 shifted in at bits 0 and 63. Lane l writes columns 2l and 2l + 1.

K4/K7: one packed counter a bin, area2 << 16 | bcount. A warp walks a band
of 8 rows; lane l holds columns 2l, 2l + 1 of row r and of row r + 1 (the
sentinel past row 63), takes the cells' right corners from lane l + 1
(the sentinel right of column 63), and sums its two pixels' and two
cells' values under the first owner it meets (a value of another owner
takes its own atomic). A segmented suffix sum over runs of equal keys
across the lanes leaves one atomicAdd a run; rows that touch no owner are
skipped. keymax is one scan of the packed bins.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meterelf_tpu.ops import components as j_comp
from meterelf_tpu.ops import pallas_stats as j_stats
from meterelf_tpu.ops import pallas_windows as j_win
from meterelf_tpu_torch.ops import stats, windows
from meterelf_tpu_torch.ops.morphology import close3
from window_families import (FAMILIES, INNER, SENT, STATS_CASES,
                             family_case, sample_start, stats_cases)

torch.set_num_threads(2)

W = 64
N = W * W
F32 = np.float32
U64 = np.uint64
ALL = U64(0xFFFFFFFFFFFFFFFF)
K2_WARPS = 4        # csrc/windows.cu: 128 threads, one window a CTA
K4_WARPS = 8        # csrc/stats.cu: 256 threads
INV255 = F32(1) / F32(255)
HSCALE = F32(256) / F32(360)


# ------------------------------------------------------------ K2 model --

def _sat(x):
    return np.clip(np.rint(x), 0, 255).astype(np.int64)


def _unit(p):
    return [((p >> s) & 255).astype(F32) * INV255 for s in (0, 8, 16)]


def _light(p):
    b, g, r = _unit(p)
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    l_ = (vmax + vmin) * F32(0.5)
    return b, g, r, vmax, vmin, l_, _sat(l_ * F32(255))


def _saturation(vmax, vmin, l_):
    """csrc/exact_color.cuh meterelf_saturation: 0 for grey, else the
    denominator chosen, then one division."""
    den = np.where(l_ < F32(0.5), vmax + vmin, (F32(2) - vmax) - vmin)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = _sat(((vmax - vmin) / den) * F32(255))
    return np.where(vmax == vmin, 0, s)


def _hue(b, g, r, vmax, vmin, hue_shift):
    with np.errstate(divide="ignore"):
        d60 = F32(60) / np.where(vmax != vmin, vmax - vmin, F32(1))
    h = np.where(vmax == r, (g - b) * d60,
                 np.where(vmax == g, (b - r) * d60 + F32(120),
                          (r - g) * d60 + F32(240)))
    h = np.where(h < 0, h + F32(360), h)
    hh = (_sat(h * HSCALE) + hue_shift) & 255
    return np.where(vmax == vmin, hue_shift & 255, hh)


def _hls(p, hue_shift):
    b, g, r, vmax, vmin, l_, L = _light(p)
    return (_hue(b, g, r, vmax, vmin, hue_shift), L,
            _saturation(vmax, vmin, l_))


def colour_bounds(win, cx, cy, cr, hue_shift):
    """lo/hi (h, l, s) from the 5x5 sample, as each warp computes them."""
    sx, sy = sample_start(cx), sample_start(cy)
    sums = [int(c.sum()) for c in _hls(win[sy:sy + 5, sx:sx + 5], hue_shift)]
    # the kernel sums h and l in one 32-bit word: each sum below 2^16
    assert all(s < 1 << 16 for s in sums)
    col = [(2 * s + 25) // 50 for s in sums]
    lo = [min(max(c - r, 0), 255) for c, r in zip(col, cr)]
    hi = [min(max(c + r, 0), 255) for c, r in zip(col, cr)]
    return lo, hi


def in_range_half(p, lo, hi, hue_shift, skips):
    """window_bits.cuh in_range over one ballot's 32 lanes, with its
    warp-uniform early-outs: the saturation only where some lane passes
    the lightness test, the hue only where some lane passes both. skips
    counts (half-rows, stopped after the lightness, stopped after the
    saturation)."""
    b, g, r, vmax, vmin, l_, L = _light(p)
    skips[0] += 1
    inn = (L >= lo[1]) & (L <= hi[1])
    if not inn.any():
        skips[1] += 1
        return np.zeros(32, bool)
    S = _saturation(vmax, vmin, l_)
    inn &= (S >= lo[2]) & (S <= hi[2])
    if not inn.any():
        skips[2] += 1
        return np.zeros(32, bool)
    H = _hue(b, g, r, vmax, vmin, hue_shift)
    return inn & (H >= lo[0]) & (H <= hi[0])


def ballot(pred):
    return int(sum(int(v) << i for i, v in enumerate(pred)))


def grow(v):
    return v | (v << U64(1)) | (v >> U64(1))


def shrink(v):
    return v & ((v << U64(1)) | U64(1)) & ((v >> U64(1)) | U64(1 << 63))


def close_rows(raw, r0, rows):
    """The closed words of rows r0 .. r0 + rows - 1, rolling as
    window_bits.cuh close_rows does."""
    word = (lambda q: raw[q] if 0 <= q < W else U64(0))
    dil = (lambda q, a, b, c: a | b | c if 0 <= q < W else ALL)
    g_prev, g_cur, g_next = grow(word(r0 - 1)), grow(word(r0)), \
        grow(word(r0 + 1))
    e_prev = shrink(dil(r0 - 1, grow(word(r0 - 2)), g_prev, g_cur))
    e_cur = shrink(dil(r0, g_prev, g_cur, g_next))
    out = []
    for r in range(r0, r0 + rows):
        g_2 = grow(word(r + 2))
        e_next = shrink(dil(r + 1, g_cur, g_next, g_2))
        out.append(e_prev & e_cur & e_next)
        g_cur, g_next, e_prev, e_cur = g_next, g_2, e_cur, e_next
    return out


def write_row(closed, raw, disk_row):
    """Lane l's int2: columns 2l and 2l + 1 of one row."""
    out = np.empty(W, np.int32)
    for lane in range(32):
        c = int(closed >> U64(2 * lane)) & 3
        m = int(raw >> U64(2 * lane)) & 3
        for j in range(2):
            d = int(disk_row[2 * lane + j] != 0)
            cj, mj = (c >> j) & 1, (m >> j) & 1
            out[2 * lane + j] = (cj & d) | d << 1 | cj << 2 | mj << 3
    return out


def window_model(win, cx, cy, cr, disk, hue_shift, skips,
                 warps=K2_WARPS):
    """bits [64, 64] of one window (packed pixels [64, 64])."""
    lo, hi = colour_bounds(win, cx, cy, cr, hue_shift)
    raw = np.array([U64(ballot(in_range_half(win[r, :32], lo, hi,
                                             hue_shift, skips)))
                    | U64(ballot(in_range_half(win[r, 32:], lo, hi,
                                               hue_shift, skips))) << U64(32)
                    for r in range(W)], dtype=U64)
    rows = W // warps
    bits = np.empty((W, W), np.int32)
    for r0 in range(0, W, rows):
        for i, c in enumerate(close_rows(raw, r0, rows)):
            bits[r0 + i] = write_row(c, raw[r0 + i], disk[r0 + i])
    return bits


def windows_model(packed, mx, my, geom, disk, hue_shift, skips):
    B = packed.shape[0]
    out = np.empty((B, len(geom), W, W), np.int32)
    for b in range(B):
        for d, (ox, oy, cx, cy, *cr) in enumerate(geom):
            y0, x0 = my[b] + oy, mx[b] + ox
            out[b, d] = window_model(packed[b, y0:y0 + W, x0:x0 + W], cx, cy,
                                     cr, disk[d], hue_shift, skips)
    return out


def _plain(packed, mx, my, geom, disk, hue):
    return windows.windows_plain(
        torch.as_tensor(packed), torch.as_tensor(mx), torch.as_tensor(my),
        geom, torch.as_tensor(disk), hue).numpy()


@pytest.mark.parametrize("hue", [0, 128, 255])
@pytest.mark.parametrize("name", FAMILIES)
def test_window_model_equals_plain(name, hue):
    """The word model equals windows_plain on every family, with the dial
    centres at 0, 1, 2, 61, 62 and 63 and five dials (one CTA a window:
    any count)."""
    packed, mx, my, geom, disk = family_case(name, 2, len(name) + hue, D=5)
    skips = [0, 0, 0]
    got = windows_model(packed, mx, my, geom, disk, hue, skips)
    np.testing.assert_array_equal(got, _plain(packed, mx, my, geom, disk,
                                              hue))
    raw = (got >> 3) & 1
    if name == "all_in":
        assert raw.all() and ((got >> 2) & 1).all() and skips[1] == 0
    elif name == "none_in":
        assert not raw.any() and skips[1] == skips[0]
    elif name == "edges":
        for d in range(len(geom)):
            w = raw[:, d]
            assert w[:, 0].all() and w[:, -1].all() and w[:, :, 0].all() \
                and w[:, :, -1].all()
    elif name == "checkerboard":
        # the close fills the checkerboard: erode's border keeps the edges
        assert ((got >> 2) & 1).all() and skips[1] < skips[0]


def test_window_early_outs_are_exercised():
    """The layered windows take all three exits of in_range: after the
    lightness (white rows), after the saturation (grey rows, and pale red
    one S unit below the range) and after the hue (near-red rows)."""
    packed, mx, my, geom, disk = family_case("layers", 2, 5)
    skips = [0, 0, 0]
    bits = windows_model(packed, mx, my, geom, disk, 128, skips)
    assert 0 < skips[1] and 0 < skips[2] and skips[1] + skips[2] < skips[0]
    assert ((bits >> 3) & 1).any()


@pytest.mark.parametrize("warps", [2, 4, 16])
def test_close_bands_equal_whole_window(warps):
    """The rolling close gives the same words whatever the band height
    (K2's and K5's 4 warps a window of 16 rows; 2 of 32; 16 of 4),
    equal to ops/morphology.close3 of the whole window."""
    rng = np.random.default_rng(warps)
    raw = rng.integers(0, 1 << 63, W, dtype=np.int64).astype(U64)
    raw[rng.random(W) < 0.3] = U64(0)
    raw[5] = ALL
    rows = W // warps
    got = [c for r0 in range(0, W, rows) for c in close_rows(raw, r0, rows)]
    bits = np.array([[(int(w) >> x) & 1 for x in range(W)] for w in raw],
                    bool)
    want = close3(torch.as_tensor(bits)[None])[0].numpy()
    np.testing.assert_array_equal(
        np.array([[(int(w) >> x) & 1 for x in range(W)] for w in got],
                 bool), want)


def test_window_model_matches_pallas_interpret():
    """Through the plain version, the model is held to
    pallas_windows.window_bits_quads (interpret=True) on the families:
    the superwindow is the crop shifted to (mx, my). The Pallas kernel
    slices the sample statically, so its centres stay 2 px inside (the
    JAX graph's dynamic slice, which the plain version follows, is what
    wraps the edge centres)."""
    cases = [family_case(n, 1, 3, centres=INNER) for n in FAMILIES]
    packed = np.concatenate([c[0] for c in cases])
    mx = np.concatenate([c[1] for c in cases])
    my = np.concatenate([c[2] for c in cases])
    geom, disk = cases[0][3], cases[0][4]
    sw = np.zeros((len(packed), j_win.SW_H, j_win.SW_W), np.int32)
    for b in range(len(packed)):
        part = packed[b, my[b]:, mx[b]:][:j_win.SW_H, :j_win.SW_W]
        sw[b, :part.shape[0], :part.shape[1]] = part
    origins = tuple((g[0], g[1]) for g in geom)
    centres = tuple((g[2], g[3]) for g in geom)
    cr = np.array([g[4:] for g in geom], np.int32)
    disk_quad = np.concatenate([disk[d].astype(np.int32) for d in range(4)],
                               axis=1)
    call = jax.jit(functools.partial(
        j_win.window_bits_quads, origins=origins, centers=centres,
        interpret=True))
    for hue in (0, 255):
        want = np.asarray(call(jnp.asarray(sw), jnp.asarray(disk_quad),
                               jnp.asarray(cr), hue))
        want = want.reshape(len(sw), W, 4, W).transpose(0, 2, 1, 3)
        got = windows_model(packed, mx, my, geom, disk, hue, [0, 0, 0])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            _plain(packed, mx, my, geom, disk, hue), want)


# ------------------------------------------------------- K4/K7 model --

def add_runs(bins, keys, vals):
    """csrc/stats.cu add_runs: one sum where the keys are one owner and
    the sentinel, else a suffix sum inside each run of equal keys over
    consecutive lanes, one atomic a run at its first lane; returns the
    atomics made."""
    keys, v = list(keys), list(vals)
    kmin = min(keys)
    if all(k in (kmin, SENT) for k in keys):
        total = sum(x for k, x in zip(keys, v) if k == kmin)
        if kmin < SENT and total:
            bins[kmin] += total
            return 1
        return 0
    heads = [lane == 0 or keys[lane - 1] != keys[lane] for lane in range(32)]
    end = [next((j for j in range(lane + 1, 32) if heads[j]), 32)
           for lane in range(32)]
    off = 1
    while off < 32:
        old = list(v)
        for lane in range(32):
            if lane + off < end[lane]:
                v[lane] += old[lane + off]
        off *= 2
    n = 0
    for lane in range(32):
        if heads[lane] and keys[lane] < SENT and v[lane]:
            bins[keys[lane]] += v[lane]
            n += 1
    return n


class Item:
    """A lane's item: the first key it meets, other keys at once."""

    def __init__(self, bins):
        self.bins, self.key, self.v, self.direct = bins, SENT, 0, 0

    def add(self, k, x):
        if not x:
            return
        if self.key == SENT:
            self.key = k
        if k == self.key:
            self.v += x
        else:
            self.bins[k] += x
            self.direct += 1


def cell_class(a, b, c, d):
    a, b, c, d = int(a), int(b), int(c), int(d)
    mn = min(a, b, c, d)
    k = (a == mn) + (b == mn) + (c == mn) + (d == mn)
    return mn, (k - 2 if mn < SENT and k >= 3 else 0)


def stats_model(okey, contrib=None, warps=K4_WARPS, count=None):
    """keymax [K] (and has_any for K4) of the packed, run-aggregated
    histogram. okey [K, 64, 64]: okey3 (K4) or, with contrib, K6's okey
    (K7). count, when given, collects (atomics, direct atomics, rows
    skipped)."""
    k7 = contrib is not None
    shift = 2 if k7 else 3
    rows = W // warps
    keymax, has_any = [], []
    for k in range(okey.shape[0]):
        ok = okey[k].astype(np.int64)
        own = np.minimum((ok & 0xFFFFFFFF) >> shift, SENT)
        below = np.vstack([own[1:], np.full((1, W), SENT)])
        bins = [0] * N
        for r in range(W):
            a0, a1 = own[r, 0::2], own[r, 1::2]
            items = [Item(bins) for _ in range(32)]
            if k7:
                for lane in range(32):
                    for j, a in enumerate((a0[lane], a1[lane])):
                        x = 2 * lane + j
                        items[lane].add(a, ((int(contrib[k, r, x]) & 3) << 16
                                            | int(ok[r, x] & 1))
                                        if a < SENT else 0)
                touched = any(it.key < SENT for it in items)
            else:
                b0, b1 = below[r, 0::2], below[r, 1::2]
                touched = min(a0.min(), a1.min(), b0.min(), b1.min()) < SENT
                if touched:
                    a2 = np.append(a0[1:], SENT)
                    b2 = np.append(b0[1:], SENT)
                    for lane in range(32):
                        m0, c0 = cell_class(a0[lane], a1[lane], b0[lane],
                                            b1[lane])
                        m1, c1 = cell_class(a1[lane], a2[lane], b1[lane],
                                            b2[lane])
                        it = items[lane]
                        it.add(a0[lane], int(ok[r, 2 * lane] & 1)
                               if a0[lane] < SENT else 0)
                        it.add(m0, c0 << 16)
                        it.add(a1[lane], int(ok[r, 2 * lane + 1] & 1)
                               if a1[lane] < SENT else 0)
                        it.add(m1, c1 << 16)
            if touched:
                n = add_runs(bins, [it.key for it in items],
                             [it.v for it in items])
            if count is not None:
                count[0] += n if touched else 0
                count[1] += sum(it.direct for it in items)
                count[2] += not touched
        assert max(bins) < 1 << 32 and all(b & 0xFFFF <= N for b in bins)
        best = max([(b >> 16) * N + o for o, b in enumerate(bins)
                    if b & 0xFFFF] or [-1])
        keymax.append(best)
        has_any.append(bool(((ok >> 1) & 1).any()))
    return np.array(keymax, np.int32), np.array(has_any)


def _k7_inputs(okey3, seed):
    okey = ((okey3 >> 3) * 4 + (okey3 & 3)).astype(np.int32)
    contrib = stats.cell_contrib(torch.as_tensor(okey >> 2)).numpy()
    # contributions 3 everywhere on the owners: K7's area2 at its maximum
    # 12288 (4096 x 3); bits above the low two are dropped
    hi = contrib | 3 | 4 * np.random.default_rng(seed).integers(
        0, 2, contrib.shape).astype(np.int32)
    return okey, contrib, hi


@pytest.mark.parametrize("case", STATS_CASES)
def test_stats_model_equals_plain(case):
    """K4's model == stats_plain and K7's == stats_select_plain on the
    one-owner, 4096-owner and sentinel-only windows, at both fields'
    maxima, and on propagated windows; K7 over K4's okey equals K4."""
    okey3 = stats_cases()[case]
    count = [0, 0, 0]
    km, ha = stats_model(okey3, count=count)
    r_km, r_ha = stats.stats_plain(torch.as_tensor(okey3))
    np.testing.assert_array_equal(km, r_km.numpy())
    np.testing.assert_array_equal(ha, r_ha.numpy())
    okey, contrib, hi = _k7_inputs(okey3, len(case))
    for c in (contrib, hi):
        got = stats_model(okey, c)[0]
        np.testing.assert_array_equal(got, stats.stats_select_plain(
            torch.as_tensor(okey), torch.as_tensor(c)).numpy())
    np.testing.assert_array_equal(stats_model(okey, contrib)[0], km)
    if case == "one_owner":
        assert km[0] == 7938 * N + 77 and count[1] == 0
        assert count[0] == W      # one atomic a row
        assert stats_model(okey, hi)[0][0] == 12288 * N + 77
    if case == "owners_4096":
        assert km[0] == N - 1
    if case == "sentinel_only":
        assert km[0] == -1 and not ha[0] and count[2] == W
    if case == "alternating":
        assert count[1] > 0       # a lane's second owner: its own atomic


def test_stats_model_matches_pallas_interpret():
    """Through the plain versions, the model is held to
    pallas_stats.stats_select_fused and stats_select (interpret=True)."""
    cases = stats_cases()
    okey3 = np.concatenate([cases[k] for k in ("propagated", "one_owner",
                                                "sentinel_only", "blocks")])
    km, ha = jax.jit(functools.partial(
        j_stats.stats_select_fused, interpret=True))(jnp.asarray(okey3))
    got = stats_model(okey3)
    np.testing.assert_array_equal(got[0], np.asarray(km))
    np.testing.assert_array_equal(got[1], np.asarray(ha))
    okey, contrib, _ = _k7_inputs(okey3, 1)
    contrib = np.asarray(j_comp._cell_contrib(jnp.asarray(okey >> 2), N),
                         np.int32)
    want = jax.jit(functools.partial(j_stats.stats_select, interpret=True))(
        jnp.asarray(okey), jnp.asarray(contrib))
    np.testing.assert_array_equal(stats_model(okey, contrib)[0],
                                  np.asarray(want))
