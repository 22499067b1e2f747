"""A CPU model of the word- and scan-level arithmetic of csrc/ccl.cu (K3
``ccl`` and K6 ``propagate``), the counterpart of
test_torch_corr_tiling.py for the CCL. The kernel cannot run here, so its
steps are written out in numpy as the kernel computes them (a lane's two
rows or two cells, shuffles as shifts along the lane axis) and each is
held equal to the serial loop it replaces:

- the outside flood on 64-bit row words: the Kogge-Stone OR fill inside a
  word (both directions), the column fill across the rows of 32 lanes,
  any4 (the glue) and any8 (the boundary);
- the labels' segmented min scan: a prefix max of run-id keys over two
  cells a lane and five shuffle steps;
- the skips: rows and columns with no masked cell, and the fill of a
  window with no enclosed cell.

Composed into whole passes with the kernel's per-window exits, the model
equals components.propagate (the plain version, which
tests/test_torch_ccl.py holds to the JAX package) under every caps set
the rescue and the card tests use, with and without the closed bit.
"""
import numpy as np
import pytest
import torch

from meterelf_tpu_torch.ops import components

W = 64
BIG = W * W
SEG = 8192
U = np.uint64
LANE = np.arange(32)
_YY, _XX = np.mgrid[:W, :W]
DISK = (_YY - 32) ** 2 + (_XX - 32) ** 2 <= 23 ** 2
DENSITIES = [0.05, 0.3, 0.6, "zeros", "ones"]
CAPS = [None, (1, 1, 1), (4, 2, 2), (3, 5, 0), (0, 0, 0),
        components.RESCUE_CAPS]


def _mask(rng, density, shape):
    if density == "zeros":
        return np.zeros(shape, bool)
    if density == "ones":
        return np.ones(shape, bool)
    return rng.random(shape) < density


def _seed(density):
    if isinstance(density, str):
        return {"zeros": 1, "ones": 2}[density]
    return int(density * 1000)


def to_words(b):
    """bool [..., 64] -> uint64 [...], bit x = cell x."""
    return np.bitwise_or.reduce(b.astype(U) << np.arange(W, dtype=U), -1)


def from_words(w):
    return ((w[..., None] >> np.arange(W, dtype=U)) & U(1)).astype(bool)


def pairs(a):
    """[..., 64] -> the lane layout: positions 2*lane and 2*lane + 1."""
    return a[..., 0::2], a[..., 1::2]


def unpair(a0, a1):
    return np.stack([a0, a1], -1).reshape(a0.shape[:-1] + (W,))


def bit(words, pos):
    """bit ``pos`` [32] of each word [...] -> bool [..., 32]."""
    return ((words[..., None] >> pos.astype(U)) & U(1)).astype(bool)


def shfl_up(x, d):
    """__shfl_up_sync: lane l reads lane l - d (lanes below d their own)."""
    out = x.copy()
    out[..., d:] = x[..., :-d]
    return out


def shfl_down(x, d):
    out = x.copy()
    out[..., :-d] = x[..., d:]
    return out


# ---- the serial loops the kernel's steps replace (the first port's) ----

def serial_or_sweep(o, bg, rev):
    """or_sweep along the last axis: runs of background cells."""
    o = o.copy()
    run = np.zeros(o.shape[:-1], bool)
    for s in range(W):
        t = W - 1 - s if rev else s
        b = bg[..., t]
        o[..., t] |= b & run
        run = np.where(b, run | o[..., t], False)
    return o


def serial_min_sweep(v, in_run, rev):
    """min_sweep along the last axis: runs of masked cells."""
    v = v.copy()
    run = np.full(v.shape[:-1], BIG)
    for s in range(W):
        t = W - 1 - s if rev else s
        inr, cur = in_run[..., t], v[..., t]
        v[..., t] = np.where(inr & (run < cur), run, cur)
        run = np.where(inr, np.minimum(run, cur), BIG)
    return v


def direct_any(o, four):
    p = np.pad(o, [(0, 0)] * (o.ndim - 2) + [(1, 1), (1, 1)])
    sh = [p[..., dy:dy + W, dx:dx + W] for dy in range(3) for dx in range(3)]
    if four:
        return sh[1] | sh[3] | sh[5] | sh[7]
    return np.any(sh, 0)


# ---- the kernel's steps ----

def row_fill(x, g, rev):
    """Kogge-Stone OR fill inside a row word (row_fill)."""
    for s in (1, 2, 4, 8, 16, 32):
        s = U(s)
        if rev:
            x = x | (g & (x >> s))
            g = g & (g >> s)
        else:
            x = x | (g & (x << s))
            g = g & (g << s)
    return x


def col_fill(a0, a1, p0, p1, rev):
    """The same fill along the columns, rows 2*lane (a0, background p0)
    and 2*lane + 1 (a1, p1) of the lane axis (col_fill)."""
    if not rev:
        x, q = a1 | (p1 & a0), p1 & p0
        for d in (1, 2, 4, 8, 16):
            on = LANE >= d
            x, q = (np.where(on, x | (q & shfl_up(x, d)), x),
                    np.where(on, q & shfl_up(q, d), q))
        e = np.where(LANE == 0, U(0), shfl_up(x, 1))
        return a0 | (p0 & e), x
    x, q = a0 | (p0 & a1), p0 & p1
    for d in (1, 2, 4, 8, 16):
        on = LANE + d < 32
        x, q = (np.where(on, x | (q & shfl_down(x, d)), x),
                np.where(on, q & shfl_down(q, d), q))
    e = np.where(LANE == 31, U(0), shfl_down(x, 1))
    return x, a1 | (p1 & e)


def any4_glue(o0, o1, bg0, bg1):
    up = np.where(LANE == 0, U(0), shfl_up(o1, 1))
    dn = np.where(LANE == 31, U(0), shfl_down(o0, 1))
    n0 = o0 | (bg0 & ((o0 << U(1)) | (o0 >> U(1)) | up | o1))
    n1 = o1 | (bg1 & ((o1 << U(1)) | (o1 >> U(1)) | o0 | dn))
    return n0, n1


def any8(o0, o1):
    h0 = o0 | (o0 << U(1)) | (o0 >> U(1))
    h1 = o1 | (o1 << U(1)) | (o1 >> U(1))
    hu = np.where(LANE == 0, U(0), shfl_up(h1, 1))
    hd = np.where(LANE == 31, U(0), shfl_down(h0, 1))
    return hu | h0 | h1, h0 | h1 | hd


def popcount(x):
    """Set bits of each uint64 of x, as int64 (__popcll)."""
    x = np.ascontiguousarray(x, dtype=U)
    b = x.view(np.uint8).reshape(*x.shape, 8)
    return np.unpackbits(b, axis=-1).sum(-1, dtype=np.int64)


def seg_min_scan(v0, v1, wall, rev):
    """seg_min_scan: v0, v1 [..., 32] at positions 2*lane, 2*lane + 1 of
    each line, wall [...] the line's wall word."""
    p0 = (2 * LANE).astype(U)
    wall = wall[..., None]
    w0 = ((wall >> p0) & U(1)).astype(np.int64)
    w1 = ((wall >> (p0 + U(1))) & U(1)).astype(np.int64)
    if not rev:
        r0 = popcount(wall & ((U(2) << p0) - U(1)))
        r1 = r0 + w1
        k0 = r0 * SEG + (SEG - 1 - v0)
        t = np.maximum(r1 * SEG + (SEG - 1 - v1), k0)
        for d in (1, 2, 4, 8, 16):
            t = np.where(LANE >= d, np.maximum(t, shfl_up(t, d)), t)
        e = np.where(LANE == 0, 0, shfl_up(t, 1))
        k0, k1 = np.maximum(k0, e), t
    else:
        r1 = popcount(wall >> (p0 + U(1)))
        r0 = r1 + w0
        k1 = r1 * SEG + (SEG - 1 - v1)
        t = np.maximum(r0 * SEG + (SEG - 1 - v0), k1)
        for d in (1, 2, 4, 8, 16):
            t = np.where(LANE + d < 32, np.maximum(t, shfl_down(t, d)), t)
        e = np.where(LANE == 31, 0, shfl_down(t, 1))
        k0, k1 = t, np.maximum(k1, e)
    return SEG - 1 - (k0 & (SEG - 1)), SEG - 1 - (k1 & (SEG - 1))


def min3x3_rows(f):
    """min3x3_rows on every row: f [K, 64, 64] -> centre (c0, c1) and 3x3
    min (g0, g1), [K, 64, 32]; rows past the window's edge read the
    row itself."""
    up = np.concatenate([f[:, :1], f[:, :-1]], 1)
    dn = np.concatenate([f[:, 1:], f[:, -1:]], 1)
    v0, v1 = pairs(np.minimum(f, np.minimum(up, dn)))
    left = np.where(LANE == 0, BIG, shfl_up(v1, 1))
    right = np.where(LANE == 31, BIG, shfl_down(v0, 1))
    c0, c1 = pairs(f)
    return c0, c1, np.minimum(np.minimum(left, v0), v1), \
        np.minimum(np.minimum(v0, v1), right)


def _exit(active, conv, ch):
    """A window leaves its phase at its first pass that changed nothing."""
    return active & ch, conv | (active & ~ch)


def model_propagate(bits, caps=None, pack_closed=True, skip_lines=True,
                    skip_fill=True):
    """The kernel's schedule in numpy -> (okey [K, 64, 64], converged
    [K]). skip_lines=False runs the label sweeps on every row and column
    and skip_fill=False the fill on every row of every window, as if
    nothing were skipped."""
    k_label, k_outside, k_fill = caps or (
        components.K_LABEL, components.K_OUTSIDE, components.K_FILL)
    K = bits.shape[0]
    masked = (bits & 1) != 0
    M = to_words(masked)
    MT = to_words(masked.transpose(0, 2, 1))
    D = to_words((bits & 2) != 0)
    every = np.full_like(M, U(1))

    # outside, two rows a lane
    m0, m1 = pairs(M)
    bg0, bg1 = ~m0, ~m1
    d0, d1 = pairs(D)
    o0, o1 = bg0 & ~d0, bg1 & ~d1
    active, out_conv = np.ones(K, bool), np.full(K, k_outside == 0)
    for it in range(k_outside):
        rev = bool(it & 1)
        n0, n1 = any4_glue(o0, o1, bg0, bg1)
        n0, n1 = col_fill(row_fill(n0, bg0, rev), row_fill(n1, bg1, rev),
                          bg0, bg1, rev)
        ch = ((n0 != o0) | (n1 != o1)).any(-1)
        o0 = np.where(active[:, None], n0, o0)
        o1 = np.where(active[:, None], n1, o1)
        active, out_conv = _exit(active, out_conv, ch)
    a0, a1 = any8(o0, o1)
    boundary = unpair(m0 & a0, m1 & a1)
    enclosed = unpair(bg0 & ~o0, bg1 & ~o1)

    # labels
    lab = np.where(masked, np.arange(BIG).reshape(W, W), BIG)
    row_live = M if skip_lines else every
    col_live = MT if skip_lines else every
    active, lab_conv = np.ones(K, bool), np.full(K, k_label == 0)
    for it in range(k_label):
        rev = bool(it & 1)
        c0, c1, g0, g1 = min3x3_rows(lab)
        v0 = np.where(bit(M, 2 * LANE), g0, BIG)
        v1 = np.where(bit(M, 2 * LANE + 1), g1, BIG)
        v0, v1 = seg_min_scan(v0, v1, ~M, rev)
        rows = np.where((row_live != 0)[..., None], unpair(v0, v1), BIG)
        colin = rows.transpose(0, 2, 1)
        v0, v1 = seg_min_scan(*pairs(colin), ~MT, rev)
        cols = np.where((col_live != 0)[..., None], unpair(v0, v1), colin)
        new = cols.transpose(0, 2, 1)
        ch = (new != lab).any((1, 2))
        lab = np.where(active[:, None, None], new, lab)
        active, lab_conv = _exit(active, lab_conv, ch)

    # fill, on rows with enclosed cells of windows that have any
    fill_rows = enclosed if skip_fill else every
    active = (fill_rows != 0).any(-1) & (k_fill > 0)
    fill_conv = ~active
    for _ in range(k_fill):
        c0, c1, g0, g1 = min3x3_rows(lab)
        v0 = np.where(bit(enclosed, 2 * LANE), g0, c0)
        v1 = np.where(bit(enclosed, 2 * LANE + 1), g1, c1)
        new = np.where((fill_rows != 0)[..., None], unpair(v0, v1), lab)
        ch = (new != lab).any((1, 2))
        lab = np.where(active[:, None, None], new, lab)
        active, fill_conv = _exit(active, fill_conv, ch)

    low = masked * 2 + from_words(boundary)
    closed = (bits >> 2) & 1
    okey = lab * 8 + closed * 4 + low if pack_closed else lab * 4 + low
    return okey, lab_conv & out_conv & fill_conv


# ---- each step against its serial loop ----

def _planes(density, K=6):
    """Background (~masked) and a seed set inside it, [K, 64, 64]."""
    rng = np.random.default_rng(_seed(density))
    bg = ~_mask(rng, density, (K, W, W))
    return bg, bg & (rng.random((K, W, W)) < 0.05)


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("density", DENSITIES)
def test_row_fill_matches_serial_or_sweep(density, rev):
    bg, o = _planes(density)
    got = from_words(row_fill(to_words(o), to_words(bg), rev))
    np.testing.assert_array_equal(got, serial_or_sweep(o, bg, rev))


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("density", DENSITIES)
def test_col_fill_matches_serial_or_sweep(density, rev):
    bg, o = _planes(density)
    a0, a1 = col_fill(*pairs(to_words(o)), *pairs(to_words(bg)), rev)
    got = from_words(unpair(a0, a1))
    want = serial_or_sweep(o.transpose(0, 2, 1), bg.transpose(0, 2, 1),
                           rev).transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", DENSITIES)
def test_any4_any8_words_match_direct(density):
    bg, _ = _planes(density)
    o = bg & (np.random.default_rng(7).random(bg.shape) < 0.3)
    n0, n1 = any4_glue(*pairs(to_words(o)), *pairs(to_words(bg)))
    np.testing.assert_array_equal(from_words(unpair(n0, n1)),
                                  o | (bg & direct_any(o, True)))
    np.testing.assert_array_equal(
        from_words(unpair(*any8(*pairs(to_words(o))))), direct_any(o, False))


@pytest.mark.parametrize("axis", ["rows", "columns"])
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("density", DENSITIES)
def test_seg_min_scan_matches_serial_min_sweep(density, rev, axis):
    """Random labels on masked cells, 4096 off them: the log-step key scan
    equals the serial segmented min along each line."""
    rng = np.random.default_rng(_seed(density) + 11)
    masked = ~_mask(rng, density, (6, W, W))     # density of walls
    if axis == "columns":
        masked = masked.transpose(0, 2, 1)
    v = np.where(masked, rng.integers(0, BIG, masked.shape), BIG)
    v0, v1 = seg_min_scan(*pairs(v), ~to_words(masked), rev)
    np.testing.assert_array_equal(unpair(v0, v1),
                                  serial_min_sweep(v, masked, rev))


# ---- the skips and the whole passes ----

def _windows():
    """Random needle masks inside the r=23 disk at each density, an
    all-0 and an all-1 window (every bit set, masked off the disk too),
    and the dense-noise rescue window (seed 0, p=0.35)."""
    rng = np.random.default_rng(12)
    out = []
    for density in (0.05, 0.3, 0.6):
        closed = rng.random((2, W, W)) < density
        out.append(_bits(closed & DISK, closed, np.broadcast_to(DISK,
                                                                closed.shape)))
    out.append(np.zeros((1, W, W), np.int32))
    out.append(np.full((1, W, W), 7, np.int32))
    closed = (np.random.default_rng(0).random((8, W, W)) < 0.35)[:1]
    out.append(_bits(closed & DISK, closed, DISK[None]))
    return np.concatenate(out)


def _bits(masked, closed, disk):
    return (masked.astype(np.int32) + 2 * disk.astype(np.int32)
            + 4 * closed.astype(np.int32))


@pytest.fixture(scope="module")
def windows():
    return _windows()


@pytest.mark.parametrize("caps", [None, (4, 2, 2), components.RESCUE_CAPS])
def test_line_skips_are_exact(windows, caps):
    """Skipping the rows and columns whose mask word is 0 gives the state
    and the flags of sweeping every line (their cells stay 4096)."""
    skipped = model_propagate(windows, caps)
    full = model_propagate(windows, caps, skip_lines=False)
    np.testing.assert_array_equal(skipped[0], full[0])
    np.testing.assert_array_equal(skipped[1], full[1])


@pytest.mark.parametrize("caps", [(0, 0, 1), (2, 3, 0), (2, 6, 3),
                                  components.RESCUE_CAPS])
def test_empty_enclosed_fill_shortcut(windows, caps):
    """A window with no enclosed cell skips the fill: one pass that
    changes nothing, so the same state and flag as running it; windows
    with enclosed cells run it on their enclosed rows only."""
    skipped = model_propagate(windows, caps)
    full = model_propagate(windows, caps, skip_fill=False)
    np.testing.assert_array_equal(skipped[0], full[0])
    np.testing.assert_array_equal(skipped[1], full[1])


@pytest.mark.parametrize("pack_closed", [True, False])
@pytest.mark.parametrize("caps", CAPS)
def test_model_passes_match_propagate(windows, caps, pack_closed):
    """The composed model equals the plain version pass for pass: okey
    and converged, including capped partial states."""
    got, conv = model_propagate(windows, caps, pack_closed)
    want, want_conv = components.propagate(torch.as_tensor(windows), caps,
                                            pack_closed=pack_closed)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(conv, want_conv.numpy())
