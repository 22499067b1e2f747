"""A model, in numpy, of the index math of csrc/corr_wgmma.cuh: K1's
correlation as Hopper warpgroup products (wgmma m64nNk32, s8). The kernel
runs only on the card (tests/test_torch_cuda.py holds it there); this
model checks its layout, band and descriptors on the CPU.

The model stages L' in 16-byte column chunks as the kernel does, with
random bytes wherever the kernel stages nothing (rows past H, the gap
before each chunk's next 16 * H bytes), and T' at its row stride between
zero margins; builds each warp's band registers from aligned template
words and a byte shift; reads B_r through the descriptor's addressing
(start 16 r bytes into chunk x0 / 16 + 2 j, SBO = 128, LBO = ch); splits
the template rows or the x tiles between the two warpgroups; stores the
accumulators to corr8 [x][y] as the PTX ISA lays out wgmma's D
fragments (one x tile: the second warpgroup's added); and forms box'
from the staged rows' prefix sums (row windows in i16, then column
windows). corr8 and box' must equal ops/frontend.py corr_box8's
exactly. The layout (ops/frontend.k1_layout, mirror of corrwg::layout)
must fit a block's shared memory wherever the frontend gate passes, so
that frontend_ok's verdict stays what it was.
"""
import numpy as np
import pytest
import torch

from meterelf_tpu_torch.ops import frontend

LANE = np.arange(32)
GQ, TQ = LANE >> 2, LANE & 3
WORD_OF_REG = np.array([2, 0, 6, 4])    # a[0], a[1], a[2], a[3]

GEOMETRIES = {
    "flagship": (250, 250, 119, 188),
    "alt": (200, 210, 90, 141),              # two x tiles, ow = 70
    "k1_largest": (256, 256, 128, 129),      # ow = 128, n = 144
    "worst_gated": (256, 256, 64, 129),      # n = 208, ow = 128
    "ow64": (250, 251, 119, 188),
    "ow65": (250, 252, 119, 188),
    "oh_edge": (184, 250, 64, 188),          # oh = 121: one past 8 * 15
    "short_template": (120, 200, 40, 141),
    "wide_template": (256, 256, 64, 256),    # ow = 1, nj = 10
    "tallest": (256, 200, 49, 141),          # oh = 208, n = 208
    "small": (60, 60, 40, 40),
}


def _fragment_rows_cols():
    """(lane, register, byte) -> (row, k) of a warp's 16 x 32 slice of A,
    and (lane, register) -> (row, column) of its D fragment per 8-column
    block, for wgmma m64nNk32 with s8 inputs (each warp's slice as
    mma.m16n8k32's)."""
    a = np.zeros((32, 4, 4, 2), np.int64)
    d = np.zeros((32, 4, 2), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            a[lane, 0, i] = (g, 4 * t + i)
            a[lane, 1, i] = (g + 8, 4 * t + i)
            a[lane, 2, i] = (g, 16 + 4 * t + i)
            a[lane, 3, i] = (g + 8, 16 + 4 * t + i)
            d[lane, i] = (g + 8 * (i >> 1), 2 * t + (i & 1))
    return a, d


A_MAP, D_MAP = _fragment_rows_cols()


def stage(lp, tp, g, rng):
    """Region A with L' in its chunks (random bytes where nothing is
    staged) and region B's template, as int64 byte arrays."""
    H, W = lp.shape
    th, tw = tp.shape
    reg_a = rng.integers(-128, 128, g.off_b)
    cols = 16 * g.kc
    val = np.zeros((H, cols), np.int64)
    val[:, :W] = lp
    s, k = np.arange(H)[:, None], np.arange(cols)[None, :]
    reg_a[(k // 16) * g.ch + 16 * s + k % 16] = val
    reg_t = np.zeros(g.t_bytes, np.int64)
    r, c = np.arange(th)[:, None], np.arange(tw)[None, :]
    reg_t[frontend.K1_TMARGIN + r * g.ts + c] = tp
    return reg_a, reg_t


def band(reg_t, g, th):
    """A_r for every template row and k32 step, [th, nj, 64, 32], from
    each lane's registers: register q' of warp q at step (r, j) is the
    byte-shifted word pair from staged word (64 - 8 - 16 q + 4 tq - gq)
    // 4 + r * ts / 4 + 8 j + WORD_OF_REG[q']."""
    nj = g.nj
    q = np.arange(4)
    w0 = (frontend.K1_TMARGIN - 8 - 16 * q[:, None] + 4 * TQ - GQ) >> 2
    shift = (-GQ) & 3                                          # [32]
    word = (w0[None, None, :, :, None]
            + (g.ts // 4) * np.arange(th)[:, None, None, None, None]
            + 8 * np.arange(nj)[None, :, None, None, None]
            + WORD_OF_REG[None, None, None, None, :])   # [th, nj, 4, 32, 4]
    byte = (4 * word[..., None] + shift[None, None, None, :, None, None]
            + np.arange(4))
    assert word.min() >= 0 and byte.max() < g.t_bytes
    vals = reg_t[byte]                               # [th, nj, 4, 32, 4, 4]
    A = np.zeros((th, nj, 64, 32), np.int64)
    rows = 16 * q[:, None, None, None] + A_MAP[None, ..., 0]
    ks = np.broadcast_to(A_MAP[None, ..., 1], rows.shape)
    A[:, :, rows, ks] = vals
    return A


def tile_sums(reg_a, A, g, tile, r0, r1):
    """One warpgroup's 64 x n accumulator: x tile `tile`, template rows
    [r0, r1), B_r read through the descriptor's addressing."""
    x0 = 64 * tile
    nj = min(g.nj, -(-(g.W - x0) // 32))
    r = np.arange(r0, r1)[:, None, None, None]
    j = np.arange(nj)[None, :, None, None]
    kk = np.arange(32)[None, None, :, None]
    y = np.arange(g.n)[None, None, None, :]
    addr = ((x0 // 16 + 2 * j + kk // 16) * g.ch + 16 * (r + y) + kk % 16)
    assert addr.size == 0 or addr.max() < g.off_b
    B = reg_a[addr].astype(np.float64)               # [r, j, 32, n]
    Ar = A[r0:r1, :nj].astype(np.float64)            # [r, j, 64, 32]
    acc = np.einsum("rjmk,rjkn->mn", Ar, B) if r1 > r0 else np.zeros(
        (64, g.n))
    return acc.astype(np.int64), (r1 - r0) * nj


def box_model(reg_a, g, th, tw):
    """box' [oh, ow] from the staged rows: the prefix Pk of each row (the
    warp scan), Rw = Pk[x + tw] - Pk[x] as i16, then th-row windows."""
    cols = 16 * g.kc
    s, k = np.arange(g.H)[:, None], np.arange(cols)[None, :]
    rows = reg_a[(k // 16) * g.ch + 16 * s + k % 16]
    pk = np.concatenate([np.zeros((g.H, 1), np.int64),
                         rows.cumsum(1)], axis=1)
    x = np.arange(g.ow)
    rw = pk[:, x + tw] - pk[:, x]
    assert rw.min() >= -2 ** 15 and rw.max() < 2 ** 15
    csum = np.concatenate([np.zeros((1, g.ow), np.int64), rw.cumsum(0)])
    return csum[th:th + g.oh] - csum[:g.oh]


def corr_model(lp, tp, rng):
    """corr8 [oh, ow], box' [oh, ow] and the k32 steps of one image as
    the kernel computes them."""
    H, W = lp.shape
    th, tw = tp.shape
    g = frontend.k1_layout(H, W, th, tw)
    assert g.bytes > 0
    reg_a, reg_t = stage(lp, tp, g, rng)
    A = band(reg_t, g, th)
    half = (th + 1) // 2
    if g.nm == 1:
        parts = [tile_sums(reg_a, A, g, 0, 0, half),
                 tile_sums(reg_a, A, g, 0, half, th)]
        tiles = [0, 0]
    else:
        parts = [tile_sums(reg_a, A, g, t, 0, th) for t in (0, 1)]
        tiles = [0, 1]
    steps = sum(p[1] for p in parts)
    # put(): each lane's fragment registers into corr8 [x][y]; one x tile
    # adds warpgroup 1's to warpgroup 0's
    nb = g.n // 8
    xs = np.full((64 * g.nm, g.n), -1 << 40, np.int64)
    written = np.zeros_like(xs)
    for wg in (0, 1):
        acc = parts[wg][0]
        for i in range(nb):
            for q in range(4):
                for e in range(4):
                    m, c = D_MAP[:, e, 0], D_MAP[:, e, 1]   # 32 lanes
                    xl, yy = 16 * q + m, 8 * i + c
                    x = 64 * tiles[wg] + xl
                    if g.nm == 1 and wg == 1:
                        xs[x, yy] += acc[xl, yy]
                    else:
                        xs[x, yy] = acc[xl, yy]
                    written[x, yy] += 1
    assert (written == (2 if g.nm == 1 else 1)).all()
    corr = xs[:g.ow, :g.oh].T
    return corr, box_model(reg_a, g, th, tw), steps


FILLS = ("random", "both_min", "min_max")


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_wgmma_model_equals_corr_box8(name, fill):
    H, W, th, tw = GEOMETRIES[name]
    rng = np.random.default_rng(H * 5 + tw)
    if fill == "random":
        lp = rng.integers(-128, 128, (H, W))
        tp = rng.integers(-128, 128, (th, tw))
    else:   # every product +2^14 (both -128), or -128 * 127
        lp = np.full((H, W), -128)
        tp = np.full((th, tw), -128 if fill == "both_min" else 127)
    corr, box, steps = corr_model(lp, tp, rng)
    ref_corr, ref_box = frontend.corr_box8(
        torch.as_tensor(lp, dtype=torch.int32)[None],
        torch.as_tensor(tp, dtype=torch.int32))
    assert np.array_equal(corr, ref_corr[0].numpy().astype(np.int64))
    assert np.array_equal(box, ref_box[0].numpy())
    assert int(np.abs(corr).max()) < 2 ** 31
    g = frontend.k1_layout(H, W, th, tw)
    if g.nm == 1:
        assert steps == th * min(g.nj, -(-W // 32))


def test_flagship_counts():
    """The flagship's layout and work as csrc/frontend.cu's note states
    them: 105,872 bytes, so two blocks share an SM (228 KB, less 1 KB a
    block); 952 k32 steps of m64n144 a crop, 280.8 M MACs, 1.51x the
    function's 186 M."""
    g = frontend.k1_layout(250, 250, 119, 188)
    assert (g.nm, g.n, g.nj, g.kc, g.ch, g.ts) == (1, 144, 8, 16, 4112, 256)
    assert g.bytes == frontend.k1_smem_bytes(250, 250, 119, 188) == 105872
    assert 2 * (g.bytes + 1024 + 64) <= 228 * 1024
    steps = 119 * g.nj
    macs = steps * 64 * g.n * 32
    useful = g.oh * g.ow * 119 * 188
    assert steps == 952 and macs == 280_756_224
    assert round(macs / useful, 2) == 1.51


def test_layout_refuses_what_the_kernel_does_not_take():
    assert frontend.k1_smem_bytes(257, 250, 119, 188) == -1
    assert frontend.k1_smem_bytes(250, 257, 119, 188) == -1
    assert frontend.k1_smem_bytes(250, 250, 119, 122) == -1    # ow = 129
    assert frontend.k1_smem_bytes(250, 250, 119, 123) > 0      # ow = 128
    assert frontend.k1_smem_bytes(100, 250, 119, 188) == -1    # oh = 0
    assert frontend.k1_smem_bytes(256, 250, 48, 188) == -1     # oh = 209
    assert frontend.k1_smem_bytes(256, 250, 49, 188) > 0       # oh = 208


def _gate(H, W, th, tw):
    """ops/frontend.geom_for is not None, over numpy arrays."""
    oh, ow = H - th + 1, W - tw + 1
    nx = -(-ow // frontend.XG)
    bank_k = -(-(tw + frontend.XG) // 32) * 32
    return ((oh >= 1) & (ow >= 1) & (ow <= 128)
            & (H <= frontend.STAGE) & (W <= frontend.STAGE)
            & (-(-th // 8) * 8 <= 128)
            & ((nx - 1) * frontend.XG + bank_k <= frontend.STAGE + 64)
            & (64 <= th) & (th <= frontend.SW_H) & (64 <= tw)
            & (tw <= frontend.SW_W))


def _mma_bytes(H, W, th, tw):
    """frontend.smem_bytes (corr8::layout) over numpy arrays: the staging
    the gate was held to before K1's wgmma layout."""
    oh, ow = H - th + 1, W - tw + 1
    nj = -(-(tw + 15) // 32)
    ls = 16 * (-(-ow // 16) - 1) + 32 * nj
    ls = ls + 16 * (ls % 32 == 0)
    lrows = 8 * -(-oh // 8) + th - 1
    return lrows * ls + th * (32 * nj + 32) + (H + 1) * ow * 4


TH_GROUPS = [list(range(lo, min(lo + 10, 137))) for lo in range(60, 137, 10)]


@pytest.mark.parametrize("ths", TH_GROUPS, ids=lambda t: f"th{t[0]}-{t[-1]}")
def test_k1_layout_fits_wherever_the_gate_passes(ths):
    """Every crop up to 256 x 256 and template width 64 .. 256 (the gate
    refuses narrower ones) at these template heights: wherever the JAX
    gate passes, K1's layout fits a block's shared memory, so
    frontend_ok's verdict (the gate, and the kernel's staging within the
    limit) is the one it gave with the mma.sync staging; and it refuses
    every geometry the gate refuses."""
    W = np.arange(64, 257)[None, :, None]
    tw = np.arange(64, 257)[None, None, :]
    worst = 0
    for th in ths:
        for h0 in range(th, 257, 32):
            H = np.arange(h0, min(h0 + 32, 257))[:, None, None]
            ok = _gate(H, W, th, tw)
            old = ok & (_mma_bytes(H, W, th, tw) <= frontend.SMEM_LIMIT)
            nbytes = frontend.k1_layout(H, W, th, tw).bytes
            new = ok & (nbytes >= 0) & (nbytes <= frontend.SMEM_LIMIT)
            assert np.array_equal(old, new) and np.array_equal(new, ok), \
                (h0, th)
            if ok.any():
                worst = max(worst, int(nbytes[ok].max()))
    assert worst <= 221_184 <= frontend.SMEM_LIMIT - 1024
    rng = np.random.default_rng(ths[0])
    for _ in range(200):
        H, W1, tw1 = (int(v) for v in rng.integers(ths[0], 257, 3))
        th = int(rng.choice(ths))
        assert frontend.frontend_ok(H, W1, th, tw1) == bool(
            _gate(H, W1, th, tw1)), (H, W1, th, tw1)
