"""A model, in torch, of the index math of csrc/corr_mma.cuh: the implicit
GEMM that K5, K8 and K9 run on the int8 tensor cores (K1's wgmma
correlation has its own model, tests/test_torch_corr_wgmma.py). The kernel
itself runs only on the card (tests/test_torch_cuda.py holds it there);
this model lets the band limits, paddings and fragment layouts be checked
on the CPU.

The model stages L' and T' as the kernel does (its layout re-derived
here), builds each lane's band fragment from two aligned template words
and a byte shift, gathers each lane's L' fragment as ldmatrix hands it
out, multiplies the fragments in the layouts of the PTX ISA's
mma.m16n8k32 (s8), deals the tiles to the warps as the kernel does, and
reads the accumulators back to (y, x) offsets. Its corr8 must equal
ops/frontend.py corr_box8's exactly, and so must its box' from the
staged prefix sums, for the flagship, ALT_CAMERA, the largest geometries
the frontend and scorer gates admit, a template under 64 rows, and a
template as wide as the crop; with random operands and with the
accumulator extremes (every product +2^14, or every product -128 * 127).
"""
import numpy as np
import pytest
import torch

from meterelf_tpu_torch.ops import frontend, match

MARGIN = 16      # zero bytes before each staged template row
MAX_TILES = 8    # tiles a warp holds at once
WARPS = 16       # 512 threads a block

LANE = np.arange(32)
GQ, TQ = LANE >> 2, LANE & 3

GEOMETRIES = {
    "flagship": (250, 250, 119, 188),
    "alt": (200, 210, 90, 141),
    "k1_largest": (256, 256, 128, 129),      # the largest K1 staging
    "k8_largest": (250, 256, 128, 192),
    "short_template": (120, 200, 40, 141),   # th < 64: K8's gate only
    "wide_template": (256, 256, 64, 256),    # ow = 1, nj = 9
    "small": (60, 60, 40, 40),
}


def layout(H, W, th, tw):
    """corr8::layout, re-derived: x tiles of 16, y tiles of 8, k32 steps
    per template row, and the byte sizes of the staged operands (ints,
    or numpy arrays of them)."""
    oh, ow = H - th + 1, W - tw + 1
    mt, nt = -(-ow // 16), -(-oh // 8)
    nj = -(-(tw + 15) // 32)             # the band of 16 x offsets: tw + 15
    reach = 16 * (mt - 1) + 32 * nj      # L' columns the last x tile reads
    ls = reach + 16 * (reach % 32 == 0)  # 16 * odd bytes
    lrows = 8 * nt + th - 1              # rows the last y tile reads
    ts = 32 * nj + 2 * MARGIN
    return dict(oh=oh, ow=ow, mt=mt, nt=nt, nj=nj, ls=ls, lrows=lrows,
                ts=ts, bytes=lrows * ls + th * ts + (H + 1) * ow * 4)


def _fragment_maps():
    """(lane, register, byte) -> (row, column) of the A (16 x 32), B
    (32 x 8) and C (16 x 8) fragments of mma.m16n8k32 with s8 inputs."""
    a = np.zeros((32, 4, 4, 2), np.int64)
    b = np.zeros((32, 2, 4, 2), np.int64)
    c = np.zeros((32, 4, 2), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            a[lane, 0, i] = (g, 4 * t + i)
            a[lane, 1, i] = (g + 8, 4 * t + i)
            a[lane, 2, i] = (g, 16 + 4 * t + i)
            a[lane, 3, i] = (g + 8, 16 + 4 * t + i)
            b[lane, 0, i] = (4 * t + i, g)
            b[lane, 1, i] = (16 + 4 * t + i, g)
            c[lane, i] = (g + 8 * (i >> 1), 2 * t + (i & 1))
    return a, b, c


A_MAP, B_MAP, C_MAP = _fragment_maps()


def stage(lp, tp, g):
    """The staged operands of one image: L' zero past row H and column
    W, T' between zero margins, and P (the column prefix of the
    row-window sums)."""
    H, W = lp.shape
    th, tw = tp.shape
    sL = torch.zeros((g["lrows"], g["ls"]), dtype=torch.int64)
    sL[:H, :W] = lp
    sT = torch.zeros((th, g["ts"]), dtype=torch.int64)
    sT[:, MARGIN:MARGIN + tw] = tp
    rw = lp.unfold(1, tw, 1).sum(-1)                    # [H, ow]
    P = torch.cat([torch.zeros((1, g["ow"]), dtype=torch.int64),
                   rw.cumsum(0)])
    return sL, sT, P


def band_fragments(trow, g):
    """Each lane's A fragments for one template row: [nj, 32, 4, 4] s8.
    Register q of step j is the unaligned word at staged byte
    MARGIN + 32 j + 4 tq - gq + (0, -8, 16, 8)[q], read as two aligned
    words and a byte shift of (-gq) & 3."""
    nj, ts = g["nj"], g["ts"]
    w0 = (MARGIN - 8 + 4 * TQ - GQ) >> 2
    shift = (-GQ) & 3
    word_of_reg = np.array([2, 0, 6, 4])       # a[0], a[1], a[2], a[3]
    w = (w0[None, :, None] + 8 * np.arange(nj)[:, None, None]
         + word_of_reg[None, None, :])         # [nj, 32, 4]
    assert w.min() >= 0 and 4 * (w.max() + 1) + 3 < ts
    byte = 4 * w[..., None] + shift[None, :, None, None] + np.arange(4)
    return trow[torch.as_tensor(byte)]


def tile_fragments(sL, g, r):
    """Each lane's B fragments for template row r, every tile and step,
    as ldmatrix.x2 hands them out: [T, nj, 32, 2, 4]. Lanes 0-7 address
    the 8 rows of matrix 0 at column k0, lanes 8-15 those of matrix 1 at
    k0 + 16; lane L receives row L / 4, bytes 4 (L % 4) .. + 3 of each."""
    nt, nj = g["nt"], g["nj"]
    tiles = np.arange(g["mt"] * nt)
    mt, ntile = tiles // nt, tiles % nt
    src = np.arange(2)[None, :] * 8 + (LANE >> 2)[:, None]    # [32, 2]
    row = (8 * ntile[:, None, None, None] + (src & 7)[None, None] + r)
    col = (16 * mt[:, None, None, None] + 32 * np.arange(nj)[None, :, None,
                                                             None]
           + 16 * (src >> 3)[None, None])
    assert row.max() < g["lrows"] and col.max() % 16 == 0
    assert col.max() + 16 <= g["ls"]
    row = np.broadcast_to(row, (len(tiles), nj, 32, 2))[..., None].copy()
    col = ((col + 4 * (LANE & 3)[None, None, :, None])[..., None]
           + np.arange(4))
    return sL[torch.as_tensor(row), torch.as_tensor(col)]


def deal(g):
    """The kernel's tile schedule: [(pass, warp, tiles)] for every warp
    with work."""
    T = g["mt"] * g["nt"]
    passes = -(-T // (WARPS * MAX_TILES))
    nb = -(-T // (WARPS * passes))
    assert nb <= MAX_TILES
    out = []
    for p in range(passes):
        for w in range(WARPS):
            t0 = (p * WARPS + w) * nb
            n = min(nb, T - t0)
            if n > 0:
                out.append((p, w, list(range(t0, t0 + n))))
    return out


def corr8_model(lp, tp):
    """corr8 [oh, ow] and box' [oh, ow] of one image as the kernel
    computes them, and the number of mma instructions it issues."""
    H, W = lp.shape
    th, tw = tp.shape
    g = layout(H, W, th, tw)
    sL, sT, P = stage(lp, tp, g)
    T = g["mt"] * g["nt"]
    acc = torch.zeros((T, 16, 8), dtype=torch.int64)
    a_rows, a_cols = torch.as_tensor(A_MAP[..., 0]), torch.as_tensor(
        A_MAP[..., 1])
    b_rows, b_cols = torch.as_tensor(B_MAP[..., 0]), torch.as_tensor(
        B_MAP[..., 1])
    n_mma = 0
    for r in range(th):
        fa = band_fragments(sT[r], g)              # [nj, 32, 4, 4]
        A = torch.zeros((g["nj"], 16, 32), dtype=torch.int64)
        A[:, a_rows, a_cols] = fa
        fb = tile_fragments(sL, g, r)              # [T, nj, 32, 2, 4]
        B = torch.zeros((T, g["nj"], 32, 8), dtype=torch.int64)
        B[:, :, b_rows, b_cols] = fb
        acc += torch.einsum("jmk,tjkn->tmn", A, B)
        n_mma += T * g["nj"]
    corr = torch.full((g["oh"], g["ow"]), -1 << 40, dtype=torch.int64)
    box = torch.full_like(corr, -1 << 40)
    written = torch.zeros_like(corr)
    for _, _, tiles in deal(g):
        for t in tiles:
            mt, nt = divmod(t, g["nt"])
            for lane in range(32):
                for i in range(4):
                    m, n = C_MAP[lane, i]
                    x, y = 16 * mt + m, 8 * nt + n
                    if x < g["ow"] and y < g["oh"]:
                        corr[y, x] = acc[t, m, n]
                        box[y, x] = P[y + th, x] - P[y, x]
                        written[y, x] += 1
    assert torch.equal(written, torch.ones_like(written))
    return corr, box, n_mma


FILLS = ("random", "both_min", "min_max")


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_tiling_model_equals_corr_box8(name, fill):
    H, W, th, tw = GEOMETRIES[name]
    rng = np.random.default_rng(H * 7 + tw)
    if fill == "random":
        lp = rng.integers(-128, 128, (H, W))
        tp = rng.integers(-128, 128, (th, tw))
    else:   # every product +2^14 (both -128), or -128 * 127
        lp = np.full((H, W), -128)
        tp = np.full((th, tw), -128 if fill == "both_min" else 127)
    lp_t = torch.as_tensor(lp, dtype=torch.int64)
    tp_t = torch.as_tensor(tp, dtype=torch.int64)
    corr, box, n_mma = corr8_model(lp_t, tp_t)
    ref_corr, ref_box = frontend.corr_box8(lp_t[None].to(torch.int32),
                                           tp_t.to(torch.int32))
    assert torch.equal(corr, ref_corr[0].to(torch.int64))
    assert torch.equal(box, ref_box[0])
    g = layout(H, W, th, tw)
    assert n_mma == g["mt"] * g["nt"] * th * g["nj"]
    assert int(corr.abs().max()) < 2 ** 31


def test_flagship_counts():
    """The flagship's layout and work, as csrc/frontend.cu's notes state
    them: 162,804 bytes staged, 56,644 mma a crop (4,096 MACs each),
    1.25x the function's 186 M MACs."""
    g = layout(250, 250, 119, 188)
    assert (g["mt"], g["nt"], g["nj"], g["ls"]) == (4, 17, 7, 272)
    assert g["bytes"] == frontend.smem_bytes(250, 250, 119, 188) == 162804
    n_mma = g["mt"] * g["nt"] * 119 * g["nj"]
    useful = g["oh"] * g["ow"] * 119 * 188
    assert n_mma == 56644 and useful == 186_045_552
    assert round(n_mma * 4096 / useful, 2) == 1.25
    # 16 warps: 13 take 5 tiles, one 3, two none
    assert sorted(len(t) for _, _, t in deal(g)) == [3] + [5] * 13


def _k1_family(th):
    """The frontend gate (ops/frontend.geom_for) over every crop width
    and template width for template height th, at crop height 256: the
    staging grows with H and the gate does not bound H below 256."""
    w = np.arange(1, 257)[:, None]
    tw = np.arange(1, 257)[None, :]
    ow = w - tw + 1
    nx = -(-ow // frontend.XG)
    bank_k = -(-(tw + frontend.XG) // 32) * 32
    ok = ((ow >= 1) & (ow <= 128) & (-(-th // 8) * 8 <= 128)
          & ((nx - 1) * frontend.XG + bank_k <= frontend.STAGE + 64)
          & (64 <= th) & (th <= frontend.SW_H) & (tw >= 64)
          & (tw <= frontend.SW_W))
    return 256, w, tw, ok


def _k8_family(th):
    """ops/match.fits likewise, at the largest crop height it admits for
    th (its only bound on H is th - 1 + ceil8(oh) <= 256)."""
    h = max((h for h in range(th, 257)
             if th - 1 + -(-(h - th + 1) // 8) * 8 <= match.H_PAD),
            default=None)
    w = np.arange(1, 257)[:, None]
    tw = np.arange(1, 257)[None, :]
    ow = w - tw + 1
    ok = ((ow >= 1) & (th <= match.R_PAD) & (tw <= match.K_PAD)
          & (ow - 1 + match.K_PAD <= match.W_PAD)) & (h is not None)
    return h or th, w, tw, ok


def _max_staging(family):
    best = 0
    for th in range(1, 257):
        H, w, tw, ok = family(th)
        if ok.any():
            nbytes = layout(H, w, th, tw)["bytes"]
            best = max(best, int(nbytes[ok].max()))
    return best


def test_staging_fits_every_gated_geometry():
    """No geometry that either gate admits stages more than a block's
    shared memory, so no camera changes branch (the frontend's gate
    stays the JAX package's) and K8 never refuses what match.fits
    admits: the largest stagings are 227,696 B (K1, K5) and 176,848 B
    (K8, K9), below the 232,448 B a block may use less K1's few hundred
    bytes of static shared memory."""
    for h, w, th, tw in ((250, 250, 119, 188), (256, 256, 128, 129),
                         (250, 256, 128, 192), (200, 210, 90, 141)):
        assert layout(h, w, th, tw)["bytes"] == frontend.smem_bytes(
            h, w, th, tw)
    assert _max_staging(_k1_family) == 227696
    assert _max_staging(_k8_family) == 176848
    assert 227696 <= frontend.SMEM_LIMIT - 1024
