"""A model, in numpy, of the K10 kernel's design (csrc/jpeg.cu
backhalf_planes_kernel): window-aligned bands that IDCT each needed block
once, and a tail over pixel pairs. The kernel itself runs only on the
card (tests/test_torch_cuda.py holds it there); this model lets its band
limits, halo rows, staging layout and pair indexing be checked on the
CPU.

One band is one chroma block row k of the window (window rows 16k to
16k+15) that holds crop rows. It stages, in the kernel's layout, the
full IDCT of the luma blocks under its crop rows and the crop's columns
and of the chroma blocks of row k under the crop's chroma columns and
their one-sample halo, and, where a crop pixel reads them, the single
chroma rows 8k-1 (row 7 of block row k-1) and 8k+8 (row 0 of block row
k+1), each from the column passes' entries of that row and one row
pass. Its tail walks window column pairs (2c, 2c+1) down its rows,
reading the vertical 3:1 sums of chroma columns c-1, c and c+1 once a
pair. The model records every staged sample it writes and fails on a
read of one it did not, and on an output written twice or never.
"""
import jax
import numpy as np
import pytest
import torch

from chip_smoke import backhalf_blocks_needed
from meterelf_tpu.ops import jpegdec as jdec
from meterelf_tpu.types import Rect as JRect
from meterelf_tpu_torch import synthetic
from meterelf_tpu_torch.io import jpeg as tio
from meterelf_tpu_torch.ops import jpeg_tail, jpegdec
from meterelf_tpu_torch.types import Rect

U32 = np.uint32
BAND_ROWS = 16       # window rows a band
CHROMA_ROWS = 10     # staged chroma rows: 8k-1, 8k..8k+7, 8k+8
QTABLES = 384        # the kernel's static shared quant tables, bytes

# (rect, frame_wh, staging): both cameras, the unaligned card window
# (staging larger than the window), the second shipped camera of the JAX
# kernel's notes (oy = 14, lw = 240), a crop that ends on the last valid
# chroma row of a frame 96 rows high (the halo row 8k+8 clamps), one that
# ends inside a band on it (frame 94 rows), one whose halo row 8k+8 is the
# last valid chroma row (frame 50 rows), and an odd crop origin
WINDOWS = {
    "flagship": (synthetic.DEFAULT_CAMERA.meter_rect, (640, 480),
                 (250, 250)),
    "alt": (synthetic.ALT_CAMERA.meter_rect, (640, 480), (200, 210)),
    "unaligned": (Rect((9, 13), (70, 72)), (128, 96), (96, 128)),
    "oy14_lw240": (Rect((98, 158), (330, 400)), (640, 480), (248, 240)),
    "last_chroma_row": (Rect((17, 40), (150, 96)), (160, 96), (56, 136)),
    "last_chroma_row_mid_band": (Rect((17, 40), (150, 94)), (160, 94),
                                 (54, 133)),
    "halo_on_last_chroma_row": (Rect((5, 10), (60, 49)), (64, 50),
                                (40, 56)),
    "odd_origin": (Rect((51, 161), (290, 400)), (640, 480), (240, 240)),
}


def stage_bytes(lw: int) -> int:
    """The band's dynamic shared memory: Y [16][lw], Cb and Cr [10][lw/2]."""
    return BAND_ROWS * lw + 2 * CHROMA_ROWS * (lw // 2)


# ---- the kernel's uint32 arithmetic (jidctint.c, wrapping mod 2^32) ----

F = {k: U32(v) for k, v in dict(
    p298=2446, p390=3196, p541=4433, p765=6270, p899=7373, p1175=9633,
    p1501=12299, p1847=15137, p1961=16069, p2053=16819, p2562=20995,
    p3072=25172).items()}


def descale(x, n):
    return ((x + U32(1 << (n - 1))).view(np.int32) >> n).view(U32)


def idct8(v, n):
    """csrc/jpeg.cu idct8 on 8 uint32 arrays."""
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * F["p541"]
    t2 = z1 - z3 * F["p1847"]
    t3 = z1 + z2 * F["p765"]
    z2, z3 = v[0], v[4]
    e0 = (z2 + z3) << U32(13)
    e1 = (z2 - z3) << U32(13)
    t10, t13 = e0 + t3, e0 - t3
    t11, t12 = e1 + t2, e1 - t2
    o0, o1, o2, o3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F["p1175"]
    o0, o1, o2, o3 = (o0 * F["p298"], o1 * F["p2053"], o2 * F["p3072"],
                      o3 * F["p1501"])
    z1 = (U32(0) - z1) * F["p899"]
    z2 = (U32(0) - z2) * F["p2562"]
    z3 = (U32(0) - z3) * F["p1961"] + z5
    z4 = (U32(0) - z4) * F["p390"] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return [descale(t, n) for t in (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                                     t13 - o0, t12 - o1, t11 - o2, t10 - o3)]


def idct8_edge(v, n, last):
    """csrc/jpeg.cu idct8_edge: output 7 (last) or 0 of idct8 alone."""
    z2, z3 = v[2], v[6]
    t3 = (z2 + z3) * F["p541"] + z2 * F["p765"]
    t10 = ((v[0] + v[4]) << U32(13)) + t3
    o0, o1, o2, o3 = v[7], v[5], v[3], v[1]
    z1, z3, z4 = o0 + o3, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F["p1175"]
    o3 = (o3 * F["p1501"] + (U32(0) - z1) * F["p899"]
          + (U32(0) - z4) * F["p390"] + z5)
    return descale(t10 - o3 if last else t10 + o3, n)


def to_u8(x):
    return np.clip(x.view(np.int32) + 128, 0, 255).astype(np.uint8)


def dequant(coef, q):
    """coef [N, 8, 8] i16 (the dense wire; the compact one unpacks to
    it), q [64] -> uint32 [N, 8, 8] as load_block: (uint32)v * q."""
    return coef.astype(np.int32).view(U32) * q.astype(U32).reshape(8, 8)


def idct_full(c):
    """idct_block: column passes (down each column, outputs are rows),
    then row passes; [N, 8, 8] uint32 -> u8 samples."""
    w = np.stack(idct8([c[:, r, :] for r in range(8)], 11), axis=1)
    return to_u8(np.stack(idct8([w[:, :, x] for x in range(8)], 18), axis=2))


def idct_edge_row(c, last):
    """idct_edge_row: sample row 7 (last) or 0 of each block, [N, 8]."""
    e = idct8_edge([c[:, r, :] for r in range(8)], 11, last)
    return to_u8(np.stack(idct8([e[:, x] for x in range(8)], 18), axis=1))


def ycc_packed(y, cb, cr):
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    cb, cr = cb - 128, cr - 128
    r = np.clip(y + ((91881 * cr + 32768) >> 16), 0, 255)
    b = np.clip(y + ((116130 * cb + 32768) >> 16), 0, 255)
    g = np.clip(y + ((-22554 * cb - 46802 * cr + 32768) >> 16), 0, 255)
    return (b | (g << 8) | (r << 16)).astype(np.int32)


# ---- the bands ----

def band_plan(win, k):
    """What band k stages: its crop rows [wy0, wy1), luma block rows and
    columns, chroma block columns, and which halo rows it computes."""
    wy0 = max(16 * k, win.oy)
    wy1 = min(16 * k + 16, win.oy + win.rh)
    lx0 = win.ox >> 3
    cx0 = max((win.ox >> 1) - 1, 0) >> 3
    return dict(
        wy0=wy0, wy1=wy1,
        lrows=range(wy0 >> 3, ((wy1 - 1) >> 3) + 1),
        lcols=range(lx0, ((win.ox + win.rw - 1) >> 3) + 1),
        ccols=range(cx0, (min(((win.ox + win.rw - 1) >> 1) + 1,
                              win.cw_valid - 1) >> 3) + 1),
        up=k > 0 and wy0 == 16 * k,
        down=wy1 == 16 * k + 16 and 8 * k + 8 <= win.ch_valid - 1)


def blocks_of(plane, brs, bxs):
    return np.stack([plane[8 * r:8 * r + 8, 8 * x:8 * x + 8]
                     for r in brs for x in bxs])


def model_image(planes, q, win, pad_hw, out, written, counts):
    """One image through the bands: planes dense i16 (Y [lh, lw], Cb, Cr
    [lh/2, lw/2]), q [3, 64]; writes out [ph, pw] i32, counts the writes
    of each output in ``written`` and the IDCTs in ``counts``."""
    ph, pw = pad_hw
    lw, cw = 8 * win.lbw, 4 * win.lbw
    k0 = win.oy >> 4
    nbands = ((win.oy + win.rh - 1) >> 4) - k0 + 1
    for b in range(nbands):
        k = k0 + b
        p = band_plan(win, k)
        sy = np.zeros((BAND_ROWS, lw), np.uint8)
        sc = np.zeros((2, CHROMA_ROWS, cw), np.uint8)
        sy_ok = np.zeros(sy.shape, bool)
        sc_ok = np.zeros(sc.shape, bool)
        assert sy.nbytes + sc.nbytes == stage_bytes(lw)
        lr, lx, cx = p["lrows"], p["lcols"], p["ccols"]
        s = idct_full(dequant(blocks_of(planes[0], lr, lx), q[0]))
        for i, (r, x) in enumerate((r, x) for r in lr for x in lx):
            rs = slice(8 * r - 16 * k, 8 * r - 16 * k + 8)
            sy[rs, 8 * x:8 * x + 8] = s[i]
            sy_ok[rs, 8 * x:8 * x + 8] = True
        counts["full"] += len(lr) * len(lx)
        for pl in range(2):
            s = idct_full(dequant(blocks_of(planes[1 + pl], [k], cx),
                                  q[1 + pl]))
            for i, x in enumerate(cx):
                sc[pl, 1:9, 8 * x:8 * x + 8] = s[i]
                sc_ok[pl, 1:9, 8 * x:8 * x + 8] = True
            counts["full"] += len(cx)
            for flag, br, row, last in ((p["up"], k - 1, 0, True),
                                        (p["down"], k + 1, 9, False)):
                if not flag:
                    continue
                e = idct_edge_row(dequant(blocks_of(planes[1 + pl], [br],
                                                    cx), q[1 + pl]), last)
                for i, x in enumerate(cx):
                    sc[pl, row, 8 * x:8 * x + 8] = e[i]
                    sc_ok[pl, row, 8 * x:8 * x + 8] = True
                counts["single"] += len(cx)
        # the tail: window column pairs (2c, 2c+1) across, rows down
        ys = max(16 * k - win.oy, 0)
        ye = ph if b == nbands - 1 else p["wy1"] - win.oy
        npairs = (pw + (win.ox & 1) + 1) >> 1
        c = (win.ox >> 1) + np.arange(npairs)
        x = 2 * c - win.ox
        for y in range(ys, ye):
            v0 = np.zeros(npairs, np.int32)
            v1 = np.zeros(npairs, np.int32)
            m = (x < win.rw) & (y < win.rh)
            if m.any():
                wy = win.oy + y
                r = wy >> 1
                nr = min(r + 1, win.ch_valid - 1) if wy & 1 else max(r - 1, 0)
                ra, rb = r - 8 * k + 1, nr - 8 * k + 1
                cm = c[m]
                lc = np.maximum(cm - 1, 0)
                rc = np.minimum(cm + 1, win.cw_valid - 1)
                keep0 = x[m] >= 0
                keep1 = x[m] + 1 < win.rw
                ly = wy - 16 * k
                assert sy_ok[ly, 2 * cm[keep0]].all()
                assert sy_ok[ly, 2 * cm[keep1] + 1].all()
                for col, keep in ((cm, keep0 | keep1), (lc, keep0),
                                  (rc, keep1)):
                    assert sc_ok[:, [ra, rb]][:, :, col[keep]].all()
                vs = [3 * sc[:, ra, col].astype(np.int32) + sc[:, rb, col]
                      for col in (lc, cm, rc)]
                even = (3 * vs[1] + vs[0] + 8) >> 4
                odd = (3 * vs[1] + vs[2] + 7) >> 4
                v0[m] = ycc_packed(sy[ly, 2 * cm], even[0], even[1])
                v1[m] = np.where(keep1, ycc_packed(sy[ly, 2 * cm + 1],
                                                   odd[0], odd[1]), 0)
            s0 = x >= 0
            s1 = x + 1 < pw
            out[y, x[s0]] = v0[s0]
            out[y, x[s1] + 1] = v1[s1]
            written[y, x[s0]] += 1
            written[y, x[s1] + 1] += 1


def model_backhalf(planes, qt, win, pad_hw):
    """The bands over a batch: dense planes [B, ...] i16, qt [B, 3, 64]
    -> ([B, ph, pw] i32, counts of full IDCTs and single rows a batch)."""
    B = planes[0].shape[0]
    out = np.full((B, *pad_hw), -1, np.int32)
    counts = {"full": 0, "single": 0}
    for i in range(B):
        written = np.zeros(pad_hw, np.int32)
        model_image([p[i] for p in planes], qt[i], win, pad_hw, out[i],
                     written, counts)
        assert (written == 1).all(), "an output written twice or never"
    return out, counts


def random_planes(win, B, hi, rng):
    lh, lw = 8 * win.lbh, 8 * win.lbw
    return [rng.integers(-hi, hi, (B, r, c)).astype(np.int16)
            for r, c in ((lh, lw), (lh // 2, lw // 2), (lh // 2, lw // 2))]


def admitted_windows(n, seed):
    """n (name, rect, frame_wh, staging) that backhalf_ok admits: random
    frames (odd sizes too), rects and stagings."""
    rng = np.random.default_rng(seed)
    found = []
    while len(found) < n:
        fw, fh = (int(v) for v in rng.integers(24, 200, 2))
        w, h = (int(v) for v in rng.integers(1, min(fw, fh, 90), 2))
        x0 = int(rng.integers(0, fw - w + 1))
        y0 = int(rng.integers(0, fh - h + 1))
        rect = Rect((x0, y0), (x0 + w, y0 + h))
        win = jpegdec.coef_window(rect, fw, fh)
        pad = (h + int(rng.integers(0, 20)), w + int(rng.integers(0, 20)))
        if jpegdec.backhalf_ok(win, pad):
            found.append((f"sweep{len(found)}", rect, (fw, fh), pad))
    return found


SWEEP = admitted_windows(14, 8)
CASES = [(n, *v) for n, v in WINDOWS.items()] + SWEEP


def test_single_row_idct_equals_full_idct_row():
    """(a) Rows 0 and 7 of a block from idct_edge_row equal those rows of
    the plain IDCT (ops/jpegdec.idct_blocks, and the JAX package's), on
    random blocks over the full i16 range with q up to 255, where the
    butterfly's sums wrap; the model's full IDCT equals it too."""
    rng = np.random.default_rng(11)
    for hi in (2048, 32768):
        coef = rng.integers(-hi, hi, (1, 512, 64)).astype(np.int16)
        coef[0, :8] = hi - 1
        coef[0, 8:16] = -hi
        q = rng.integers(1, 256, (1, 64)).astype(np.uint16)
        q[0, :16] = 255
        ref = jpegdec.idct_blocks(torch.as_tensor(coef),
                                  torch.as_tensor(q)).numpy()
        assert np.array_equal(ref, np.asarray(jdec.idct_blocks(coef, q)))
        ref = ref.reshape(512, 8, 8)
        c = dequant(coef[0].reshape(512, 8, 8), q[0])
        assert np.array_equal(idct_full(c), ref)
        assert np.array_equal(idct_edge_row(c, last=False), ref[:, 0])
        assert np.array_equal(idct_edge_row(c, last=True), ref[:, 7])


@pytest.mark.parametrize("name,rect,wh,pad_hw", CASES,
                         ids=[c[0] for c in CASES])
def test_bands_equal_plain_version(name, rect, wh, pad_hw):
    """(b) Crops built band by band from the model's staged samples equal
    backhalf_planes_to_packed (dense and compact planes, coefficients at
    the compact range and at full i16 range with q up to 255), every
    read staged and every output written once; on the named windows the
    JAX package's plain back-half agrees as well."""
    win = jpegdec.coef_window(rect, *wh)
    assert jpegdec.backhalf_ok(win, pad_hw)
    rng = np.random.default_rng(sum(map(ord, name)))
    B = 2
    qt = rng.integers(1, 256, (B, 3, 64)).astype(np.uint16)
    qt[0, :, :8] = 255
    tq = torch.as_tensor(qt)
    for hi in (2048, 32768):
        planes = random_planes(win, B, hi, rng)
        got, counts = model_backhalf(planes, qt, win, pad_hw)
        ref = jpegdec.backhalf_planes_to_packed(
            *map(torch.as_tensor, planes), tq, win, pad_hw).numpy()
        assert np.array_equal(got, ref), (name, hi)
        if hi == 2048:
            compact = [torch.as_tensor(tio.compact_planes(p))
                       for p in planes]
            assert np.array_equal(got, jpegdec.backhalf_planes_to_packed(
                *compact, tq, win, pad_hw).numpy())
        if name in WINDOWS:
            jwin = jdec.coef_window(JRect(*rect), *wh)
            assert tuple(jwin) == tuple(win)
            jref = jax.jit(lambda a, b, c, q: jdec.backhalf_planes_to_packed(
                a, b, c, q, jwin, pad_hw=pad_hw))(*planes, qt)
            assert np.array_equal(got, np.asarray(jref)), (name, hi)
        _, full, single = jpeg_tail.backhalf_bands(win)
        assert counts == {"full": B * full, "single": B * single}


@pytest.mark.parametrize("name,rect,wh,pad_hw", CASES,
                         ids=[c[0] for c in CASES])
def test_band_idct_counts(name, rect, wh, pad_hw):
    """(c) The full IDCTs an image the design runs (backhalf_bands, which
    chip_smoke.py prints) are at most the blocks the crop needs
    (chip_smoke.backhalf_blocks_needed): each needed luma block once, the
    chroma halo block rows as single rows. The flagship's fall from the
    2,528 of 16-row tiles starting at the crop's rows to 1,536."""
    win = jpegdec.coef_window(rect, *wh)
    bands, full, single = jpeg_tail.backhalf_bands(win)
    needed = backhalf_blocks_needed(win)
    assert full <= needed
    k0 = win.oy >> 4
    assert bands == ((win.oy + win.rh - 1) >> 4) - k0 + 1
    assert single <= 2 * bands * 2 * (len(band_plan(win, k0)["ccols"]))
    if name == "flagship":
        assert (bands, full, single, needed) == (16, 1536, 992, 1568)


def test_band_staging_fits_every_admitted_window():
    """(d) The bands' staging (26 B a window column) plus the quant
    tables fits a block's shared memory for every window the unchanged
    gate admits: the sweep, the named windows, and the widest window
    backhalf_ok takes."""
    wins = [jpegdec.coef_window(r, *wh) for _, r, wh, _ in CASES]
    wins += [w for w, _ in SWEEP_WIDE]
    for win in wins:
        assert stage_bytes(8 * win.lbw) + QTABLES <= jpegdec.SMEM_LIMIT
    widest = max(w.lbw for w, pad in SWEEP_WIDE
                 if jpegdec.backhalf_ok(w, pad))
    assert not jpegdec.backhalf_ok(*_wide(widest + 2))
    assert stage_bytes(8 * widest) + QTABLES <= jpegdec.SMEM_LIMIT


def _wide(lbw):
    """A window lbw luma blocks wide (and 2 high) with a one-row crop."""
    win = jpegdec.CoefWindow(lbx0=0, lby0=0, lbw=lbw, lbh=2, ox=2, oy=2,
                             rw=8 * lbw - 4, rh=1, cw_valid=4 * lbw,
                             ch_valid=8)
    return win, (1, 8 * lbw - 4)


SWEEP_WIDE = [_wide(lbw) for lbw in range(2, 700, 2)]
