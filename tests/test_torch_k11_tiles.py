"""A model, in numpy, of the K11 kernel's design (csrc/jpeg.cu
upsample_color_pack_kernel): one CTA per (image, band of window rows
32k..32k+31, tile of 256 output columns), staged packed vertical sums, a
far slot for the last valid chroma column, and 16-byte store groups. The
kernel itself runs only on the card (tests/test_torch_cuda.py holds it
there); this model lets its index math be checked on the CPU.

A CTA stages, for each crop row of its band, the vertical 3:1 sums
3 * near + neighbour of both chroma planes (Cb in the low half of a word,
Cr in the high half) over the chroma columns [c0, c0 + 8 * groups) of its
tile's crop columns and their one-column halo, c0 a multiple of 8, and the
sums of column cw_valid - 1 in the far slot; the neighbour row is read
where it lies (row ch_valid - 1 for a crop row past the valid chroma). A
row of the output is cut at its first 16-byte boundary into a head of 0-3
pixels (group -1, tile 0), quads (16-byte stores) and a tail of 0-3
pixels (group nq); tile t takes groups 64 t to 64 t + 63, and runs
those that hold pixels. The model
records every slot it stages, and fails on a read of one it did not, on a
quad store off a 16-byte boundary, on a luma word outside the row, and on
an output written twice or never.
"""
import jax
import numpy as np
import pytest
import torch

from meterelf_tpu.ops import jpegdec as jdec
from meterelf_tpu.ops import pallas_jpeg
from meterelf_tpu_torch.ops import jpeg_tail, jpegdec
from meterelf_tpu_torch.types import Rect
from jpeg_windows import K11_ALL, k11_random_planes

U32 = np.uint32
BAND = 32        # window rows of a band
TILE = 256       # output columns of a tile
FAR = 144        # the far column's slot
PITCH = 148      # staged words of a window row
LPITCH = 280     # staged luma bytes of a window row
EVEN, ODD = U32(0x00080008), U32(0x00070007)

WINDOWS = K11_ALL


def tail_windows(n, seed):
    """n (name, CoefWindow, staging) that tail_ok admits: random frames
    (odd sizes too) and rects that may reach past the frame's edge by up
    to 15 rows or columns (past the valid chroma), random stagings."""
    rng = np.random.default_rng(seed)
    found = []
    while len(found) < n:
        fw, fh = (int(v) for v in rng.integers(24, 300, 2))
        w = int(rng.integers(1, fw + 1))
        h = int(rng.integers(1, min(fh, 90) + 1))
        x0 = int(rng.integers(0, fw - w + 16))
        y0 = int(rng.integers(0, fh - h + 16))
        win = jpegdec.coef_window(Rect((x0, y0), (x0 + w, y0 + h)), fw, fh)
        pad = (h + int(rng.integers(0, 20)), w + int(rng.integers(0, 9)))
        if jpegdec.tail_ok(win, pad):
            found.append((f"sweep{len(found)}", win, pad))
    return found


SWEEP = tail_windows(24, 10)
CASES = [(n, *v) for n, v in WINDOWS.items()] + SWEEP


def ycc_packed(y, cb, cr):
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    cb, cr = cb - 128, cr - 128
    r = np.clip(y + ((91881 * cr + 32768) >> 16), 0, 255)
    b = np.clip(y + ((116130 * cb + 32768) >> 16), 0, 255)
    g = np.clip(y + ((-22554 * cb - 46802 * cr + 32768) >> 16), 0, 255)
    return (b | (g << 8) | (r << 16)).astype(np.int32)


def tile_plan(win, t):
    """Tile t's first staged chroma column c0 and its groups of 8, its
    first staged luma column l0 and its words of 8."""
    cw = 4 * win.lbw
    x0 = TILE * t
    x1 = min(x0 + TILE + 3, win.rw - 1)
    c0 = max(((win.ox + x0) >> 1) - 1, 0) & ~7
    c1 = min(((win.ox + x1) >> 1) + 1, cw - 1)
    l0 = (win.ox + x0) & ~7
    if x0 > x1:
        return c0, 0, l0, 0
    return c0, ((c1 - c0) >> 3) + 1, l0, ((win.ox + x1 - l0) >> 3) + 1


def grid(win, pad_hw):
    """The launch's bands and tiles (meterelf_upsample_color_pack)."""
    ph, pw = pad_hw
    return ((win.oy + ph - 1) >> 5) - (win.oy >> 5) + 1, pw // TILE + 1


class Staged:
    """A band's staged words and luma bytes, and which were written."""

    def __init__(self):
        self.v = np.zeros((BAND, PITCH), U32)
        self.ok = np.zeros((BAND, PITCH), bool)
        self.lu = np.zeros((BAND, LPITCH), np.uint8)
        self.lu_ok = np.zeros((BAND, LPITCH), bool)

    def read(self, row, slots):
        slots = np.asarray(slots)
        assert (slots >= 0).all() and (slots < PITCH).all()
        assert self.ok[row, slots].all(), "read of a slot not staged"
        return self.v[row, slots]

    def luma(self, row, offs):
        offs = np.asarray(offs)
        assert (offs >= 0).all() and (offs < LPITCH).all()
        assert self.lu_ok[row, offs].all(), "read of a luma byte not staged"
        return self.lu[row, offs]


def px(y, mid, side, bias):
    t = U32(3) * mid + side + bias
    return ycc_packed(y, (t >> U32(4)) & U32(255), t >> U32(20))


def model_cta(planes, win, pad_hw, img, k, t, out, written, reads):
    """CTA (img, band k, tile t): stage, then write its pixels."""
    sy, scb, scr = planes
    ph, pw = pad_hw
    lw, cw = 8 * win.lbw, 4 * win.lbw
    ys = max(BAND * k - win.oy, 0)
    ye = min(BAND * k + BAND - win.oy, ph)
    yc = min(ye, win.rh)
    c0, groups, l0, words = tile_plan(win, t)
    assert c0 % 8 == 0 and 8 * groups <= FAR and groups < 32
    assert l0 % 8 == 0 and 8 * words <= LPITCH and words <= 64
    st = Staged()
    for yy in range(ys, yc):
        wy = win.oy + yy
        r = wy >> 1
        nr = min(r + 1, win.ch_valid - 1) if wy & 1 else max(r - 1, 0)
        assert 0 <= nr < scb.shape[0] and r < scb.shape[0]
        cols = c0 + np.arange(8 * groups)
        # a row of 4 mod 8 samples: the last group's second half reads as
        # zeros, in slots no pixel reads
        assert (cols >= cw).sum() == (4 if groups and cw % 8 else 0)
        cols = cols[cols < cw]
        lcols = l0 + np.arange(8 * words)
        assert words == 0 or lcols[-1] < lw
        st.lu[wy - BAND * k, :8 * words] = sy[wy, lcols]
        st.lu_ok[wy - BAND * k, :8 * words] = True
        for c, slots in ((cols, np.arange(cols.size)),
                         (np.array([win.cw_valid - 1]), np.array([FAR]))):
            vb = 3 * scb[r, c].astype(U32) + scb[nr, c]
            vr = 3 * scr[r, c].astype(U32) + scr[nr, c]
            st.v[wy - BAND * k, slots] = vb | (vr << U32(16))
            st.ok[wy - BAND * k, slots] = True
        reads.add((r, nr))
    for yy in range(ys, ye):
        e0 = (img * ph + yy) * pw
        head = (-e0) & 3
        nq = (pw - head) >> 2
        crop = yy < win.rh
        wy = win.oy + yy
        row = wy - BAND * k
        odd = (win.ox + head) & 1
        jb = 64 * t - (t == 0 and head > 0)
        je = min(64 * t + 63, nq if (pw - head) & 3 else nq - 1)
        j = np.arange(jb, je + 1)
        x = head + 4 * j
        quad = (j >= 0) & (j < nq)
        assert ((e0 + x[quad]) % 4 == 0).all(), "quad store off 16 bytes"
        fast = quad & crop & (x + 3 < win.rw)
        mixed = quad & crop & (x < win.rw) & ~fast
        for xq in x[quad]:
            out[yy, xq:xq + 4] = 0
            written[yy, xq:xq + 4] += 1
        if fast.any():
            v = model_quad(st, row, l0, win.ox + x[fast], c0, win, odd)
            for xq, q in zip(x[fast], v):
                out[yy, xq:xq + 4] = q
        for xq in x[mixed]:
            for xx in range(xq, win.rw):
                out[yy, xx] = model_pixel(st, row, l0, win.ox + xx, c0,
                                          win)
        for xq in x[~quad]:   # the head and the tail, a pixel at a time
            for xx in range(max(xq, 0), min(xq + 4, pw)):
                out[yy, xx] = (model_pixel(st, row, l0, win.ox + xx, c0,
                                           win)
                               if crop and xx < win.rw else 0)
                written[yy, xx] += 1


def model_quad(st, row, l0, wx, c0, win, odd):
    """tail_quad<odd> on the quads at window columns wx..wx+3 (an array
    of quads of one row) -> [n, 4] i32: the luma from the staged row's
    two aligned words at (wx - l0) & ~3, the second inside the row's
    pitch and staged where the quad reads it."""
    assert ((wx & 1) == odd).all()
    o = wx - l0
    s = o & 3
    assert (o - s + 8 <= LPITCH).all()
    lum = st.luma(row, o[:, None] + np.arange(4))
    c = wx >> 1
    m = c - c0
    m0, m1 = st.read(row, m), st.read(row, m + 1)
    r0 = st.read(row, np.where(c + 1 < win.cw_valid, m + 1, FAR))
    r1 = st.read(row, np.where(c + 2 < win.cw_valid, m + 2, FAR))
    if not odd:
        left = st.read(row, np.maximum(m - 1, 0))
        mids, sides = (m0, m0, m1, m1), (left, r0, m0, r1)
        biases = (EVEN, ODD, EVEN, ODD)
    else:
        m2 = st.read(row, m + 2)
        mids, sides = (m0, m1, m1, m2), (r0, m0, r1, m1)
        biases = (ODD, EVEN, ODD, EVEN)
    return np.stack([px(lum[:, i], mids[i], sides[i], biases[i])
                     for i in range(4)], axis=1)


def model_pixel(st, row, l0, wx, c0, win):
    """tail_pixel: window column wx."""
    c = wx >> 1
    m = c - c0
    y = st.luma(row, wx - l0)
    if wx & 1:
        side = st.read(row, m + 1 if c + 1 < win.cw_valid else FAR)
        return px(y, st.read(row, m), side, ODD)
    return px(y, st.read(row, m), st.read(row, max(m - 1, 0)), EVEN)


def model_k11(planes, win, pad_hw):
    """The kernel's grid over a batch of u8 planes [B, ...] -> [B, ph, pw]
    i32, and the (near, neighbour) chroma row pairs it staged."""
    B = planes[0].shape[0]
    out = np.full((B, *pad_hw), -1, np.int32)
    bands, tiles = grid(win, pad_hw)
    reads = set()
    for img in range(B):
        written = np.zeros(pad_hw, np.int32)
        for b in range(bands):
            for t in range(tiles):
                model_cta([p[img] for p in planes], win, pad_hw, img,
                          (win.oy >> 5) + b, t, out[img], written, reads)
        assert (written == 1).all(), "an output written twice or never"
    return out, reads


def random_planes(win, B, rng, fill=None):
    """chip_smoke.k11_random_planes on the CPU, as numpy arrays."""
    return [p.numpy() for p in k11_random_planes(win, B, rng, "cpu", fill)]


@pytest.mark.parametrize("name,win,pad_hw", CASES, ids=[c[0] for c in CASES])
def test_tiles_equal_plain_version(name, win, pad_hw):
    """(a) Crops built CTA by CTA from the model's staged sums equal
    tail_to_packed on random u8 planes (B = 1 on the wide windows, 2
    elsewhere) and on all-0 and all-255 planes, every read staged, no
    load past a row's end, every quad store on a 16-byte boundary and
    every output written once."""
    assert jpegdec.tail_ok(win, pad_hw)
    rng = np.random.default_rng(sum(map(ord, name)))
    B = 1 if win.lbw > 64 else 2
    for fill in (None, 0, 255):
        planes = random_planes(win, B, rng, fill)
        got, _ = model_k11(planes, win, pad_hw)
        ref = jpegdec.tail_to_packed(*map(torch.as_tensor, planes), win,
                                     pad_hw).numpy()
        assert np.array_equal(got, ref), (name, fill)


def _to_blocks(fp, bh, bw):
    B = fp.shape[0]
    return (fp.reshape(B, bh, 8, bw, 8).transpose(0, 1, 3, 2, 4)
            .reshape(B, bh * bw, 64))


@pytest.mark.parametrize("name", sorted(n for n, (w, _) in WINDOWS.items()
                                         if w.lbw % 2 == 0))
def test_block_branch_equals_jax(name):
    """(b) Through the plain IDCT (jpegdec.idct_planes), the model of K11
    on random coefficient blocks (B = 1) equals the JAX package's
    backhalf_to_packed on the CPU (its XLA tail), and the port's block
    branch (backhalf_blocks: the plain version of K11 here) too, on every
    window the block layout takes (an even number of luma blocks
    across)."""
    win, pad_hw = WINDOWS[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    lh, lw = 8 * win.lbh, 8 * win.lbw
    fp = [rng.integers(-1024, 1024, s).astype(np.int16)
          for s in ((1, lh, lw), (1, lh // 2, lw // 2), (1, lh // 2, lw // 2))]
    blocks = [_to_blocks(fp[0], win.lbh, win.lbw)] + [
        _to_blocks(p, win.lbh // 2, win.lbw // 2) for p in fp[1:]]
    qt = rng.integers(1, 64, (1, 3, 64)).astype(np.uint16)
    tb = [torch.as_tensor(b) for b in blocks]
    tq = torch.as_tensor(qt)
    planes = [p.numpy() for p in jpegdec.idct_planes(*tb, tq, win)]
    got, _ = model_k11(planes, win, pad_hw)
    jwin = jdec.CoefWindow(*win)
    ref = np.asarray(jax.jit(lambda a, b, c, q: jdec.backhalf_to_packed(
        a, b, c, q, jwin, pad_hw=pad_hw))(*blocks, qt))
    assert np.array_equal(got, ref), name
    assert np.array_equal(got, jpeg_tail.backhalf_blocks(
        *tb, tq, win, pad_hw).numpy())


def _pallas_tail(planes, win, pad_hw):
    """The TPU kernel K11 replaces (pallas_jpeg.upsample_color_pack) in
    interpret mode on the CPU, with a 1-image group, as the JAX package's
    tests run it."""
    gt = pallas_jpeg.GT
    pallas_jpeg.GT = 1
    try:
        return np.asarray(jax.jit(
            lambda a, b, c: pallas_jpeg.upsample_color_pack(
                a, b, c, jdec.CoefWindow(*win), pad_hw, interpret=True))(
                    *planes))
    finally:
        pallas_jpeg.GT = gt


@pytest.mark.parametrize("name", ["unaligned", "halo_on_last_chroma_row"])
def test_model_equals_pallas_kernel_in_interpret_mode(name):
    """(c) The model equals the TPU kernel it replaces, in interpret mode,
    on a window with an odd origin and a pad past the crop and on one
    whose crop ends on the last valid chroma row."""
    win, pad_hw = WINDOWS[name]
    planes = random_planes(win, 1, np.random.default_rng(7))
    got, _ = model_k11(planes, win, pad_hw)
    assert np.array_equal(got, _pallas_tail(planes, win, pad_hw))


def test_pallas_tail_past_valid_chroma_is_a_reference_side_fault():
    """(c') Past the valid chroma rows the JAX package's two tails
    disagree: its Pallas kernel differs from its XLA tail
    (jpegdec.backhalf_to_packed off the TPU, and the port's plain version
    and kernel) on the crop rows whose window row is odd and past
    2 * ch_valid, where the XLA tail's down neighbour is row ch_valid - 1;
    they agree on every other row. The port follows the XLA tail."""
    win, pad_hw = WINDOWS["past_chroma_rows"]
    planes = random_planes(win, 1, np.random.default_rng(7))
    got, _ = model_k11(planes, win, pad_hw)
    ref = _pallas_tail(planes, win, pad_hw)
    wy = win.oy + np.arange(pad_hw[0])
    fault = (wy & 1 == 1) & (wy >> 1 >= win.ch_valid)
    assert fault.any()
    assert np.array_equal(got[:, ~fault], ref[:, ~fault])
    assert (got[:, fault] != ref[:, fault]).any(axis=-1).all()


def test_far_clamps_reach_past_band_and_tile():
    """(d) What only K11's windows reach, and its staging holds: past the
    valid chroma rows, crop rows read row ch_valid - 1 as their down
    neighbour from two and more rows below it (from bands below its own
    in far_clamps); past the valid chroma columns the crop reads column
    cw_valid - 1 as the right neighbour of columns past it, and in
    far_clamps tiles 1-19 read it from outside their staged columns; the
    wide window runs 20 tiles a band."""
    for name in ("past_chroma_rows", "past_rows_and_cols", "far_clamps"):
        win, pad_hw = WINDOWS[name]
        assert not jpegdec.backhalf_ok(win, pad_hw)
        _, reads = model_k11(random_planes(win, 1, np.random.default_rng(1)),
                             win, pad_hw)
        far = {r for r, nr in reads if nr == win.ch_valid - 1}
        assert max(far) >= win.ch_valid + 1, name
    win, pad_hw = WINDOWS["far_clamps"]
    assert (win.oy + win.rh - 1) >> 5 > (2 * (win.ch_valid - 1)) >> 5
    for name in ("past_chroma_cols", "past_rows_and_cols", "far_clamps"):
        win, pad_hw = WINDOWS[name]
        assert (win.ox + win.rw - 1) >> 1 > win.cw_valid - 1, name
    win, pad_hw = WINDOWS["far_clamps"]
    assert grid(win, pad_hw)[1] == 20
    assert all(tile_plan(win, t)[0] > win.cw_valid - 1 for t in range(1, 20))


def test_staging_bound_over_origins_and_widths():
    """(e) A tile stages at most FAR words of sums a row (18 groups of 8)
    and 272 luma bytes (34 words of 8) for every crop origin ox 0..15 and
    width, in every tile, and both bounds are reached: the kernel's static
    shared memory is 32 x (148 words + 280 B) = 27,904 B whatever the
    window."""
    worst = worst_l = 0
    for ox in range(16):
        for rw in range(1, 1100, 7):
            lbw = 2 * ((ox + rw + 15) // 16)
            win = jpegdec.CoefWindow(lbx0=0, lby0=0, lbw=lbw, lbh=2, ox=ox,
                                     oy=0, rw=rw, rh=1, cw_valid=4 * lbw,
                                     ch_valid=8)
            for t in range(rw // TILE + 1):
                c0, groups, l0, words = tile_plan(win, t)
                assert c0 % 8 == 0 and l0 % 8 == 0
                worst = max(worst, 8 * groups)
                worst_l = max(worst_l, 8 * words)
    assert worst == FAR and worst_l == 272 <= LPITCH - 8
    assert BAND * (PITCH * 4 + LPITCH) == 27904
