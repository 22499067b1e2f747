"""The traffic generator: a pool of distinct meter frames made from the
seed, as JPEG bytes and as the quantised DCT coefficients they encode.

The renderer and the JPEG encoder are copies of
meterelf_tpu_torch/synthetic.py's ``make_template``, ``render_frame`` and
``encode_jpeg`` (the program's copy may change; this one is the
benchmark's yardstick), driven by a configuration file of
bench_torch/configs/ instead of a ``SyntheticCamera``. ``encode_jpeg``
here also hands back the quantised coefficients of the block window that
covers the meter crop, so the plain reference (reference.py) finishes the
decode from the encoder's own numbers and never reads the program's.

Nothing here imports torch: the frames render on a spawned process pool
whose workers must start fast and never touch the card.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

# ---- the configuration's geometry -----------------------------------------


def rect_of(cfg: Dict) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1) of the configuration's meter_rect."""
    (x0, y0), (x1, y1) = (cfg["meter_rect"]["top_left"],
                          cfg["meter_rect"]["bottom_right"])
    return int(x0), int(y0), int(x1), int(y1)


def offset_range(cfg: Dict) -> Tuple[int, int]:
    """The exclusive upper ends of the template's offset inside
    meter_rect (chip_smoke.py's calibration tasks draw from these)."""
    x0, y0, x1, y1 = rect_of(cfg)
    return ((x1 - x0) - cfg["template"]["width"] - 1,
            (y1 - y0) - cfg["template"]["height"] - 1)


def make_template(cfg: Dict) -> np.ndarray:
    """The grey dial-cluster template [th, tw] u8 (synthetic.py
    make_template)."""
    th, tw = cfg["template"]["height"], cfg["template"]["width"]
    rng = np.random.default_rng(cfg["template"]["seed"])
    t = np.full((th, tw), 200, np.uint8)
    t = (t + rng.integers(-20, 20, t.shape)).astype(np.uint8)
    yy, xx = np.mgrid[:th, :tw]
    for d in cfg["dials"]:
        cx, cy = d["center"]
        diam = d["diameter"]
        r2 = (yy - cy) ** 2 + (xx - cx) ** 2
        ring = (r2 <= (diam + 8) ** 2) & (r2 >= (diam + 4) ** 2)
        t[ring] = 60
        t[r2 <= (diam // 2) ** 2] = 120
    return t


def render_frame(cfg: Dict, template: np.ndarray, positions: Sequence[float],
                 offset: Tuple[int, int]) -> np.ndarray:
    """A [H, W, 3] u8 BGR frame: grey background, the template at
    meter_rect's top left + offset, a red needle at each dial's position
    (0..10; 0 = up, clockwise) as synthetic.py render_frame draws it."""
    fh, fw = cfg["frame"]["height"], cfg["frame"]["width"]
    th, tw = template.shape
    frame = np.full((fh, fw, 3), 180, np.uint8)
    x0, y0 = rect_of(cfg)[:2]
    ox, oy = x0 + offset[0], y0 + offset[1]
    frame[oy:oy + th, ox:ox + tw] = template[..., None]

    def paint(px: float, py: float, rad: int) -> None:
        for ddy in range(-rad, rad + 1):
            for ddx in range(-rad, rad + 1):
                x, y = int(round(px + ddx)), int(round(py + ddy))
                if 0 <= x < tw and 0 <= y < th:
                    frame[oy + y, ox + x] = (40, 40, 200)

    for d, pos in zip(cfg["dials"], positions):
        (cx, cy), diam = d["center"], d["diameter"]
        theta = 2 * math.pi * (pos / 10.0 + d["angle_of_zero"] / 360.0)
        dx, dy = math.sin(theta), -math.cos(theta)
        if d["negative_momentum"]:
            # a fat counterweight on the tail side, a thin spur to the tip
            r0 = diam // 2 + 4
            for t in np.linspace(0, r0 - 2, 24):
                paint(cx - dx * t, cy - dy * t, 5)
            for t in np.linspace(0, r0 + 3, 48):
                paint(cx + dx * t, cy + dy * t, 1)
        else:
            for t in np.linspace(0, diam / 2.0 + 4 + 9, 64):
                paint(cx + dx * t, cy + dy * t, 2)
    return frame


# ---- the baseline JPEG encoder (synthetic.py encode_jpeg, 4:2:0) ----------

_STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_STD_CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_AC_LUMA_SYMS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_SYMS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
HUFF = {
    "dc0": ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
            bytes(range(12))),
    "ac0": ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
            _AC_LUMA_SYMS),
    "dc1": ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
            bytes(range(12))),
    "ac1": ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
            _AC_CHROMA_SYMS),
}


def _huff_codes(counts: Sequence[int], syms: bytes
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical Huffman (code, length) per symbol 0..255 (T.81 C.2)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[syms[k]] = code
            len_of[syms[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling + jpeg_add_quant_table (baseline)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker, (len(body) + 2) >> 8,
                  (len(body) + 2) & 255]) + body


def _magnitude(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    s = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return s, np.where(v < 0, v + (1 << s) - 1, v)


def encode_jpeg(frame_bgr: np.ndarray, quality: int
                ) -> Tuple[bytes, List[np.ndarray], np.ndarray]:
    """A [H, W, 3] u8 BGR frame as a baseline JFIF 4:2:0 JPEG with the
    Annex K tables scaled to ``quality``. Returns (bytes, [Y, Cb, Cr]
    quantised coefficient blocks [bh, bw, 64] i16 in natural order,
    quantisation tables [2, 64] natural order)."""
    f = np.asarray(frame_bgr, np.float64)
    h, w = f.shape[:2]
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    mcux, mcuy = -(-w // 16), -(-h // 16)
    pad = ((0, 16 * mcuy - h), (0, 16 * mcux - w))
    planes = [np.pad(np.clip(np.round(p), 0, 255), pad, mode="edge")
              for p in planes]
    for i in (1, 2):
        p = planes[i]
        planes[i] = np.floor((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                              + p[1::2, 1::2] + 2) / 4)
    qts = [quality_table(_STD_LUMA_QT, quality),
           quality_table(_STD_CHROMA_QT, quality)]
    u = np.arange(8)
    dct = np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16) / 2
    dct[0] /= np.sqrt(2)
    blocks, natural = [], []
    for i, p in enumerate(planes):
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        x = (p - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.clip(np.round(dct @ x @ dct.T
                                / qts[min(i, 1)].reshape(8, 8)),
                       -1023, 1023).astype(np.int64).reshape(bh, bw, 64)
        natural.append(coef.astype(np.int16))
        blocks.append(coef[..., ZIGZAG])
    nmcu = mcux * mcuy
    ys = (blocks[0].reshape(mcuy, 2, mcux, 2, 64)
          .transpose(0, 2, 1, 3, 4).reshape(nmcu, 4, 64))
    scan = np.concatenate([ys, blocks[1].reshape(nmcu, 1, 64),
                           blocks[2].reshape(nmcu, 1, 64)],
                          axis=1).reshape(nmcu * 6, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), nmcu)
    diff = np.empty(nmcu * 6, np.int64)
    for c in range(3):
        sel = np.nonzero(comp == c)[0]
        dc = scan[sel, 0]
        diff[sel] = dc - np.concatenate([[0], dc[:-1]])
    tab = np.minimum(comp, 1)
    codes = {k: _huff_codes(*v) for k, v in HUFF.items()}

    def huff(kind: str, t: np.ndarray, sym: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
        c0, l0 = codes[kind + "0"]
        c1, l1 = codes[kind + "1"]
        return (np.where(t == 0, c0[sym], c1[sym]),
                np.where(t == 0, l0[sym], l1[sym]))

    nblk = nmcu * 6
    s, extra = _magnitude(diff)
    code, ln = huff("dc", tab, s)
    keys = [np.arange(nblk) * 1024]
    vals = [(code << s) | extra]
    lens = [ln + s]
    bi, kk = np.nonzero(scan[:, 1:])
    k = kk + 1
    newblk = np.concatenate([[True], bi[1:] != bi[:-1]])
    prev_k = np.where(newblk, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev_k - 1
    v = scan[bi, k]
    s, extra = _magnitude(v)
    code, ln = huff("ac", tab[bi], (run % 16) * 16 + s)
    keys.append(bi * 1024 + 4 * k + 3)
    vals.append((code << s) | extra)
    lens.append(ln + s)
    for j in range(3):          # zero runs of 16 before a coefficient
        z = np.nonzero(run // 16 > j)[0]
        code, ln = huff("ac", tab[bi[z]], np.full(len(z), 0xF0))
        keys.append(bi[z] * 1024 + 4 * k[z] + j)
        vals.append(code)
        lens.append(ln)
    last = np.zeros(nblk, np.int64)
    np.maximum.at(last, bi, k)
    e = np.nonzero(last < 63)[0]
    code, ln = huff("ac", tab[e], np.zeros(len(e), np.int64))
    keys.append(e * 1024 + 256)
    vals.append(code)
    lens.append(ln)
    key = np.concatenate(keys)
    val = np.concatenate(vals)
    nbits = np.concatenate(lens)
    padn = int(-nbits.sum() % 8)     # pad the scan to a byte with 1-bits
    key = np.concatenate([key, [nblk * 1024]])
    val = np.concatenate([val, [(1 << padn) - 1]])
    nbits = np.concatenate([nbits, [padn]])
    order = np.argsort(key, kind="stable")
    val, nbits = val[order], nbits[order]
    ends = np.cumsum(nbits)
    which = np.repeat(np.arange(len(nbits)), nbits)
    shift = ends[which] - 1 - np.arange(int(ends[-1]))
    data = np.packbits(((val[which] >> shift) & 1).astype(np.uint8))
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0)

    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xDB, b"".join(
        bytes([i]) + bytes(int(x) for x in qts[i][ZIGZAG])
        for i in range(2)))
    out += _segment(0xC0, bytes([8, h >> 8, h & 255, w >> 8, w & 255, 3,
                                 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    out += _segment(0xC4, b"".join(
        bytes([cls]) + bytes(HUFF[name][0]) + HUFF[name][1]
        for cls, name in ((0x00, "dc0"), (0x10, "ac0"), (0x01, "dc1"),
                          (0x11, "ac1"))))
    out += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    out += data.astype(np.uint8).tobytes() + b"\xff\xd9"
    return bytes(out), natural, np.stack(qts).astype(np.int32)


# ---- the block window the reference decodes -------------------------------


def coef_window(cfg: Dict) -> Tuple[int, int, int, int]:
    """(cy0, cx0, cy1, cx1): the chroma blocks (16x16 luma px each) that
    cover meter_rect with a margin of one chroma sample, clamped to the
    frame: what the crop's pixels depend on through the 3:1 filter."""
    x0, y0, x1, y1 = rect_of(cfg)
    fw, fh = cfg["frame"]["width"], cfg["frame"]["height"]
    cbw, cbh = -(-fw // 16), -(-fh // 16)
    cx0 = min(max((x0 - 2) // 16, 0), cbw - 1)
    cy0 = min(max((y0 - 2) // 16, 0), cbh - 1)
    cx1 = max(min(-(-(x1 + 2) // 16), cbw), cx0 + 1)
    cy1 = max(min(-(-(y1 + 2) // 16), cbh), cy0 + 1)
    return cy0, cx0, cy1, cx1


def window_coefs(cfg: Dict, natural: List[np.ndarray]) -> List[np.ndarray]:
    """The coefficient blocks of the crop's window: luma [2h, 2w, 64] and
    each chroma plane [h, w, 64] for the (h, w) chroma blocks of
    ``coef_window``."""
    cy0, cx0, cy1, cx1 = coef_window(cfg)
    return [natural[0][2 * cy0:2 * cy1, 2 * cx0:2 * cx1],
            natural[1][cy0:cy1, cx0:cx1], natural[2][cy0:cy1, cx0:cx1]]


# ---- the pool --------------------------------------------------------------


def pool_tasks(cfg: Dict, seed: int, n: int) -> List[tuple]:
    """n render tasks drawn from the seed: (cfg, positions uniform in
    [0, 10) per dial, offset inside meter_rect's slack)."""
    rng = np.random.default_rng(seed)
    max_ox, max_oy = offset_range(cfg)
    pos = rng.uniform(0.0, 10.0, (n, len(cfg["dials"])))
    ox = rng.integers(0, max_ox, n)
    oy = rng.integers(0, max_oy, n)
    return [(cfg, tuple(float(p) for p in pos[i]), (int(ox[i]), int(oy[i])))
            for i in range(n)]


def render_task(task: tuple) -> Tuple[bytes, List[np.ndarray]]:
    """One pool frame: (JPEG bytes, the window's coefficient blocks)."""
    cfg, positions, offset = task
    frame = render_frame(cfg, make_template(cfg), positions, offset)
    data, natural, _qt = encode_jpeg(frame, cfg["frame"]["quality"])
    return data, window_coefs(cfg, natural)


class Pool:
    """The pool's n frames rendering on ``workers`` spawned processes that
    see no card (started at construction, so the caller can import and
    build meanwhile); ``frames()`` waits for them, in order, and shuts
    the workers down."""

    def __init__(self, cfg: Dict, seed: int, n: int, workers: int) -> None:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        tasks = pool_tasks(cfg, seed, n)
        old = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            self._ex = ProcessPoolExecutor(max(1, workers),
                                           mp.get_context("spawn"))
            self._it = self._ex.map(render_task, tasks,
                                    chunksize=max(1, n // (4 * workers)))
        finally:
            if old is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = old

    def frames(self) -> List[Tuple[bytes, List[np.ndarray]]]:
        try:
            return list(self._it)
        finally:
            self._ex.shutdown(wait=True)


def qtables(cfg: Dict) -> np.ndarray:
    """The [2, 64] natural-order quantisation tables every frame uses."""
    q = cfg["frame"]["quality"]
    return np.stack([quality_table(_STD_LUMA_QT, q),
                     quality_table(_STD_CHROMA_QT, q)]).astype(np.int32)


class Order:
    """Which pool frame each row of batch k holds: the pool rotated by a
    seed-drawn offset (``batch`` rows of ``pool`` frames, the rotation
    cycled when the batch is longer). Batches differ in order, and in
    composition only where the pool is longer than the batch; where it is
    as long, every batch holds the same frames."""

    def __init__(self, seed: int, pool: int, batch: int) -> None:
        self._rng = np.random.default_rng([seed, 1])
        self._pool, self._batch = pool, batch
        self._offsets: List[int] = []

    def __call__(self, k: int) -> np.ndarray:
        while len(self._offsets) <= k:
            self._offsets.append(int(self._rng.integers(0, self._pool)))
        return (self._offsets[k] + np.arange(self._batch)) % self._pool


def damage(n: int, seed: int, empty: int, truncated: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Seed-drawn pool frames that the traffic spoils: (emptied,
    truncated to the first half of their bytes)."""
    pick = np.random.default_rng([seed, 3]).permutation(n)
    return pick[:empty], pick[empty:empty + truncated]
