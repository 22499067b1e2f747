"""Synthetic camera configs and meter frames.

Generates a complete Params (dial template + YAML-schema dict) and
renderable meter frames with needles at known angles, so the decode path
can be exercised and checked end to end without the reference sample
corpus.

Parameterized by `SyntheticCamera`: `DEFAULT_CAMERA` has the reference's
188x119-template / 250x250-crop shape, while `ALT_CAMERA` is a
deliberately different geometry (141x90 template, 210x200 crop), proof
that the decoder is not hardwired to one camera (reference analog: the
two shipped params.yml files, sample-images1/2), and
`FIVE_DIAL_CAMERA` is the flagship geometry with a fifth dial.

Copy of meterelf_tpu/synthetic.py for the port, which cannot import the
JAX package. The renderer is unchanged (tests/test_torch_params.py holds
its crops equal to the original's bit for bit); ``make_params`` builds
the Params from the template array and writes no PNG, and
``write_params`` writes a parameters directory with the port's own PNG
and YAML writers.

``encode_jpeg`` makes test data for the JPEG feed: a numpy baseline JPEG
encoder (JFIF, 4:2:0 or 4:4:4, the standard tables), so that frames
can be encoded where no image library is installed. It is not a user
feature."""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .io import png, yaml_subset
from .params import Params
from .types import Rect

TEMPLATE_H = 119
TEMPLATE_W = 188
FRAME_H = 480
FRAME_W = 640
METER_RECT = Rect((50, 160), (300, 410))

# dial layout mirroring the real meter's scattered arrangement
DIAL_SPECS = [
    ("0.0001", (37.3, 63.4), 16),
    ("0.001", (94.0, 86.0), 15),
    ("0.01", (135.0, 71.9), 11),
    ("0.1", (160.9, 36.5), 12),
]


@dataclasses.dataclass(frozen=True)
class SyntheticCamera:
    """One synthetic camera geometry: template + crop + dial layout."""

    template_h: int = TEMPLATE_H
    template_w: int = TEMPLATE_W
    frame_h: int = FRAME_H
    frame_w: int = FRAME_W
    meter_rect: Rect = METER_RECT
    dial_specs: Sequence[Tuple[str, Tuple[float, float], int]] = tuple(
        DIAL_SPECS)
    seed: int = 1234

    def make_template(self) -> np.ndarray:
        """Grayscale dial-cluster template with distinctive structure (so
        the correlation has a sharp, unambiguous peak)."""
        rng = np.random.default_rng(self.seed)
        t = np.full((self.template_h, self.template_w), 200, np.uint8)
        t = (t + rng.integers(-20, 20, t.shape)).astype(np.uint8)
        yy, xx = np.mgrid[:self.template_h, :self.template_w]
        for _name, (cx, cy), diam in self.dial_specs:
            r2 = (yy - cy) ** 2 + (xx - cx) ** 2
            ring = (r2 <= (diam + 8) ** 2) & (r2 >= (diam + 4) ** 2)
            t[ring] = 60
            t[r2 <= (diam // 2) ** 2] = 120
        return t

    def params_dict(self, template_file: str) -> Dict:
        (x0, y0), (x1, y1) = self.meter_rect
        return {
            "image_glob": "*.jpg",
            "meter_rect": {"top_left": [x0, y0], "bottom_right": [x1, y1]},
            "dials_template": os.path.basename(template_file),
            "dials_template_match_threshold": 1000000,
            "dials_template_size": [self.template_w, self.template_h],
            "hue_shift": 128,
            "needle_color": {"h": 125, "l": 80, "s": 130},
            "needle_color_range": {"h": 9, "l": 45, "s": 35},
            "needle_data": [
                {
                    "name": name,
                    "color_range": {"h": 15, "l": 60, "s": 80},
                    "dist_from_center": 4,
                    "circle_thickness": 10,
                    "angle_of_zero": -4.5,
                    "center": [float(cx), float(cy)],
                    "diameter": diam,
                    "negative_momentum": name == "0.001",
                }
                for name, (cx, cy), diam in self.dial_specs
            ],
        }

    def make_params(self) -> Params:
        """The camera's Params, built from the template array (no file is
        written or read)."""
        return Params("", self.params_dict("synthetic_template.png"),
                      template=self.make_template())

    def write_params(self, dir_path: str) -> str:
        """Write the camera's parameters directory: the template as
        ``synthetic_template.png`` (io/png.py) and ``params.yml``
        (io/yaml_subset.dump) beside it; returns the yml's path, which
        ``params.load`` and the CLI take."""
        os.makedirs(dir_path, exist_ok=True)
        tpath = os.path.join(dir_path, "synthetic_template.png")
        png.write(tpath, self.make_template())
        path = os.path.join(dir_path, "params.yml")
        with open(path, "w") as fp:
            fp.write(yaml_subset.dump(self.params_dict(tpath)))
        return path

    def render_frame(
        self,
        dial_positions: List[float],
        offset: Tuple[int, int] = (30, 40),
        rng: Optional[np.random.Generator] = None,
        stub_dials: Tuple[int, ...] = (),
    ) -> np.ndarray:
        """Render a BGR frame: gray background, template-like dial cluster
        at meter_rect.top_left + offset, red needles at the given
        positions (fraction-of-dial 0..10; needle angle convention matches
        the reference: 0 = up, clockwise)."""
        rng = rng or np.random.default_rng(0)
        frame = np.full((self.frame_h, self.frame_w, 3), 180, np.uint8)
        tmpl = self.make_template()
        ox = self.meter_rect.top_left[0] + offset[0]
        oy = self.meter_rect.top_left[1] + offset[1]
        frame[oy:oy + self.template_h,
              ox:ox + self.template_w] = tmpl[..., None]

        for di, (name_spec, pos) in enumerate(
                zip(self.dial_specs, dial_positions)):
            name, (cx, cy), diam = name_spec
            negative = name == "0.001"
            zero_turn = -4.5 / 360.0
            angle = pos / 10.0 + zero_turn  # invert pos = 10*(angle-zero)
            theta = 2 * math.pi * angle
            dx = math.sin(theta)
            dy = -math.cos(theta)
            tip_len = diam / 2.0 + 4 + 9

            def paint(px, py, rad):
                for ddy in range(-rad, rad + 1):
                    for ddx in range(-rad, rad + 1):
                        x, y = int(round(px + ddx)), int(round(py + ddy))
                        if 0 <= x < self.template_w and 0 <= y < self.template_h:
                            frame[oy + y, ox + x] = (40, 40, 200)  # BGR red

            if di in stub_dials:
                # a needle stub that never reaches the tip annulus: the
                # dial becomes unreadable (no tip pixels survive)
                paint(cx, cy, 2)
                continue
            if negative:
                # counterweighted needle (negative_momentum geometry): a
                # fat mass on the tail side dominates the distance^2
                # momentum, while a thin connected spur pokes just into
                # the annulus on the tip side
                r0 = diam // 2 + 4
                for t in np.linspace(0, r0 - 2, 24):
                    paint(cx - dx * t, cy - dy * t, 5)
                for t in np.linspace(0, r0 + 3, 48):
                    paint(cx + dx * t, cy + dy * t, 1)
            else:
                for t in np.linspace(0, tip_len, 64):
                    paint(cx + dx * t, cy + dy * t, 2)
        return frame

    def render_frames(self, batch_positions: List[List[float]]
                      ) -> List[np.ndarray]:
        """Render a batch of full frames, the dial cluster of frame i at
        the i-th of a cycle of offsets inside meter_rect."""
        (x0, y0), (x1, y1) = self.meter_rect
        max_ox = (x1 - x0) - self.template_w - 1
        max_oy = (y1 - y0) - self.template_h - 1
        return [self.render_frame(pos, offset=(min(20 + (i % 3) * 7, max_ox),
                                               min(30 + (i % 5) * 5, max_oy)))
                for i, pos in enumerate(batch_positions)]

    def render_crops(self, batch_positions: List[List[float]]) -> np.ndarray:
        """Render a batch of meter-rect crops [B, ch, cw, 3] u8 (of
        render_frames)."""
        (x0, y0), (x1, y1) = self.meter_rect
        return np.stack([f[y0:y1, x0:x1]
                         for f in self.render_frames(batch_positions)])


def blind_dial(frame: np.ndarray, camera: SyntheticCamera,
               offset: Tuple[int, int], dial: int) -> np.ndarray:
    """A copy of ``frame`` (rendered by ``camera`` at ``offset`` with
    ``dial`` stubbed) whose dial centre holds a 9x9 patch of two cyan hues
    (172 and 187 degrees), left half and right half. The decoder samples
    the centre's mean colour, and the hue shift puts the two hues on
    either side of the wrap, so their mean is half a turn from both: no
    pixel of the dial matches it, and the frame reads as the
    needle-contours error (NEEDLE_CONTOURS) for that dial, after JPEG
    coding too."""
    out = frame.copy()
    _name, (cx, cy), _diam = camera.dial_specs[dial]
    x = camera.meter_rect.top_left[0] + offset[0] + int(cx)
    y = camera.meter_rect.top_left[1] + offset[1] + int(cy)
    out[y - 4:y + 5, x - 4:x] = (221, 255, 0)     # BGR, hue 172 degrees
    out[y - 4:y + 5, x:x + 5] = (255, 225, 0)     # BGR, hue 187 degrees
    return out


def dial_positions(n: int, step: float = 1.7, spread: float = 2.3,
                   dials: int = 4) -> List[List[float]]:
    """Positions of ``dials`` dials in n frames: dial d of frame i at
    (i*step + d*spread) % 10."""
    return [[(i * step + d * spread) % 10 for d in range(dials)]
            for i in range(n)]


DEFAULT_CAMERA = SyntheticCamera()

# A second, deliberately different geometry: smaller template, different
# crop size, shifted dial layout.
ALT_CAMERA = SyntheticCamera(
    template_h=90,
    template_w=141,
    meter_rect=Rect((60, 120), (270, 320)),   # 210 x 200 crop
    # pairwise center distances >= ~38 px: a neighbor's needle tip
    # (reach ~18.5) can never enter another dial's disk (radius ~19.5)
    dial_specs=(
        ("0.0001", (20.0, 52.0), 14),
        ("0.001", (62.0, 70.0), 13),
        ("0.01", (96.0, 48.0), 11),
        ("0.1", (122.0, 20.0), 11),
    ),
    seed=77,
)

# The flagship geometry (640x480 frames, 250x250 crop, 119x188 template)
# with a fifth dial: a meter with D != 4 dials takes the general-geometry
# decode branch (K1, K2, K6). The fifth centre keeps >= 38 px from the
# others (see ALT_CAMERA) and its window lies inside the template.
FIVE_DIAL_CAMERA = SyntheticCamera(
    dial_specs=tuple(DIAL_SPECS) + (("1", (62.0, 24.0), 12),))



# ---- test-data JPEG encoder ------------------------------------------------

# ITU-T T.81 Annex K.1 quantisation tables, natural (row-major) order
_STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)
# zigzag position -> natural index (jutils.c jpeg_natural_order)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.3 Huffman tables: (code counts by length 1..16, symbols)
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
_HUFF = {
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


def _quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling + jpeg_add_quant_table (baseline)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker, (len(body) + 2) >> 8,
                  (len(body) + 2) & 255]) + body


def _magnitude(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(bit category s, the s appended bits) of coefficient values."""
    s = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return s, np.where(v < 0, v + (1 << s) - 1, v)


def encode_jpeg(frame_bgr: np.ndarray, quality: int = 92,
                restart_interval: int = 0, subsampling: str = "4:2:0"
                ) -> bytes:
    """Encode a [H, W, 3] u8 BGR frame as a baseline JFIF JPEG: YCbCr
    4:2:0 (or 4:4:4 with ``subsampling="4:4:4"``), the Annex K
    quantisation tables scaled to ``quality`` as libjpeg scales them, the
    Annex K Huffman tables, and a restart marker every
    ``restart_interval`` MCUs when it is > 0. Float DCT, numpy
    throughout."""
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"subsampling {subsampling!r}: 4:2:0 or 4:4:4")
    sub = subsampling == "4:2:0"
    ms = 16 if sub else 8          # MCU size in pixels
    f = np.asarray(frame_bgr, np.float64)
    h, w = f.shape[:2]
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    mcux, mcuy = -(-w // ms), -(-h // ms)
    pad = ((0, ms * mcuy - h), (0, ms * mcux - w))
    planes = [np.pad(np.clip(np.round(p), 0, 255), pad, mode="edge")
              for p in planes]
    for i in (1, 2) if sub else ():    # 2x2 box downsampling
        p = planes[i]
        planes[i] = np.floor((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                              + p[1::2, 1::2] + 2) / 4)
    qts = [_quality_table(_STD_LUMA_QT, quality),
           _quality_table(_STD_CHROMA_QT, quality)]
    u = np.arange(8)
    dct = np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16) / 2
    dct[0] /= np.sqrt(2)
    blocks = []
    for i, p in enumerate(planes):
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        x = (p - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.round(dct @ x @ dct.T / qts[min(i, 1)].reshape(8, 8))
        blocks.append(np.clip(coef.reshape(bh, bw, 64)[..., _ZIGZAG],
                              -1023, 1023).astype(np.int64))
    nmcu = mcux * mcuy
    ny = 4 if sub else 1           # luma blocks per MCU
    ys = (blocks[0].reshape(mcuy, ms // 8, mcux, ms // 8, 64)
          .transpose(0, 2, 1, 3, 4).reshape(nmcu, ny, 64))
    scan = np.concatenate([ys, blocks[1].reshape(nmcu, 1, 64),
                           blocks[2].reshape(nmcu, 1, 64)],
                          axis=1).reshape(nmcu * (ny + 2), 64)
    comp = np.tile(np.array([0] * ny + [1, 2]), nmcu)
    mcu = np.arange(nmcu * (ny + 2)) // (ny + 2)
    interval = mcu // restart_interval if restart_interval else 0 * mcu

    # DC differences, the predictor reset at every restart interval
    diff = np.empty(nmcu * (ny + 2), np.int64)
    for c in range(3):
        sel = np.nonzero(comp == c)[0]
        dc = scan[sel, 0]
        prev = np.concatenate([[0], dc[:-1]])
        first = np.concatenate([[True], interval[sel][1:]
                                != interval[sel][:-1]])
        diff[sel] = dc - np.where(first, 0, prev)
    tab = np.minimum(comp, 1)
    codes = {k: _huff_codes(*v) for k, v in _HUFF.items()}

    def huff(kind: str, t: np.ndarray, sym: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
        c0, l0 = codes[kind + "0"]
        c1, l1 = codes[kind + "1"]
        return (np.where(t == 0, c0[sym], c1[sym]),
                np.where(t == 0, l0[sym], l1[sym]))

    # events (sort key, value bits, bit count): DC, ZRLs + AC, EOB
    nblk = nmcu * (ny + 2)
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
    np.maximum.at(last, bi, k)  # the last nonzero AC index of each block
    e = np.nonzero(last < 63)[0]
    code, ln = huff("ac", tab[e], np.zeros(len(e), np.int64))
    keys.append(e * 1024 + 256)
    vals.append(code)
    lens.append(ln)
    key = np.concatenate(keys)
    val = np.concatenate(vals)
    nbits = np.concatenate(lens)
    # pad each restart interval to a byte with 1-bits
    ev_int = interval[key // 1024]
    n_int = int(interval[-1]) + 1
    tot = np.bincount(ev_int, weights=nbits, minlength=n_int).astype(np.int64)
    padn = (-tot) % 8
    last_blk = np.array([np.nonzero(interval == i)[0][-1]
                         for i in range(n_int)])
    key = np.concatenate([key, last_blk * 1024 + 1000])
    val = np.concatenate([val, (1 << padn) - 1])
    nbits = np.concatenate([nbits, padn])
    order = np.argsort(key, kind="stable")
    val, nbits = val[order], nbits[order]
    # bits, MSB first
    ends = np.cumsum(nbits)
    which = np.repeat(np.arange(len(nbits)), nbits)
    shift = ends[which] - 1 - np.arange(int(ends[-1]))
    bits = ((val[which] >> shift) & 1).astype(np.uint8)
    data = np.packbits(bits)
    cuts = np.cumsum(tot + padn) // 8
    scan_bytes = bytearray()
    for i in range(n_int):
        chunk = data[(cuts[i - 1] if i else 0):cuts[i]]
        chunk = np.insert(chunk, np.nonzero(chunk == 0xFF)[0] + 1, 0)
        scan_bytes += chunk.astype(np.uint8).tobytes()
        if i + 1 < n_int:
            scan_bytes += bytes([0xFF, 0xD0 + i % 8])

    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xDB, b"".join(
        bytes([i]) + bytes(int(x) for x in qts[i][_ZIGZAG])
        for i in range(2)))
    out += _segment(0xC0, bytes([8, h >> 8, h & 255, w >> 8, w & 255, 3,
                                 1, 0x22 if sub else 0x11, 0, 2, 0x11, 1,
                                 3, 0x11, 1]))
    out += _segment(0xC4, b"".join(
        bytes([cls]) + bytes(_HUFF[name][0]) + _HUFF[name][1]
        for cls, name in ((0x00, "dc0"), (0x10, "ac0"), (0x01, "dc1"),
                          (0x11, "ac1"))))
    if restart_interval:
        out += _segment(0xDD, bytes([restart_interval >> 8,
                                     restart_interval & 255]))
    out += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    out += scan_bytes + b"\xff\xd9"
    return bytes(out)
