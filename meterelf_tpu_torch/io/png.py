"""A PNG reader and writer in numpy and zlib, for the dial template and
the debug overlays: the card's machine has no Pillow.

``read_gray`` gives what ``PIL.Image.open(path).convert("L")`` gives, as
a [h, w] u8 array, for the PNGs of 8-bit depth without interlacing:
greyscale (colour type 0), RGB (2), palette (3), greyscale with alpha (4)
and RGBA (6), each row under any of the five filters. Colour becomes
grey by Pillow's integer luma, ``(R*19595 + G*38470 + B*7471 + 0x8000)
>> 16``; alpha is dropped, as Pillow's conversion drops it. Any other
PNG (16-bit or sub-byte depth, Adam7 interlacing, a bad CRC, a truncated
or malformed stream) raises ``params.LoadError`` naming the file and
what it holds; no PNG is read otherwise.

``write`` writes an 8-bit greyscale [h, w] or RGB [h, w, 3] u8 array.
"""
from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

from ..params import LoadError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by colour type, 8-bit depth


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: [..., 3] u8 -> [...] u8."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int,
              fail) -> np.ndarray:
    """Undo the per-row filters: raw (h rows of 1 + stride bytes) ->
    [h, stride] u8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        row = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1)
        if ftype == 0:
            cur = row.copy()
        elif ftype == 1:      # Sub: a running sum per channel
            cur = (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = row + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential within the row
            r = row.tolist()
            up = prev.tolist()
            c: List[int] = [0] * stride
            for x in range(stride):
                left = c[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
                c[x] = (r[x] + pred) & 255
            cur = np.array(c, np.uint8)
        else:
            raise fail(f"filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def read_gray(path: str) -> np.ndarray:
    """The PNG at ``path`` as Pillow's ``convert("L")`` gives it: [h, w]
    u8. LoadError for what the module docstring lists as refused."""
    def fail(what: str) -> LoadError:
        return LoadError(f"{path}: {what} (not read: the PNG reader takes "
                         "non-interlaced 8-bit PNGs)")

    with open(path, "rb") as fp:
        data = fp.read()
    if not data.startswith(SIGNATURE):
        raise fail("not a PNG file")
    pos = len(SIGNATURE)
    header = None
    palette = None
    idat = []
    while True:
        if pos + 8 > len(data):
            raise fail("truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise fail(f"truncated {ctype!r} chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise fail(f"bad CRC in the {ctype!r} chunk")
        pos += 12 + length
        if header is None and ctype != b"IHDR":
            raise fail("the first chunk is not IHDR")
        if ctype == b"IHDR":
            if header is not None or length != 13:
                raise fail("a malformed IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            if length % 3 or not 0 < length <= 768:
                raise fail(f"a PLTE chunk of {length} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        elif not ctype[0] & 0x20:
            raise fail(f"the unknown critical chunk {ctype!r}")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8:
        raise fail(f"bit depth {depth}")
    if color not in _CHANNELS:
        raise fail(f"colour type {color}")
    if interlace != 0:
        raise fail("Adam7 interlacing")
    if compression != 0 or filtering != 0:
        raise fail(f"compression method {compression}, filter method "
                   f"{filtering}")
    if not w or not h:
        raise fail(f"an empty image ({w}x{h})")
    bpp = _CHANNELS[color]
    stride = w * bpp
    try:
        z = zlib.decompressobj()
        raw = z.decompress(b"".join(idat))
    except zlib.error as e:
        raise fail(f"a corrupt image stream ({e})") from e
    if not z.eof or len(raw) != h * (stride + 1):
        raise fail(f"an image stream of {len(raw)} bytes, expected "
                   f"{h * (stride + 1)}")
    px = _unfilter(raw, h, stride, bpp, fail).reshape(h, w, bpp)
    if color == 0:
        return px[..., 0]
    if color == 4:
        return np.ascontiguousarray(px[..., 0])
    if color == 3:
        if palette is None:
            raise fail("a palette image without a PLTE chunk")
        if int(px.max()) >= len(palette):
            raise fail("a palette index past the PLTE chunk")
        return _luma(palette)[px[..., 0]]
    return _luma(px[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write(path: str, img: np.ndarray) -> None:
    """Write a [h, w] (greyscale) or [h, w, 3] (RGB) u8 array as an 8-bit
    PNG, every row unfiltered."""
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8 or not (
            a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)) or not a.size:
        raise ValueError(f"write takes a non-empty [h, w] or [h, w, 3] u8 "
                         f"array, not {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    color = 0 if a.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)],
                          axis=1)
    with open(path, "wb") as fp:
        fp.write(SIGNATURE
                 + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                               0, 0, 0))
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + _chunk(b"IEND", b""))
