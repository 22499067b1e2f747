"""Entropy decode of the generator's baseline 4:2:0 JPEGs, for the files
that the traffic cuts short: the reference needs the coefficients that
libjpeg's Huffman decoder gives for such a file (jdhuff.c): past the end
of the data the stream reads as a marker, a code that needs bits past it
gets zero bits and sets "insufficient data", and every later MCU is left
zero (uniform grey).

Plain numpy and Python; only the generator's own markers (DQT, SOF0,
DHT, SOS, no restart interval) are read."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from . import gen


def _segments(data: bytes) -> Tuple[Dict[int, List[bytes]], int]:
    """The marker segments before the scan, and where the scan starts."""
    seg: Dict[int, List[bytes]] = {}
    i = 2
    while i + 4 <= len(data):
        marker = data[i + 1]
        n = (data[i + 2] << 8) | data[i + 3]
        seg.setdefault(marker, []).append(data[i + 4:i + 2 + n])
        i += 2 + n
        if marker == 0xDA:
            return seg, i
    raise ValueError("no scan")


def _scan_bits(data: bytes, start: int) -> np.ndarray:
    """The entropy-coded bits up to the first marker or the end, stuffed
    zero bytes removed, as 0/1 u8."""
    out = bytearray()
    i = start
    while i < len(data):
        b = data[i]
        if b == 0xFF:
            j = i + 1
            while j < len(data) and data[j] == 0xFF:
                j += 1
            if j < len(data) and data[j] == 0:
                out.append(0xFF)
                i = j + 1
                continue
            break                       # a marker, or the end after FF
        out.append(b)
        i += 1
    return np.unpackbits(np.frombuffer(bytes(out), np.uint8))


def _lut(counts, syms) -> np.ndarray:
    """16-bit peek -> (symbol << 8 | code length), canonical codes."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (syms[k] << 8) | length
            code += 1
            k += 1
        code <<= 1
    return lut


def coefficients(data: bytes, cfg: Dict) -> List[np.ndarray]:
    """[Y, Cb, Cr] natural-order quantised coefficients [bh, bw, 64] of a
    generator JPEG, possibly cut short, as libjpeg decodes them."""
    _seg, start = _segments(data)
    fw, fh = cfg["frame"]["width"], cfg["frame"]["height"]
    mcux, mcuy = -(-fw // 16), -(-fh // 16)
    bits = _scan_bits(data, start)
    end = len(bits)
    # zero bits past the end: a cut MCU reads on into them
    padded = np.concatenate([bits, np.zeros(1 << 14, np.uint8)])
    padded = padded.astype(np.int64)
    n = len(padded) - 16
    peek = np.zeros(n, np.int64)
    for k in range(16):
        peek = (peek << 1) | padded[k:k + n]
    luts = {name: _lut(*gen.HUFF[name]) for name in gen.HUFF}
    planes = [np.zeros((2 * mcuy, 2 * mcux, 64), np.int64),
              np.zeros((mcuy, mcux, 64), np.int64),
              np.zeros((mcuy, mcux, 64), np.int64)]
    pred = [0, 0, 0]
    pos = 0
    insufficient = False

    def value(s: int) -> int:
        nonlocal pos
        if s == 0:
            return 0
        v = int(peek[pos]) >> (16 - s)
        pos += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1

    def block(c: int) -> np.ndarray:
        nonlocal pos
        t = min(c, 1)
        dc, ac = luts[f"dc{t}"], luts[f"ac{t}"]
        out = np.zeros(64, np.int64)
        e = int(dc[peek[pos]])
        pos += e & 255
        pred[c] += value(e >> 8)
        out[0] = pred[c]
        k = 1
        while k < 64:
            e = int(ac[peek[pos]])
            pos += e & 255
            rs = e >> 8
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r != 15:
                    break
                k += 16
                continue
            k += r
            # past the block's end libjpeg writes to position 63
            out[gen.ZIGZAG[k] if k < 64 else 63] = value(s)
            k += 1
        return out

    for my in range(mcuy):
        for mx in range(mcux):
            if insufficient:
                continue                  # left zero: grey
            for j in range(4):
                planes[0][2 * my + j // 2, 2 * mx + j % 2] = block(0)
            planes[1][my, mx] = block(1)
            planes[2][my, mx] = block(2)
            insufficient = pos > end
    return [p.astype(np.int16) for p in planes]
