"""Host half of the JPEG feed: entropy decode, and whole-frame decode for
the frames the coefficient reader rejects and for the file helpers.

Port of meterelf_tpu/io/jpeg.py (the coefficient feed:
``read_coefs_batch``, ``load_coef_feed``, ``load_coef_feed_shard``,
``load_packed_crops_from_bytes``, ``_decode_bytes_full``, ``pack_crops``;
the file helpers: ``decode_file``, ``decode_region``, ``crop_rect``,
``load_crops``, ``load_crops_threaded``, ``load_crop_bytes_u8``) over the
port's own C readers in ``io/native/``, built by gcc at first use
(``_build.host_jpeg``); none needs libjpeg:

- ``coefs.c`` decodes the Huffman stream of each frame's coefficient
  window on host threads (GIL-free); dequantisation, the IDCT, chroma
  upsampling and colour conversion run on the device (ops/jpegdec.py,
  csrc/jpeg.cu). A stream its fast baseline reader rejects goes to the
  general reader of ``decoder.c``, as the JAX reader hands it to libjpeg:
  16-bit DQT, truncated streams and restart resync come back read.
- ``decoder.c`` decodes whole frames as libjpeg does, bit for bit
  (progressive and sequential scans, Huffman or arithmetic coding,
  sampling factors up to 4, grayscale, RGB, truncation and restart
  recovery, block smoothing of incomplete progressive images). It reads
  every stream libjpeg's 8-bit BGR decode reads. ``load_coef_feed`` uses
  it for the fallback slots: the first ``fb_slots`` frames the
  coefficient reader rejects (progressive, arithmetic-coded, 4:4:4 or
  4:2:2, Adobe RGB, sequential in several scans, ...) are decoded to
  packed crops that the decode step scatters over the back-half's output.

A sequential 4:2:0 frame in several scans is read differently from the
JAX feed on purpose: the JAX reader's libjpeg path can stop inside its
first (Y) scan and hand on zero chroma (ROADMAP, open faults on the
reference side); here the frame takes a fallback slot.

The file helpers decode whole frames, as ``load_packed_crops_from_bytes``
does: where the JAX package decodes only the meter rect's band with
libjpeg-turbo's cropping and falls back to a whole frame, the port's
``decode_region`` decodes the whole frame and crops it (the same pixels:
``decoder.c`` decodes as libjpeg does).

One difference from the JAX package: every call returns freshly
allocated arrays that the caller owns; the JAX feed hands out
thread-local double-buffered arenas that a second later call on the same
thread overwrites.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import _build
from ..ops.jpegdec import CoefWindow, backhalf_ok, coef_window
from ..types import Rect

Feed = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
             np.ndarray, np.ndarray, np.ndarray]

MAX_W = 4096    # the largest frame decode_bytes_full returns
MAX_H = 4096


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def read_coefs_batch(
    datas: Sequence[bytes],
    win: CoefWindow,
    frame_wh: Tuple[int, int],
    num_threads: int = 2,
    plane_layout: bool = False,
    compact: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Entropy-decode the coefficient window of every frame.

    Returns (coef_y, coef_cb, coef_cr, qt [N, 3, 64] u16, ok [N] bool).
    Block layout (default): coef_y [N, lbh*lbw, 64] i16, chroma
    [N, (lbh//2)*(lbw//2), 64] i16, natural order within a block.
    plane_layout=True: the frequency-plane layout, coef_y
    [N, lbh*8, lbw*8] with coefficient (r, c) of block (by, bx) at
    [8*by + r, 8*bx + c], chroma [N, lbh*4, lbw*4]. compact=True (plane
    layout only): each plane as int8 [rows*3/2, cols], the lo bytes
    followed by row-pair hi nibbles (ops/jpegdec.uncompact_plane), 12
    bits a coefficient. ok=False rows (the reader rejected the frame, or
    a coefficient is outside the compact range) are zero."""
    if compact and not plane_layout:
        raise ValueError("the compact wire format is plane-layout only")
    lib = _build.host_jpeg()
    n = len(datas)
    if plane_layout:
        yshape = (n, win.lbh * 8, win.lbw * 8)
        cshape = (n, win.lbh * 4, win.lbw * 4)
    else:
        yshape = (n, win.lbh * win.lbw, 64)
        cshape = (n, win.lbh * win.lbw // 4, 64)
    coef_y = np.zeros(yshape, np.int16)
    coef_cb = np.zeros(cshape, np.int16)
    coef_cr = np.zeros(cshape, np.int16)
    qt = np.zeros((n, 3, 64), np.uint16)
    ok = np.zeros(n, np.int32)
    arr_ptrs = (ctypes.c_char_p * n)(*datas)
    arr_sizes = (ctypes.c_ulong * n)(*[len(d) for d in datas])
    args = [ctypes.addressof(arr_ptrs), ctypes.addressof(arr_sizes), n,
            win.lbx0, win.lby0, win.lbw, win.lbh,
            frame_wh[0], frame_wh[1], int(plane_layout),
            _ptr(coef_y), _ptr(coef_cb), _ptr(coef_cr), _ptr(qt), _ptr(ok),
            num_threads]
    if compact:
        cmp = [np.zeros((n, s[1] * 3 // 2, s[2]), np.int8)
               for s in (yshape, cshape, cshape)]
        lib.mej_read_coefs_region_batch_compact(*args,
                                                *[_ptr(c) for c in cmp])
        coef_y, coef_cb, coef_cr = cmp
    else:
        lib.mej_read_coefs_region_batch(*args)
    bad = ok != 0
    for a in (coef_y, coef_cb, coef_cr, qt):
        a[bad] = 0     # a rejected frame may have written some rows
    return coef_y, coef_cb, coef_cr, qt, ~bad


def load_coef_feed(
    datas: Sequence[bytes],
    meter_rect: Rect,
    frame_wh: Tuple[int, int],
    pad_hw: Tuple[int, int],
    fb_slots: int = 8,
    num_threads: int = 2,
    compact: Optional[bool] = None,
) -> Feed:
    """The host feed of one ``make_coef_decode_fn`` step.

    Picks the frequency-plane layout whenever the fused back-half kernel
    (K10) takes the window (ops/jpegdec.backhalf_ok), else the block
    layout (the plain IDCT and K11). The planes ship in the compact int8
    wire when ``compact`` (None: the environment's
    ``METERELF_COEF_COMPACT``, default 1; 0 ships dense i16 planes, as in
    the JAX package), which K10 reads either way. Returns (coef_y,
    coef_cb, coef_cr, qt, load_ok, fb_packed [fb_slots, PH, PW] i32,
    fb_idx [fb_slots] i32): the fallback slots hold the frames the
    coefficient reader rejects, decoded whole, with fb_idx their row
    (len(datas) for an unused slot, which the step drops)."""
    win = coef_window(meter_rect, frame_wh[0], frame_wh[1])
    plane = backhalf_ok(win, tuple(pad_hw))
    return load_coef_feed_shard(
        datas, tuple(win), plane, meter_rect, frame_wh, pad_hw,
        fb_slots=fb_slots, num_threads=num_threads, compact=compact)


def load_coef_feed_shard(
    datas: Sequence[bytes],
    win_tuple: Tuple[int, ...],
    plane: bool,
    meter_rect: Rect,
    frame_wh: Tuple[int, int],
    pad_hw: Tuple[int, int],
    fb_slots: int = 8,
    num_threads: int = 1,
    compact: Optional[bool] = None,
) -> Feed:
    """load_coef_feed with the window (a CoefWindow as a plain tuple) and
    the layout chosen by the caller: planes when ``plane`` (compact as
    load_coef_feed says, the environment read at each call), else
    blocks. The first ``fb_slots`` frames the coefficient reader rejects
    are decoded whole (load_packed_crops_from_bytes) into the fallback
    slots, and load_ok is raised for those that decode."""
    if compact is None:
        compact = os.environ.get("METERELF_COEF_COMPACT", "1") != "0"
    cy, cb, cr, qt, ok = read_coefs_batch(
        datas, CoefWindow(*win_tuple), frame_wh, num_threads=num_threads,
        plane_layout=plane, compact=plane and compact)
    load_ok = ok.copy()
    fb_idx = np.full(fb_slots, len(datas), np.int32)
    fb_packed = np.zeros((fb_slots, pad_hw[0], pad_hw[1]), np.int32)
    bad = np.nonzero(~ok)[0][:fb_slots]
    if len(bad):
        pk, pok = load_packed_crops_from_bytes(
            [datas[i] for i in bad], meter_rect, pad_hw,
            num_threads=num_threads)
        for j, i in enumerate(bad):
            if pok[j]:
                fb_idx[j] = i
                fb_packed[j] = pk[j]
                load_ok[i] = True
    return cy, cb, cr, qt, load_ok, fb_packed, fb_idx


def load_packed_crops_from_bytes(
    datas: Sequence[bytes],
    meter_rect: Rect,
    pad_hw: Tuple[int, int],
    num_threads: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode in-memory JPEGs straight to the step's staging layout:
    [B, PH, PW] i32 packed BGR (b | g<<8 | r<<16), the meter rect at
    [0:rh, 0:rw], zeros elsewhere; decode, crop and pack in one C pass
    (pthreads, GIL-free). Returns (packed, load_ok): a frame that does
    not decode, or does not cover the rect, gets load_ok=False. The pass
    decodes whole frames, so the JAX package's whole-frame retry after a
    failed region decode is already in it."""
    lib = _build.host_jpeg()
    n = len(datas)
    ph, pw = pad_hw
    (x0, y0) = meter_rect.top_left
    out = np.zeros((n, ph, pw), np.int32)
    ok = np.ones(n, np.int32)
    if n:
        arr_ptrs = (ctypes.c_char_p * n)(*datas)
        arr_sizes = (ctypes.c_ulong * n)(*[len(d) for d in datas])
        lib.mej_decode_packed_batch(
            ctypes.addressof(arr_ptrs), ctypes.addressof(arr_sizes), n,
            _ptr(out), pw, ph, x0, y0, meter_rect.width, meter_rect.height,
            _ptr(ok), num_threads)
    return out, ok == 0


def decode_bytes_full(data: bytes) -> Optional[np.ndarray]:
    """Whole-frame decode of in-memory JPEG bytes -> [H, W, 3] u8 BGR
    (grayscale replicated), or None when the stream does not decode or
    exceeds MAX_W x MAX_H (the JAX package's ``_decode_bytes_full``)."""
    lib = _build.host_jpeg()
    out = np.zeros(MAX_H * MAX_W * 3, np.uint8)
    ok, w, h = (np.ones(1, np.int32) for _ in range(3))
    arr_ptrs = (ctypes.c_char_p * 1)(data)
    arr_sizes = (ctypes.c_ulong * 1)(len(data))
    lib.mej_decode_full_batch(
        ctypes.addressof(arr_ptrs), ctypes.addressof(arr_sizes), 1,
        _ptr(out), MAX_W, MAX_H, _ptr(w), _ptr(h), _ptr(ok), 1)
    if ok[0] != 0:
        return None
    w, h = int(w[0]), int(h[0])
    return out[:h * w * 3].reshape(h, w, 3).copy()


def _read(path: str) -> bytes:
    """A file's bytes; b"" (which no decode accepts) when it cannot be
    read."""
    try:
        with open(path, "rb") as fp:
            return fp.read()
    except OSError:
        return b""


def decode_file(path: str, max_w: int = MAX_W, max_h: int = MAX_H
                ) -> Optional[np.ndarray]:
    """Decode one JPEG file to BGR u8 [h, w, 3]; None when it cannot be
    read or decoded, or is larger than max_w x max_h."""
    img = decode_bytes_full(_read(path))
    if img is None or img.shape[0] > max_h or img.shape[1] > max_w:
        return None
    return img


def crop_rect(img: np.ndarray, rect: Rect) -> np.ndarray:
    (x0, y0) = rect.top_left
    (x1, y1) = rect.bottom_right
    return img[y0:y1, x0:x1]


def decode_region(path: str, rect: Rect) -> Optional[np.ndarray]:
    """The meter rect of one JPEG file as BGR u8 [rh, rw, 3]; None when
    the file does not decode or the frame does not cover the rect. The
    port decodes the whole frame and crops it (module docstring)."""
    img = decode_file(path)
    if img is None:
        return None
    c = crop_rect(img, rect)
    return c if c.shape == (rect.height, rect.width, 3) else None


def load_crop_bytes_u8(
    datas: Sequence[bytes],
    meter_rect: Rect,
    num_threads: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """In-memory JPEGs -> their meter rects as BGR u8 [N, rh, rw, 3] and
    load_ok [N]: the whole-frame C pass of load_packed_crops_from_bytes,
    unpacked; a frame that does not decode, or does not cover the rect,
    gets load_ok=False and an all-zero slot."""
    packed, ok = load_packed_crops_from_bytes(
        datas, meter_rect, (meter_rect.height, meter_rect.width),
        num_threads=num_threads)
    shifts = np.array([0, 8, 16], np.int32)
    return ((packed[..., None] >> shifts) & 255).astype(np.uint8), ok


def load_crops_threaded(
    filenames: Sequence[str],
    meter_rect: Rect,
    batch_size: Optional[int] = None,
    num_threads: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode files to [B, rh, rw, 3] u8 BGR crops and load_ok [B] in one
    threaded C pass (GIL-free). B = batch_size (zero slots pad the batch)
    or len(filenames); a file that cannot be read or decoded, or whose
    frame does not cover the rect, gets load_ok=False."""
    n = len(filenames)
    B = batch_size or n
    crops = np.zeros((B, meter_rect.height, meter_rect.width, 3), np.uint8)
    ok = np.zeros(B, bool)
    c, k = load_crop_bytes_u8([_read(fn) for fn in filenames], meter_rect,
                              num_threads=num_threads)
    crops[:n], ok[:n] = c, k
    return crops, ok


def load_crops(
    filenames: Sequence[str],
    meter_rect: Rect,
    batch_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """load_crops_threaded one file at a time (decode_region per file)."""
    B = batch_size or len(filenames)
    crops = np.zeros((B, meter_rect.height, meter_rect.width, 3), np.uint8)
    ok = np.zeros(B, bool)
    for i, fn in enumerate(filenames):
        c = decode_region(fn, meter_rect)
        if c is not None:
            crops[i], ok[i] = c, True
    return crops, ok


def compact_planes(plane: np.ndarray) -> np.ndarray:
    """Dense coefficient planes [N, R, C] (values in [-2048, 2047], R
    even) -> the compact wire [N, R*3/2, C] int8 that read_coefs_batch
    writes with compact=True (numpy copy of the reader's
    mej_compact_plane; the inverse of ops/jpegdec.uncompact_plane)."""
    vi = plane.astype(np.int32)
    lo = (vi & 255).astype(np.uint8).view(np.int8)
    hi = ((vi[:, 0::2] >> 8) & 15) | (((vi[:, 1::2] >> 8) & 15) << 4)
    return np.concatenate([lo, hi.astype(np.uint8).view(np.int8)], axis=1)


def pack_crops(crops_u8: np.ndarray,
               pad_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """[B, H, W, 3] u8 BGR -> [B, H, W] i32 packed (b | g<<8 | r<<16),
    zero-padded to pad_hw=(PH, PW) when given."""
    c = crops_u8.astype(np.int32)
    packed = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
    if pad_hw is not None:
        B, H, W = packed.shape
        out = np.zeros((B, pad_hw[0], pad_hw[1]), np.int32)
        out[:, :H, :W] = packed
        packed = out
    return packed
