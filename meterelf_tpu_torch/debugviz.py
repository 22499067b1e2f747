"""Headless debug visualization: annotated overlay PNGs.

Port of meterelf_tpu/debugviz.py ``render_overlay`` and ``render_masks``
(``serve_overlays``, the live viewer, belongs to the stream, which the
port does not have yet). The reference's DEBUG mode pops cv2.imshow
windows with contour/momentum overlays (meterelf/_reading.py:43-78) and
per-dial mask windows (meterelf/_dial_data.py:50-54); headless, those
become files. ``render_overlay`` re-derives the per-dial masks for one
frame on the host (numpy twins of the device ops) and writes an upscaled
annotated PNG; ``render_masks`` writes the precomputed dial masks (the
``masks`` DEBUG mode). Both are wired into the CLI by the ``DEBUG``
environment variable (cli.py) and write with io/png.py, so the PNGs hold
the pixels the JAX package's do.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .api import _host_hls
from .io import jpeg as jio
from .io import png
from .params import DIAL_WIN, Params

# OpenCV's HLS2RGB sector table: per sector, the (b, g, r) sources among
# (p2, p1, falling, rising)
_SECTOR_DATA = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]], np.int32)


def hls_full_to_bgr(hls: np.ndarray, hue_shift: int) -> np.ndarray:
    """Host numpy twin of the JAX package's ops/color.hls_full_to_bgr
    (reference meterelf/_utils.py:105-110): [..., 3] int HLS_FULL with
    the hue shift -> [..., 3] u8 BGR, in float32 op by op."""
    f32 = np.float32
    hls = np.asarray(hls, np.int32)
    h_i = (hls[..., 0] - np.int32(hue_shift)) % 256
    h = h_i.astype(f32) * (f32(6.0) / f32(256.0))  # sector units
    l = hls[..., 1].astype(f32) * (f32(1.0) / f32(255.0))
    s = hls[..., 2].astype(f32) * (f32(1.0) / f32(255.0))

    p2 = np.where(l <= f32(0.5), l * (1 + s), l + s - l * s)
    p1 = 2 * l - p2
    sector = np.clip(np.floor(h), 0, 5).astype(np.int32)
    frac = h - sector.astype(f32)
    tab = (p2, p1, p1 + (p2 - p1) * (1 - frac), p1 + (p2 - p1) * frac)

    def pick(tab_idx: np.ndarray) -> np.ndarray:
        return np.where(tab_idx == 0, tab[0],
                        np.where(tab_idx == 1, tab[1],
                                 np.where(tab_idx == 2, tab[2], tab[3])))

    idx = _SECTOR_DATA[sector]
    gray = s == 0
    out = np.stack([np.where(gray, l, pick(idx[..., c])) for c in range(3)],
                   axis=-1) * f32(255.0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _pool3(a: np.ndarray, fn, pad_value) -> np.ndarray:
    from numpy.lib.stride_tricks import sliding_window_view

    p = np.pad(a, 1, constant_values=pad_value)
    return fn(sliding_window_view(p, (3, 3)), axis=(2, 3))


def _np_match(L: np.ndarray, template_u8: np.ndarray):
    from numpy.lib.stride_tricks import sliding_window_view

    t = template_u8.astype(np.float64)
    tz = t - t.mean()
    win = sliding_window_view(L.astype(np.float64), t.shape)
    scores = np.tensordot(win, tz, axes=([2, 3], [0, 1]))
    i = int(np.argmax(scores))
    y, x = divmod(i, scores.shape[1])
    return scores[y, x], x, y


def render_overlay(
    filename: str,
    params: Params,
    out_dir: str,
    scale: int = 4,
) -> Optional[str]:
    """Write ``<out_dir>/<name>_debug.png``: the matched dial cluster of
    one frame, upscaled ``scale`` times, with each dial's raw colour mask,
    needle mask, tip pixels and centre painted over it; returns its path,
    or None when the frame does not decode or cover the meter rect."""
    pa = params.arrays()
    img = jio.decode_file(filename)
    if img is None:
        return None
    crop = jio.crop_rect(img, params.meter_rect)
    if crop.shape[:2] != (params.meter_rect.height, params.meter_rect.width):
        return None
    hls = _host_hls(crop, params.hue_shift).astype(np.int32)
    _mv, mx, my = _np_match(hls[:, :, 1].astype(np.uint8), pa.template_u8)
    th, tw = pa.template_u8.shape
    dials = hls[my:my + th, mx:mx + tw]

    # true-colour backdrop: HLS back to BGR, then flipped to RGB for PNG
    bgr = hls_full_to_bgr(dials, params.hue_shift)
    canvas = np.ascontiguousarray(bgr[:, :, ::-1])
    W = DIAL_WIN
    for d in range(pa.mask_full.shape[0]):
        ox, oy = (int(v) for v in pa.win_origin[d])
        win = dials[oy:oy + W, ox:ox + W]
        cx, cy = (int(v) for v in pa.centers_int[d])
        core = win[cy - 2:cy + 3, cx - 2:cx + 3].reshape(-1, 3)
        color = (2 * core.sum(axis=0) + 25) // 50
        lo = np.clip(color - pa.color_range[d], 0, 255)
        hi = np.clip(color + pa.color_range[d], 0, 255)
        raw = ((win >= lo) & (win <= hi)).all(axis=-1)
        closed = _pool3(_pool3(raw, np.max, False), np.min, True)
        masked = closed & pa.mask_full[d]
        tips = closed & pa.mask_circle[d]

        view = canvas[oy:oy + W, ox:ox + W]
        view[raw] = (255, 160, 40)
        view[masked] = (220, 40, 40)
        view[tips] = (255, 40, 255)
        view[cy, cx] = (40, 255, 255)

    big = np.kron(canvas, np.ones((scale, scale, 1), np.uint8))
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(
        out_dir, os.path.basename(filename).rsplit(".", 1)[0] + "_debug.png")
    png.write(out_path, big)
    return out_path


def render_masks(params: Params, out_dir: str, scale: int = 4) -> List[str]:
    """The ``masks`` DEBUG mode: one PNG per dial, ``mask_<name>.png``,
    showing the full needle mask (grey) with the tip annulus highlighted
    (white), the headless analog of the reference's per-dial imshow
    windows (meterelf/_dial_data.py:50-54)."""
    pa = params.arrays()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for d, name in enumerate(params.dial_names):
        full = np.asarray(pa.mask_full[d], bool)
        circle = np.asarray(pa.mask_circle[d], bool)
        img = np.zeros(full.shape, np.uint8)
        img[full] = 128
        img[circle] = 255
        big = np.kron(img, np.ones((scale, scale), np.uint8))
        out_path = os.path.join(out_dir, f"mask_{name}.png")
        png.write(out_path, big)
        paths.append(out_path)
    return paths
