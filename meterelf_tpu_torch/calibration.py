"""Offline dial-center calibration (reference: meterelf/_calibration.py).

Port of meterelf_tpu/calibration.py. Derives per-dial centers and
diameters from data:

  1. decode and localize every frame on the device (the exact HLS
     lightness, the JAX package's matmul scorer ops/match.scores_matmul
     with TF32 off, and the first-max ops/frontend.locate), then
     translation-stabilize each meter crop so the matched dial rect lands
     at a fixed anchor (the reference used cv2.warpAffine with an integer
     translation, _image.py:34-44; here a zero-filled shift of all frames
     at once),
  2. fold a float64 running mean with the reference's reducer
     (new = prev*((n-1)/n) + img/n, _utils.py:82-88) frame by frame on
     the device, seeded and masked as the JAX package's scan is,
  3. threshold the averaged image by the global needle color
     (_calibration.py:82-84), label components, and least-squares-fit an
     ellipse to each component's boundary (the host code of the JAX
     package, copied unchanged).

The averaged image and the printed centres equal the JAX package's bit
for bit, so the mean is computed as the JAX graph computes it on the
CPU, which is not as written: XLA turns ``/ 255.0`` into a
multiplication by the rounded reciprocal and contracts the step into one
fused multiply-add, fma(prev, (n-1)/n, img/n). The port spells both out:
``INV_255`` and ``fma``, whose operations each round once on the CPU and
on the card alike. (A torch division by a Python number runs on CUDA as
a multiplication by its reciprocal too, so the divisor n lives on the
device.) The device is ``device`` (None: the environment's
``METERELF_DEVICE``, default ``cuda``); without a card it raises.
"""
from __future__ import annotations

import glob as glob_mod
import random
from typing import Any, Iterable, List, Tuple, Union

import numpy as np
import torch

from .api import device_from_env
from .params import Params
from .types import DialCenter

# frames excluded from calibration globs (reference _calibration.py:72-79
# hardcodes these two corrupt sample frames)
_EXCLUDED_FILENAMES = (
    "20180814021309-01-e01.jpg",
    "20180814021310-00-e02.jpg",
)

STABILIZE_ANCHOR = (30, 116)  # matched rect top-left target (_image.py:41-42)
INV_255 = 1.0 / 255.0         # x / 255.0 as the JAX graph computes it


def get_image_filenames(params: Params) -> List[str]:
    return [
        path for path in glob_mod.glob(params.image_glob)
        if all(bad not in path for bad in _EXCLUDED_FILENAMES)
    ]


def get_files(
    params: Params, files: Union[int, Iterable[str]] = 255
) -> Iterable[str]:
    if isinstance(files, int):
        return random.sample(get_image_filenames(params), files)
    return files


def find_dial_centers(
    params: Params, files: Union[int, Iterable[str]] = 255,
    device: Any = None,
) -> List[DialCenter]:
    avg_meter = get_average_meter_image(params, list(get_files(params, files)),
                                        device=device)
    return find_dial_centers_from_image(params, avg_meter, device=device)


def _locate(bgr: torch.Tensor, params: Params, tmean: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, H, W, 3] u8 BGR on the device -> (hls u8 [N, H, W, 3], and the
    first maximum of the template score: max_val f32, x i32, y i32 [N])."""
    from .ops.color import bgr_planes_to_hls
    from .ops.frontend import locate
    from .ops.match import scores_matmul

    c = bgr.to(torch.int32)
    h, l, s = bgr_planes_to_hls(c[..., 0], c[..., 1], c[..., 2],
                                params.hue_shift)
    hls = torch.stack([h, l, s], dim=-1).to(torch.uint8)
    template = torch.as_tensor(params.arrays().template_u8).to(bgr.device)
    scores = scores_matmul(l.to(torch.float32), template, tmean)
    return (hls, *locate(scores))


def get_average_meter_image(
    params: Params, files: List[str], device: Any = None,
) -> np.ndarray:
    """Decode, localize, stabilize and average frames -> uint8 BGR crop."""
    from .io import jpeg as jio

    dev = device_from_env(device)
    f64 = torch.float64
    t = params.arrays().template_u8
    th, tw = t.shape
    tmean = float(np.float32(np.asarray(t, np.int64).sum())
                  / np.float32(th * tw))
    crops, ok = jio.load_crops(files, params.meter_rect)
    ch, cw = crops.shape[1:3]
    c = torch.as_tensor(crops).to(dev)
    _hls, max_val, mx, my = _locate(c, params, tmean)
    usable = ok & (max_val.cpu().numpy() >= params.dials_match_threshold)
    if not usable.any():
        raise ValueError("Cannot calculate average of empty sequence")

    # integer translation with zero fill (cv2.warpAffine identity
    # translation semantics at _image.py:38-44), every frame at once
    ax, ay = STABILIZE_ANCHOR
    dx = (ax - mx.to(torch.int64))[:, None, None]
    dy = (ay - my.to(torch.int64))[:, None, None]
    sy = torch.arange(ch, device=dev)[None, :, None] - dy
    sx = torch.arange(cw, device=dev)[None, None, :] - dx
    valid = (sy >= 0) & (sy < ch) & (sx >= 0) & (sx < cw)
    n_idx = torch.arange(len(crops), device=dev)[:, None, None]
    shifted = c[n_idx, sy.clamp(0, ch - 1), sx.clamp(0, cw - 1)]
    imgs = torch.where(valid[..., None], shifted, 0)

    # the JAX package's scan, step for step: it masks the first usable
    # frame out of the stream, seeds with the first frame still in it
    # (argmax of the mask: frame 0 when none is) and folds every frame
    # still in it from n = 2, the seed included
    use = usable.copy()
    use[int(np.argmax(usable))] = False
    avg = imgs[int(np.argmax(use))].to(f64) * INV_255
    n = 2.0
    for i in np.nonzero(use)[0]:
        img = imgs[int(i)].to(f64) * INV_255
        avg = fma(avg, (n - 1.0) / n,
                  img / torch.full((), n, dtype=f64, device=dev))
        n += 1.0
    return ((avg.cpu().numpy() * 255.0) + 0.5).astype(np.uint8)


def fma(x: torch.Tensor, y: float, z: torch.Tensor) -> torch.Tensor:
    """x * y + z rounded once, as a fused multiply-add rounds it, in
    float64 tensor operations that each round once (glibc's software
    fma: Dekker's exact product m1 + m2 = x * y, Knuth's exact sum
    a1 + a2 = z + m1, then a1 + (a2 + m2) with the inner sum rounded to
    odd, which makes the outer rounding the only one; Boldo and
    Melquiond, IEEE Trans. Computers 57(4), 2008). For finite values
    whose products neither overflow nor underflow, as here."""
    split = 134217729.0               # 2**27 + 1
    x1 = x * split
    x1 = (x - x1) + x1
    x2 = x - x1
    y1 = y * split
    y1 = (y - y1) + y1
    y2 = y - y1
    m1 = x * y
    m2 = (((x1 * y1 - m1) + x1 * y2) + x2 * y1) + x2 * y2
    a1 = z + m1
    t1 = a1 - z
    t2 = a1 - t1
    a2 = (m1 - t1) + (z - t2)
    s = a2 + m2                       # rounded to nearest ...
    bb = s - a2
    err = (a2 - (s - bb)) + (m2 - bb)   # ... with its exact error
    # round to odd: the neighbour of s on the exact sum's side when s
    # is inexact and its last bit is even
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return a1 + s


def get_needles_mask_by_color(params: Params, hls_image: np.ndarray) -> np.ndarray:
    lo, hi = params.needle_color.get_range(params.needle_color_range)
    lo_a = np.array(lo, np.int32)
    hi_a = np.array(hi, np.int32)
    return ((hls_image >= lo_a) & (hls_image <= hi_a)).all(axis=-1)


def find_dial_centers_from_image(
    params: Params, avg_meter: np.ndarray, device: Any = None,
) -> List[DialCenter]:
    dev = device_from_env(device)
    t = params.arrays().template_u8
    th, tw = t.shape
    tmean = float(t.astype(np.float64).mean())
    hls, _mv, x, y = _locate(torch.as_tensor(avg_meter[None]).to(dev),
                             params, tmean)
    hls = hls[0].cpu().numpy()
    x, y = int(x[0]), int(y[0])
    dials_hls = hls[y:y + th, x:x + tw]

    mask = get_needles_mask_by_color(params, dials_hls)
    centers = []
    for comp in _components_8(mask):
        boundary = _boundary_points(comp)
        (cx, cy), (w, h) = fit_ellipse(boundary)
        diameter = (w + h) / 2.0
        if abs(h - w) / diameter > 0.2:
            raise ValueError("Needle center not circle enough")
        centers.append(DialCenter((cx, cy), int(round(diameter))))
    return sorted(centers, key=lambda c: c.center[0])


def _components_8(mask: np.ndarray) -> List[np.ndarray]:
    """8-connected components of a small host mask (BFS)."""
    h, w = mask.shape
    seen = np.zeros_like(mask, bool)
    comps = []
    for sy, sx in zip(*np.nonzero(mask)):
        if seen[sy, sx]:
            continue
        stack = [(sy, sx)]
        seen[sy, sx] = True
        comp = np.zeros_like(mask, bool)
        while stack:
            y, x = stack.pop()
            comp[y, x] = True
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ny, nx = y + dy, x + dx
                    if (0 <= ny < h and 0 <= nx < w and mask[ny, nx]
                            and not seen[ny, nx]):
                        seen[ny, nx] = True
                        stack.append((ny, nx))
        comps.append(comp)
    return comps


def _boundary_points(comp: np.ndarray) -> np.ndarray:
    """Moore-neighbor border trace of a component, reproducing the point
    sequence (including revisits of 1-px-wide parts) that the reference's
    cv2.findContours(CHAIN_APPROX_NONE) feeds into fitEllipse."""
    ys, xs = np.nonzero(comp)
    order = np.lexsort((xs, ys))  # raster order: topmost, then leftmost
    sy, sx = int(ys[order[0]]), int(xs[order[0]])
    h, w = comp.shape

    def fg(y, x):
        return 0 <= y < h and 0 <= x < w and comp[y, x]

    # counterclockwise directions (y-down coords): E NE N NW W SW S SE
    dirs = [(0, 1), (-1, 1), (-1, 0), (-1, -1),
            (0, -1), (1, -1), (1, 0), (1, 1)]
    pts = [(sx, sy)]
    if not any(fg(sy + dy, sx + dx) for dy, dx in dirs):
        return np.array(pts, np.float64)
    prev_dir = 4  # pretend we arrived from the west
    y, x = sy, sx
    while True:
        moved = False
        for k in range(8):
            d = (prev_dir + 1 + k) % 8
            dy, dx = dirs[d]
            if fg(y + dy, x + dx):
                y, x = y + dy, x + dx
                prev_dir = (d + 4) % 8
                moved = True
                break
        if not moved or ((x, y) == (sx, sy) and len(pts) > 1):
            break
        pts.append((x, y))
        if len(pts) > 4 * (h * w):  # safety bound
            break
    return np.array(pts, np.float64)


def fit_ellipse(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """Direct least-squares ellipse fit (Fitzgibbon / Halir-Flusser).

    Returns ((cx, cy), (width, height)) like cv2.fitEllipse's center/size
    (axis lengths = full axes, unordered orientation ignored).
    """
    x = points[:, 0]
    y = points[:, 1]
    xm, ym = x.mean(), y.mean()
    xs, ys = x - xm, y - ym

    D1 = np.stack([xs ** 2, xs * ys, ys ** 2], axis=1)
    D2 = np.stack([xs, ys, np.ones_like(xs)], axis=1)
    S1 = D1.T @ D1
    S2 = D1.T @ D2
    S3 = D2.T @ D2
    T = -np.linalg.solve(S3, S2.T)
    M = S1 + S2 @ T
    C_inv_M = np.array([M[2] / 2.0, -M[1], M[0] / 2.0])
    eigval, eigvec = np.linalg.eig(C_inv_M)
    cond = 4 * eigvec[0] * eigvec[2] - eigvec[1] ** 2
    a1 = eigvec[:, cond > 0][:, 0]
    a, b, c, d, e, f = np.concatenate([a1, T @ a1])

    # center: gradient of the conic vanishes
    cx, cy = np.linalg.solve(
        np.array([[2 * a, b], [b, 2 * c]]), np.array([-d, -e]))
    # conic value at the center
    f_c = a * cx * cx + b * cx * cy + c * cy * cy + d * cx + e * cy + f
    # centered quadratic form: [x y] M [x y]^T = -f_c
    M = np.array([[a, b / 2.0], [b / 2.0, c]]) / (-f_c)
    lam = np.linalg.eigvalsh(M)
    if (lam <= 0).any():
        raise ValueError("degenerate ellipse fit")
    semi = 1.0 / np.sqrt(lam)
    width, height = 2.0 * semi[0], 2.0 * semi[1]
    return ((cx + xm, cy + ym), (width, height))


def main(argv: "Union[None, List[str]]" = None) -> None:
    """Calibration CLI for bringing up a NEW camera:
    `python -m meterelf_tpu_torch.calibration PARAMS_FILE
    [N_SAMPLES|FILE...]` averages sample frames (default: 255 random
    frames from the params' image_glob, or the given count/files), finds
    the dial centers, and prints them as YAML-pasteable
    `center`/`diameter` needle fields (sorted by x, the params file's dial
    order), as `python -m meterelf_tpu.calibration` does. The device is
    METERELF_DEVICE (default cuda)."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m meterelf_tpu_torch.calibration PARAMS_FILE "
              "[N_SAMPLES | IMAGE_FILE...]", file=sys.stderr)
        raise SystemExit(1)
    params = Params.load(args[0])
    files: Union[int, List[str]]
    if len(args) == 1:
        files = min(255, len(get_image_filenames(params)))
    elif len(args) == 2 and args[1].isdigit():
        files = int(args[1])
    else:
        files = args[1:]
    centers = find_dial_centers(params, files)
    print(f"# {len(centers)} dial centers (sorted by x); paste per-dial"
          " into the params' needle entries")
    for i, dc in enumerate(centers):
        print(f"# dial {i + 1}")
        print(f"center: [{dc.center[0]:.1f}, {dc.center[1]:.1f}]")
        print(f"diameter: {dc.diameter:g}")


if __name__ == "__main__":
    main()
