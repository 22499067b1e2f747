"""The plain reference meter reader, in plain torch, that decides
``correct``.

It reads a configuration file of bench_torch/configs/ and the encoder's
own quantised coefficients (gen.py), and gives for every frame what the
upstream meterelf reading defines (meterelf/_reading.py,
meterelf/_dial_data.py, OpenCV's float HLS and TM_CCOEFF): the error code
by the upstream raise order, the match score and its first maximum, and
each dial's position, readability and the carry-corrected value. It
imports nothing of the program and takes none of its tables: the
geometry (dial masks by OpenCV's midpoint circle and 4-connected flood
fill, the annulus order by angle and distance) is built here from the
configuration.

Every stage is the straightforward form, run to its end:

- the JPEG back-half by libjpeg's default numerics (jidctint.c ISLOW IDCT
  in exact integers, jdsample.c h2v2 fancy upsampling, jdcolor.c
  fixed-point colour);
- the match score sum L (T - mean T) as an exact integer ratio in
  float64, and the first maximum in row-major order;
- connected components and holes by propagating to a fixed point (no pass
  caps), the external contours' doubled areas by marching squares;
- angle statistics in float64.

``lower=True`` computes every stage one precision below the
configuration's statement (4-bit correlation operands, bfloat16 HLS,
float32 angle statistics): the control that the comparison must refuse.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import gen

WIN = 64          # the per-dial window (covers the largest dial disk)
N_PX = WIN * WIN
OK, LOAD, DIALS_NOT_FOUND, NEEDLE_CONTOURS, DIAL_ANGLE = range(5)


# ---- geometry from the configuration ---------------------------------------


def _circle(mask: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """OpenCV's thickness-1 midpoint circle (meterelf/_dial_data.py:35)."""
    h, w = mask.shape
    if radius == 0:
        mask[cy, cx] = 1
        return
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for px, py in ((cx - dx, cy - dy), (cx + dx, cy - dy),
                       (cx - dx, cy + dy), (cx + dx, cy + dy),
                       (cx - dy, cy - dx), (cx + dy, cy - dx),
                       (cx - dy, cy + dx), (cx + dy, cy + dx)):
            if 0 <= px < w and 0 <= py < h:
                mask[py, px] = 1
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _flood4(mask: np.ndarray, x: int, y: int) -> None:
    """cv2.floodFill, 4-connected, new value 1, from (x, y)."""
    h, w = mask.shape
    old = mask[y, x]
    if old == 1:
        return
    todo = [(x, y)]
    mask[y, x] = 1
    while todo:
        x, y = todo.pop()
        for nx, ny in ((x - 1, y), (x + 1, y), (x, y - 1), (x, y + 1)):
            if 0 <= nx < w and 0 <= ny < h and mask[ny, nx] == old:
                mask[ny, nx] = 1
                todo.append((nx, ny))


def _angle(x: float, y: float) -> float:
    """meterelf/_utils.py angle_by_vector: a turn's fraction, 0 = up,
    clockwise (never called at the centre)."""
    if y == 0:
        return 0.25 if x > 0 else 0.75
    return (-math.atan(x / y) / (2 * math.pi) + (0.5 if y > 0 else 0.0)) % 1.0


class Geometry(NamedTuple):
    template: np.ndarray      # [th, tw] u8
    threshold: float
    hue_shift: int
    origin: List[Tuple[int, int]]    # per dial (ox, oy), template coords
    centre: List[Tuple[int, int]]    # per dial, window coords
    colour_range: np.ndarray  # [D, 3]
    disk: np.ndarray          # [D, 64, 64] bool
    disk_idx: np.ndarray      # [D, P] flat window index (pad 0)
    disk_ok: np.ndarray       # [D, P] bool
    disk_sx2: np.ndarray      # [D, P] f64 sign(x) x^2
    disk_sy2: np.ndarray
    ann_idx: np.ndarray       # [D, Q], in (angle, squared distance) order
    ann_ok: np.ndarray
    ann_x: np.ndarray         # f64 px - cx
    ann_y: np.ndarray
    ann_angle: np.ndarray
    ann_sqd: np.ndarray
    neg_sign: np.ndarray      # [D] +1 / -1
    zero_turn: np.ndarray     # [D] f64
    name_order: List[int]     # dial indices sorted by name


def geometry(cfg: Dict) -> Geometry:
    template = gen.make_template(cfg)
    th, tw = template.shape
    dials = cfg["dials"]
    D = len(dials)
    disk = np.zeros((D, WIN, WIN), bool)
    origin, centre, disks, anns = [], [], [], []
    for i, d in enumerate(dials):
        (fx, fy), diam = d["center"], d["diameter"]
        m = np.zeros((th, tw), np.uint8)
        cx, cy = int(round(fx)), int(round(fy))
        r0 = int(round(diam / 2.0)) + d["dist_from_center"]
        for k in (0, d["circle_thickness"] - 1):
            _circle(m, cx, cy, r0 + k)
        _flood4(m, cx + r0 + 1, cy)
        ring = m.copy()
        _flood4(m, cx, cy)
        ox = int(np.clip(int(fx) - WIN // 2, 0, tw - WIN))
        oy = int(np.clip(int(fy) - WIN // 2, 0, th - WIN))
        ys, xs = np.nonzero(m)
        if (xs.min() < ox or xs.max() >= ox + WIN or ys.min() < oy
                or ys.max() >= oy + WIN):
            raise ValueError(f"dial {d['name']}: disk outside its window")
        c = (int(fx) - ox, int(fy) - oy)
        if not all(2 <= v <= WIN - 3 for v in c):
            raise ValueError(f"dial {d['name']}: centre too near the edge")
        origin.append((ox, oy))
        centre.append(c)
        disk[i] = m[oy:oy + WIN, ox:ox + WIN] != 0
        dy, dx = np.nonzero(disk[i])
        x, y = dx + ox - fx, dy + oy - fy
        disks.append((dy * WIN + dx, np.where(x < 0, -1.0, 1.0) * x * x,
                      np.where(y < 0, -1.0, 1.0) * y * y))
        ay, ax = np.nonzero(ring[oy:oy + WIN, ox:ox + WIN])
        slots = sorted((_angle(px + ox - fx, py + oy - fy),
                        (px + ox - fx) ** 2 + (py + oy - fy) ** 2,
                        px + ox - fx, py + oy - fy, py * WIN + px)
                       for py, px in zip(ay, ax))
        anns.append(np.array(slots, np.float64).reshape(-1, 5))
    P = max(len(a[0]) for a in disks)
    Q = max(len(a) for a in anns)

    def pad(rows: Sequence[np.ndarray], n: int, dtype) -> np.ndarray:
        out = np.zeros((D, n), dtype)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out

    return Geometry(
        template=template,
        threshold=float(cfg["dials_template_match_threshold"]),
        hue_shift=int(cfg["hue_shift"]),
        origin=origin, centre=centre,
        colour_range=np.array([[d["color_range"][k] for k in "hls"]
                               for d in dials], np.int64),
        disk=disk,
        disk_idx=pad([a[0] for a in disks], P, np.int64),
        disk_ok=pad([np.ones(len(a[0]), bool) for a in disks], P, bool),
        disk_sx2=pad([a[1] for a in disks], P, np.float64),
        disk_sy2=pad([a[2] for a in disks], P, np.float64),
        ann_idx=pad([a[:, 4].astype(np.int64) for a in anns], Q, np.int64),
        ann_ok=pad([np.ones(len(a), bool) for a in anns], Q, bool),
        ann_x=pad([a[:, 2] for a in anns], Q, np.float64),
        ann_y=pad([a[:, 3] for a in anns], Q, np.float64),
        ann_angle=pad([a[:, 0] for a in anns], Q, np.float64),
        ann_sqd=pad([a[:, 1] for a in anns], Q, np.float64),
        neg_sign=np.array([-1.0 if d["negative_momentum"] else 1.0
                           for d in dials]),
        zero_turn=np.array([d["angle_of_zero"] / 360.0 for d in dials]),
        name_order=sorted(range(D), key=lambda i: dials[i]["name"]),
    )


# ---- the JPEG back-half ------------------------------------------------------

_C = {k: v for k, v in zip(
    ("0_298631336", "0_390180644", "0_541196100", "0_765366865",
     "0_899976223", "1_175875602", "1_501321110", "1_847759065",
     "1_961570560", "2_053119869", "2_562915447", "3_072711026"),
    (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819,
     20995, 25172))}


def _idct8(d: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
    """jidctint.c's 8-point ISLOW butterfly, descaled by ``shift``."""
    z1 = (d[2] + d[6]) * _C["0_541196100"]
    t2 = z1 - d[6] * _C["1_847759065"]
    t3 = z1 + d[2] * _C["0_765366865"]
    t0 = (d[0] + d[4]) * 8192
    t1 = (d[0] - d[4]) * 8192
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    a0, a1, a2, a3 = d[7], d[5], d[3], d[1]
    z5 = (a0 + a2 + a1 + a3) * _C["1_175875602"]
    z1 = -(a0 + a3) * _C["0_899976223"]
    z2 = -(a1 + a2) * _C["2_562915447"]
    z3 = -(a0 + a2) * _C["1_961570560"] + z5
    z4 = -(a1 + a3) * _C["0_390180644"] + z5
    b0 = a0 * _C["0_298631336"] + z1 + z3
    b1 = a1 * _C["2_053119869"] + z2 + z4
    b2 = a2 * _C["3_072711026"] + z2 + z3
    b3 = a3 * _C["1_501321110"] + z1 + z4
    r = 1 << (shift - 1)
    return [(v + r) >> shift for v in (
        t10 + b3, t11 + b2, t12 + b1, t13 + b0,
        t13 - b0, t12 - b1, t11 - b2, t10 - b3)]


def _plane(coef: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """[N, bh, bw, 64] natural-order coefficients, [64] table -> the
    [N, 8 bh, 8 bw] samples: dequantise, IDCT (columns, then rows),
    level shift and clamp."""
    N, bh, bw, _ = coef.shape
    d = coef.to(torch.int64).reshape(N, bh, bw, 8, 8) * qt.reshape(8, 8)
    cols = _idct8([d[..., r, :] for r in range(8)], 11)    # per row r
    ws = torch.stack(cols, dim=-2)
    rows = _idct8([ws[..., c] for c in range(8)], 18)
    s = (torch.stack(rows, dim=-1) + 128).clamp(0, 255)
    return s.permute(0, 1, 3, 2, 4).reshape(N, 8 * bh, 8 * bw)


def _fancy_h2v2(c: torch.Tensor, rows_valid: int, cols_valid: int
                ) -> torch.Tensor:
    """jdsample.c h2v2_fancy_upsample on [N, h, w] samples: 3:1 vertical
    column sums, then 3:1 horizontal with the +8 / +7 rounding; the
    neighbours clamp at the image edge (rows_valid, cols_valid)."""
    N, h, w = c.shape
    r = torch.arange(h, device=c.device)
    above = c[:, (r - 1).clamp(min=0)]
    below = c[:, (r + 1).clamp(max=rows_valid - 1)]
    cs = torch.stack([3 * c + above, 3 * c + below], 2).reshape(N, 2 * h, w)
    k = torch.arange(w, device=c.device)
    left = cs[:, :, (k - 1).clamp(min=0)]
    right = cs[:, :, (k + 1).clamp(max=cols_valid - 1)]
    return torch.stack([(3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4],
                       3).reshape(N, 2 * h, 2 * w)


def crops_from_coefs(cfg: Dict, coefs: Sequence[torch.Tensor],
                     qt: torch.Tensor) -> torch.Tensor:
    """The meter crops [N, rh, rw, 3] u8 BGR of frames given as the
    window coefficients of gen.window_coefs (Y [N, 2h, 2w, 64], Cb and Cr
    [N, h, w, 64]) and the [2, 64] tables."""
    cy0, cx0, cy1, cx1 = gen.coef_window(cfg)
    x0, y0, x1, y1 = gen.rect_of(cfg)
    fw, fh = cfg["frame"]["width"], cfg["frame"]["height"]
    y = _plane(coefs[0], qt[0])
    rows_valid = min(8 * (cy1 - cy0), (fh + 1) // 2 - 8 * cy0)
    cols_valid = min(8 * (cx1 - cx0), (fw + 1) // 2 - 8 * cx0)
    cb, cr = (_fancy_h2v2(_plane(c, qt[1]), rows_valid, cols_valid) - 128
              for c in coefs[1:])
    oy, ox = y0 - 16 * cy0, x0 - 16 * cx0
    sl = (slice(None), slice(oy, oy + y1 - y0), slice(ox, ox + x1 - x0))
    y, cb, cr = y[sl], cb[sl], cr[sl]
    half = 1 << 15
    fix = {k: int(v * 65536 + 0.5) for k, v in (
        ("r", 1.40200), ("b", 1.77200), ("gr", 0.71414), ("gb", 0.34414))}
    r = y + ((fix["r"] * cr + half) >> 16)
    b = y + ((fix["b"] * cb + half) >> 16)
    g = y + ((-fix["gb"] * cb - fix["gr"] * cr + half) >> 16)
    return torch.stack([b, g, r], -1).clamp(0, 255).to(torch.uint8)


# ---- the reading --------------------------------------------------------------


def _hls(bgr: torch.Tensor, hue_shift: int, dt: torch.dtype
         ) -> torch.Tensor:
    """OpenCV 3.4 COLOR_BGR2HLS_FULL on u8 pixels in float type ``dt``
    (every operation rounded once), then the wrapping hue shift ->
    [..., 3] int64 (h, l, s)."""
    one = torch.tensor(1.0, dtype=dt, device=bgr.device)
    scale = one / torch.tensor(255.0, dtype=dt, device=bgr.device)
    b, g, r = (bgr[..., i].to(dt) * scale for i in range(3))
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = vmax - vmin
    light = (vmax + vmin) * 0.5
    grey = diff == 0
    safe = torch.where(grey, one, diff)
    sat = torch.where(light < 0.5, diff / (vmax + vmin),
                      diff / (2.0 - vmax - vmin))
    d60 = 60.0 / safe
    hue = torch.where(vmax == r, (g - b) * d60,
                      torch.where(vmax == g, (b - r) * d60 + 120.0,
                                  (r - g) * d60 + 240.0))
    hue = torch.where(hue < 0, hue + 360.0, hue)
    hue = torch.where(grey, torch.zeros_like(hue), hue)
    sat = torch.where(grey, torch.zeros_like(sat), sat)
    hscale = (torch.tensor(256.0, dtype=dt, device=bgr.device)
              / torch.tensor(360.0, dtype=dt, device=bgr.device))

    def u8(x: torch.Tensor) -> torch.Tensor:
        return torch.round(x.float()).clamp(0, 255).to(torch.int64)

    return torch.stack([(u8(hue * hscale) + hue_shift) % 256,
                        u8(light * 255.0), u8(sat * 255.0)], -1)


def _match(light: torch.Tensor, template: torch.Tensor, lower: bool,
           chunk: int = 8) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TM_CCOEFF of the template over the lightness [N, H, W]: the score
    sum L (T - mean T) = (n sum L T - sum T sum L) / n as exact integers
    in float64, and its first maximum in row-major order -> (score f64,
    x, y)."""
    if lower:                         # 4-bit operands, rescaled
        light, template = (light >> 4) * 16, (template >> 4) * 16
    N, H, W = light.shape
    th, tw = template.shape
    oh, ow = H - th + 1, W - tw + 1
    n = th * tw
    t = template.to(torch.float64)
    tsum = float(t.sum())
    out = []
    for i in range(0, N, chunk):
        lf = light[i:i + chunk].to(torch.float64)
        rows = lf.unfold(2, tw, 1) @ t.t()          # [c, H, ow, th]
        corr = sum(rows[:, r:r + oh, :, r] for r in range(th))
        ii = F.pad(lf.cumsum(1).cumsum(2), (1, 0, 1, 0))
        box = (ii[:, th:, tw:] - ii[:, :-th, tw:] - ii[:, th:, :-tw]
               + ii[:, :-th, :-tw])
        out.append(n * corr - tsum * box)           # exact integers
    num = torch.cat(out).reshape(N, oh * ow)
    best = num.argmax(1)
    return (num.gather(1, best[:, None])[:, 0] / n, best % ow, best // ow)


def _pool3(x: torch.Tensor, fill: int, op) -> torch.Tensor:
    """op over each pixel's 3x3 neighbourhood, ``fill`` beyond the
    window."""
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    out = x
    for dy in range(3):
        for dx in range(3):
            out = op(out, p[..., dy:dy + WIN, dx:dx + WIN])
    return out


def _fixpoint(step, x: torch.Tensor) -> torch.Tensor:
    """Apply ``step`` until nothing changes."""
    for _ in range(N_PX + 1):
        nx = step(step(x))
        if torch.equal(nx, x):
            return x
        x = nx
    raise RuntimeError("no fixed point")


def _components(masked: torch.Tensor, disk: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The owner map [K, 64, 64] (each 8-connected component of
    ``masked`` labelled by its first pixel in raster order; each hole,
    the background that no 4-connected path joins to the off-disk
    background, by the least label around it; N_PX elsewhere) and the
    boundary pixels (masked pixels beside that outer background)."""
    big = N_PX
    idx = torch.arange(N_PX, device=masked.device).reshape(WIN, WIN)
    lab = torch.where(masked, idx, big)
    lab = _fixpoint(lambda v: torch.where(
        masked, _pool3(v, big, torch.minimum), big), lab)
    bg = ~masked

    def grow(out: torch.Tensor) -> torch.Tensor:
        p = F.pad(out, (1, 1, 1, 1))
        four = (p[..., :-2, 1:-1] | p[..., 2:, 1:-1] | p[..., 1:-1, :-2]
                | p[..., 1:-1, 2:])
        return out | (bg & four)

    outside = _fixpoint(grow, bg & ~disk)
    enclosed = bg & ~outside
    own = _fixpoint(lambda v: torch.where(
        enclosed, _pool3(v, big, torch.minimum), v), lab)
    near_out = _pool3(outside, False, torch.logical_or)
    return torch.where(masked | enclosed, own, big), masked & near_out


def _largest(owner: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """keymax [K] = max over external components (those with a boundary
    pixel) of area2 * 4096 + label, area2 the doubled marching-squares
    area; -1 where there is none."""
    K = owner.shape[0]
    big = N_PX
    c = torch.stack([owner[:, :-1, :-1], owner[:, :-1, 1:],
                     owner[:, 1:, :-1], owner[:, 1:, 1:]])
    m = c.amin(0)
    k = (c == m).sum(0)
    cls = torch.where(m < big, torch.where(k == 4, 2, (k == 3).long()), 0)
    area2 = torch.zeros((K, big + 1), dtype=torch.int64, device=owner.device)
    area2.scatter_add_(1, m.reshape(K, -1), cls.reshape(K, -1))
    bcount = torch.zeros_like(area2)
    bcount.scatter_add_(1, owner.reshape(K, -1),
                        boundary.reshape(K, -1).long())
    label = torch.arange(big, device=owner.device)
    key = torch.where(bcount[:, :big] > 0, area2[:, :big] * big + label, -1)
    return key.amax(1)


class Reading(NamedTuple):
    err: torch.Tensor             # [N] i64
    first_bad_dial: torch.Tensor  # [N]
    unreadable_bits: torch.Tensor  # [N]
    match_val: torch.Tensor       # [N] f64 (the exact score)
    match_x: torch.Tensor
    match_y: torch.Tensor
    dial_pos: torch.Tensor        # [N, D]
    readable: torch.Tensor        # [N, D] bool
    value: torch.Tensor           # [N] (0 unless 4 dials)


def read(crops: torch.Tensor, load_ok: torch.Tensor, g: Geometry,
         lower: Union[bool, str] = False) -> Reading:
    """Read [N, H, W, 3] u8 BGR meter crops (``load_ok`` False: the file
    did not load). ``lower``: True for every stage one precision lower,
    "angles" for the angle statistics alone in float32."""
    dev = crops.device
    N = crops.shape[0]
    D = len(g.origin)
    fdt = torch.bfloat16 if lower is True else torch.float32
    adt = torch.float32 if lower else torch.float64
    template = torch.as_tensor(g.template, device=dev).long()
    light = _hls(crops, 0, fdt)[..., 1]
    score, mx, my = _match(light, template, lower is True)

    ar = torch.arange(WIN, device=dev)
    ox = torch.tensor([o[0] for o in g.origin], device=dev)
    oy = torch.tensor([o[1] for o in g.origin], device=dev)
    rows = (my[:, None] + oy)[:, :, None] + ar            # [N, D, 64]
    cols = (mx[:, None] + ox)[:, :, None] + ar
    win = crops[torch.arange(N, device=dev)[:, None, None, None],
                rows[..., None], cols[..., None, :]]      # [N, D, 64, 64, 3]
    hls = _hls(win, g.hue_shift, fdt)
    colour = torch.stack([
        hls[:, d, cy - 2:cy + 3, cx - 2:cx + 3].sum((1, 2))
        for d, (cx, cy) in enumerate(g.centre)], 1)       # [N, D, 3]
    colour = torch.div(2 * colour + 25, 50, rounding_mode="floor")
    cr = torch.as_tensor(g.colour_range, device=dev)
    lo = (colour - cr).clamp(0, 255)[:, :, None, None]
    hi = (colour + cr).clamp(0, 255)[:, :, None, None]
    raw = ((hls >= lo) & (hls <= hi)).all(-1)              # [N, D, 64, 64]
    closed = _pool3(_pool3(raw, False, torch.logical_or), True,
                    torch.logical_and)
    disk = torch.as_tensor(g.disk, device=dev)
    masked = (closed & disk).reshape(N * D, WIN, WIN)
    owner, boundary = _components(
        masked, disk.repeat(N, 1, 1))
    keymax = _largest(owner, boundary)
    big = (keymax >= 0) & ((keymax >> 12) > 200)           # contourArea > 100
    region = torch.where(big[:, None, None],
                         owner == (keymax & (N_PX - 1))[:, None, None],
                         closed.reshape(N * D, WIN, WIN)).reshape(N, D, N_PX)
    has_any = masked.reshape(N, D, N_PX).any(-1)

    def at(idx: np.ndarray, ok: np.ndarray) -> torch.Tensor:
        i = torch.as_tensor(idx, device=dev)[None].expand(N, -1, -1)
        return region.gather(2, i) & torch.as_tensor(ok, device=dev)

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=dev).to(adt)

    needle = at(g.disk_idx, g.disk_ok)
    tip = at(g.ann_idx, g.ann_ok)
    sign = t(g.neg_sign)[:, None]
    mom_x = (torch.where(needle, t(g.disk_sx2), 0).sum(-1) * sign[:, 0])
    mom_y = (torch.where(needle, t(g.disk_sy2), 0).sum(-1) * sign[:, 0])
    kept = tip & (t(g.ann_x) * mom_x[..., None]
                  + t(g.ann_y) * mom_y[..., None] > 0)
    n = kept.sum(-1, keepdim=True)
    angle = t(g.ann_angle)
    lowest = torch.where(kept, angle, math.inf).amin(-1, keepdim=True)
    tail = kept & (angle - lowest >= 0.75)
    n_tail = tail.sum(-1, keepdim=True)
    # kept slots in (rebased angle, distance) order: the tail, one turn
    # back, comes first
    pos = torch.where(tail, tail.cumsum(-1) - 1,
                      n_tail + (kept & ~tail).cumsum(-1) - 1)
    cut = torch.where(n >= 5, ((n - 3) // 2).clamp(max=2), 0)
    trim = kept & (pos >= cut) & (pos < n - cut)
    w = torch.where(trim, t(g.ann_sqd), 0)
    num = (torch.where(tail, angle - 1.0, angle) * w).sum(-1)
    den = w.sum(-1)
    mean = num / torch.where(den == 0, 1.0, den)
    dial_pos = torch.remainder(10.0 * (mean - t(g.zero_turn)), 10.0)
    readable = n[..., 0] > 0

    value = torch.zeros(N, dtype=adt, device=dev)
    if D == 4:
        r4, r3, r2, r1 = (dial_pos[:, i] for i in g.name_order)

        def digit(r, le2, ge8):
            fl = torch.floor(r)
            return torch.remainder(fl.long() + ((r - fl > 0.55) & le2).long()
                                   - ((r - fl < 0.45) & ge8).long(), 10)

        d3 = digit(r3, r4 <= 2, r4 >= 8)
        d2 = digit(r2, d3 <= 2, d3 >= 8)
        d1 = digit(r1, d2 <= 2, d2 >= 8)
        value = d1.to(adt) * 100.0 + d2.to(adt) * 10.0 + d3.to(adt) + r4 / 10.0

    no_contours = ~has_any
    unreadable = ~readable
    err = torch.full((N,), OK, dtype=torch.int64, device=dev)
    for cond, code in ((unreadable.any(1), DIAL_ANGLE),
                       (no_contours.any(1), NEEDLE_CONTOURS),
                       (score < g.threshold, DIALS_NOT_FOUND),
                       (~load_ok, LOAD)):
        err = torch.where(cond, code, err)
    weights = 1 << torch.arange(D, device=dev)
    return Reading(
        err=err, first_bad_dial=no_contours.long().argmax(1),
        unreadable_bits=(unreadable.long() * weights).sum(1),
        match_val=score, match_x=mx, match_y=my,
        dial_pos=dial_pos.to(torch.float64), readable=readable,
        value=value.to(torch.float64))


def read_frames(cfg: Dict, g: Geometry, coefs: Sequence[np.ndarray],
                load_ok: np.ndarray, device: str,
                lower: Union[bool, str] = False, block: int = 32
                ) -> Dict[str, np.ndarray]:
    """The reading of every frame given by its window coefficients
    (numpy, stacked over frames), on ``device`` in blocks of ``block``
    frames, as numpy arrays by field."""
    qt = torch.as_tensor(gen.qtables(cfg), device=device)
    parts: List[Reading] = []
    for i in range(0, len(load_ok), block):
        c = [torch.as_tensor(a[i:i + block], device=device) for a in coefs]
        crops = crops_from_coefs(cfg, c, qt)
        ok = torch.as_tensor(load_ok[i:i + block], device=device)
        parts.append(read(crops, ok, g, lower))
    return {f: torch.cat([getattr(p, f) for p in parts]).cpu().numpy()
            for f in Reading._fields}
