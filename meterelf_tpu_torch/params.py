"""Camera/dial configuration: YAML schema (reference-compatible) plus the
derived arrays the decode path consumes, and their carry onto a torch
device (``to_device``).

Copy of meterelf_tpu/params.py with three changes: the files are read
by the port's own readers, io/yaml_subset.py for the YAML (what
``yaml.safe_load`` gives, for the subset parameter files use) and
io/png.py for the template (what Pillow's ``convert("L")`` gives), so no
PyYAML or Pillow is needed; a ``Params`` may be built from the
YAML-schema dict plus a template array (no PNG on disk); and
``to_device`` turns the numpy ``ParamArrays`` (this module's or the JAX
package's) into tensors. The host math of ``build_param_arrays`` is
unchanged; tests/test_torch_params.py holds it equal to the original
field by field.

The YAML schema, validation semantics and error messages mirror the
reference loader (reference: meterelf/_params.py:17-155), including the
(w, h) -> (h, w) swap for ``dials_template_size`` (_params.py:136-138).

Where the reference keeps per-dial data in dicts of Python objects and
materializes OpenCV mask images lazily (meterelf/_dial_data.py), this
module precomputes everything the device graph needs as stacked arrays:

- the dial-cluster template, both raw (uint8) and zero-mean (f32), for the
  cross-correlation;
- per-dial 64x64 windows around each dial center: all per-dial work
  (color sampling, inRange, morphology, component labeling, angle
  reductions) happens in these fixed windows, which provably contain the
  full dial mask disk -- a pure translation, so numerics are unchanged;
- dial masks (full disk and annulus) rasterized with an exact
  reimplementation of OpenCV's midpoint circle + 4-connected flood fill
  (reference: meterelf/_dial_data.py:22-48), cropped to the windows.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .colors import HlsColor
from .io import yaml_subset
from .types import DialCenter, Rect

TEMPLATE_H = 119  # enforced by params schema in both shipped configs
TEMPLATE_W = 188
DIAL_WIN = 64  # per-dial window size (covers max disk radius ~23 px)


class LoadError(Exception):
    pass


# --------------------------------------------------------------------------
# Schema-driven YAML validation
#
# Each schema entry is (key, converter). Converters are small composable
# functions raising LoadError with the offending key path; the same
# machinery validates the top-level mapping and each needle_data entry.
# Semantics match the reference loader (meterelf/_params.py:17-155):
# strict isinstance type checks (so "37" is not a valid float coordinate),
# the (w, h) -> (h, w) swap for dials_template_size, HLS bounds
# validation, and template-file existence.
# --------------------------------------------------------------------------

def _typed(tp: type):
    def conv(value: Any, where: str) -> Any:
        if not isinstance(value, tp):
            raise LoadError(f"{where}: expected {tp.__name__}, "
                            f"got {type(value).__name__}")
        return value
    return conv


def _pair_of(tp: type):
    def conv(value: Any, where: str) -> Tuple[Any, Any]:
        if (not isinstance(value, list) or len(value) != 2
                or not all(isinstance(v, tp) for v in value)):
            raise LoadError(f"{where}: expected a pair of {tp.__name__}")
        return (value[0], value[1])
    return conv


def _hls(value: Any, where: str) -> HlsColor:
    fields = _convert_mapping(
        value, [("h", _typed(int)), ("l", _typed(int)),
                ("s", _typed(int))], where)
    return HlsColor(fields["h"], fields["l"], fields["s"]).validate()


def _rect(value: Any, where: str) -> Rect:
    fields = _convert_mapping(
        value, [("top_left", _pair_of(int)),
                ("bottom_right", _pair_of(int))], where)
    return Rect(top_left=fields["top_left"],
                bottom_right=fields["bottom_right"])


def _size_hw(value: Any, where: str) -> Tuple[int, int]:
    w, h = _pair_of(int)(value, where)
    return (h, w)  # YAML declares (w, h); everything downstream is (h, w)


def _convert_mapping(data: Any, schema, where: str) -> Dict[str, Any]:
    if not isinstance(data, dict):
        raise LoadError(f"{where}: expected a mapping")
    out = {}
    for key, conv in schema:
        if key not in data:
            raise LoadError(f"{where}: missing key {key!r}")
        out[key] = conv(data[key], f"{where}.{key}")
    return out


_NEEDLE_SCHEMA = [
    ("name", _typed(str)),
    ("color_range", _hls),
    ("dist_from_center", _typed(int)),
    ("circle_thickness", _typed(int)),
    ("angle_of_zero", _typed(float)),
    ("center", _pair_of(float)),
    ("diameter", _typed(int)),
    ("negative_momentum", _typed(bool)),
]

_TOP_SCHEMA = [
    ("image_glob", _typed(str)),
    ("meter_rect", _rect),
    ("dials_template", _typed(str)),
    ("dials_template_match_threshold", _typed(int)),
    ("dials_template_size", _size_hw),
    ("hue_shift", _typed(int)),
    ("needle_color", _hls),
    ("needle_color_range", _hls),
    ("needle_data", _typed(list)),
]


class Params:
    """Host-side validated configuration (same surface as the reference)."""

    @classmethod
    def load(cls, filename: str) -> "Params":
        try:
            with open(filename, "rt") as fp:
                data = yaml_subset.load(fp.read())
        except Exception as error:
            message = f"Cannot load YAML data from {filename}"
            raise LoadError(message) from error
        if not isinstance(data, dict):
            raise LoadError(f"Not a valid parameters file: {filename}")
        return cls(os.path.dirname(filename), data)

    def __init__(self, base_dir: str, data: Dict[Any, Any],
                 template: Optional[np.ndarray] = None) -> None:
        """``template``: the dial-cluster template as a [h, w] u8 array;
        None reads the file ``data["dials_template"]`` names."""
        top = _convert_mapping(data, _TOP_SCHEMA, "params")

        def in_base(fn: str) -> str:
            return os.path.join(base_dir, fn) if base_dir else fn

        self.image_glob: str = in_base(top["image_glob"])
        self.meter_rect: Rect = top["meter_rect"]
        self.dials_file: str = in_base(top["dials_template"])
        self.template: Optional[np.ndarray] = template
        if template is None and not os.path.exists(self.dials_file):
            raise LoadError(f"File not found: {self.dials_file}")
        self.dials_match_threshold: int = top["dials_template_match_threshold"]
        self.dials_template_size: Tuple[int, int] = top["dials_template_size"]
        self.hue_shift: int = top["hue_shift"]
        self.needle_color: HlsColor = top["needle_color"]
        self.needle_color_range: HlsColor = top["needle_color_range"]

        if not top["needle_data"]:
            raise LoadError("params.needle_data: at least one needle needed")
        needles = [
            _convert_mapping(nd, _NEEDLE_SCHEMA, f"params.needle_data[{i}]")
            for i, nd in enumerate(top["needle_data"])
        ]

        self.dial_color_range: Dict[str, HlsColor] = {
            n["name"]: n["color_range"] for n in needles
        }
        self.needle_dists_from_dial_center: Dict[str, int] = {
            n["name"]: n["dist_from_center"] for n in needles
        }
        self.needle_circle_mask_thickness: Dict[str, int] = {
            n["name"]: n["circle_thickness"] for n in needles
        }
        self.needle_angles_of_zero: Dict[str, float] = {
            n["name"]: n["angle_of_zero"] for n in needles
        }
        self.negative_momentum_dials = {
            n["name"] for n in needles if n["negative_momentum"]
        }
        self.dial_centers: Dict[str, DialCenter] = {
            n["name"]: DialCenter(n["center"], n["diameter"])
            for n in needles
        }

        self._arrays: Optional[ParamArrays] = None

    @property
    def dial_names(self) -> List[str]:
        return list(self.dial_centers.keys())

    def arrays(self) -> "ParamArrays":
        if self._arrays is None:
            self._arrays = build_param_arrays(self)
        return self._arrays


def load(filename: str) -> Params:
    return Params.load(filename)


# --------------------------------------------------------------------------
# OpenCV-exact dial mask rasterization (host precompute)
# --------------------------------------------------------------------------

def draw_cv_circle_outline(mask: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """Set the thickness-1 circle pixels exactly as OpenCV's midpoint
    rasterizer does (the circles drawn at meterelf/_dial_data.py:35-36)."""
    if radius == 0:
        mask[cy, cx] = 255
        return
    err = 0
    dx = radius
    dy = 0
    plus = 1
    minus = (radius << 1) - 1
    h, w = mask.shape
    while dx >= dy:
        for (px, py) in (
            (cx - dx, cy - dy), (cx + dx, cy - dy),
            (cx - dx, cy + dy), (cx + dx, cy + dy),
            (cx - dy, cy - dx), (cx + dy, cy - dx),
            (cx - dy, cy + dx), (cx + dy, cy + dx),
        ):
            if 0 <= px < w and 0 <= py < h:
                mask[py, px] = 255
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def flood_fill_4(mask: np.ndarray, seed_x: int, seed_y: int) -> None:
    """cv2.floodFill with default 4-connectivity and newVal=255
    (meterelf/_dial_data.py:43,47): fill the 4-connected region of pixels
    equal to the seed's value with 255."""
    h, w = mask.shape
    seed_val = mask[seed_y, seed_x]
    if seed_val == 255:
        return
    stack = [(seed_x, seed_y)]
    mask[seed_y, seed_x] = 255
    while stack:
        x, y = stack.pop()
        for nx, ny in ((x - 1, y), (x + 1, y), (x, y - 1), (x, y + 1)):
            if 0 <= nx < w and 0 <= ny < h and mask[ny, nx] == seed_val:
                mask[ny, nx] = 255
                stack.append((nx, ny))


def make_dial_masks(
    center: Tuple[float, float],
    diameter: int,
    dist_from_center: int,
    circle_thickness: int,
    shape: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Full-disk mask and annulus mask for one dial, replicating
    meterelf/_dial_data.py:22-48 (circle outlines + two flood fills)."""
    mask = np.zeros(shape, np.uint8)
    dial_radius = int(round(diameter / 2.0))
    cx = int(round(center[0]))
    cy = int(round(center[1]))
    start_radius = dial_radius + dist_from_center
    for i in (0, circle_thickness - 1):
        draw_cv_circle_outline(mask, cx, cy, start_radius + i)
    flood_fill_4(mask, cx + start_radius + 1, cy)
    circle_mask = mask.copy()
    flood_fill_4(mask, cx, cy)
    return mask, circle_mask


# --------------------------------------------------------------------------
# Device-array pytree
# --------------------------------------------------------------------------

def _pad256(n: int) -> int:
    """Round a slot count up to a multiple of 256 (lane-friendly)."""
    return max(256, -(-n // 256) * 256)


def angle_by_vector(x: float, y: float) -> float | None:
    """Host copy of the reference's angle convention
    (meterelf/_utils.py:18-42): fraction of a turn in [0, 1), 0 = up,
    clockwise; None for the zero vector. Uses math.atan exactly like the
    reference so precomputed angles are bit-identical.

    >>> [angle_by_vector(*v) for v in
    ...  [(0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0),
    ...   (-1, -1), (0, 0)]]
    [0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, None]
    """
    import math

    if y == 0:
        return 0.25 if x > 0 else 0.75 if x < 0 else None
    atan = math.atan(x / y) / (2 * math.pi)
    return (-atan + (0.5 if y > 0 else 0.0)) % 1.0


class ParamArrays(NamedTuple):
    """Host arrays of one camera configuration (leading dim D = dials).

    The disk_*/ann_* fields are the static dial geometry: flat window
    indices of each dial's full-disk / annulus mask pixels, with their
    reference-rounded float64 offsets from the dial center, squared
    distances, sign-preserving squares (momentum terms,
    _reading.py:34-37) and needle angles (host math.atan,
    _utils.py:18-42) precomputed so the device does no transcendentals.
    """

    template_zm: np.ndarray      # [th, tw] f32, zero-mean template
    template_u8: np.ndarray      # [th, tw] u8, raw template (exact rescores)
    threshold: np.ndarray        # [] f32
    hue_shift: np.ndarray        # [] i32
    color_range: np.ndarray      # [D, 3] i32
    centers_int: np.ndarray      # [D, 2] i32 (int(cx), int(cy)), window coords
    win_origin: np.ndarray       # [D, 2] i32 (x, y) of window in template coords
    mask_full: np.ndarray        # [D, W, W] bool (window coords)
    mask_circle: np.ndarray      # [D, W, W] bool
    neg_sign: np.ndarray         # [D] i32 (+1 / -1)
    zero_turn: np.ndarray        # [D] f64 (angle_of_zero / 360)
    value_perm: np.ndarray       # [D] i32: indices of dials in name-sorted order
    disk_idx: np.ndarray         # [D, PAD_DISK] i32 flat window indices
    disk_valid: np.ndarray       # [D, PAD_DISK] bool
    disk_sx2: np.ndarray         # [D, PAD_DISK] f64 sign(x)*x^2
    disk_sy2: np.ndarray         # [D, PAD_DISK] f64 sign(y)*y^2
    ann_idx: np.ndarray          # [D, PAD_ANN] i32
    ann_valid: np.ndarray        # [D, PAD_ANN] bool
    ann_x: np.ndarray            # [D, PAD_ANN] f64 (px - cx)
    ann_y: np.ndarray            # [D, PAD_ANN] f64
    ann_angle: np.ndarray        # [D, PAD_ANN] f64
    ann_sqd: np.ndarray          # [D, PAD_ANN] f64 x^2 + y^2


def load_template_u8(path: str) -> np.ndarray:
    """The template PNG as [h, w] u8 grey (io/png.read_gray: Pillow's
    ``convert("L")``); LoadError for a PNG the reader refuses."""
    from .io import png   # here: io/png.py imports this module's LoadError

    return png.read_gray(path)


def build_param_arrays(params: Params) -> ParamArrays:
    template = (np.ascontiguousarray(params.template, np.uint8)
                if params.template is not None
                else load_template_u8(params.dials_file))
    if template.shape != params.dials_template_size:
        raise LoadError(
            f"Template shape {template.shape} != declared "
            f"{params.dials_template_size}"
        )
    th, tw = template.shape
    tmpl_f64 = template.astype(np.float64)
    template_zm = (tmpl_f64 - tmpl_f64.mean()).astype(np.float32)

    names = params.dial_names
    D = len(names)
    win = DIAL_WIN
    color_range = np.zeros((D, 3), np.int32)
    centers_int = np.zeros((D, 2), np.int32)
    win_origin = np.zeros((D, 2), np.int32)
    mask_full = np.zeros((D, win, win), bool)
    mask_circle = np.zeros((D, win, win), bool)
    neg_sign = np.zeros((D,), np.int32)
    zero_turn = np.zeros((D,), np.float64)

    for i, name in enumerate(names):
        dc = params.dial_centers[name]
        cr = params.dial_color_range[name]
        color_range[i] = (cr.hue, cr.lightness, cr.saturation)
        full, circ = make_dial_masks(
            dc.center,
            dc.diameter,
            params.needle_dists_from_dial_center[name],
            params.needle_circle_mask_thickness[name],
            (th, tw),
        )
        cx, cy = dc.center
        ox = int(np.clip(int(cx) - win // 2, 0, tw - win))
        oy = int(np.clip(int(cy) - win // 2, 0, th - win))
        # the full mask disk must be contained in the window
        ys, xs = np.nonzero(full)
        if len(xs) and (
            xs.min() < ox or xs.max() >= ox + win
            or ys.min() < oy or ys.max() >= oy + win
        ):
            raise LoadError(f"Dial {name} mask does not fit its window")
        win_origin[i] = (ox, oy)
        mask_full[i] = full[oy:oy + win, ox:ox + win] != 0
        mask_circle[i] = circ[oy:oy + win, ox:ox + win] != 0
        centers_int[i] = (int(cx) - ox, int(cy) - oy)
        neg_sign[i] = -1 if name in params.negative_momentum_dials else 1
        zero_turn[i] = params.needle_angles_of_zero[name] / 360.0

    pad_disk = _pad256(int(mask_full.sum(axis=(1, 2)).max()))
    pad_ann = _pad256(int(mask_circle.sum(axis=(1, 2)).max()))
    disk_idx = np.zeros((D, pad_disk), np.int32)
    disk_valid = np.zeros((D, pad_disk), bool)
    disk_sx2 = np.zeros((D, pad_disk), np.float64)
    disk_sy2 = np.zeros((D, pad_disk), np.float64)
    ann_idx = np.zeros((D, pad_ann), np.int32)
    ann_valid = np.zeros((D, pad_ann), bool)
    ann_x = np.zeros((D, pad_ann), np.float64)
    ann_y = np.zeros((D, pad_ann), np.float64)
    ann_angle = np.zeros((D, pad_ann), np.float64)
    ann_sqd = np.zeros((D, pad_ann), np.float64)

    for i, name in enumerate(names):
        cx, cy = params.dial_centers[name].center
        ox, oy = (int(v) for v in win_origin[i])

        # static dial geometry: offsets computed in TEMPLATE coordinates
        # with the same float ops as the reference (px - cx in f64), so
        # every downstream float is bit-identical.
        dys, dxs = np.nonzero(mask_full[i])
        for j, (wy_, wx_) in enumerate(zip(dys, dxs)):
            px, py = wx_ + ox, wy_ + oy  # template coords
            x = px - cx
            y = py - cy
            disk_idx[i, j] = wy_ * win + wx_
            disk_valid[i, j] = True
            disk_sx2[i, j] = (-1 if x < 0 else 1) * x ** 2
            disk_sy2[i, j] = (-1 if y < 0 else 1) * y ** 2

        ays, axs = np.nonzero(mask_circle[i])
        slots = []
        for (wy_, wx_) in zip(ays, axs):
            px, py = wx_ + ox, wy_ + oy
            x = px - cx
            y = py - cy
            ang = angle_by_vector(x, y)
            if ang is None:
                raise LoadError(f"Dial {name}: annulus pixel at center")
            slots.append((ang, x ** 2 + y ** 2, x, y, wy_ * win + wx_))
        # slots ordered by (angle, sqdist): the reference's tuple sort
        # (_reading.py:89) becomes a cyclic rotation of this static order,
        # so the device needs no runtime sort (ops/angles.py)
        slots.sort(key=lambda t: (t[0], t[1]))
        for j, (ang, sqd, x, y, flat) in enumerate(slots):
            ann_idx[i, j] = flat
            ann_valid[i, j] = True
            ann_x[i, j] = x
            ann_y[i, j] = y
            ann_angle[i, j] = ang
            ann_sqd[i, j] = sqd

    value_perm = np.argsort(np.array(names)).astype(np.int32)

    return ParamArrays(
        template_zm=template_zm,
        template_u8=template,
        threshold=np.float32(params.dials_match_threshold),
        hue_shift=np.int32(params.hue_shift),
        color_range=color_range,
        centers_int=centers_int,
        win_origin=win_origin,
        mask_full=mask_full,
        mask_circle=mask_circle,
        neg_sign=neg_sign,
        zero_turn=zero_turn,
        value_perm=value_perm,
        disk_idx=disk_idx,
        disk_valid=disk_valid,
        disk_sx2=disk_sx2,
        disk_sy2=disk_sy2,
        ann_idx=ann_idx,
        ann_valid=ann_valid,
        ann_x=ann_x,
        ann_y=ann_y,
        ann_angle=ann_angle,
        ann_sqd=ann_sqd,
    )


# --------------------------------------------------------------------------
# Carry onto a torch device
# --------------------------------------------------------------------------

class DeviceParams(NamedTuple):
    """``ParamArrays`` on a torch device: the same field names, every
    array a tensor of the same dtype (f64 stays f64; bool, i32 and u8
    keep their types), except the static geometry, which the kernels
    take as Python ints: ``win_origin`` and ``centers_int`` as
    ((x, y) per dial), ``value_perm`` as a tuple."""

    template_zm: Any
    template_u8: Any
    threshold: Any
    hue_shift: Any
    color_range: Any
    centers_int: Tuple[Tuple[int, int], ...]
    win_origin: Tuple[Tuple[int, int], ...]
    mask_full: Any
    mask_circle: Any
    neg_sign: Any
    zero_turn: Any
    value_perm: Tuple[int, ...]
    disk_idx: Any
    disk_valid: Any
    disk_sx2: Any
    disk_sy2: Any
    ann_idx: Any
    ann_valid: Any
    ann_x: Any
    ann_y: Any
    ann_angle: Any
    ann_sqd: Any


_STATIC_PAIRS = ("win_origin", "centers_int")


def to_device(pa: Any, device: Any) -> DeviceParams:
    """Any object with ``ParamArrays``' field names (this module's, or
    the JAX package's ``ParamArrays`` of numpy arrays) -> DeviceParams
    on ``device``."""
    import torch

    out: Dict[str, Any] = {}
    for name in DeviceParams._fields:
        a = np.asarray(getattr(pa, name))
        if name in _STATIC_PAIRS:
            out[name] = tuple((int(x), int(y)) for x, y in a)
        elif name == "value_perm":
            out[name] = tuple(int(v) for v in a)
        else:
            out[name] = torch.from_numpy(np.array(a)).to(device)
    return DeviceParams(**out)
