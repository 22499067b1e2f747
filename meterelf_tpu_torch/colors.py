"""HLS color value type (reference: meterelf/_colors.py).

HlsColor here is a plain NamedTuple of ints (not an ndarray subclass like
the reference's) — the decode path consumes colors as arrays built in
params.py, so the host type only needs value semantics and range clamping.

Copy of meterelf_tpu/colors.py's HlsColor: the port cannot import the
JAX package (its ``__init__`` imports jax), so it carries this
numpy-only copy; tests/test_torch_params.py holds the two equal.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple


class HlsColor(NamedTuple):
    hue: int = 0
    lightness: int = 0
    saturation: int = 0

    def validate(self) -> "HlsColor":
        for v in self:
            if not (0 <= v < 256):
                raise ValueError(f"HLS component out of range: {self}")
        return self

    def get_range(self, color_range: "HlsColor") -> Tuple["HlsColor", "HlsColor"]:
        lo = HlsColor(
            max(self.hue - color_range.hue, 0),
            max(self.lightness - color_range.lightness, 0),
            max(self.saturation - color_range.saturation, 0),
        )
        hi = HlsColor(
            min(self.hue + color_range.hue, 255),
            min(self.lightness + color_range.lightness, 255),
            min(self.saturation + color_range.saturation, 255),
        )
        return (lo, hi)

