"""Shared host-side types (reference: meterelf/_types.py).

Copy of the parts of meterelf_tpu/types.py that the port uses: the port
cannot import the JAX package (its ``__init__`` imports jax), so it
carries this numpy-only copy; tests/test_torch_params.py holds the two
equal.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

Point = Tuple[int, int]
FloatPoint = Tuple[float, float]


class DialCenter(NamedTuple):
    center: FloatPoint
    diameter: int


class Rect(NamedTuple):
    top_left: Point
    bottom_right: Point

    @property
    def width(self) -> int:
        return self.bottom_right[0] - self.top_left[0]

    @property
    def height(self) -> int:
        return self.bottom_right[1] - self.top_left[1]

