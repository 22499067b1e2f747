"""The control comes out not correct, at a size a test run holds (24
frames a seed on the CPU; control.py runs it at the cells' size on the
card), and the reference against itself comes out correct."""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import control  # noqa: E402
from harness import compare  # noqa: E402


@pytest.mark.parametrize("name", ["flagship", "five_dial"])
@pytest.mark.parametrize("seed", [2**40 + 1, 7])
def test_control_fails(name, seed):
    cfg = control.config(name)
    r = control.readings(cfg, seed, 24, "cpu", 2)
    lim = compare.limits()
    for which in ("control", "angles_f32"):
        nums = r[which]
        assert any(v > lim[k] for k, v in nums.items()), (which, nums)


def test_reference_against_itself_is_correct():
    got = {"err": np.zeros(3, int), "first_bad_dial": np.zeros(3, int),
           "unreadable_bits": np.zeros(3, int),
           "match_val": np.ones(3), "match_x": np.zeros(3, int),
           "match_y": np.zeros(3, int), "dial_pos": np.full((3, 4), 9.99),
           "readable": np.ones((3, 4), bool), "value": np.ones(3),
           "converged": np.ones(3, bool)}
    ref = {k: v for k, v in got.items() if k != "converged"}
    nums = compare.numbers(np.arange(3), got, ref)
    assert compare.is_correct(compare.verdict(nums, compare.limits()))
