"""The comparison that decides ``correct``: every row that the timed path
produced, held to the plain reference's reading of the same frame.

The numbers, each against its limit in limits.json (PERF.md gives the
readings each limit was set from):

- ``rows_wrong``: rows whose error code differs, or, for a frame that
  loaded, whose first bad dial, unreadable-dial bits, match location or
  dial readability differ;
- ``rows_unconverged``: rows whose component propagation the program
  flags as not converged (such a row's reading is not final);
- ``match_val_gap``: the largest relative gap of the match score
  (program float32 against the exact score);
- ``dial_pos_gap``: the largest gap of a readable dial's position, taken
  around the dial (0 and 10 are one point);
- ``value_gap``: the largest gap of the carry-corrected value of a row
  both read as OK (4-dial configurations; with other dial counts the
  value is 0 by definition and not compared);
- each entry's own numbers (``reports_wrong`` for the stream).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np

DISCRETE = ("first_bad_dial", "unreadable_bits", "match_x", "match_y",
            "readable")
LIMITS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "limits.json")


def limits() -> Dict[str, float]:
    with open(LIMITS) as fp:
        return json.load(fp)


def numbers(frame: np.ndarray, got: Dict[str, np.ndarray],
            ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """``got``: the program's fields over R rows, ``frame`` [R] the pool
    frame of each row; ``ref``: the reference's fields over the pool."""
    r = {k: v[frame] for k, v in ref.items()}
    loaded = r["err"] != 1
    n = len(frame)
    wrong = np.asarray(got["err"]) != r["err"]
    for k in DISCRETE:
        diff = (np.asarray(got[k]).reshape(n, -1)
                != r[k].reshape(n, -1)).any(1)
        wrong |= diff & loaded
    both = loaded[:, None] & np.asarray(got["readable"]) & r["readable"]
    gap = np.abs(np.asarray(got["dial_pos"], np.float64) - r["dial_pos"])
    gap = np.minimum(gap, 10.0 - gap)
    mv = np.asarray(got["match_val"], np.float64)
    out = {
        "rows_wrong": float(wrong.sum()),
        "rows_unconverged": float((~np.asarray(got["converged"])).sum()),
        "match_val_gap": float(np.max(
            np.abs(mv - r["match_val"])[loaded]
            / np.abs(r["match_val"][loaded]), initial=0.0)),
        "dial_pos_gap": float(np.max(gap[both], initial=0.0)),
    }
    if gap.shape[1] == 4:         # the value exists for 4 dials only
        ok = (r["err"] == 0) & (np.asarray(got["err"]) == 0)
        out["value_gap"] = float(np.max(np.abs(
            np.asarray(got["value"], np.float64) - r["value"])[ok],
            initial=0.0))
    return out


def verdict(nums: Dict[str, float], lim: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit (a number with no limit is an
    error: every compared number has one)."""
    return {k: {"value": v, "limit": lim[k]} for k, v in nums.items()}


def is_correct(check: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in check.values())


def stack(rows: Sequence, fields: Sequence[str]) -> Dict[str, np.ndarray]:
    """Concatenate host results (objects with the fields) along rows."""
    return {f: np.concatenate([np.asarray(getattr(r, f)) for r in rows])
            for f in fields}
