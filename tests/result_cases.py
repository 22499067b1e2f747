"""Inputs for K13 ``result_pack`` (csrc/result.cu) and a numpy model of
what it must write, shared by the CPU tests and the card tests (no JAX).

``cases(B, D, seed)`` gives the stage's inputs as numpy arrays: seeded
random rows, then the hand-made rows that fit in B, each reaching one of
the five error codes or one of the edges of the match test and the dial
scans (``HAND``). ``expected`` spells out the reference's raise order
row by row, the match test in float32 as torch compares an f32 tensor
with a Python float.
"""
import numpy as np

from meterelf_tpu_torch.errors import ErrCode

# rounds down to float32: a max_val equal to float32(THRESHOLD) passes in
# float32 and would fail in float64
THRESHOLD = 0.7
T32 = np.float32(THRESHOLD)
NAMES = ("load_ok", "max_val", "mx", "my", "has_any", "conv", "position",
         "readable", "value")
# (label, row edits); edits on a row that reads OK on every dial
HAND = (
    ("ok", {}),
    ("load", {"load_ok": False}),
    ("load_before_all", {"load_ok": False, "max_val": np.nan,
                         "has_any": [0], "readable": [1, 2]}),
    ("nan_match", {"max_val": np.nan}),
    ("match_at_threshold", {"max_val": T32}),
    ("match_below_threshold", {"max_val": np.nextafter(T32, np.float32(0))}),
    ("match_neg_inf", {"max_val": -np.inf}),
    ("match_before_contours", {"max_val": np.float32(0.0),
                               "has_any": [2], "readable": [0]}),
    ("first_dial_no_contours", {"has_any": [0]}),
    ("last_dial_no_contours", {"has_any": [-1]}),
    ("later_dials_no_contours", {"has_any": [1, -1]}),
    ("no_dial_has_contours", {"has_any": "all"}),
    ("contours_before_angle", {"has_any": [1], "readable": [0]}),
    ("one_dial_unreadable", {"readable": [-1]}),
    ("no_dial_readable", {"readable": "all"}),
    ("one_dial_unconverged", {"conv": [0]}),
    ("no_dial_converged", {"conv": "all"}),
)


def cases(B: int, D: int, seed: int) -> dict:
    """The stage's inputs for B rows of D dials: random rows from
    ``seed``, the first min(B, len(HAND)) of them then overwritten by the
    hand-made rows in HAND's order."""
    rng = np.random.default_rng(seed)
    x = {
        "load_ok": rng.random(B) < 0.9,
        "max_val": np.where(rng.random(B) < 0.5, T32,
                            rng.normal(0.7, 0.05, B)).astype(np.float32),
        "mx": rng.integers(0, 200, B, dtype=np.int32),
        "my": rng.integers(0, 200, B, dtype=np.int32),
        "has_any": rng.random((B, D)) < 0.9,
        "conv": rng.random((B, D)) < 0.95,
        "position": rng.uniform(0, 10, (B, D)),
        "readable": rng.random((B, D)) < 0.85,
        "value": rng.uniform(0, 1000, B),
    }
    x["max_val"][rng.random(B) < 0.05] = np.nan
    for row, (_, edits) in zip(range(B), HAND):
        x["load_ok"][row] = True
        x["max_val"][row] = np.float32(0.9)
        for k in ("has_any", "conv", "readable"):
            x[k][row] = True
        for k, v in edits.items():
            if k in ("has_any", "conv", "readable"):
                x[k][row, slice(None) if v == "all" else v] = False
            else:
                x[k][row] = v
    return x


def expected(x: dict, threshold: float = THRESHOLD) -> tuple:
    """The ten BatchResult fields the stage must give for inputs x, row by
    row in the reference's raise order."""
    B, D = x["position"].shape
    err = np.zeros(B, np.int32)
    first_bad = np.zeros(B, np.int32)
    bits = np.zeros(B, np.int32)
    t = np.float32(threshold)
    for b in range(B):
        lacking = [d for d in range(D) if not x["has_any"][b, d]]
        unread = [d for d in range(D) if not x["readable"][b, d]]
        first_bad[b] = lacking[0] if lacking else 0
        bits[b] = sum(1 << d for d in unread)
        if not x["load_ok"][b]:
            err[b] = ErrCode.LOAD
        elif not x["max_val"][b] >= t:
            err[b] = ErrCode.DIALS_NOT_FOUND
        elif lacking:
            err[b] = ErrCode.NEEDLE_CONTOURS
        elif unread:
            err[b] = ErrCode.DIAL_ANGLE
        else:
            err[b] = ErrCode.OK
    return (err, first_bad, bits, x["max_val"], x["mx"], x["my"],
            x["position"], x["readable"], x["value"],
            x["conv"].all(axis=1))


def flat(x: dict) -> dict:
    """x with has_any and conv flattened to [B * D], as K4 and K3 (or the
    components of the other branches) give them."""
    return {k: v.reshape(-1) if k in ("has_any", "conv") else v
            for k, v in x.items()}
