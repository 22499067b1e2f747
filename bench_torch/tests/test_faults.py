"""A run of each entry on the CPU, past the harness's look for a card, at
a size a test run holds, with the timed path broken underneath: each
fault must turn ``correct`` false, and the sound path must not."""
from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from cpu import SMALL, run_small  # noqa: E402

torch.set_num_threads(2)   # several test workers share the host's cores


def altered(fn):
    """An answer altered where it is produced: row 0's first dial."""
    def wrapped(*a, **k):
        res = fn(*a, **k)
        pos = res.dial_pos.clone()
        pos[0, 0] = torch.remainder(pos[0, 0] + 0.37, 10.0)
        return res._replace(dial_pos=pos)
    return wrapped


def half_left_out(fn):
    """Half of the batch left out: the second half of the rows repeats
    the first half's results."""
    def wrapped(dec, packed, load_ok, **k):
        B = packed.shape[0]
        h = B // 2
        res = fn(dec, packed[:h], load_ok[:h], **k)
        return type(res)(*[torch.cat([v, v[:B - h]]) for v in res])
    return wrapped


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    assert run_small(cell)["correct"]


@pytest.mark.parametrize("fault", [altered, half_left_out])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from meterelf_tpu_torch.pipeline import decode

    monkeypatch.setattr(decode, "_decode_batch", fault(decode._decode_batch))
    r = run_small(cell)
    assert not r["correct"], r["check"]
