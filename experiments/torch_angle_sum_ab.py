"""Cost, on the card, of summing the angle statistics in the JAX graph's
order (ops/angles.tree_sum: runs of 32 in index order, as XLA's CPU
backend sums them) against torch's own reduction (one ``sum(-1)``, the
port's order before), in turns.

    python3 experiments/torch_angle_sum_ab.py [--rounds N]

Decodes chip_smoke.py's B_MAIN flagship crops (quad branch) and
FIVE_DIAL_CAMERA crops (general branch) with MeterDecoder on the card,
under each summation: first held to the CPU (the tree order's dial
positions equal the CPU's bit for bit; torch's within 1e-9 of them,
every discrete field equal), then timed in turns (tree, sum, sum, tree,
... ``--rounds`` times) as the time between CUDA events around REPS
decodes (``ms``: the wall of a host-bound decode), and profiled once
each (chip_smoke.profile_ms: device busy time, kernels and aten ops a
batch). Prints the card and one JSON line. Needs one CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (B_MAIN, DEVICE, check, cuda_ms,  # noqa: E402
                        profile_ms, render, say)

REPS = 20


def main() -> int:
    import torch

    from meterelf_tpu_torch import synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.ops import angles
    from meterelf_tpu_torch.pipeline.decode import MeterDecoder

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    say(f"card: {card}")
    dev = torch.device(DEVICE)
    orders = {"tree": angles.tree_sum, "sum": lambda x: x.sum(-1)}
    paths = {}
    for name, cam, step, spread in (
            ("quad", synthetic.DEFAULT_CAMERA, 1.7, 2.3),
            ("general", synthetic.FIVE_DIAL_CAMERA, 1.3, 1.9)):
        crops, _ = render(cam, B_MAIN, step, spread)
        dec = MeterDecoder(cam.make_params(), device=dev)
        packed = torch.as_tensor(tio.pack_crops(crops)).to(dev)
        cpu = MeterDecoder(cam.make_params(), device="cpu").decode_numpy(
            crops[:16])
        for order, fn in orders.items():
            angles.tree_sum = fn
            got = dec.decode_numpy(crops)
            rd = cpu.readable
            d = np.where(rd, got.dial_pos[:16] - cpu.dial_pos, 0.0)
            for f in ("err", "readable", "match_x", "match_y",
                      "unreadable_bits", "first_bad_dial"):
                check(np.array_equal(getattr(got, f)[:16], getattr(cpu, f)),
                      f"{name}, {order} order: {f} differs from the CPU")
            check((not d.any()) if order == "tree" else (
                np.abs(d).max() <= 1e-9), f"{name}, {order} order: dial "
                f"positions differ from the CPU by {np.abs(d).max()}")
        paths[name] = (dec, packed)
        angles.tree_sum = orders["tree"]
    say("checked: tree order == CPU bit for bit, sum within 1e-9")

    out = {"card": card, "B": B_MAIN}
    for name, (dec, packed) in paths.items():
        runs = {o: [] for o in orders}
        for r in range(args.rounds):           # tree, sum, sum, tree, ...
            for order in list(orders)[::1 if r % 2 == 0 else -1]:
                angles.tree_sum = orders[order]
                runs[order].append(cuda_ms(lambda: dec(packed), REPS))
        for order, fn in orders.items():
            angles.tree_sum = fn
            profile_ms(f"{name} decode, {order} order", lambda: dec(packed))
        angles.tree_sum = orders["tree"]
        for order in orders:
            ms = runs[order]
            out[f"{name}_{order}_ms"] = float(np.median(ms))
            out[f"{name}_{order}_runs"] = [round(m, 6) for m in ms]
            say(f"{name} decode, {order} order: median {np.median(ms):.6f} "
                f"ms/batch over {len(ms)} runs of {REPS} "
                f"({min(ms):.6f}-{max(ms):.6f})")
    say(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
