"""The control of the comparison: the plain reference computed one
precision below the configuration's statement (harness/reference.py
``lower=True``), put in the program's place, must come out not correct.

On the card, at the cells' size (the pool of 256 frames of each seed):

    python3 bench_torch/tests/control.py --config flagship --seeds 1 2 3

prints, for each seed, the comparison's numbers of the control's rows
against the reference (the upper readings the limits are set below), and
of the control with only the angle statistics lowered (float32), the
subtlest of the three. test_control.py runs the same at a small size on
the CPU."""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import compare, gen, reference  # noqa: E402


def config(name: str) -> Dict:
    """A configuration of BENCHMARK.json's (bench_torch/configs/), or a
    fixture of the self-checks' (bench_torch/tests/)."""
    for d in (os.path.join(BENCH, "configs"), HERE):
        path = os.path.join(d, name + ".json")
        if os.path.exists(path):
            with open(path) as fp:
                return json.load(fp)
    raise FileNotFoundError(name)


def readings(cfg: Dict, seed: int, n: int, device: str,
             workers: int) -> Dict[str, Dict[str, float]]:
    """The numbers of the control (every stage lower) and of the
    float32 angle statistics alone, each against the reference, over a
    pool of n frames of the seed."""
    frames = gen.Pool(cfg, seed, n, workers).frames()
    coefs = [np.stack([f[1][i] for f in frames]) for i in range(3)]
    ok = np.ones(n, bool)
    g = reference.geometry(cfg)
    ref = reference.read_frames(cfg, g, coefs, ok, device)
    out = {}
    for name, lower in (("control", True), ("angles_f32", "angles")):
        got = reference.read_frames(cfg, g, coefs, ok, device, lower=lower)
        got["converged"] = np.ones(n, bool)
        out[name] = compare.numbers(np.arange(n), got, ref)
    return out


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = config(args.config)
    lim = compare.limits()
    for seed in args.seeds:
        r = readings(cfg, seed, args.frames, args.device,
                     min(7, max(1, (os.cpu_count() or 2) - 1)))
        for name, nums in r.items():
            fails = [k for k, v in nums.items() if v > lim[k]]
            print(json.dumps({"config": args.config, "seed": seed,
                              "control": name, "numbers": nums,
                              "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
