"""The host's cost of enqueueing one batch of the coefficient step on the
graphs' path, before and after a change to the step's glue, in turns.

    git archive PARENT_REV meterelf_tpu_torch | tar -x -C build/parent
    python3 experiments/torch_host_enqueue_ab.py \
        [--parent build/parent/meterelf_tpu_torch] [--rounds N] [--profile]

Loads the package at ``--parent`` beside the checkout's under another
name (its kernels from the same build: the glue is Python) and builds,
for each variant, the flagship decoder and its coefficient step at B =
256. Two feeds: ``resident``, four feeds uploaded to the card once and
handed in turn, as the benchmark's resident cell hands them (the
graphs read them in place); ``staged``, the host numpy feed, as the
stream hands it (copied into the staged graph's buffers each batch).
Each variant first gives the change's fields on both feeds and on a feed
with fallback slots in use. Then, in turns (AB, BA, ...), each round
times BATCHES batches of:

- ``enqueue_ms``: the host's wall from the step's entry to the return of
  ``to_host_later``, with no wait, the card idle at each call (the
  previous batch pulled and the card synchronised before it): what the
  host spends to put one batch on the card;
- ``pipelined_ms``: the resident cell's loop, each batch dispatched one
  ahead of the pull of the previous one: the pace the slower of the host
  and the card sets.

``--profile`` also runs each variant's pipelined resident loop under
cProfile and prints the functions with the most own time. Prints the
card, each metric's median and quartiles a variant, the change over the
parent a round and the rounds the change won, and one JSON line. Needs
one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import importlib
import importlib.util
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B = 256
BATCHES = 400
PARENT = "meterelf_tpu_torch_parent"


def load_package(path: str, name: str):
    """The package directory ``path`` imported as ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def same(a, b) -> bool:
    return all(np.asarray(x).shape == np.asarray(y).shape
               and np.array_equal(np.asarray(x).view(np.uint8),
                                  np.asarray(y).view(np.uint8))
               for x, y in zip(a, b))


def quartiles(x):
    q1, q2, q3 = statistics.quantiles(x, n=4)
    return q1, q2, q3


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="the parent commit's meterelf_tpu_torch directory")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)

    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.pipeline import decode as c_dec

    mods = {"change": c_dec}
    if args.parent:
        load_package(os.path.abspath(args.parent), PARENT)
        importlib.import_module(PARENT + "._build").BUILD_DIR = \
            _build.BUILD_DIR
        mods = {"parent": importlib.import_module(PARENT + ".pipeline.decode"),
                "change": c_dec}
    _build.library()
    _build.host_jpeg()

    cam = synthetic.DEFAULT_CAMERA
    params = cam.make_params()
    frames = cam.render_frames(synthetic.dial_positions(64))
    datas = [synthetic.encode_jpeg(f, 92) for f in frames] * 4
    feed = tio.load_coef_feed(datas, cam.meter_rect, (640, 480), (250, 250),
                              num_threads=8)
    fb_datas = list(datas)
    for i in (5, 77, 200):       # 4:4:4: the coefficient reader's fallback
        fb_datas[i] = synthetic.encode_jpeg(frames[i % 64], 92,
                                            subsampling="4:4:4")
    fb_feed = tio.load_coef_feed(fb_datas, cam.meter_rect, (640, 480),
                                 (250, 250), num_threads=8)
    assert (fb_feed[6] < B).sum() == 3, fb_feed[6]
    resident = [[torch.as_tensor(np.roll(a, 37 * k, axis=0)).to(dev)
                 for a in feed[:5]] + list(feed[5:]) for k in range(4)]

    steps = {}
    for name, D in mods.items():
        dec = D.MeterDecoder(params, device=dev)
        steps[name] = (D, D.make_coef_decode_fn(dec, (640, 480))[0])

    def outputs(name):
        D, step = steps[name]
        return [D.to_host_later(step(None, *f))()
                for f in (resident[0], resident[1], feed, fb_feed)]

    want = outputs("change")
    for name in steps:
        got = outputs(name)
        for k, label in enumerate(("resident feed 0", "resident feed 1",
                                   "staged host feed", "fallback feed")):
            if not same(got[k], want[k]):
                print(f"FAIL: {name}: {label} differs from the change's")
                return 1
    print("every variant equal to the change on two resident feeds, the "
          "host feed and a feed with 3 fallback slots kept", flush=True)

    def enqueue(name, feeds, n):
        D, step = steps[name]
        t = []
        for i in range(n):
            f = feeds[i % len(feeds)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fetch = D.to_host_later(step(None, *f))
            t.append(time.perf_counter() - t0)
            fetch()
        return statistics.median(t) * 1e3

    def pipelined(name, feeds, n):
        D, step = steps[name]
        torch.cuda.synchronize()
        pending = None
        t0 = time.perf_counter()
        for i in range(n):
            fetch = D.to_host_later(step(None, *feeds[i % len(feeds)]))
            if pending is not None:
                pending()
            pending = fetch
        pending()
        return (time.perf_counter() - t0) / n * 1e3

    def measure(name):
        return {
            "enqueue_ms": enqueue(name, resident, BATCHES),
            "pipelined_ms": pipelined(name, resident, BATCHES),
            "staged_enqueue_ms": enqueue(name, [feed], BATCHES // 2),
            "staged_pipelined_ms": pipelined(name, [feed], BATCHES // 2),
        }

    names = list(steps)
    for n in names:
        measure(n)                                   # warm
    runs = {n: [] for n in names}
    for r in range(args.rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            runs[n].append(measure(n))
    summary = {}
    for metric in runs["change"][0]:
        row = {}
        for n in names:
            x = [m[metric] for m in runs[n]]
            q1, q2, q3 = quartiles(x) if len(x) > 1 else (x[0],) * 3
            row[n] = {"median": q2, "q1": q1, "q3": q3, "runs": x}
        line = f"{metric:20s} " + "  ".join(
            f"{n} {row[n]['median']:.4f} [{row[n]['q1']:.4f}, "
            f"{row[n]['q3']:.4f}]" for n in names)
        if "parent" in runs:
            pairs = [(a[metric], b[metric])
                     for a, b in zip(runs["change"], runs["parent"])]
            row["change_over_parent"] = statistics.median(
                a / b for a, b in pairs)
            row["change_wins"] = sum(a < b for a, b in pairs)
            line += (f"  change/parent {row['change_over_parent']:.3f} "
                     f"(wins {row['change_wins']}/{len(pairs)})")
        summary[metric] = row
        print(line, flush=True)
    print(f"medians [Q1, Q3] of {args.rounds} rounds in turns; enqueue: the "
          f"median of {BATCHES} batches a round (staged: {BATCHES // 2}); "
          f"B={B}; on {card}")
    if args.profile:
        for n in names:
            prof = cProfile.Profile()
            prof.enable()
            pipelined(n, resident, BATCHES)
            prof.disable()
            s = io.StringIO()
            pstats.Stats(prof, stream=s).sort_stats("tottime").print_stats(25)
            print(f"--- cProfile, {n}, {BATCHES} pipelined resident batches "
                  "(own time; the profiler's own cost inflates each call)")
            print(s.getvalue())
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "batches": BATCHES, "batch": B, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
