"""Host walls of the decoder's card paths before and after the
dispatch-without-waiting repair (host inputs through pinned,
non-blocking copies; no tensor built from host values per call; one wait
for a result's fields), in turns.

    git archive PARENT_REV meterelf_tpu_torch | tar -x -C build/parent
    python3 experiments/torch_sync_ab.py \
        --parent build/parent/meterelf_tpu_torch [--rounds N]

Loads the package at ``--parent`` beside the checkout's under another
name (its kernels from the same build: this repair changed no source in
csrc/ or io/native/) and times three variants: ``parent``, ``change``
and ``pageable`` (the change with its ``upload`` put back to a pageable
copy, to see what pinning costs a synchronous caller). Each variant
first decodes the same inputs as the change, field for field. Then, in
turns (ABC, CBA, ... ``--rounds`` times), REPS calls each of:

- ``crop_call_ms``: host time of ``MeterDecoder(crops)`` on B_MAIN host
  u8 flagship crops, the card idle at each call (what the host is held);
- ``crop_back_to_back_ms``: REPS such calls back to back, then one
  synchronise, a call;
- ``crop_decode_numpy_ms``: ``decode_numpy(crops)``, a synchronous
  caller;
- ``coef_call_ms``, ``coef_back_to_back_ms``, ``coef_to_numpy_ms``: the
  same three for the coefficient step on the flagship host feed
  (``_to_numpy`` of the variant's package);
- ``coef_fallback_to_numpy_ms``: the step on the feed with fallback
  slots in use (8 rows 4:4:4, 2 cut), to numpy;
- ``coef_device_feed_ms``: chip_smoke's "coefficient step
  (device-resident feed)": CUDA events around REPS steps;
- ``cli_images_per_s``: ``api.get_meter_values`` over CLI_FILES flagship
  files at batch 64 with a decoder made once (the CLI's steady rate).

Prints the card, each metric's median, min, max and interquartile
range over the rounds for each variant, the median ratio of each variant
to the parent's run of the same round and the rounds it won, and one
JSON line. Needs one CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (B_MAIN, DEVICE, FB_444, FB_CUT,  # noqa: E402
                        FEED_THREADS, FRAME_WH, N_DISTINCT, check, cuda_ms,
                        encode_frames, render, say, tiled_jpegs,
                        write_cli_files)

REPS = 10
CLI_FILES = 256
PARENT = "meterelf_tpu_torch_parent"


def load_package(path: str, name: str):
    """The package directory ``path`` imported as ``name`` (the port's
    modules import each other relatively)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def same(a, b) -> bool:
    """Two BatchResults (numpy) equal in every field, floats bitwise."""
    return all(np.array_equal(np.asarray(x).view(np.uint8),
                              np.asarray(y).view(np.uint8))
               and np.asarray(x).shape == np.asarray(y).shape
               for x, y in zip(a, b))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the parent commit's meterelf_tpu_torch directory")
    ap.add_argument("--rounds", type=int, default=10)
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

    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch import api as c_api
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.pipeline import decode as c_dec

    load_package(os.path.abspath(args.parent), PARENT)
    p_build = importlib.import_module(PARENT + "._build")
    p_build.BUILD_DIR = _build.BUILD_DIR
    p_dec = importlib.import_module(PARENT + ".pipeline.decode")
    p_api = importlib.import_module(PARENT + ".api")
    _build.library()
    _build.host_jpeg()

    cam = synthetic.DEFAULT_CAMERA
    params = cam.make_params()
    crops, pos = render(cam, B_MAIN, 1.7, 2.3)
    _, datas = tiled_jpegs(cam, pos, N_DISTINCT, B_MAIN)
    fb_datas = list(datas)
    for i, d in zip(FB_444, encode_frames(cam, pos[list(FB_444)], "4:4:4")):
        fb_datas[i] = d
    for i in FB_CUT:
        fb_datas[i] = datas[i][:int(len(datas[i]) * 0.95)]
    tmp = tempfile.mkdtemp(prefix="meterelf_sync_ab_")
    try:
        yml = cam.write_params(os.path.join(tmp, "params"))
        files = write_cli_files(cam, [datas[i % B_MAIN]
                                      for i in range(CLI_FILES)], tmp)
        files = files[:CLI_FILES]
        return run(torch, dev, card, args.rounds, params, yml, files,
                   crops, datas, fb_datas, tio, c_dec, c_api, p_dec, p_api)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(torch, dev, card, rounds, params, yml, files, crops, datas,
        fb_datas, tio, c_dec, c_api, p_dec, p_api) -> int:
    cam_rect = params.meter_rect
    pageable = lambda a, d: torch.as_tensor(a).to(d)  # noqa: E731
    variants = {}
    for name, D, A, patch in (("parent", p_dec, p_api, None),
                              ("change", c_dec, c_api, None),
                              ("pageable", c_dec, c_api, pageable)):
        dec = D.MeterDecoder(params, device=dev)
        step, _win, pad_hw = D.make_coef_decode_fn(dec, FRAME_WH)
        variants[name] = dict(D=D, A=A, patch=patch, dec=dec, step=step,
                              cli_dec=D.MeterDecoder(params, device=dev))
    feed = tio.load_coef_feed(datas, cam_rect, FRAME_WH, pad_hw,
                              num_threads=FEED_THREADS)
    fb_feed = tio.load_coef_feed(fb_datas, cam_rect, FRAME_WH, pad_hw,
                                 num_threads=FEED_THREADS)
    check((fb_feed[6] < B_MAIN).any(), "no fallback slot in use")
    feed_dev = [torch.as_tensor(a).to(dev) for a in feed[:5]]

    def use(v):
        """Put the variant's upload in place (the change's module is
        shared by two variants)."""
        c_dec.upload = v["patch"] or real_upload

    real_upload = c_dec.upload

    def outputs(v) -> tuple:
        use(v)
        D, dec, step = v["D"], v["dec"], v["step"]
        recs = list(v["A"].get_meter_values(yml, files,
                                            decoder=v["cli_dec"]))
        return (dec.decode_numpy(crops), D._to_numpy(step(None, *feed)),
                D._to_numpy(step(None, *fb_feed)),
                D._to_numpy(step(None, *feed_dev, *feed[5:])),
                [(r.value, r.error and str(r.error), r.meter_values)
                 for r in recs])

    want = outputs(variants["change"])
    for name, v in variants.items():
        got = outputs(v)
        for k, label in enumerate(("crop decode_numpy", "coef host feed",
                                   "coef fallback feed",
                                   "coef device feed")):
            check(same(got[k], want[k]), f"{name}: {label} differs from "
                  "the change's")
        check(got[4] == want[4], f"{name}: get_meter_values records differ")
    say(f"every variant equal to the change on {B_MAIN} crops, the host, "
        f"fallback and device feeds and {len(files)} CLI files")

    def sync_each(fn) -> float:
        t_all = 0.0
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            t_all += time.perf_counter() - t
        torch.cuda.synchronize()
        return t_all / REPS * 1e3

    def back_to_back(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / REPS * 1e3

    def wall(fn) -> float:
        t = time.perf_counter()
        for _ in range(REPS):
            fn()
        return (time.perf_counter() - t) / REPS * 1e3

    def measure(v) -> dict:
        use(v)
        D, dec, step = v["D"], v["dec"], v["step"]
        out = {
            "crop_call_ms": sync_each(lambda: dec(crops)),
            "crop_back_to_back_ms": back_to_back(lambda: dec(crops)),
            "crop_decode_numpy_ms": wall(lambda: dec.decode_numpy(crops)),
            "coef_call_ms": sync_each(lambda: step(None, *feed)),
            "coef_back_to_back_ms": back_to_back(lambda: step(None, *feed)),
            "coef_to_numpy_ms": wall(
                lambda: D._to_numpy(step(None, *feed))),
            "coef_fallback_to_numpy_ms": wall(
                lambda: D._to_numpy(step(None, *fb_feed))),
            "coef_device_feed_ms": cuda_ms(
                lambda: step(None, *feed_dev, *feed[5:]), REPS),
        }
        t = time.perf_counter()
        for _ in v["A"].get_meter_values(yml, files, decoder=v["cli_dec"]):
            pass
        out["cli_images_per_s"] = len(files) / (time.perf_counter() - t)
        return out

    names = list(variants)
    runs = {n: [] for n in names}
    for n in names:
        measure(variants[n])                 # warm
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            runs[n].append(measure(variants[n]))
    use(variants["change"])
    summary = {}
    for metric in runs["change"][0]:
        row = {}
        for n in names:
            x = np.array([m[metric] for m in runs[n]])
            q1, q3 = np.percentile(x, [25, 75])
            row[n] = {"median": float(np.median(x)), "min": float(x.min()),
                      "max": float(x.max()), "iqr": float(q3 - q1)}
        better = max if metric.endswith("_per_s") else min
        for n in ("change", "pageable"):
            pairs = list(zip(runs[n], runs["parent"]))
            row[f"{n}_over_parent"] = float(np.median(
                [a[metric] / b[metric] for a, b in pairs]))
            row[f"{n}_wins"] = sum(
                a[metric] != b[metric]
                and better(a[metric], b[metric]) == a[metric]
                for a, b in pairs)
        summary[metric] = row
        say(f"{metric:26s} " + "  ".join(
            f"{n} {row[n]['median']:8.3f} [{row[n]['min']:.3f}, "
            f"{row[n]['max']:.3f}]" for n in names)
            + f"  parent IQR {row['parent']['iqr']:.3f}"
            f"  change/parent {row['change_over_parent']:.3f} "
            f"(wins {row['change_wins']}/{rounds})"
            f"  pageable/parent {row['pageable_over_parent']:.3f} "
            f"(wins {row['pageable_wins']}/{rounds})")
    say(f"medians [min, max] of {rounds} rounds in turns, {REPS} calls a "
        f"round, B={B_MAIN}, on {card}; wins: rounds in which the variant "
        "beat the parent's run of the same round")
    say(json.dumps({"card": card, "rounds": rounds, "reps": REPS,
                    "batch": B_MAIN, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
