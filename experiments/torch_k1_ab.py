"""Device time of K1 `frontend` against other builds of frontend.cu, and
the split of its time between its phases, in turns on one card.

    python3 experiments/torch_k1_ab.py [--variant NAME=DIR ...]
                                       [--probe NAME=PATCHES ...]

"new" is meterelf_tpu_torch/csrc; each --variant another directory of
kernel sources with the same C entry (an earlier commit's, unpacked with
`git show REV:meterelf_tpu_torch/csrc/FILE` into the gitignored build/).
Each --probe is a copy of "new" with text patches, PATCHES a
comma-separated list of PROBES keys: `noloop` runs no product (staging,
box' and the epilogue alone), `nobox` skips box' (the products and the
epilogue on garbage box'), `nostage` skips the image's staging.
frontend.cu of each source is built alone (_build.build_source; a source
includes its own directory's headers first), all builds at once.

Inputs: chip_smoke.py's B_MAIN flagship crops. Every variant (not the
probes) must give frontend_plain's (max_val, mx, my) bit for bit. Then
each build's C entry is timed in turns (builds in order, then reversed,
ROUNDS times) with CUDA events: back to back (``kernel_ms``, the crops in
L2 where they fit) and one launch at a time after a 256 MB read that
empties L2 (``cold_ms``, as a decode finds them). For "new" it prints
the SM clocks a k32 wgmma step and SM (kernel time x SM clock x SMs /
steps). Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (B_MAIN, cold_ms, cuda_ms, k1_steps,  # noqa: E402
                        render, sm_clock_mhz)

REPS = 20
ROUNDS = 3
ENTRIES = ("meterelf_frontend", "meterelf_frontend_smem_bytes")
PROBES = {
    "noloop": ("corr_wgmma.cuh",
               "const int steps = (r1 - r0) * nj;",
               "const int steps = 0 * (r1 - r0) * nj;"),
    "nobox": ("corr_wgmma.cuh",
              "  box_sums(smem, g, th, tw);\n",
              "  __syncthreads();\n"),
    "nostage": ("corr_wgmma.cuh",
                "  if (k0 < 16 * g.kc) {",
                "  if (false) {"),
}


def probe_dir(name: str, src: Path, patches: str, out: Path) -> Path:
    d = out / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(src, d)
    for key in patches.split(","):
        fname, old, new = PROBES[key]
        text = (d / fname).read_text()
        if text.count(old) != 1:
            raise ValueError(f"probe {key}: {fname} holds its text "
                             f"{text.count(old)} times, not once")
        (d / fname).write_text(text.replace(old, new))
    return d


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--probe", action="append", default=[])
    args = ap.parse_args()

    import torch

    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.ops import frontend
    from meterelf_tpu_torch.pipeline.decode import MeterDecoder

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    out = Path(_build.BUILD_DIR) / "k1_ab"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"new": (_build.CSRC, True)}
    for v in args.variant:
        name, d = v.split("=", 1)
        sources[name] = (Path(d), True)
    for p in args.probe:
        name, patches = p.split("=", 1)
        sources[name] = (probe_dir(name, _build.CSRC, patches, out), False)

    def build(item):
        name, (d, _) = item
        return name, _build.build_source(d / "frontend.cu", "k1ab_" + re.sub(
            r"\W", "_", name), ENTRIES)

    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(ex.map(build, sources.items()))
    for name, lib in libs.items():
        print(f"{name}: nvcc {lib.build_seconds:.1f} s")
        entry = ""
        for line in lib.build_log.splitlines():
            entry = line if "Compiling entry" in line else entry
            if "Used" in line and "ILi18E" in entry:
                print(f"  {name} n144 ptxas:", line.split("Used")[-1].strip())

    dev = torch.device("cuda:0")
    cam = synthetic.DEFAULT_CAMERA
    dec = MeterDecoder(cam.make_params(), device=dev)
    crops, _ = render(cam, B_MAIN, 1.7, 2.3)
    packed = torch.as_tensor(tio.pack_crops(crops)).to(dev)
    fe = (packed, dec.param_arrays.template_u8, dec.score_c1, dec.score_c0)
    ref = frontend.frontend_plain(*fe)
    calls = {}
    for name, lib in libs.items():
        a, o = frontend.c_args(*fe)
        calls[name] = (lambda lib=lib, a=a: lib.meterelf_frontend(*a))
        assert calls[name]() == 0, f"{name}: launch failed"
        torch.cuda.synchronize()
        if sources[name][1]:
            same = (o[0].cpu().numpy().tobytes()
                    == ref[0].cpu().numpy().tobytes()
                    and torch.equal(o[1], ref[1])
                    and torch.equal(o[2], ref[2]))
            print(f"{name}: equal to frontend_plain: {same}")
            if not same:
                return 1
    flush = torch.zeros(1 << 28, dtype=torch.uint8, device=dev)
    warm = {n: [] for n in calls}
    cold = {n: [] for n in calls}
    order = list(calls)
    for _ in range(ROUNDS):
        for seq in (order, order[::-1]):
            for n in seq:
                warm[n].append(cuda_ms(calls[n], REPS))
                cold[n].append(cold_ms(calls[n], REPS, flush))
    clk = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, H, W = packed.shape
    th, tw = dec.param_arrays.template_u8.shape
    steps = B * k1_steps(H, W, th, tw)
    for n in order:
        w, c = float(np.median(warm[n])), float(np.median(cold[n]))
        print(f"{n}: kernel_ms {w:.5f} (runs {np.round(warm[n], 5).tolist()})"
              f", cold_ms {c:.5f} (runs {np.round(cold[n], 5).tolist()}); "
              f"{w * 1e-3 * clk * 1e6 * sms / steps:.1f} SM clocks a k32 "
              f"step of new's {steps} at {clk:.0f} MHz, {sms} SMs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
