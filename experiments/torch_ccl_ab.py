"""Device time of the port's CCL kernels (K3 `ccl`, K6 `propagate`,
csrc/ccl.cu) against other builds of the same C interface, in turns on
one card.

    python3 experiments/torch_ccl_ab.py [--variant NAME=PATH/ccl.cu ...]

Builds csrc/ccl.cu alone into its own library under _build/ ("new") and
each --variant, another ccl.cu of the same C interface (an earlier
commit's, unpacked with `git show REV:meterelf_tpu_torch/csrc/ccl.cu`, or
a patched copy, into the gitignored build/), with _build.build_source;
the build's ptxas lines give each one's registers, spills and shared
memory. Makes the windows of the main paths with the port's K1 and K2
(chip_smoke.window_bits): 256 flagship crops (1024 windows), the same
crops with chip_smoke's 1 % speckle, 256 FIVE_DIAL_CAMERA crops (1280
windows). Each build's K3 and K6 must equal
the plain version (components.propagate) on every window set; then each
is timed with CUDA events over REPS back-to-back launches of its C entry
under the default caps, in turns (variants in order, then reversed,
ROUNDS times). Last, "new" alone on the flagship windows (the first
132, one a SM, then all) under caps that stop each phase early
(CAPS_SWEEP): what a label or an outside pass costs, alone on an SM and
with the SM full. Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import cuda_ms, speckle, window_bits  # noqa: E402

ENTRIES = ("meterelf_ccl", "meterelf_propagate")
REPS = 20
ROUNDS = 2
CAPS_SWEEP = ((0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0), (4, 0, 0),
              (6, 0, 0), (10, 0, 0), (0, 1, 0), (0, 2, 0), (0, 3, 0),
              (0, 6, 0), (10, 6, 8))


def build(name: str, source: str):
    from meterelf_tpu_torch import _build

    lib = _build.build_source(source, f"ccl_{name}", ENTRIES)
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  {name} ptxas: {line.strip()}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another ccl.cu with the same C interface")
    args = ap.parse_args()
    import torch

    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.ops import ccl, components
    from meterelf_tpu_torch.pipeline.decode import MeterDecoder

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    sources = {"new": str(_build.CSRC / "ccl.cu")}
    sources.update(v.split("=", 1) for v in args.variant)
    libs = {name: build(name, path) for name, path in sources.items()}

    def windows_of(dec, crops):
        return window_bits(dec, torch.as_tensor(tio.pack_crops(crops)).to(dev))

    cam, five = synthetic.DEFAULT_CAMERA, synthetic.FIVE_DIAL_CAMERA
    crops = cam.render_crops(synthetic.dial_positions(256, 1.7, 2.3))
    dec = MeterDecoder(cam.make_params(), device=dev)
    five_dec = MeterDecoder(five.make_params(), device=dev)
    sets = {
        "flagship": windows_of(dec, crops),
        "speckled": windows_of(dec, speckle(crops)),
        "five_dial": windows_of(
            five_dec, five.render_crops(synthetic.dial_positions(
                256, 1.3, 1.9, len(five.dial_specs)))),
    }
    calls = {}
    for wname, bits in sets.items():
        K = bits.shape[0]
        for entry, pack in zip(ENTRIES, (True, False)):
            ref = components.propagate(bits, pack_closed=pack)
            for name, lib in libs.items():
                okey = torch.empty_like(bits)
                conv = torch.empty(K, dtype=torch.uint8, device=dev)
                fn = getattr(lib, entry)
                a = ccl.c_args(bits, None, okey, conv)
                if fn(*a) != 0:
                    raise RuntimeError(f"{name} {entry}: launch failed")
                torch.cuda.synchronize()
                if not (torch.equal(okey, ref[0])
                        and torch.equal(conv.bool(), ref[1])):
                    raise AssertionError(f"{name} {entry} {wname}: differs "
                                         "from the plain version")
                calls[(wname, entry, name)] = (fn, a, okey, conv)
    print("every build equal to the plain version on every window set")

    times = {k: [] for k in calls}
    names = list(libs)
    for _ in range(ROUNDS):
        for order in (names, names[::-1]):
            for name in order:
                for key, (fn, a, _, _) in calls.items():
                    if key[2] != name:
                        continue
                    times[key].append(cuda_ms(lambda: fn(*a), REPS))
    for (wname, entry, name), t in times.items():
        print(f"{wname:9s} {entry:18s} {name:16s} "
              f"K={sets[wname].shape[0]} mean {np.mean(t):.6f} ms "
              f"runs {np.round(t, 6).tolist()}")
    fn, a, okey, conv = calls[("flagship", "meterelf_ccl", "new")]
    for K in (132, sets["flagship"].shape[0]):
        bits = sets["flagship"][:K]
        for caps in CAPS_SWEEP:
            ka = ccl.c_args(bits, caps, okey, conv)
            ms = [cuda_ms(lambda: fn(*ka), REPS) for _ in range(2)]
            ref = components.propagate(bits, caps)
            if not (torch.equal(okey[:K], ref[0])
                    and torch.equal(conv[:K].bool(), ref[1])):
                raise AssertionError(f"new under caps {caps}: differs")
            print(f"caps {caps}: K3 new, {K} flagship windows, "
                  f"{np.mean(ms):.6f} ms (runs {np.round(ms, 6).tolist()})")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
