"""Device time of K11 `upsample_color_pack` (csrc/jpeg.cu) against other
builds of the same C interface and against the card's write floor for its
output, in turns on one card.

    python3 experiments/torch_k11_ab.py [--variant NAME=PATH/jpeg.cu ...]
                                        [--probe NAME=PATH/jpeg.cu ...]
                                        [--k10]

Builds csrc/jpeg.cu alone ("new"), each --variant (another jpeg.cu of the
same C interface: the parent's, unpacked with `git show
HEAD:meterelf_tpu_torch/csrc/jpeg.cu > build/parent_jpeg.cu` into the
gitignored build/) and "store", a kernel of K11's C entry that writes
the [B, PH, PW] i32 output as zeros with 16-byte stores and reads
nothing: the card's floor for K11's 64 MB write. Each --probe is a
jpeg.cu of the same C interface that is timed beside them but not held
to the plain version: a copy of K11 patched by text to leave out one
phase (its colour, its stores, its global loads), to see what that phase
costs. All are built at once
with _build.build_source; the ptxas lines give each build's registers,
spills and shared memory (torch_k10_ab.report_ptxas).

Inputs: chip_smoke.py's flagship block feed (B_MAIN quality-92 JPEGs,
N_DISTINCT distinct, through io.jpeg.load_coef_feed_shard and the plain
IDCT jpegdec.idct_planes: the planes K11 takes in a decode) and ALT's,
and random planes on the windows only K11 takes (chip_smoke.K11_WINDOWS:
past the valid chroma rows, past the valid chroma columns, 4,960
columns wide). Each jpeg.cu build must equal the plain version
(ops/jpegdec.tail_to_packed) on all of them first. Then, on the flagship
feed, in turns (builds in order, then reversed, ROUNDS times: 10 runs
of each), each build's C entry is timed with CUDA events over REPS
launches back to back (``kernel_ms``: the 26.7 MB of planes stay in the
50 MB L2), one launch at a time after a 256 MB read that empties L2
(``cold_ms``: what a decode sees, the one to hold against the bound),
and, for jpeg.cu builds, through the wrapper
ops/jpeg_tail.upsample_color_pack with the build swapped in as the
port's library (``ms``). With --k10 each jpeg.cu build's K10 C entry is
timed as well on the flagship compact feed (``k10_kernel_ms``,
``k10_cold_ms``), after a check against its plain version. Needs one
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))
from chip_smoke import (B_ALT, B_MAIN, DEVICE, FEED_THREADS,  # noqa: E402
                        FRAME_WH, K11_WINDOWS, N_DISTINCT, cold_ms, cuda_ms,
                        encode_frames, k11_random_planes, k11_window,
                        render, tiled_jpegs)
from torch_k10_ab import report_ptxas  # noqa: E402

K11 = "meterelf_upsample_color_pack"
K10 = "meterelf_backhalf_planes"
REPS = 20
ROUNDS = 5

# K11's C entry, writing zeros over the output and reading nothing
STORE_ONLY = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256) store_only_kernel(int4* out,
                                                         size_t n4) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * 256)
    out[i] = make_int4(0, 0, 0, 0);
}

extern "C" int meterelf_upsample_color_pack(const uint8_t*, const uint8_t*,
                                            const uint8_t*, int B,
                                            const int32_t* geom,
                                            int32_t* out, void* stream) {
  const size_t n = (size_t)B * geom[8] * geom[9];
  if (n % 4) return (int)cudaErrorInvalidValue;
  store_only_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (int4*)out, n / 4);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another jpeg.cu with the same C interface")
    ap.add_argument("--probe", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a jpeg.cu timed but not checked (a phase probe)")
    ap.add_argument("--k10", action="store_true",
                    help="also time each jpeg.cu build's K10 C entry")
    args = ap.parse_args()
    import torch

    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.ops import jpeg_tail, jpegdec
    from meterelf_tpu_torch.pipeline.decode import (MeterDecoder,
                                                    make_coef_decode_fn)

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device(DEVICE)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    store = _build.BUILD_DIR / "k11_store_only.cu"
    store.write_text(STORE_ONLY)
    sources = {"new": _build.CSRC / "jpeg.cu"}
    sources.update((k, Path(v)) for k, v in
                   (s.split("=", 1) for s in args.variant))
    jpeg_builds = list(sources)
    sources.update((k, Path(v)) for k, v in
                   (s.split("=", 1) for s in args.probe))
    sources["store"] = store

    def build(name):
        entries = (K11,) if name == "store" else (K11, K10)
        return _build.build_source(sources[name], f"k11_{name}", entries)

    with ThreadPoolExecutor(len(sources)) as pool:
        futs = {n: pool.submit(build, n) for n in sources}
        libs = {n: f.result() for n, f in futs.items()}
    for name, lib in libs.items():
        print(f"{name}: built in {lib.build_seconds:.1f} s "
              f"from {sources[name]}")
        report_ptxas(name, lib)

    # the flagship and ALT block feeds through the plain IDCT, and the
    # flagship compact feed for K10
    feeds, k10_feed = {}, None
    for label, cam, n in (("flagship", synthetic.DEFAULT_CAMERA, B_MAIN),
                          ("alt", synthetic.ALT_CAMERA, B_ALT)):
        _, pos = render(cam, n, *((1.7, 2.3) if label == "flagship"
                                  else (2.1, 1.3)))
        datas = (tiled_jpegs(cam, pos, N_DISTINCT, n)[1]
                 if label == "flagship" else encode_frames(cam, pos))
        _, win, pad_hw = make_coef_decode_fn(
            MeterDecoder(cam.make_params(), device=dev), FRAME_WH)
        block = tio.load_coef_feed_shard(
            datas, tuple(win), False, cam.meter_rect, FRAME_WH, pad_hw,
            num_threads=FEED_THREADS)
        if not block[4].all():
            raise RuntimeError(f"{label}: frames not loaded")
        planes = jpegdec.idct_planes(
            *(torch.as_tensor(a).to(dev) for a in block[:4]), win)
        feeds[label] = (planes, win, pad_hw)
        if label == "flagship" and args.k10:
            feed = tio.load_coef_feed(datas, cam.meter_rect, FRAME_WH,
                                      pad_hw, num_threads=FEED_THREADS)
            k10_feed = ([torch.as_tensor(a).to(dev) for a in feed[:4]],
                        win, pad_hw)
    rng = np.random.default_rng(10)
    for label in K11_WINDOWS:
        win, pad_hw = k11_window(label)
        planes = k11_random_planes(win, 4, rng, dev)
        feeds[label] = (planes, win, pad_hw)
    print(f"flagship window {feeds['flagship'][1]}, staging "
          f"{feeds['flagship'][2]}; planes "
          f"{[tuple(p.shape) for p in feeds['flagship'][0]]}")

    loaded = _build._LOADED
    for fname, (planes, win, pad_hw) in feeds.items():
        ref = jpegdec.tail_to_packed(*planes, win, pad_hw)
        for name in jpeg_builds:
            a, out = jpeg_tail.upsample_c_args(*planes, win, pad_hw)
            if getattr(libs[name], K11)(*a) != 0:
                raise RuntimeError(f"{name} {fname}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"{name} {fname}: differs from the "
                                     "plain version")
    print(f"every jpeg.cu build equal to the plain version on "
          f"{', '.join(feeds)}")
    if k10_feed is not None:
        ref10 = jpegdec.backhalf_planes_to_packed(*k10_feed[0], *k10_feed[1:])
        for name in jpeg_builds:
            a, out = jpeg_tail.backhalf_c_args(*k10_feed[0], *k10_feed[1:])
            if getattr(libs[name], K10)(*a) != 0:
                raise RuntimeError(f"{name} K10: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(out, ref10):
                raise AssertionError(f"{name} K10: differs from plain")
        print("every jpeg.cu build's K10 equal to its plain version")

    planes, win, pad_hw = feeds["flagship"]
    calls = {}
    for name, lib in libs.items():
        a, _ = jpeg_tail.upsample_c_args(*planes, win, pad_hw)
        fn = getattr(lib, K11)
        calls[(name, "kernel_ms")] = calls[(name, "cold_ms")] = (
            lambda fn=fn, a=a: fn(*a))
        if name in jpeg_builds:
            def wrapper(lib=lib):
                loaded[:] = [lib]
                return jpeg_tail.upsample_color_pack(*planes, win, pad_hw)
            calls[(name, "ms")] = wrapper
            if k10_feed is not None:
                a10, _ = jpeg_tail.backhalf_c_args(*k10_feed[0],
                                                   *k10_feed[1:])
                fn10 = getattr(lib, K10)
                calls[(name, "k10_kernel_ms")] = calls[
                    (name, "k10_cold_ms")] = (lambda fn=fn10, a=a10: fn(*a))
    flush = torch.zeros(1 << 28, dtype=torch.uint8, device=dev)
    times = {k: [] for k in calls}
    names = list(libs)
    for _ in range(ROUNDS):
        for order in (names, names[::-1]):
            for name in order:
                for key, fn in calls.items():
                    if key[0] == name:
                        times[key].append(
                            cold_ms(fn, REPS, flush)
                            if key[1].endswith("cold_ms")
                            else cuda_ms(fn, REPS))
    loaded.clear()
    out_mb = planes[0].shape[0] * pad_hw[0] * pad_hw[1] * 4 / 1e6
    in_mb = sum(p.numel() for p in planes) / 1e6
    print(f"flagship: {in_mb:.1f} MB of planes in, {out_mb:.1f} MB out "
          f"(B={planes[0].shape[0]})")
    for (name, what), t in times.items():
        print(f"{name:10s} {what:13s} median {np.median(t):.6f} ms "
              f"mean {np.mean(t):.6f} runs {np.round(t, 6).tolist()}")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
