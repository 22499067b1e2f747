"""Device time of K12 `readout` against other builds of angles.cu, and the
split of its time between its phases, in turns on one card.

    python3 experiments/torch_k12_ab.py [--variant NAME=DIR ...]
                                        [--group NAME=N ...]
                                        [--no-stamps]

"new" is meterelf_tpu_torch/csrc/angles.cu; each --variant another
directory holding an angles.cu with the same C entry (an earlier
commit's, unpacked with `git show REV:meterelf_tpu_torch/csrc/angles.cu`
into the gitignored build/). Each --group is a copy of "new" with its
kGroup (the chunks a lane and the terms a thread loads at once) set to
N. Every
build is built alone (_build.build_source), all at once, and its
ptxas registers and spills are printed for each instantiation of
readout_kernel.

Inputs: chip_smoke.py's B_MAIN flagship crops through K1, K2, K3 and K4
(okey3, keymax), and K6's needle region; every build must equal
readout_plain bit for bit on the okey3 and the region gather, with the
geometry in f64 and in f32. Then each build's C entry on the okey3
gather in f64 (the quad branch's) is timed in turns (builds in order,
then reversed, ROUNDS times) with CUDA events: back to back
(``kernel_ms``) and one launch at a time after a 256 MB read that
empties L2 (``cold_ms``, as the decode finds the geometry after K10).

Unless --no-stamps, a copy of each build with clock64() stamps at its
phase boundaries (gather of the disk, the disk's sum, gather of the
annulus with the minimum angle, the tail and the prefix counts, the
annulus's trimmed sum, the value) is run once warm and once after the
L2 read: the mean SM clocks of each phase over the warps, and the span
of the CTAs' start times on the global timer (a second wave shows as a
start span near the kernel's time). Needs one CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
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
from chip_smoke import B_MAIN, cold_ms, cuda_ms, render  # noqa: E402

REPS = 20
ROUNDS = 3
ENTRIES = ("meterelf_readout",)
NSLOT = 10             # stamps a warp: 7 clocks, 2 global times, the SM
PHASES = ("disk gather", "disk sum", "annulus gather", "tail, prefix",
          "annulus sum", "value")

STAMP_HEAD = r"""
__device__ unsigned long long* g_k12_stamps;
extern "C" int k12_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_k12_stamps, &p, sizeof(p));
}
__device__ __forceinline__ unsigned long long k12_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned k12_smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}
#define K12_SLOT(k) g_k12_stamps[((size_t)blockIdx.x * (blockDim.x >> 5) + \
                                  (threadIdx.x >> 5)) * 10 + (k)]
#define K12_STAMP(k) do { if ((threadIdx.x & 31) == 0 && g_k12_stamps) \
    K12_SLOT(k) = clock64(); } while (0)
#define K12_TIME(k) do { if ((threadIdx.x & 31) == 0 && g_k12_stamps) { \
    K12_SLOT(k) = k12_gtime(); K12_SLOT(9) = k12_smid(); } } while (0)
"""

# (stamp, text it goes before): the first text found once in a source is
# used, so that one table serves the one-warp and the several-warp kernel
STAMPS = (
    ("K12_TIME(7); K12_STAMP(0);",
     ("  const int lane = threadIdx.x & 31, d = threadIdx.x >> 5;\n",
      "  const int W = warps_of(D), T32 = W * 32;\n")),
    ("K12_STAMP(1);",
     ("  const double2 mom = tree_sum2(",
      "  for (int r = t; r < first_runs(n_disk); r += T32) {\n")),
    ("K12_STAMP(2);", ("  const double sign = (double)g.neg_sign[d];\n",)),
    ("K12_STAMP(3);", ("  // kept slots more than 0.75 turn past the first",)),
    ("K12_STAMP(4);", ("  const int cut = n >= 5",)),
    ("K12_STAMP(5);", ("  const double mean = __ddiv_rn(",)),
    ("K12_STAMP(6); K12_TIME(8);",
     ("    value[blockIdx.x] = v;\n  }\n}\n",)),
)


def patch_once(text: str, old: str, new: str, what: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"{what}: the source holds {old!r} "
                         f"{text.count(old)} times, not once")
    return text.replace(old, new)


def stamped(text: str) -> str:
    text = patch_once(text, '#include "meterelf_kernels.h"\n',
                      '#include "meterelf_kernels.h"\n' + STAMP_HEAD,
                      "stamps")
    for stamp, anchors in STAMPS:
        found = [a for a in anchors if text.count(a) == 1]
        if not found:
            raise ValueError(f"no place for {stamp} in the source")
        a = found[0]
        if stamp.startswith("K12_STAMP(6)"):
            text = text.replace(a, a[:-2] + "  " + stamp + "\n}\n")
        else:
            text = text.replace(a, "  " + stamp + "\n" + a)
    return text


def with_group(text: str, group: str) -> str:
    text, n = re.subn(r"constexpr int kGroup = \d+;",
                      f"constexpr int kGroup = {int(group)};", text)
    if n != 1:
        raise ValueError(f"--group: the source holds kGroup {n} times")
    return text


def ptxas_lines(log: str):
    """(entry, registers and spills) of each readout_kernel instance."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if "readout_kernel" in m.group(1) else None
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            out.append((entry, line.split("Used")[-1].strip() + "; "
                        + spill))
            entry = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--group", action="append", default=[])
    ap.add_argument("--no-stamps", action="store_true")
    args = ap.parse_args()

    import torch

    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.ops import angles, ccl, frontend, stats, windows
    from meterelf_tpu_torch.pipeline.decode import MeterDecoder

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    out = Path(_build.BUILD_DIR) / "k12_ab"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    texts = {"new": (_build.CSRC / "angles.cu").read_text()}
    for v in args.variant:
        name, d = v.split("=", 1)
        texts[name] = (Path(d) / "angles.cu").read_text()
    for g in args.group:
        name, group = g.split("=", 1)
        texts[name] = with_group(texts["new"], group)
    sources = {}
    for name, text in texts.items():
        sources[name] = text
        if not args.no_stamps:
            sources[name + "+stamps"] = stamped(text)

    def build(item):
        name, text = item
        tag = re.sub(r"\W", "_", name)
        path = out / f"angles_{tag}.cu"
        path.write_text(text)
        return name, _build.build_source(path, "k12ab_" + tag, ENTRIES)

    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(ex.map(build, sources.items()))
    for name, lib in libs.items():
        print(f"{name}: nvcc {lib.build_seconds:.1f} s")
        for entry, regs in ptxas_lines(lib.build_log):
            print(f"  ptxas {entry}: {regs}")

    dev = torch.device("cuda:0")
    cam = synthetic.DEFAULT_CAMERA
    dec = MeterDecoder(cam.make_params(), device=dev)
    fast = MeterDecoder(cam.make_params(), device=dev, exact=False)
    crops, _ = render(cam, B_MAIN, 1.7, 2.3)
    packed = torch.as_tensor(tio.pack_crops(crops)).to(dev)
    pa = dec.param_arrays
    mx, my = frontend.frontend(packed, pa.template_u8, dec.score_c1,
                               dec.score_c0)[1:]
    bits = windows.windows(packed, mx, my, dec.geom, dec.disk,
                           dec.hue_shift).reshape(-1, 64, 64)
    D = len(dec.geom)
    okey3 = ccl.ccl(bits)[0]
    km = stats.stats(okey3)[0].reshape(B_MAIN, D)
    okey3 = okey3.reshape(B_MAIN, D, -1)
    region = ccl.analyze_batch(
        bits, dec.static_kwargs["static_bbox"]).needle_region.reshape(
            B_MAIN, D, -1)
    cases = {"okey3 f64": (okey3, km, pa),
             "okey3 f32": (okey3, km, fast.param_arrays),
             "region f64": (region, None, pa),
             "region f32": (region, None, fast.param_arrays)}

    def bits_of(t):
        return t.view(torch.int64) if t.is_floating_point() else t

    ok = True
    for label, (src, k, p) in cases.items():
        ref = angles.readout_plain(src, k, p)
        for name, lib in libs.items():
            a, o = angles.c_args(src, k, p)
            assert lib.meterelf_readout(*a) == 0, f"{name}: launch failed"
            torch.cuda.synchronize()
            same = all(torch.equal(bits_of(x), bits_of(y))
                       for x, y in zip(o, ref))
            ok &= same
            print(f"{name} {label}: equal to readout_plain: {same}")
    if not ok:
        return 1

    calls = {}
    keep = []
    for name, lib in libs.items():
        if name.endswith("+stamps"):
            continue
        a, o = angles.c_args(okey3, km, pa)
        keep.append(o)
        calls[name] = (lambda lib=lib, a=a: lib.meterelf_readout(*a))
    flush = torch.zeros(1 << 28, dtype=torch.uint8, device=dev)
    warm = {n: [] for n in calls}
    cold = {n: [] for n in calls}
    order = list(calls)
    for _ in range(ROUNDS):
        for seq in (order, order[::-1]):
            for n in seq:
                warm[n].append(cuda_ms(calls[n], REPS))
                cold[n].append(cold_ms(calls[n], REPS, flush))
    for n in order:
        w, c = float(np.median(warm[n])), float(np.median(cold[n]))
        print(f"{n}: kernel_ms {w:.6f} (runs {np.round(warm[n], 6).tolist()})"
              f", cold_ms {c:.6f} (runs {np.round(cold[n], 6).tolist()})")

    for name, lib in libs.items():
        if not name.endswith("+stamps"):
            continue
        fn = lib.lib.k12_set_stamps
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        a, o = angles.c_args(okey3, km, pa)
        for state in ("warm", "cold"):
            for _ in range(3):     # the last of three launches is read
                stamps = torch.zeros(B_MAIN * 16 * NSLOT, dtype=torch.int64,
                                     device=dev)
                assert fn(stamps.data_ptr()) == 0
                if state == "cold":
                    flush.max()
                assert lib.meterelf_readout(*a) == 0
                torch.cuda.synchronize()
            assert fn(None) == 0
            s = stamps.view(-1, NSLOT).cpu().numpy()
            s = s[s[:, 8] > 0]                   # warps of the launch
            clk = np.diff(s[:, :7].astype(np.float64), axis=1)
            tot = clk.sum(1).mean()
            split = ", ".join(f"{p} {c:.0f} ({100 * c / tot:.0f} %)"
                              for p, c in zip(PHASES, clk.mean(0)))
            t0 = s[:, 7].min()
            print(f"{name} {state}: {len(s)} warps on "
                  f"{len(np.unique(s[:, 9]))} SMs; SM clocks a warp "
                  f"{tot:.0f}: {split}; CTA starts span "
                  f"{(s[:, 7].max() - t0) / 1e3:.2f} us, last end "
                  f"{(s[:, 8].max() - t0) / 1e3:.2f} us after the first "
                  "start")
    return 0


if __name__ == "__main__":
    sys.exit(main())
