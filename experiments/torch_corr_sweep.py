"""What bounds the port's mma.sync correlation (K5, K8, K9; K1 runs the
wgmma one of csrc/corr_wgmma.cuh, timed by experiments/torch_k1_ab.py) on
the card: device time of each kernel alone, and of K8 as the batch, the
template's rows and its width move around the flagship shape; the card's
own mma.sync.m16n8k32 s8 rate beside it; and K8 built from variants of
csrc/corr_mma.cuh.

    python3 experiments/torch_corr_sweep.py

Builds the kernels afresh (the build's ptxas lines give each
instantiation's registers and spills), then for each case prints the
kernel's device time (torch.profiler, mean of REPS launches), its
mma.sync.m16n8k32 count, and the SM clocks it spent per mma and SM at
the clock nvidia-smi reads after the case. The rate probe runs
independent mma.sync chains on registers alone (no memory) at 1 and 4
blocks of 512 threads an SM. The variants are patched copies of the
header, each built with match.cu alone into its own library under
_build/, timed in turns with CUDA events. Needs one CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10
SMS = 132


def corr_mma(H: int, W: int, th: int, tw: int) -> int:
    """mma.sync instructions the correlation runs for one image
    (csrc/corr_mma.cuh: 16-wide x tiles, 8-high y tiles, th rows,
    ceil((tw + 15) / 32) k32 steps)."""
    oh, ow = H - th + 1, W - tw + 1
    return -(-ow // 16) * -(-oh // 8) * th * -(-(tw + 15) // 32)


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return float(out.split()[0])


PEAK_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_peak(int* out, int iters) {
  const uint32_t a0 = threadIdx.x, a1 = 3u * threadIdx.x, a2 = 7u, a3 = 11u;
  const uint32_t b0 = 5u * threadIdx.x, b1 = 13u;
  int acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+r"(acc[t][0]), "+r"(acc[t][1]), "+r"(acc[t][2]),
            "+r"(acc[t][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
  for (int t = 0; t < 8; ++t)
    s += acc[t][0] + acc[t][1] + acc[t][2] + acc[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_launch(int* out, int blocks, int threads, int iters,
                               void* stream) {
  mma_peak<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

# the (r, j) loop of warp_tiles in csrc/corr_mma.cuh
LOOP = """  for (int r = 0; r < th; ++r) {
    const uint32_t* trow = sT + r * (g.ts / 4);
    const uint32_t lrow = r * g.ls;
    for (int j = 0; j < g.nj; ++j) {
      const uint32_t* w = trow + 8 * j;
      uint32_t a[4];
      a[1] = __byte_perm(w[0], w[1], sel);  // rows gq + 8, k 4 tq ..
      a[0] = __byte_perm(w[2], w[3], sel);  // rows gq,     k 4 tq ..
      a[3] = __byte_perm(w[4], w[5], sel);  // rows gq + 8, k 16 + 4 tq ..
      a[2] = __byte_perm(w[6], w[7], sel);  // rows gq,     k 16 + 4 tq ..
      const uint32_t off = lrow + 32 * j;
      uint32_t b[kN][2];
#pragma unroll
      for (int t = 0; t < kN; ++t) ldsm_x2(base[t] + off, b[t][0], b[t][1]);
#pragma unroll
      for (int t = 0; t < kN; ++t) mma_s8(acc[t], a, b[t][0], b[t][1]);
    }
  }
"""
# one flat loop over the (r, j) steps, the next step's band words loaded
# before this step's mma
PREFETCH = """  {
    const uint32_t* w = sT;
    uint32_t off = 0;
    int j = 0;
    uint32_t wn[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) wn[q] = w[q];
    for (int s = th * g.nj; s > 0; --s) {
      uint32_t a[4];
      a[1] = __byte_perm(wn[0], wn[1], sel);
      a[0] = __byte_perm(wn[2], wn[3], sel);
      a[3] = __byte_perm(wn[4], wn[5], sel);
      a[2] = __byte_perm(wn[6], wn[7], sel);
      uint32_t b[kN][2];
#pragma unroll
      for (int t = 0; t < kN; ++t) ldsm_x2(base[t] + off, b[t][0], b[t][1]);
      if (++j == g.nj) {
        j = 0;
        w += g.ts / 4 - 8 * (g.nj - 1);
        off += g.ls - 32 * (g.nj - 1);
      } else {
        w += 8;
        off += 32;
      }
      if (s > 1) {
#pragma unroll
        for (int q = 0; q < 8; ++q) wn[q] = w[q];
      }
#pragma unroll
      for (int t = 0; t < kN; ++t) mma_s8(acc[t], a, b[t][0], b[t][1]);
    }
  }
"""
# (name, text in csrc/corr_mma.cuh, its replacement)
VARIANTS = (
    ("j loop unrolled by 2", "    for (int j = 0; j < g.nj; ++j) {",
     "#pragma unroll 2\n    for (int j = 0; j < g.nj; ++j) {"),
    ("band prefetched", LOOP, PREFETCH),
)


def events_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_lib(name: str, files: dict, entry: str, argtypes):
    """Compile the sources ``files`` (name -> text; the .cu ones are
    built) with the port's nvcc flags into _build/sweep/<name>.so."""
    import ctypes

    from meterelf_tpu_torch import _build

    d = _build.BUILD_DIR / "sweep" / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for fname, text in files.items():
        (d / fname).write_text(text)
    cus = [str(d / f) for f in files if f.endswith(".cu")]
    log = _build._compile([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d),
                           *cus], d / "lib.so", name)
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas ({name}):",
                  line.strip().split("ptxas info    : ")[-1])
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def mma_rate() -> None:
    """The card's mma.sync.m16n8k32 s8 rate on registers alone."""
    import ctypes

    import torch

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = build_lib("mma_peak", {"peak.cu": PEAK_SRC}, "mma_peak_launch",
                   [P, I, I, I, P])
    iters = 2048
    for per_sm in (1, 4):
        blocks, threads = SMS * per_sm, 512
        out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            assert fn(out.data_ptr(), blocks, threads, iters, stream) == 0

        ms = events_ms(run, 5)
        n = blocks * threads // 32 * iters * 8
        clk = sm_clock_mhz()
        print(f"mma.sync.m16n8k32 s8 on registers, {per_sm} block(s) of "
              f"{threads} threads an SM: {ms:.6f} ms for {n} mma = "
              f"{n * 4096 * 2 / ms / 1e9:.1f} TOP/s, "
              f"{ms * 1e-3 * clk * 1e6 * SMS / n:.3f} SM clocks per mma "
              f"per SM at {clk:.0f} MHz")


def kernel_ms(fn, name: str) -> float:
    """Mean device time of the kernels whose name holds ``name`` over
    REPS calls of fn (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages() if name in e.key)
    return us / REPS / 1e3


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    from meterelf_tpu_torch import _build, synthetic
    from meterelf_tpu_torch.io import jpeg as tio
    from meterelf_tpu_torch.ops import frontend, match
    from meterelf_tpu_torch.ops.color import (lightness_from_planes,
                                              unpack_planes)
    from meterelf_tpu_torch.pipeline.decode import MeterDecoder

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    lib = _build.library()
    for line in lib.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip().split("ptxas info    : ")[-1])

    dev = torch.device("cuda:0")
    cam = synthetic.DEFAULT_CAMERA
    dec = MeterDecoder(cam.make_params(), device=dev)
    pa = dec.param_arrays
    rng = np.random.default_rng(0)
    crops = cam.render_crops(rng.uniform(0, 10, (256, 4)).tolist())
    packed = torch.as_tensor(tio.pack_crops(crops)).to(dev)
    L = lightness_from_planes(*unpack_planes(packed)).to(torch.float32)
    tm = pa.template_u8
    B, H, W = packed.shape
    th, tw = tm.shape

    def report(label, ms, b, h, w, t_h, t_w):
        n = corr_mma(h, w, t_h, t_w)
        clk = sm_clock_mhz()
        per = ms * 1e-3 * clk * 1e6 * SMS / (b * n)
        print(f"{label}: {ms:.6f} ms, B={b}, {n} mma an image, "
              f"{per:.2f} SM clocks per mma per SM at {clk:.0f} MHz")

    fe_args = (packed, tm, dec.score_c1, dec.score_c0)
    report("K5 frontend_windows", kernel_ms(
        lambda: frontend.frontend_windows(*fe_args, dec.geom, dec.disk,
                                          dec.hue_shift),
        "frontend_kernel<true>"), B, H, W, th, tw)
    report("K8 match_scores", kernel_ms(
        lambda: match.match_scores(L, tm, dec.tmean), "match_kernel<true>"),
        B, H, W, th, tw)
    report("K9 match_corr", kernel_ms(lambda: match.match_corr(L, tm),
                                      "match_kernel<false>"),
           B, H, W, th, tw)
    for b in (66, 132, 133, 264):
        Lb = L.repeat(2, 1, 1)[:b].contiguous()
        report(f"K8 batch {b}", kernel_ms(
            lambda: match.match_scores(Lb, tm, dec.tmean),
            "match_kernel<true>"), b, H, W, th, tw)
    # template rows: the same 132 x 63 offsets, th rows of the template
    for t_h in (1, 15, 30, 60, 119):
        Lr = L[:, :131 + t_h].contiguous()
        tr = tm[:t_h].contiguous()
        report(f"K8 template rows {t_h}", kernel_ms(
            lambda: match.match_scores(Lr, tr, dec.tmean),
            "match_kernel<true>"), B, 131 + t_h, W, t_h, tw)
    # template width: the same 132 x 63 offsets, nj = ceil((tw + 15) / 32)
    for t_w in (17, 49, 113, 188):
        Lw = L[:, :, :62 + t_w].contiguous()
        tr = tm[:, :t_w].contiguous()
        report(f"K8 template width {t_w}", kernel_ms(
            lambda: match.match_scores(Lw, tr, dec.tmean),
            "match_kernel<true>"), B, H, 62 + t_w, th, t_w)
    mma_rate()
    # K8 from the header as it is and from each variant, built alike
    import ctypes

    csrc = _build.CSRC
    files = {f: (csrc / f).read_text() for f in
             ("match.cu", "corr_mma.cuh", "meterelf_kernels.h")}
    sig = _build._SIGNATURES["meterelf_match_scores"]
    libs = {"as committed": build_lib("as committed", files,
                                      "meterelf_match_scores", sig)}
    for name, old, new in VARIANTS:
        assert old in files["corr_mma.cuh"], name
        v = dict(files, **{"corr_mma.cuh": files["corr_mma.cuh"].replace(
            old, new)})
        libs[name] = build_lib(name, v, "meterelf_match_scores", sig)
    tsum = int(tm.to(torch.int64).sum())
    out = torch.empty((B, H - th + 1, W - tw + 1), dtype=torch.float32,
                      device=dev)
    ref = match.match_scores_plain(L, tm, dec.tmean)
    stream = torch.cuda.current_stream().cuda_stream
    times = {k: [] for k in libs}
    order = list(libs)
    for k in order + order[::-1]:
        def run(fn=libs[k]):
            assert fn(L.data_ptr(), B, H, W, tm.data_ptr(), th, tw, tsum,
                      ctypes.c_float(dec.tmean), out.data_ptr(), stream) == 0
        times[k].append(events_ms(run))
        torch.cuda.synchronize()
        assert torch.equal(out, ref), k
    for k in order:
        print(f"K8 {k}: {np.mean(times[k]):.6f} ms (runs "
              f"{np.round(times[k], 6).tolist()}), bit-equal to plain")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
