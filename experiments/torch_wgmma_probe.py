"""Two questions about Hopper's warpgroup int8 product that K1's wgmma
correlation (csrc/corr_wgmma.cuh) rests on, asked of the card.

    python3 experiments/torch_wgmma_probe.py

1. The descriptor. B is L' stored in 16-byte column chunks, byte (s, k)
   of L' at (k / 16) * CH + 16 * s + k % 16, so that every no-swizzle
   core matrix (8 rows of 16 bytes) is 128 contiguous bytes whatever the
   row shift. B_r[k, y] = L'[y + r, k] is then a K-major no-swizzle
   descriptor that starts 16 * r bytes into the chunk, with SBO = 128
   (the next 8 rows) and LBO = CH (the next 16 bytes of k). For r = 0..7
   and N = 16, 128, 144 and 208, one wgmma.mma_async.m64nNk32.s32.s8.s8
   with A from registers is checked against numpy's sums, with LBO and
   SBO as above (and swapped at N = 16: only one order can be right).
2. The rate. A loop of such products, A rebuilt in registers before
   each from 8 shared words and 4 byte permutes as K1 does, double
   buffered (wgmma.wait_group 1), at 1 and 2 warpgroups a block and 1
   and 2 blocks an SM: SM clocks per k32 step and TOP/s, for one m64n144
   against m64n128 + m64n16, and m64n64 and m64n208 beside them; then
   m64n128 + m64n16 with 3 and 4 band buffers (wait_group 2 and 3), and
   with one band built once and no wait in the loop (the tensor cores'
   own rate on register A).

Prints the int8 N that CUTLASS's headers name (where present), ptxas's
registers and any wgmma serialisation warning. Needs one CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132


def wgmma_src(n: int) -> str:
    """An inline-PTX m64n{n}k32 s8 product, A from 4 registers."""
    nr = n // 2
    outs = ", ".join(f"%{i}" for i in range(nr))
    d = ", ".join(f'"+r"(d[{i}])' for i in range(nr))
    return f"""
__device__ __forceinline__ void wgmma_n{n}(int* d, const uint32_t* a,
                                           uint64_t desc) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nr + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
      "{{{outs}}}, {{%{nr}, %{nr + 1}, %{nr + 2}, %{nr + 3}}}, "
      "%{nr + 4}, p;\\n}}\\n"
      : {d}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}}
"""


NS = (16, 64, 128, 144, 208)

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
""" + "".join(wgmma_src(n) for n in NS) + r"""
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
__device__ __forceinline__ void pin(int& x) {
  asm volatile("" : "+r"(x)::"memory");
}
__device__ __forceinline__ uint64_t bdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

template <int N>
__device__ __forceinline__ void product(int* d, const uint32_t* a,
                                        uint64_t desc) {
  if constexpr (N == 16) wgmma_n16(d, a, desc);
  if constexpr (N == 64) wgmma_n64(d, a, desc);
  if constexpr (N == 128) wgmma_n128(d, a, desc);
  if constexpr (N == 144) wgmma_n144(d, a, desc);
  if constexpr (N == 208) wgmma_n208(d, a, desc);
  if constexpr (N == 128 + 1) {  // m64n128 then m64n16 on the next rows
    wgmma_n128(d, a, desc);
    wgmma_n16(d + 64, a, desc + (128 * 16 >> 4));
  }
}

// one warpgroup: D[64, N] = A[64, 32] x B_r, B_r[k, y] = L[y + r, k]
template <int N>
__global__ void desc_test(const int8_t* A, const int8_t* L, int S, int CH,
                          int r, int swap, int* D) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NN = N == 129 ? 144 : N;
  const int tid = threadIdx.x;
  for (int i = tid; i < S * 32; i += 128) {
    const int s = i / 32, k = i % 32;
    smem[(k / 16) * CH + 16 * s + k % 16] = (unsigned char)L[i];
  }
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const int w = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const uint32_t* A32 = reinterpret_cast<const uint32_t*>(A);
  uint32_t a[4];
  a[0] = A32[(16 * w + gq) * 8 + tq];
  a[1] = A32[(16 * w + gq + 8) * 8 + tq];
  a[2] = A32[(16 * w + gq) * 8 + 4 + tq];
  a[3] = A32[(16 * w + gq + 8) * 8 + 4 + tq];
  int d[NN / 2];
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) d[i] = 0;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem) + 16 * r;
  const uint64_t desc = swap ? bdesc(base, 128, CH) : bdesc(base, CH, 128);
  wg_fence();
  product<N>(d, a, desc);
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) pin(d[i]);
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) {
    const int row = 16 * w + gq + 8 * ((i & 3) >> 1);
    const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
    D[row * NN + col] = d[i];
  }
}

// the loop's rate: per warpgroup `steps` k32 products, A rebuilt before
// each from 8 shared words and 4 byte permutes, double buffered
template <int N>
__global__ void rate(int steps, int CH, int* out, long long* clk) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NN = N == 129 ? 144 : N;
  const int tid = threadIdx.x;
  uint32_t* sT = reinterpret_cast<uint32_t*>(smem + 16 * CH + 4096);
  for (int i = tid; i < 2048; i += blockDim.x) sT[i] = i * 2654435761u;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const long long t0 = clock64();
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)((-gq) & 3);
  const uint32_t* tw = sT + ((tid >> 5) & 3) * 4 + tq;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  int d[NN / 2];
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) d[i] = 0;
  uint32_t a0[4], a1[4];
  auto build = [&](uint32_t* a, int s) {
    const uint32_t* w = tw + 8 * (s & 127);
    a[1] = __byte_perm(w[0], w[1], sel);
    a[0] = __byte_perm(w[2], w[3], sel);
    a[3] = __byte_perm(w[4], w[5], sel);
    a[2] = __byte_perm(w[6], w[7], sel);
  };
  auto desc = [&](int s) {
    return bdesc(base + (s & 15) * CH + 16 * ((s >> 4) % 119), CH, 128);
  };
  build(a0, 0);
  for (int s = 0; s < steps; s += 2) {
    wg_fence();
    product<N>(d, a0, desc(s));
    wg_commit();
    wg_wait<1>();
    build(a1, s + 1);
    wg_fence();
    product<N>(d, a1, desc(s + 1));
    wg_commit();
    wg_wait<1>();
    build(a0, s + 2);
  }
  wg_wait<0>();
  int sum = 0;
#pragma unroll
  for (int i = 0; i < NN / 2; ++i) {
    pin(d[i]);
    sum += d[i];
  }
  out[blockIdx.x * blockDim.x + tid] = sum;
  if (tid == 0) clk[blockIdx.x] = clock64() - t0;
}

// the same loop with D band buffers: after step t's issue, wait until at
// most D - 1 products are in flight, then build step t + 1's band
// (D = 2 is rate<129>); D = 0: one band built once, no wait in the loop
template <int D>
__global__ void rate_depth(int steps, int CH, int* out, long long* clk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  uint32_t* sT = reinterpret_cast<uint32_t*>(smem + 16 * CH + 4096);
  for (int i = tid; i < 2048; i += blockDim.x) sT[i] = i * 2654435761u;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const long long t0 = clock64();
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)((-gq) & 3);
  const uint32_t* tw = sT + ((tid >> 5) & 3) * 4 + tq;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  int d[72];
#pragma unroll
  for (int i = 0; i < 72; ++i) d[i] = 0;
  auto build = [&](uint32_t* a, int s) {
    const uint32_t* w = tw + 8 * (s & 127);
    a[1] = __byte_perm(w[0], w[1], sel);
    a[0] = __byte_perm(w[2], w[3], sel);
    a[3] = __byte_perm(w[4], w[5], sel);
    a[2] = __byte_perm(w[6], w[7], sel);
  };
  auto desc = [&](int s) {
    return bdesc(base + (s & 15) * CH + 16 * ((s >> 4) % 119), CH, 128);
  };
  if constexpr (D == 0) {
    uint32_t a[4];
    build(a, 0);
    wg_fence();
    for (int s = 0; s < steps; ++s) {
      product<129>(d, a, desc(s));
      wg_commit();
    }
  } else {
    uint32_t a[D][4];
    build(a[0], 0);
    for (int s = 0; s < steps; s += D) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        wg_fence();
        product<129>(d, a[i], desc(s + i));
        wg_commit();
        wg_wait<D - 1>();
        build(a[(i + 1) % D], s + i + 1);
      }
    }
  }
  wg_wait<0>();
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 72; ++i) {
    pin(d[i]);
    sum += d[i];
  }
  out[blockIdx.x * blockDim.x + tid] = sum;
  if (tid == 0) clk[blockIdx.x] = clock64() - t0;
}

template <int D>
int run_depth(int blocks, int threads, int smem, int steps, int CH, int* out,
              long long* clk) {
  cudaFuncSetAttribute(rate_depth<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rate_depth<D><<<blocks, threads, smem>>>(steps, CH, out, clk);
  return (int)cudaGetLastError();
}

template <int N>
int run_desc(const int8_t* A, const int8_t* L, int S, int CH, int r,
             int swap, int* D) {
  const int bytes = 2 * CH + 1024;
  cudaFuncSetAttribute(desc_test<N>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  desc_test<N><<<1, 128, bytes>>>(A, L, S, CH, r, swap, D);
  return (int)cudaGetLastError();
}

template <int N>
int run_rate(int blocks, int threads, int smem, int steps, int CH, int* out,
             long long* clk) {
  cudaFuncSetAttribute(rate<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  rate<N><<<blocks, threads, smem>>>(steps, CH, out, clk);
  return (int)cudaGetLastError();
}

extern "C" int probe_desc(int n, const int8_t* A, const int8_t* L, int S,
                          int CH, int r, int swap, int* D) {
  switch (n) {
    case 16: return run_desc<16>(A, L, S, CH, r, swap, D);
    case 128: return run_desc<128>(A, L, S, CH, r, swap, D);
    case 129: return run_desc<129>(A, L, S, CH, r, swap, D);
    case 144: return run_desc<144>(A, L, S, CH, r, swap, D);
    case 208: return run_desc<208>(A, L, S, CH, r, swap, D);
  }
  return -1;
}

extern "C" int probe_rate(int n, int blocks, int threads, int smem,
                          int steps, int CH, int* out, long long* clk) {
  switch (n) {
    case 64: return run_rate<64>(blocks, threads, smem, steps, CH, out, clk);
    case 129: return run_rate<129>(blocks, threads, smem, steps, CH, out, clk);
    case 144: return run_rate<144>(blocks, threads, smem, steps, CH, out, clk);
    case 208: return run_rate<208>(blocks, threads, smem, steps, CH, out, clk);
    case 1000: return run_depth<0>(blocks, threads, smem, steps, CH, out, clk);
    case 1003: return run_depth<3>(blocks, threads, smem, steps, CH, out, clk);
    case 1004: return run_depth<4>(blocks, threads, smem, steps, CH, out, clk);
  }
  return -1;
}
"""


def build():
    sys.path.insert(0, ROOT)
    from meterelf_tpu_torch import _build

    d = _build.BUILD_DIR / "probe"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe.cu").write_text(SRC)
    log = _build._compile([_build._nvcc(), *_build.NVCC_FLAGS,
                           str(d / "probe.cu")], d / "probe.so", "probe")
    for line in log.splitlines():
        if ("Used" in line or "spill" in line or "wgmma" in line
                or "arning" in line):
            print("  ptxas:", line.strip().split("ptxas info    : ")[-1])
    lib = ctypes.CDLL(str(d / "probe.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_desc.argtypes = [I, P, P, I, I, I, I, P]
    lib.probe_rate.argtypes = [I, I, I, I, I, I, P, P]
    return lib


def cutlass_int8_ns() -> None:
    names = set()
    arch = "/usr/local/cutlass/include/cute/arch"
    for f in glob.glob(f"{arch}/mma_sm90_gmma*.hpp"):
        with open(f) as fh:
            names.update(re.findall(r"MMA_64x(\d+)x32_S32S8S8_RS_TN\b",
                                    fh.read()))
    print("CUTLASS int8 RS shapes, N:",
          sorted(int(n) for n in names) or "headers not found")


def desc_checks(lib, torch) -> bool:
    rng = np.random.default_rng(7)
    ok = True
    for n in (16, 128, 129, 144, 208):
        nn = 144 if n == 129 else n
        S = nn + 8
        CH = 16 * S + 16
        A = rng.integers(-128, 128, (64, 32), dtype=np.int8)
        L = rng.integers(-128, 128, (S, 32), dtype=np.int8)
        At, Lt = torch.as_tensor(A).cuda(), torch.as_tensor(L).cuda()
        # swapped, only at N = 16: a wrong order reads past the buffer
        for swap in ((0, 1) if n == 16 else (0,)):
            good = []
            for r in range(8):
                D = torch.zeros((64, nn), dtype=torch.int32, device="cuda")
                rc = lib.probe_desc(n, At.data_ptr(), Lt.data_ptr(), S, CH,
                                    r, swap, D.data_ptr())
                torch.cuda.synchronize()
                want = A.astype(np.int64) @ L[r:r + nn].astype(np.int64).T
                good.append(rc == 0 and np.array_equal(D.cpu().numpy(), want))
            label = "n128+n16" if n == 129 else f"n{n}"
            order = "LBO=128, SBO=CH" if swap else "LBO=CH, SBO=128"
            print(f"descriptor {label} {order}: r = 0..7 equal to the "
                  f"plain sums: {good}")
            if not swap:
                ok = ok and all(good)
    return ok


def rates(lib, torch) -> None:
    clk_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    CH = 16 * 260 + 16
    steps = 4096 - 4096 % 12
    for n in (144, 129, 64, 208, 1003, 1004, 1000):
        nn = 144 if n in (129, 1000, 1003, 1004) else n
        for wgs in (1, 2):
            for per_sm in (1, 2):
                smem = 100 * 1024 if per_sm == 2 else 150 * 1024
                blocks, threads = SMS * per_sm, 128 * wgs
                out = torch.empty(blocks * threads, dtype=torch.int32,
                                  device="cuda")
                clk = torch.empty(blocks, dtype=torch.int64, device="cuda")
                args = (n, blocks, threads, smem, steps, CH, out.data_ptr(),
                        clk.data_ptr())
                assert lib.probe_rate(*args) == 0
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(3):
                    lib.probe_rate(*args)
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1) / 3
                k = blocks * wgs * steps
                tops = k * 64 * nn * 32 * 2 / ms / 1e9
                cyc = float(clk.double().mean()) / (steps * wgs * per_sm)
                label = {129: "n128+n16", 1000: "n128+n16, one band, no "
                         "wait", 1003: "n128+n16, 3 bands, wait 2",
                         1004: "n128+n16, 4 bands, wait 3"}.get(n, f"n{n}")
                print(f"rate {label}: {wgs} warpgroup(s) a block, {per_sm} "
                      f"block(s) an SM: {ms:.4f} ms, {tops:.0f} TOP/s, "
                      f"{ms * 1e-3 * clk_mhz * 1e6 * SMS / k:.1f} SM clocks "
                      f"per k32 step (event, {clk_mhz:.0f} MHz), {cyc:.1f} "
                      f"by clock64 of a block; ideal {nn / 2:.0f} at the "
                      "int8 peak of 4096 MAC a clock")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    cutlass_int8_ns()
    lib = build()
    ok = desc_checks(lib, torch)
    rates(lib, torch)
    print("descriptor at 16 * r with LBO = CH, SBO = 128:",
          "EQUAL" if ok else "DIFFERS")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
