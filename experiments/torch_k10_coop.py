"""Write a variant of csrc/jpeg.cu whose K10 IDCT phase runs on 8 lanes
a block (the cooperative butterfly), for experiments/torch_k10_ab.py.

    python3 experiments/torch_k10_coop.py [--row-loads] [SRC [DST]]
    python3 experiments/torch_k10_ab.py --variant coop=build/k10_coop.cu

Reads SRC (default meterelf_tpu_torch/csrc/jpeg.cu, the band design)
and writes DST (default build/k10_coop.cu, gitignored) with the band's
job loop replaced: a team of 8 lanes takes a block, lane t loads
coefficient column t (load_column) and runs its column pass, the 8x8
goes through the team's exchange in shared memory (row stride 9, team
stride 72 words: the 32 lanes of a warp on 32 banks), and lane t runs
the row pass of row t; for a halo row, lane t's column entry of that
row (idct8_edge) goes through the exchange and lane t keeps sample t of
the one row pass. Same numerics, far fewer registers a thread (no
uint32_t c[64]). With --row-loads (DST default build/k10_coop2.cu)
lane t loads row t instead, with load_block's 8-byte (16-byte dense)
loads, and the column reaches it through the exchange. Fails if SRC is
not the band design's text.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# the band kernel's job loop, from its warp-aligned single rows to the
# tail-alone switch, and what replaces it
LOOP_START = '      const int s0 = (nfull + 31) & ~31;   // single rows start on a warp'
LOOP_END = '  } else {   // the tail alone (experiments/torch_k10_ab.py --split)'
COOP_LOOP = '''      const int s0 = (nfull + 3) & ~3;   // single rows start on a warp
      const int njobs = s0 + ((int)up + (int)down) * 2 * ncx;
      // 8 lanes a block: lane t loads column t and runs its column pass,
      // the 8x8 goes through the team's exchange, lane t runs row t
      const int team = tid >> 3, t = tid & 7;
      const unsigned tmask = 0xFFu << (tid & 24);
      uint32_t* xs = xch + team * kXchStride;
      for (int j = team; j < njobs; j += kThreads / 8) {
        uint32_t v[8];
        if (j < nfull) {
          const void* plane;
          int rows, cols, br, bx, ds;
          const uint16_t* qq;
          uint8_t* dst;
          if (j < nl) {
            const int second = j >= nlx;
            br = lr0 + second;
            bx = lx0 + j - (second ? nlx : 0);
            plane = fy;
            rows = g.lh;
            cols = g.lw;
            qq = q;
            dst = sy + (8 * br - 16 * k) * g.lw + 8 * bx;
            ds = g.lw;
          } else {
            const int jj = j - nl, p = jj >= ncx;
            br = k;
            bx = cx0 + jj - (p ? ncx : 0);
            plane = p ? fcr : fcb;
            rows = ch;
            cols = cw;
            qq = q + 64 * (1 + p);
            dst = (p ? scr : scb) + cw + 8 * bx;
            ds = cw;
          }
          load_column<kCompact>(plane, img, rows, cols, br, bx, t, qq, v);
          idct8(v, 1, 11);
#pragma unroll
          for (int r = 0; r < 8; ++r) xs[9 * r + t] = v[r];
          __syncwarp(tmask);
#pragma unroll
          for (int c = 0; c < 8; ++c) v[c] = xs[9 * t + c];
          idct8(v, 1, 18);
          store_row(v, dst + t * ds);
          __syncwarp(tmask);
        } else if (j >= s0) {
          const int jj = j - s0, second = jj >= 2 * ncx;
          const int jh = jj - (second ? 2 * ncx : 0), p = jh >= ncx;
          const int bx = cx0 + jh - (p ? ncx : 0);
          const bool below = second || !up;
          load_column<kCompact>(p ? fcr : fcb, img, ch, cw,
                                below ? k + 1 : k - 1, bx, t,
                                q + 64 * (1 + p), v);
          xs[t] = idct8_edge(v, 1, 11, !below);
          __syncwarp(tmask);
#pragma unroll
          for (int c = 0; c < 8; ++c) v[c] = xs[c];
          idct8(v, 1, 18);
          uint32_t mine = v[0];
#pragma unroll
          for (int c = 1; c < 8; ++c) mine = c == t ? v[c] : mine;
          const int x = (int32_t)mine + 128;
          ((p ? scr : scb) + (below ? 9 : 0) * cw + 8 * bx)[t] =
              (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
          __syncwarp(tmask);
        }
      }
    }
'''
# --row-loads: load_column from 8-byte (16-byte dense) row loads through
# the exchange, as load_block reads, in place of one-byte column loads
ROW_LOADS = (
    ('''// Column t of block (br, bx) of a plane of image img, dequantised, into
// v[r] = coefficient (r, t): the load of one of the 8 lanes that share a
// block (load_block's layouts).
template <bool kCompact>
__device__ __forceinline__ void load_column(const void* plane, int img,
                                            int rows, int cols, int br,
                                            int bx, int t,
                                            const uint16_t* q, uint32_t* v) {
  if (kCompact) {
    const uint8_t* base = (const uint8_t*)plane
                          + (size_t)img * (rows * 3 / 2) * cols + 8 * bx + t;
#pragma unroll
    for (int r = 0; r < 8; r += 2) {
      const int pr = 8 * br + r;
      const int h8 = base[(size_t)(rows + (pr >> 1)) * cols];
      const int a = ((h8 & 15) << 8) | base[(size_t)pr * cols];
      const int b = ((h8 >> 4) << 8) | base[(size_t)(pr + 1) * cols];
      v[r] = (uint32_t)(a - ((a & 0x800) << 1)) * q[8 * r + t];
      v[r + 1] = (uint32_t)(b - ((b & 0x800) << 1)) * q[8 * r + 8 + t];
    }
  } else {
    const int16_t* base = (const int16_t*)plane + (size_t)img * rows * cols
                          + 8 * bx + t;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      v[r] = (uint32_t)(int)base[(size_t)(8 * br + r) * cols] * q[8 * r + t];
  }
}

''',
     '''// Column t of block (br, bx) of a plane of image img, dequantised, into
// v[r] = coefficient (r, t), for a team of 8 lanes: lane t loads row t
// (load_block's layouts, 8-byte and 16-byte loads), writes it to the
// team's exchange xs (row stride 9) and reads column t back.
template <bool kCompact>
__device__ __forceinline__ void load_column(const void* plane, int img,
                                            int rows, int cols, int br,
                                            int bx, int t,
                                            const uint16_t* q, uint32_t* v,
                                            uint32_t* xs, unsigned tmask) {
  const int pr = 8 * br + t;
  if (kCompact) {
    const int8_t* base = (const int8_t*)plane
                         + (size_t)img * (rows * 3 / 2) * cols + 8 * bx;
    const uint2 lo = *(const uint2*)(base + (size_t)pr * cols);
    const uint2 hi = *(const uint2*)(base + (size_t)(rows + (pr >> 1))
                                     * cols);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t lo_w = k < 4 ? lo.x : lo.y;
      const uint32_t hi_w = k < 4 ? hi.x : hi.y;
      const int sh = 8 * (k & 3);
      const int l8 = (lo_w >> sh) & 255, h8 = (hi_w >> sh) & 255;
      const int nib = (t & 1) ? (h8 >> 4) : (h8 & 15);
      const int x = (nib << 8) | l8;
      xs[9 * t + k] = (uint32_t)(x - ((x & 0x800) << 1)) * q[8 * t + k];
    }
  } else {
    const int16_t* base = (const int16_t*)plane + (size_t)img * rows * cols
                          + 8 * bx;
    const uint4 w = *(const uint4*)(base + (size_t)pr * cols);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int x = (int16_t)(words[k >> 1] >> (16 * (k & 1)));
      xs[9 * t + k] = (uint32_t)x * q[8 * t + k];
    }
  }
  __syncwarp(tmask);
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = xs[9 * r + t];
}

'''),
    ('load_column<kCompact>(plane, img, rows, cols, br, bx, t, qq, v);',
     'load_column<kCompact>(plane, img, rows, cols, br, bx, t, qq, v, xs,\n'
     '                                tmask);'),
    ('                                q + 64 * (1 + p), v);',
     '                                q + 64 * (1 + p), v, xs, tmask);'),
)
# (text, replacement) pairs: load_column before the kernel, the team
# exchange beside the quant tables, its stride beside the band constants
EDITS = (
    ('''template <bool kCompact>
__global__ void __launch_bounds__(kThreads)
    backhalf_planes_kernel(''',
     '''// Column t of block (br, bx) of a plane of image img, dequantised, into
// v[r] = coefficient (r, t): the load of one of the 8 lanes that share a
// block (load_block's layouts).
template <bool kCompact>
__device__ __forceinline__ void load_column(const void* plane, int img,
                                            int rows, int cols, int br,
                                            int bx, int t,
                                            const uint16_t* q, uint32_t* v) {
  if (kCompact) {
    const uint8_t* base = (const uint8_t*)plane
                          + (size_t)img * (rows * 3 / 2) * cols + 8 * bx + t;
#pragma unroll
    for (int r = 0; r < 8; r += 2) {
      const int pr = 8 * br + r;
      const int h8 = base[(size_t)(rows + (pr >> 1)) * cols];
      const int a = ((h8 & 15) << 8) | base[(size_t)pr * cols];
      const int b = ((h8 >> 4) << 8) | base[(size_t)(pr + 1) * cols];
      v[r] = (uint32_t)(a - ((a & 0x800) << 1)) * q[8 * r + t];
      v[r + 1] = (uint32_t)(b - ((b & 0x800) << 1)) * q[8 * r + 8 + t];
    }
  } else {
    const int16_t* base = (const int16_t*)plane + (size_t)img * rows * cols
                          + 8 * bx + t;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      v[r] = (uint32_t)(int)base[(size_t)(8 * br + r) * cols] * q[8 * r + t];
  }
}

template <bool kCompact>
__global__ void __launch_bounds__(kThreads)
    backhalf_planes_kernel('''),
    ('''  __shared__ uint16_t q[3 * 64];
  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int cw = g.lw / 2, ch = g.lh / 2;
  uint8_t* sy = stage;''',
     '''  __shared__ uint16_t q[3 * 64];
  __shared__ uint32_t xch[kThreads / 8 * kXchStride];   // 8x8 a team
  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int cw = g.lw / 2, ch = g.lh / 2;
  uint8_t* sy = stage;'''),
    ('''constexpr int kChromaRows = 10;   // staged chroma rows: the row and 2 halos
''',
     '''constexpr int kChromaRows = 10;   // staged chroma rows: the row and 2 halos
// a team's 8x8 exchange: row stride 9 and team stride 72 words put the 32
// lanes of a warp on 32 banks when they write a row or read a column
constexpr int kXchStride = 72;
'''),
)


def coop_source(s: str, row_loads: bool = False) -> str:
    """The band kernel's source with the cooperative IDCT phase."""
    start, end = s.index(LOOP_START), s.index(LOOP_END)
    s = s[:start] + COOP_LOOP + s[end:]
    for old, new in EDITS + (ROW_LOADS if row_loads else ()):
        if old not in s:
            raise ValueError("not the band design's jpeg.cu")
        s = s.replace(old, new, 1)
    return s


def main() -> int:
    args = sys.argv[1:]
    row_loads = "--row-loads" in args
    args = [a for a in args if a != "--row-loads"]
    src = Path(args[0]) if args else (
        ROOT / "meterelf_tpu_torch" / "csrc" / "jpeg.cu")
    dst = Path(args[1]) if len(args) > 1 else (
        ROOT / "build" / ("k10_coop2.cu" if row_loads else "k10_coop.cu"))
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(coop_source(src.read_text(), row_loads))
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
