// K12 `readout`: the dial angle statistics and the 4-dial value.
//
// The TPU graph computes these with XLA ops, not with a Pallas kernel:
// meterelf_tpu/ops/angles.py read_dial_from_okey (quad fused branch) or
// read_dial (the other branches), then assemble_value. The port's plain
// version of that graph is ops/angles.py (read_dials, read_dials_region,
// _read_dial_core, assemble_value); on the card it took ~140 small
// launches a batch, so the host's launches, not the card, set the
// decode's pace. This kernel is the whole stage in one launch, bit-equal
// to that plain graph run on the card.
//
// One CTA an image, one warp a dial window. Per window:
//   - gather: the needle bit at the static disk and annulus slots
//     (pa.disk_idx / pa.ann_idx, masked by disk_valid / ann_valid), from
//     okey3 and the stats key (kRegion = false: big blob, keymax >= 0 and
//     area2 > 200, means owner == keymax & 4095, else the closed bit) or
//     from the bool needle region (kRegion = true). Lane l takes slot
//     32c + l; a ballot packs each 32 slots into one word in shared memory;
//   - momentum: sum sx2, sy2 over the needle slots in tree_sum's order
//     (ops/angles.py: zero-padded evenly on both sides to a multiple of
//     32, each run of 32 summed in index order from 0.0, again until 32 or
//     fewer partials are left, which are summed in order from 0.0). Lane l
//     sums runs l, l + 32, ...; higher levels take the partials from shared
//     memory. Every add is one IEEE add in that order, so the bits equal
//     the plain version's;
//   - tip filter: the half-plane test dot > 0 (two rounded f64 products
//     and an add), the minimum angle of the kept slots (a warp min) and
//     the 0.75-turn tail test in the geometry dtype T, each kept and tail
//     bit a ballot word; n and k_tail are popcounts, the inclusive rank of
//     a kept slot its word's prefix count plus a masked popcount;
//   - trimmed weighted mean: sum rebased * w and w (f64) in tree_sum's
//     order, mean = num / (den == 0 ? 1 : den), position = torch's
//     remainder(10 * (mean - zero_turn), 10) as its CUDA kernel computes
//     it (fmod, then + 10 where the result is negative);
// then, with the image's D positions in shared memory, one thread writes
// the carry-corrected value (D == 4; 0 otherwise).
//
// T is the geometry's dtype: double by default, float for
// MeterDecoder(exact=False); the minimum angle, the tail test, the
// rebasing by one turn and the trim weights are computed in T, as the
// plain version does, and every sum in double.
//
// What bounds it on the H100: its bytes, the gathered okey3 (4 bytes a
// slot, ~10 MB for the flagship's 1024 windows of 1536 + 1024 slots) and
// the geometry, which every CTA reads again from L2. Its sequential parts
// (32 dependent adds a run) are short; the ballot passes load a group of
// chunks before they ballot, so each lane has several gathers in flight.
#include <cuda_runtime.h>
#include <math.h>

#include "meterelf_kernels.h"

namespace {

constexpr int kWin = 64 * 64;        // pixels of a dial window
constexpr int kRun = 32;             // tree_sum's run
constexpr int kMaxSlots = kWin;      // slots a dial may have
constexpr int kMaxDials = 8;         // warps of a CTA (K2's limit too)
constexpr int kGroup = 4;            // chunks a lane loads before a ballot
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Geometry {
  const int32_t* disk_idx;   // [D, n_disk]
  const uint8_t* disk_valid;
  const T* disk_sx2;
  const T* disk_sy2;
  const int32_t* ann_idx;    // [D, n_ann]
  const uint8_t* ann_valid;
  const T* ann_x;
  const T* ann_y;
  const T* ann_angle;
  const T* ann_sqd;
  const int32_t* neg_sign;   // [D]
  const T* zero_turn;        // [D]
  int n_disk, n_ann;
  int perm[4];               // value_perm (D == 4)
};

__host__ __device__ constexpr int words_of(int n) { return (n + 31) >> 5; }

// Per-warp shared memory: two f64 buffers of first-level partials, then
// the needle words, the kept and tail words and the kept words' prefix
// counts. The CTA's D positions come first. Rounded up to 16 bytes, so
// that every warp's f64 buffers stay 8-aligned whatever the word counts.
__host__ __device__ inline int warp_bytes(int n_disk, int n_ann) {
  const int runs = words_of(n_disk > n_ann ? n_disk : n_ann);
  const int bytes = 16 * runs + 4 * (words_of(n_disk) + 3 * words_of(n_ann));
  return (bytes + 15) & ~15;
}

__device__ __forceinline__ bool bit_at(const uint32_t* words, int s) {
  return (words[s >> 5] >> (s & 31)) & 1u;
}

// words[c] bit l = bit(32c + l) for the n slots. The warp evaluates
// kGroup chunks, then ballots them; a lane past the end evaluates slot
// n - 1 again and its bit is masked, so bit(s) may read unconditionally
// and the group's loads issue together.
template <class Bit>
__device__ __forceinline__ void ballot_words(int n, Bit bit,
                                             uint32_t* words) {
  const int lane = threadIdx.x & 31;
  const int nw = words_of(n);
  for (int c0 = 0; c0 < nw; c0 += kGroup) {
    bool v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int s = (c0 + k) * 32 + lane;
      v[k] = bit(min(s, n - 1)) & (s < n);
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const unsigned w = __ballot_sync(kFull, v[k]);
      if (lane == 0 && c0 + k < nw) words[c0 + k] = w;
    }
  }
  __syncwarp();
}

// ops/angles.py tree_sum of two rows at once, term(s) giving slot s's
// pair (s < n): every lane returns the two sums. bu, bv: this warp's
// buffers of words_of(n) partials.
template <class Term>
__device__ __forceinline__ double2 tree_sum2(int n, Term term, double* bu,
                                             double* bv) {
  const int lane = threadIdx.x & 31;
  double u = 0.0, v = 0.0;
  if (n <= kRun) {                    // one run, no padding
    for (int s = 0; s < n; ++s) {
      const double2 t = term(s);
      u = __dadd_rn(u, t.x);
      v = __dadd_rn(v, t.y);
    }
    return make_double2(u, v);
  }
  int pad = -n & (kRun - 1), lo = pad >> 1, runs = (n + pad) / kRun;
  for (int r = lane; r < runs; r += 32) {
    u = 0.0;
    v = 0.0;
#pragma unroll 8
    for (int j = 0; j < kRun; ++j) {
      const int s = r * kRun + j - lo;
      const double2 t = s >= 0 && s < n ? term(s) : make_double2(0.0, 0.0);
      u = __dadd_rn(u, t.x);
      v = __dadd_rn(v, t.y);
    }
    bu[r] = u;
    bv[r] = v;
  }
  __syncwarp();
  // the partials' levels: n <= kMaxSlots leaves at most 128 partials,
  // so a later level has at most 4 runs, one a lane
  for (n = runs; n > kRun; n = runs) {
    pad = -n & (kRun - 1);
    lo = pad >> 1;
    runs = (n + pad) / kRun;
    u = 0.0;
    v = 0.0;
    if (lane < runs) {
      for (int j = 0; j < kRun; ++j) {
        const int s = lane * kRun + j - lo;
        const bool in = s >= 0 && s < n;
        u = __dadd_rn(u, in ? bu[s] : 0.0);
        v = __dadd_rn(v, in ? bv[s] : 0.0);
      }
    }
    __syncwarp();
    if (lane < runs) {
      bu[lane] = u;
      bv[lane] = v;
    }
    __syncwarp();
  }
  u = 0.0;
  v = 0.0;
  for (int i = 0; i < n; ++i) {
    u = __dadd_rn(u, bu[i]);
    v = __dadd_rn(v, bv[i]);
  }
  __syncwarp();                       // the buffers are reused next
  return make_double2(u, v);
}

// assemble_value's digit: floor, carry up or down by the lower dial,
// modulo 10 (Python's, non-negative).
__device__ __forceinline__ int digit(double r, bool lower_le2,
                                     bool lower_ge8) {
  const double fl = floor(r);
  const double frac = __dsub_rn(r, fl);
  const long long x = (long long)fl + (frac > 0.55 && lower_le2) -
                      (frac < 0.45 && lower_ge8);
  return (int)(((x % 10) + 10) % 10);
}

template <typename T, bool kRegion>
__global__ void __launch_bounds__(kMaxDials * 32)
    readout_kernel(const void* __restrict__ src,
                   const int32_t* __restrict__ keymax, int D,
                   const Geometry<T> g, double* __restrict__ position,
                   uint8_t* __restrict__ readable,
                   double* __restrict__ value) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, d = threadIdx.x >> 5;
  const int win = blockIdx.x * D + d;
  double* pos_s = reinterpret_cast<double*>(smem);
  const int n_disk = g.n_disk, n_ann = g.n_ann;
  const int runs = words_of(n_disk > n_ann ? n_disk : n_ann);
  double* bu = reinterpret_cast<double*>(
      smem + 8 * D + d * warp_bytes(n_disk, n_ann));
  double* bv = bu + runs;
  uint32_t* nw = reinterpret_cast<uint32_t*>(bv + runs);
  uint32_t* kw = nw + words_of(n_disk);
  uint32_t* tw = kw + words_of(n_ann);
  int* pc = reinterpret_cast<int*>(tw + words_of(n_ann));

  // the needle bit at window pixel i
  const int32_t* ok = static_cast<const int32_t*>(src) + (size_t)win * kWin;
  const uint8_t* rg = static_cast<const uint8_t*>(src) + (size_t)win * kWin;
  const int km = kRegion ? -1 : keymax[win];
  const bool big = km >= 0 && (km >> 12) > 200;   // contourArea > 100
  const int sel = km & 4095;
  auto needle_at = [&](int i) -> bool {
    if constexpr (kRegion) {
      return rg[i] != 0;
    } else {
      const int v = ok[i];
      return big ? (v >> 3) == sel : (v & 4) != 0;
    }
  };

  // momentum over the needle's disk slots
  const int32_t* didx = g.disk_idx + (size_t)d * n_disk;
  const uint8_t* dval = g.disk_valid + (size_t)d * n_disk;
  const T* sx2 = g.disk_sx2 + (size_t)d * n_disk;
  const T* sy2 = g.disk_sy2 + (size_t)d * n_disk;
  ballot_words(n_disk, [&](int s) {
    return (dval[s] != 0) & needle_at(didx[s]);
  }, nw);
  const double2 mom = tree_sum2(n_disk, [&](int s) {
    return bit_at(nw, s) ? make_double2((double)sx2[s], (double)sy2[s])
                         : make_double2(0.0, 0.0);
  }, bu, bv);
  const double sign = (double)g.neg_sign[d];
  const double msx = __dmul_rn(sign, mom.x), msy = __dmul_rn(sign, mom.y);

  // the tip: annulus slots of the needle on the momentum's side
  const size_t ao = (size_t)d * n_ann;
  const int32_t* aidx = g.ann_idx + ao;
  const uint8_t* aval = g.ann_valid + ao;
  const T* ax = g.ann_x + ao;
  const T* ay = g.ann_y + ao;
  const T* ang = g.ann_angle + ao;
  const T* sqd = g.ann_sqd + ao;
  T amin = (T)INFINITY;
  ballot_words(n_ann, [&](int s) {
    const double dot = __dadd_rn(__dmul_rn((double)ax[s], msx),
                                 __dmul_rn((double)ay[s], msy));
    const bool kept = (aval[s] != 0) & needle_at(aidx[s]) & (dot > 0.0);
    const T a = ang[s];
    if (kept && a < amin) amin = a;
    return kept;
  }, kw);
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const T o = __shfl_xor_sync(kFull, amin, off);
    amin = o < amin ? o : amin;
  }
  // kept slots more than 0.75 turn past the first: the wrap's tail
  ballot_words(n_ann, [&](int s) {
    T diff = ang[s] - amin;
    diff = diff < (T)0 ? -diff : diff;
    return bit_at(kw, s) & !(diff < (T)0.75);
  }, tw);
  // n, k_tail and each kept word's prefix count
  const int na = words_of(n_ann);
  int n = 0, k_tail = 0;
  for (int c0 = 0; c0 < na; c0 += 32) {
    const int c = c0 + lane;
    const int cnt = c < na ? __popc(kw[c]) : 0;
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    if (c < na) pc[c] = n + incl - cnt;
    n += __shfl_sync(kFull, incl, 31);
    k_tail += __reduce_add_sync(kFull, c < na ? __popc(tw[c]) : 0);
  }
  __syncwarp();
  const int cut = n >= 5 ? min((n - 3) >> 1, 2) : 0;

  // the trimmed, weighted mean angle: the tail rebased by one turn, the
  // kept slots ranked in the rotated order, cut slots at each end
  const double2 nd = tree_sum2(n_ann, [&](int s) {
    const int c = s >> 5;
    const uint32_t m = 1u << (s & 31);
    const bool kept = kw[c] & m, tail = tw[c] & m;
    const int rank = pc[c] + __popc(kw[c] & (m | (m - 1))) - 1;
    const int p = tail ? rank - (n - k_tail) : rank + k_tail;
    const bool trim = kept && p >= cut && p < n - cut;
    const T a = ang[s];
    const T rebased = tail ? a - (T)1 : a;
    const double w = trim ? (double)sqd[s] : 0.0;
    return make_double2(__dmul_rn((double)rebased, w), w);
  }, bu, bv);
  const double mean = __ddiv_rn(nd.x, nd.y == 0.0 ? 1.0 : nd.y);
  const double t = __dmul_rn(10.0, __dsub_rn(mean, (double)g.zero_turn[d]));
  double r = fmod(t, 10.0);             // torch.remainder on the card
  if (r < 0.0) r = __dadd_rn(r, 10.0);
  if (lane == 0) {
    position[win] = r;
    readable[win] = n > 0;
    pos_s[d] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double v = 0.0;
    if (D == 4) {
      // value_perm lists the dials name-sorted: r4, r3, r2, r1
      const double r4 = pos_s[g.perm[0]], r3 = pos_s[g.perm[1]];
      const double r2 = pos_s[g.perm[2]], r1 = pos_s[g.perm[3]];
      // d3's carry compares the raw r4; the coarser dials the digits
      const int d3 = digit(r3, r4 <= 2.0, r4 >= 8.0);
      const int d2 = digit(r2, d3 <= 2, d3 >= 8);
      const int d1 = digit(r1, d2 <= 2, d2 >= 8);
      v = __dadd_rn(__dadd_rn(__dadd_rn(__dmul_rn((double)d1, 100.0),
                                        __dmul_rn((double)d2, 10.0)),
                              (double)d3),
                    __ddiv_rn(r4, 10.0));
    }
    value[blockIdx.x] = v;
  }
}

template <typename T, bool kRegion>
int launch(const void* src, const int32_t* keymax, int B, int D,
           const Geometry<T>& g, double* position, uint8_t* readable,
           double* value, cudaStream_t stream) {
  // at most 8 * 4 KB + 64 B: under the 48 KB a block may take unasked
  const int smem = 8 * D + D * warp_bytes(g.n_disk, g.n_ann);
  readout_kernel<T, kRegion><<<B, D * 32, smem, stream>>>(
      src, keymax, D, g, position, readable, value);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* src, int region, const int32_t* keymax, int B,
             int D, const int32_t* disk_idx, const uint8_t* disk_valid,
             const void* disk_sx2, const void* disk_sy2, int n_disk,
             const int32_t* ann_idx, const uint8_t* ann_valid,
             const void* ann_x, const void* ann_y, const void* ann_angle,
             const void* ann_sqd, int n_ann, const int32_t* neg_sign,
             const void* zero_turn, int p0, int p1, int p2, int p3,
             double* position, uint8_t* readable, double* value,
             cudaStream_t stream) {
  const Geometry<T> g{disk_idx, disk_valid,
                      static_cast<const T*>(disk_sx2),
                      static_cast<const T*>(disk_sy2), ann_idx, ann_valid,
                      static_cast<const T*>(ann_x),
                      static_cast<const T*>(ann_y),
                      static_cast<const T*>(ann_angle),
                      static_cast<const T*>(ann_sqd), neg_sign,
                      static_cast<const T*>(zero_turn), n_disk, n_ann,
                      {p0, p1, p2, p3}};
  return region ? launch<T, true>(src, keymax, B, D, g, position, readable,
                                  value, stream)
                : launch<T, false>(src, keymax, B, D, g, position, readable,
                                   value, stream);
}

}  // namespace

extern "C" int meterelf_readout(
    const void* src, int region, const int32_t* keymax, int B, int D,
    const int32_t* disk_idx, const uint8_t* disk_valid, const void* disk_sx2,
    const void* disk_sy2, int n_disk, const int32_t* ann_idx,
    const uint8_t* ann_valid, const void* ann_x, const void* ann_y,
    const void* ann_angle, const void* ann_sqd, int n_ann,
    const int32_t* neg_sign, const void* zero_turn, int geom_f32, int p0,
    int p1, int p2, int p3, double* position, uint8_t* readable,
    double* value, void* stream) {
  if (D < 1 || D > kMaxDials || n_disk < 1 || n_disk > kMaxSlots ||
      n_ann < 1 || n_ann > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto s = (cudaStream_t)stream;
  return geom_f32
             ? dispatch<float>(src, region, keymax, B, D, disk_idx,
                               disk_valid, disk_sx2, disk_sy2, n_disk,
                               ann_idx, ann_valid, ann_x, ann_y, ann_angle,
                               ann_sqd, n_ann, neg_sign, zero_turn, p0, p1,
                               p2, p3, position, readable, value, s)
             : dispatch<double>(src, region, keymax, B, D, disk_idx,
                                disk_valid, disk_sx2, disk_sy2, n_disk,
                                ann_idx, ann_valid, ann_x, ann_y, ann_angle,
                                ann_sqd, n_ann, neg_sign, zero_turn, p0, p1,
                                p2, p3, position, readable, value, s);
}
