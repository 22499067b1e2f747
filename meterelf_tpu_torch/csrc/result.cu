// K13 `result_pack`: the decode's error codes, the converged reduction
// and every BatchResult field, written into one buffer.
//
// The TPU graph computes the error priority with XLA ops (meterelf_tpu/
// pipeline/decode.py _decode_batch), not with a Pallas kernel. The port's
// plain version (ops/result.py error_codes, and the converged AND over a
// row's dials) took ~26 small launches a batch on the card, and the ten
// BatchResult fields then took ten copies to the host. This kernel is the
// whole stage in one launch: it reads the stage's inputs and K12's
// outputs and writes the ten fields at the offsets ops/result.layout
// gives them inside one buffer, so that the host copies the result once.
//
// One thread a row (D <= 8 dials). Bit for bit the plain version:
//   - match_ok = max_val >= threshold, both float (torch compares an f32
//     tensor with a Python float in f32; NaN is not ok);
//   - first_bad_dial = the first dial without contours, 0 when every
//     dial has them (argmax's first maximum);
//   - unreadable_bits = sum over d of !readable[d] << d;
//   - err in the reference's raise order: LOAD, DIALS_NOT_FOUND,
//     NEEDLE_CONTOURS, DIAL_ANGLE, else OK (errors.py ErrCode);
//   - converged = the AND of the row's D flags;
//   - match_val, match_x, match_y, dial_pos, readable and value copied.
#include <cuda_runtime.h>

#include "meterelf_kernels.h"

namespace {

constexpr int kMaxDials = 8;
constexpr int kThreads = 128;
// errors.py ErrCode
constexpr int32_t kOk = 0, kLoad = 1, kDialsNotFound = 2,
                  kNeedleContours = 3, kDialAngle = 4;

struct Inputs {
  const uint8_t* load_ok;
  const float* max_val;
  const int32_t* mx;
  const int32_t* my;
  const uint8_t* has_any;
  const uint8_t* conv;
  const double* position;
  const uint8_t* readable;
  const double* value;
};

struct Outputs {
  int32_t* err;
  int32_t* first_bad_dial;
  int32_t* unreadable_bits;
  float* match_val;
  int32_t* match_x;
  int32_t* match_y;
  double* dial_pos;
  uint8_t* readable;
  double* value;
  uint8_t* converged;
};

__global__ void __launch_bounds__(kThreads)
    result_pack_kernel(Inputs in, float threshold, int B, int D,
                       Outputs out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float mv = in.max_val[b];
  int first_bad = -1, bits = 0;
  bool conv = true;
  for (int d = 0; d < D; ++d) {
    const int i = b * D + d;
    if (!in.has_any[i] && first_bad < 0) first_bad = d;
    const bool ok = in.readable[i] != 0;
    bits |= (ok ? 0 : 1) << d;
    conv = conv && in.conv[i] != 0;
    out.dial_pos[i] = in.position[i];
    out.readable[i] = ok;
  }
  int32_t err = kOk;
  if (!in.load_ok[b]) err = kLoad;
  else if (!(mv >= threshold)) err = kDialsNotFound;
  else if (first_bad >= 0) err = kNeedleContours;
  else if (bits) err = kDialAngle;
  out.err[b] = err;
  out.first_bad_dial[b] = first_bad < 0 ? 0 : first_bad;
  out.unreadable_bits[b] = bits;
  out.match_val[b] = mv;
  out.match_x[b] = in.mx[b];
  out.match_y[b] = in.my[b];
  out.value[b] = in.value[b];
  out.converged[b] = conv;
}

}  // namespace

extern "C" int meterelf_result_pack(
    const uint8_t* load_ok, const float* max_val, const int32_t* mx,
    const int32_t* my, float threshold, const uint8_t* has_any,
    const uint8_t* conv, const double* position, const uint8_t* readable,
    const double* value, int B, int D, int32_t* err,
    int32_t* first_bad_dial, int32_t* unreadable_bits, float* match_val,
    int32_t* match_x, int32_t* match_y, double* dial_pos,
    uint8_t* readable_out, double* value_out, uint8_t* converged,
    void* stream) {
  if (B < 0 || D < 1 || D > kMaxDials) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Inputs in{load_ok, max_val, mx, my, has_any, conv, position,
                  readable, value};
  const Outputs out{err, first_bad_dial, unreadable_bits, match_val,
                    match_x, match_y, dial_pos, readable_out, value_out,
                    converged};
  result_pack_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(in, threshold, B, D, out);
  return (int)cudaGetLastError();
}
