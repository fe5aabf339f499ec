// MXSF byte codec as __device__ helpers, shared by both kernels.
//
// Device counterpart of kernels/common.py (and of the JAX package's
// kernels/common.py): exponents are read and powers of two built by
// bit-casting, RNE is rintf (round half to even).  Built without
// --use_fast_math, so subnormals are kept (flog2) and division is IEEE
// (the E3M2 step of encode_mxsf).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxsf {

constexpr int kScaleBias = 127;
constexpr float kNegInf = -1e30f;

// floor(log2(a)) for a >= 0, exact down to subnormals; -127 for 0.
__device__ __forceinline__ int flog2(float a) {
  const bool sub = (a > 0.f) && (a < 1.17549435082228750797e-38f);  // 2^-126
  const float an = sub ? a * 16777216.0f : a;                        // 2^24
  return ((__float_as_int(an) >> 23) & 0xFF) - 127 - (sub ? 24 : 0);
}

// Exact 2^e for integer e, clipped to [-126, 127].
__device__ __forceinline__ float exp2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ int floor_div2(int e) {
  return (e >= 0) ? (e / 2) : -((1 - e) / 2);
}

// x * 2^e for e in [-252, 252], split so each factor is representable.
__device__ __forceinline__ float scale_by_exp2(float x, int e) {
  const int e1 = floor_div2(e);
  return x * exp2i(e1) * exp2i(e - e1);
}

// MXSF byte -> value relative to the shared exponent.
__device__ __forceinline__ float decode_mxsf(uint32_t code) {
  const int c = static_cast<int>(code & 0xFF);
  const int ee = (c >> 5) & 3;
  const int eee = (c >> 2) & 7;
  const float m5 = static_cast<float>(c & 31);
  const float m2 = static_cast<float>(c & 3);
  float mag;
  if (ee > 0) {
    mag = (1.0f + m5 / 32.0f) * exp2i(ee - 3);
  } else if (eee > 0) {
    mag = (1.0f + m2 / 4.0f) * exp2i(eee - 10);
  } else {
    mag = (m2 / 4.0f) * 0.001953125f;  // 2^-9
  }
  return ((c >> 7) & 1) ? -mag : mag;
}

// Relative value (|xa| < 2) -> MXSF byte.  Mirrors encode_mxsf step by step.
__device__ __forceinline__ uint32_t encode_mxsf(float xa) {
  const uint32_t s = static_cast<uint32_t>(__float_as_int(xa)) >> 31;
  const float a = fabsf(xa);
  if (a == 0.f) return s << 7;
  const int e = flog2(a);
  int code;
  if (e >= -2) {  // E2M5 regime (gap < 3)
    int e25 = min(max(e, -2), 0);
    float m25 = rintf(a * exp2i(5 - e25));
    if (m25 >= 64.f) { e25 += 1; m25 = 32.f; }
    if (e25 > 0) { e25 = 0; m25 = 63.f; }
    code = ((e25 + 3) << 5) | (static_cast<int>(m25) - 32);
  } else {        // E3M2 regime (gap >= 3)
    int e32 = min(max(e, -9), -3);
    bool sub = a < 0.001953125f;  // 2^-9
    const float step = sub ? 0.00048828125f : exp2i(e32 - 2);  // 2^-11
    float q = rintf(a / step);
    const bool promote = sub && (q >= 4.f);
    if (promote) { q = 4.f; e32 = -9; }
    sub = sub && !promote;
    if (!sub && q >= 8.f) { e32 += 1; q = 4.f; }
    if (e32 > -3) {
      code = 1 << 5;
    } else {
      const int eee = sub ? 0 : e32 + 10;
      const int m2 = static_cast<int>(sub ? q : q - 4.f);
      code = (eee << 2) | m2;
    }
  }
  return (static_cast<uint32_t>(code) | (s << 7)) & 0xFF;
}

__device__ __forceinline__ float load_act(const void* p, int is_bf16,
                                          size_t i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

}  // namespace mxsf

extern "C" const char* mxsf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
