// Shared pieces of the shear kernels (shear_rows.cu, shear_cols.cu).
//
// Both kernels compute a fractional shift with a 2-tap lerp and zero fill:
//
//   out = (1 - t) * in[i + f] + t * in[i + f + 1]
//   f = floor(s),  t = s - f,  s clipped to [-255, 254]
//
// along W with one shift per row (shear_rows) or along H with one shift per
// column (shear_cols). The blend is in float32; inputs and outputs are
// float32 or bfloat16 (same dtype); s is float32.
//
// Both take the input as an (N, C, H, W) view whose (H, W) planes are
// contiguous and whose N and C strides are given in elements. A stride of 0
// is allowed: every copy then reads the same source plane. The output is
// always a dense (N, C, H, W) array. The shift is shared by the C planes of
// a copy: s is (N, H) for shear_rows and (N, W) for shear_cols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace shear {

constexpr float kShiftMin = -255.0f;
constexpr float kShiftMax = 254.0f;

// The input view and the output's extent, passed by value to every kernel.
struct View {
  int n, c, h, w;
  long long stride_n, stride_c;  // elements between copies / between planes
};

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// s -> (f, t) with the clip.
__device__ __forceinline__ void split_shift(float s, int& f, float& t) {
  s = fminf(fmaxf(s, kShiftMin), kShiftMax);
  const float fl = floorf(s);
  f = static_cast<int>(fl);
  t = s - fl;
}

__device__ __forceinline__ float blend(float a, float b, float t) {
  return (1.0f - t) * a + t * b;
}

}  // namespace shear
