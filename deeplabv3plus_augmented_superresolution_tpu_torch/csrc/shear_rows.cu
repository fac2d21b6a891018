// Per-row fractional shear for Hopper (sm_90a).
//
// Replaces deeplabv3plus_augmented_superresolution_tpu/ops/pallas_shear.py
// ::_shear_rows_pallas_impl (kernel body `_kernel`). For (N, H, W) images and
// per-row shifts s (N, H):
//
//   out[n, y, x] = (1 - t) * in[n, y, x + f] + t * in[n, y, x + f + 1]
//   f = floor(s[n, y]),  t = s[n, y] - f,  s clipped to [-255, 254]
//
// with zero fill for reads outside the row and the blend in float32. Inputs
// and outputs are float32 or bfloat16 (same dtype); s is float32.
//
// What bounds it: device-memory bytes. Each output element costs about two
// reads (the second tap is the neighbour of the first, so it comes from L1)
// and one write, and two FMAs -- far below the card's compute. The design is
// therefore a plain coalesced gather: one block per row (row index in
// blockIdx.x), each thread reads s once and walks the row in strides of the
// block width, so neighbouring threads touch neighbouring addresses. The TPU
// kernel's lane roll and two-level tap blend existed only because the TPU
// cannot gather; they are not carried over.
//
// A later change can add a column-shear variant (shift along H) so the y
// passes of the warp and of the fused operator skip their transpose copies.
//
// Interface: plain C, loaded with ctypes. Each launcher returns the
// cudaError_t of the launch (cudaGetLastError), 0 on success. It runs on the
// caller's stream and neither allocates nor synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }

__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shear_rows_kernel(const T* __restrict__ in, const float* __restrict__ shift,
                  T* __restrict__ out, int width) {
  const size_t row = blockIdx.x;
  const float s = fminf(fmaxf(shift[row], -255.0f), 254.0f);
  const float fl = floorf(s);
  const int f = static_cast<int>(fl);
  const float t = s - fl;
  const T* src = in + row * static_cast<size_t>(width);
  T* dst = out + row * static_cast<size_t>(width);
  for (int x = threadIdx.x; x < width; x += blockDim.x) {
    const int i0 = x + f;
    const int i1 = i0 + 1;
    const float a = (i0 >= 0 && i0 < width) ? load_as_float(src + i0) : 0.0f;
    const float b = (i1 >= 0 && i1 < width) ? load_as_float(src + i1) : 0.0f;
    store_from_float(dst + x, (1.0f - t) * a + t * b);
  }
}

template <typename T>
int launch(const void* in, const void* shift, void* out, int rows, int width,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  shear_rows_kernel<T><<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<const float*>(shift),
      static_cast<T*>(out), width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int shear_rows_f32(const void* in, const void* shift, void* out, int rows,
                   int width, int device, void* stream) {
  return launch<float>(in, shift, out, rows, width, device, stream);
}

int shear_rows_bf16(const void* in, const void* shift, void* out, int rows,
                    int width, int device, void* stream) {
  return launch<__nv_bfloat16>(in, shift, out, rows, width, device, stream);
}

const char* shear_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
