// Per-column fractional shear for Hopper (sm_90a): the shift along H.
//
// The y pass of the Paeth warp and of the fused operator. The JAX package
// runs it through the same TPU kernel as the x pass, on a transposed array
// (deeplabv3plus_augmented_superresolution_tpu/ops/shear_warp.py::_shear_pass_y
// -> ops/pallas_shear.py::_shear_rows_pallas_impl); on this card the
// transposes would move as many bytes as the shear itself, so the shift along
// H is a kernel of its own. For an (N, C, H, W) view and per-column shifts
// s (N, W), shared by the C planes of a copy:
//
//   out[n, c, y, x] = (1 - t) * in[n, c, y + f, x] + t * in[n, c, y + f + 1, x]
//   f = floor(s[n, x]),  t = s[n, x] - f,  s clipped to [-255, 254]
//
// with zero fill for reads above and below the plane (shear_common.cuh has
// the shared arithmetic and the view's layout).
//
// What bounds it: device-memory bytes (one read, one write, two FMAs per
// element). The design:
//
//  * Threads run along x, so a warp's loads and stores are neighbouring
//    addresses without any transpose. Neighbouring columns' shifts differ by
//    a fraction of a row (|sin(angle)| per column), so a warp's loads of one
//    step fall in two or three row segments, which the next steps reuse from
//    L1.
//  * A thread owns kColumns neighbouring columns (2 bfloat16 or 1 float32:
//    4 bytes of every row) and walks y. Each step's second tap is the next
//    step's first, so it stays in a register and every input element is
//    loaded once. Both columns of a bfloat16 pair are stored as one 4-byte
//    word.
//  * The walk is unrolled by kUnroll rows: the loads of a turn are issued
//    together, ahead of the blends and stores, so a thread keeps kUnroll
//    loads in flight.
//  * A block covers kThreads x K columns and a chunk of rows of one
//    plane; the first tap of a chunk's top row is the only element read
//    twice (one row in a chunk's worth of the input). A chunk is
//    kRowsPerBlock rows, halved (down to kUnroll) while the grid would have
//    fewer than kWavesPerSm blocks per SM: a small launch (8 planes of
//    128 x 128, the training batch's labels) otherwise runs a few dozen
//    blocks, each walking 64 rows one dependent turn after another.
//
// Any width, stride and alignment runs the same kernel; a bfloat16 pair that
// would be misaligned, or the odd last column, takes the one-column path.
//
// Interface: plain C, loaded with ctypes, as shear_rows.cu.

#include "shear_common.cuh"

namespace {

using shear::View;

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 64;
constexpr int kUnroll = 8;
constexpr int kWavesPerSm = 4;
constexpr int kMaxGridY = 65535;

// Walks rows [y0, y1) of one column.
template <typename T>
__device__ __forceinline__ void walk_column(const T* __restrict__ src,
                                            T* __restrict__ dst, int h, int w, int y0,
                                            int y1, float s) {
  int f;
  float t;
  shear::split_shift(s, f, t);
  auto tap = [&](int y) {
    return (y >= 0 && y < h) ? shear::load_as_float(src + static_cast<long long>(y) * w)
                             : 0.0f;
  };
  float prev = tap(y0 + f);
  for (int y = y0; y < y1; y += kUnroll) {
    float next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) next[u] = tap(y + u + f + 1);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (y + u < y1) {
        shear::store_from_float(dst + static_cast<long long>(y + u) * w,
                                shear::blend(prev, next[u], t));
        prev = next[u];
      }
    }
  }
}

// Walks rows [y0, y1) of two neighbouring bfloat16 columns whose pair is
// 4-byte aligned in every row of the output (w even, x even, aligned base).
__device__ __forceinline__ void walk_pair(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* __restrict__ dst, int h, int w,
                                          int y0, int y1, float s0, float s1) {
  int f0, f1;
  float t0, t1;
  shear::split_shift(s0, f0, t0);
  shear::split_shift(s1, f1, t1);
  auto tap = [&](int y, int col) {
    return (y >= 0 && y < h)
               ? shear::load_as_float(src + static_cast<long long>(y) * w + col)
               : 0.0f;
  };
  float prev0 = tap(y0 + f0, 0);
  float prev1 = tap(y0 + f1, 1);
  for (int y = y0; y < y1; y += kUnroll) {
    float next0[kUnroll], next1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      next0[u] = tap(y + u + f0 + 1, 0);
      next1[u] = tap(y + u + f1 + 1, 1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (y + u < y1) {
        *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<long long>(y + u) * w) =
            __floats2bfloat162_rn(shear::blend(prev0, next0[u], t0),
                                  shear::blend(prev1, next1[u], t1));
        prev0 = next0[u];
        prev1 = next1[u];
      }
    }
  }
}

template <typename T>
struct Columns {
  static constexpr int kCount = 1;
};
template <>
struct Columns<__nv_bfloat16> {
  static constexpr int kCount = 2;
};

// grid = (planes * row chunks, column blocks); block = kThreads; a chunk is
// kRows rows, a compile-time constant: with a run-time chunk the bfloat16
// pair walk of the serving layouts ran 13% slower on an H100.
template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
shear_cols_kernel(const T* __restrict__ in, const float* __restrict__ shift,
                  T* __restrict__ out, View v, int chunks, bool pairs_aligned) {
  constexpr int K = Columns<T>::kCount;
  const int x = (blockIdx.y * kThreads + threadIdx.x) * K;
  if (x >= v.w) return;
  const long long plane = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - plane * chunks);
  const long long n = plane / v.c;
  const int c = static_cast<int>(plane - n * v.c);
  const T* src = in + n * v.stride_n + c * v.stride_c + x;
  T* dst = out + plane * v.h * v.w + x;
  const float* s = shift + n * v.w + x;
  const int y0 = chunk * kRows;
  const int y1 = min(y0 + kRows, v.h);
  if constexpr (K == 2) {
    if (pairs_aligned && x + 1 < v.w) {
      walk_pair(src, dst, v.h, v.w, y0, y1, __ldg(s), __ldg(s + 1));
      return;
    }
    if (x + 1 < v.w) walk_column(src + 1, dst + 1, v.h, v.w, y0, y1, __ldg(s + 1));
  }
  walk_column(src, dst, v.h, v.w, y0, y1, __ldg(s));
}

template <typename T>
int launch(const void* in, const void* shift, void* out, View v, int device,
           void* stream) {
  constexpr int K = Columns<T>::kCount;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long planes = static_cast<long long>(v.n) * v.c;
  if (planes <= 0 || v.h <= 0 || v.w <= 0) return static_cast<int>(cudaSuccess);
  const int block_columns = kThreads * K;
  const long long grid_y = (static_cast<long long>(v.w) + block_columns - 1) / block_columns;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rows = kRowsPerBlock;
  auto chunks_of = [&](int r) { return (v.h + r - 1) / r; };
  while (rows > kUnroll &&
         planes * grid_y * chunks_of(rows) < static_cast<long long>(kWavesPerSm) * sms)
    rows /= 2;
  const int chunks = chunks_of(rows);
  const long long grid_x = planes * chunks;
  if (grid_x > 0x7fffffffLL || grid_y > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  // A pair store needs every (row, even x) of the output on a 4-byte boundary.
  const bool pairs_aligned = v.w % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const T*>(in);
  const auto* sh = static_cast<const float*>(shift);
  auto* dst = static_cast<T*>(out);
  static_assert(kRowsPerBlock == 64 && kUnroll == 8, "the chunk sizes below");
  switch (rows) {
    case 64:
      shear_cols_kernel<T, 64><<<grid, kThreads, 0, s>>>(src, sh, dst, v, chunks,
                                                         pairs_aligned);
      break;
    case 32:
      shear_cols_kernel<T, 32><<<grid, kThreads, 0, s>>>(src, sh, dst, v, chunks,
                                                         pairs_aligned);
      break;
    case 16:
      shear_cols_kernel<T, 16><<<grid, kThreads, 0, s>>>(src, sh, dst, v, chunks,
                                                         pairs_aligned);
      break;
    default:
      shear_cols_kernel<T, 8><<<grid, kThreads, 0, s>>>(src, sh, dst, v, chunks,
                                                        pairs_aligned);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int shear_cols_f32(const void* in, const void* shift, void* out, int n, int c, int h,
                   int w, long long stride_n, long long stride_c, int device,
                   void* stream) {
  return launch<float>(in, shift, out, View{n, c, h, w, stride_n, stride_c}, device,
                       stream);
}

int shear_cols_bf16(const void* in, const void* shift, void* out, int n, int c, int h,
                    int w, long long stride_n, long long stride_c, int device,
                    void* stream) {
  return launch<__nv_bfloat16>(in, shift, out, View{n, c, h, w, stride_n, stride_c},
                               device, stream);
}

}  // extern "C"
