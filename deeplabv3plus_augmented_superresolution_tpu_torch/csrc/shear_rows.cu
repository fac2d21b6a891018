// Per-row fractional shear for Hopper (sm_90a): the shift along W.
//
// Replaces deeplabv3plus_augmented_superresolution_tpu/ops/pallas_shear.py
// ::_shear_rows_pallas_impl (kernel body `_kernel`). For an (N, C, H, W) view
// and per-row shifts s (N, H), shared by the C planes of a copy:
//
//   out[n, c, y, x] = (1 - t) * in[n, c, y, x + f] + t * in[n, c, y, x + f + 1]
//   f = floor(s[n, y]),  t = s[n, y] - f,  s clipped to [-255, 254]
//
// with zero fill for reads outside the row (shear_common.cuh has the shared
// arithmetic and the view's layout).
//
// What bounds it: device-memory bytes. An output element costs one read, one
// write and two FMAs, far below the card's compute, so the only lever is how
// the bytes move. The design:
//
//  * 16-byte access. A thread produces one 16-byte vector of neighbouring
//    outputs (4 float32 or 8 bfloat16) and stores it with one instruction.
//    Its source run [x + f, x + f + V] has the alignment of f, so the thread
//    loads the two aligned vectors that cover the run and selects its V + 1
//    taps in registers. f is one number per row, so the selection offset
//    (f mod V) is the same for a whole warp and the switch does not diverge.
//    The second vector is the neighbouring thread's first: it comes from L1.
//  * Several rows per block: 256 threads as (threads along the row, rows), 4
//    rows of 512 bfloat16 or 2 rows of 512 float32, so that an SM has tens
//    of KB of loads in flight instead of one short row per block.
//  * A strided, broadcastable input. The N and C strides come from the
//    caller; with stride_n == 0 every copy reads the same planes, which stay
//    in L2, and no expanded batch is ever written to memory.
//
// Rows that cannot be read as aligned vectors (W not a multiple of V, a
// stride that is not, or a base pointer off a 16-byte boundary) run
// shear_rows_scalar_kernel: one block per row, one element per thread and
// turn. The TPU kernel's lane roll and two-level tap blend existed only
// because the TPU cannot gather; they are not carried over.
//
// Interface: plain C, loaded with ctypes. Each launcher returns the
// cudaError_t of the launch (cudaGetLastError), 0 on success. It runs on the
// caller's stream and neither allocates nor synchronises.

#include "shear_common.cuh"

namespace {

using shear::View;

constexpr int kVecThreads = 256;
constexpr int kScalarThreads = 128;
constexpr int kMaxGridY = 65535;

// ---- 16-byte vectors as float lanes ---------------------------------------

template <typename T>
struct Lanes {
  static constexpr int kCount = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& v, float* lanes, const float*) {
  lanes[0] = __uint_as_float(v.x);
  lanes[1] = __uint_as_float(v.y);
  lanes[2] = __uint_as_float(v.z);
  lanes[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float* lanes,
                                       const __nv_bfloat16*) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lanes[2 * i] = __uint_as_float(words[i] << 16);
    lanes[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float* lanes, const float*) {
  return make_uint4(__float_as_uint(lanes[0]), __float_as_uint(lanes[1]),
                    __float_as_uint(lanes[2]), __float_as_uint(lanes[3]));
}

__device__ __forceinline__ unsigned pack_pair(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&pair);
}

__device__ __forceinline__ uint4 pack(const float* lanes, const __nv_bfloat16*) {
  return make_uint4(pack_pair(lanes[0], lanes[1]), pack_pair(lanes[2], lanes[3]),
                    pack_pair(lanes[4], lanes[5]), pack_pair(lanes[6], lanes[7]));
}

// out[i] = blend(taps[R + i], taps[R + i + 1]) with R known at compile time,
// so every index is a register.
template <int R, int V>
__device__ __forceinline__ void blend_at(const float (&taps)[2 * V], float t,
                                         float (&out)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = shear::blend(taps[R + i], taps[R + i + 1], t);
}

template <int V>
__device__ __forceinline__ void blend_select(const float (&taps)[2 * V], int r,
                                             float t, float (&out)[V]) {
  switch (r) {
    case 0: blend_at<0, V>(taps, t, out); break;
    case 1: blend_at<1, V>(taps, t, out); break;
    case 2: blend_at<2, V>(taps, t, out); break;
    case 3: blend_at<3, V>(taps, t, out); break;
    default:
      if constexpr (V == 8) {
        switch (r) {
          case 4: blend_at<4, V>(taps, t, out); break;
          case 5: blend_at<5, V>(taps, t, out); break;
          case 6: blend_at<6, V>(taps, t, out); break;
          default: blend_at<7, V>(taps, t, out); break;
        }
      }
      break;
  }
}

// Row index -> source row pointer, destination row pointer and the shift.
template <typename T>
__device__ __forceinline__ void locate_row(const View& v, long long row, const T* in,
                                           const float* shift, T* out, const T*& src,
                                           T*& dst, int& f, float& t) {
  const long long plane = row / v.h;
  const int y = static_cast<int>(row - plane * v.h);
  const long long n = plane / v.c;
  const int c = static_cast<int>(plane - n * v.c);
  shear::split_shift(__ldg(shift + n * v.h + y), f, t);
  src = in + n * v.stride_n + c * v.stride_c + static_cast<long long>(y) * v.w;
  dst = out + row * v.w;
}

// blockDim = (threads along the row, rows per block); grid = (row blocks,
// column blocks). Needs W % V == 0 and 16-byte aligned rows.
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
shear_rows_vec_kernel(const T* __restrict__ in, const float* __restrict__ shift,
                      T* __restrict__ out, View v, long long rows) {
  constexpr int V = Lanes<T>::kCount;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const int x0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (row >= rows || x0 >= v.w) return;
  const T* src;
  T* dst;
  int f;
  float t;
  locate_row(v, row, in, shift, out, src, dst, f, t);

  const int first = x0 + f;            // the run is [first, first + V]
  const int lo_at = first & ~(V - 1);  // aligned start at or below it
  const int r = first & (V - 1);
  const int hi_at = lo_at + V;
  // W % V == 0, so an aligned vector lies wholly inside the row or outside.
  uint4 lo = make_uint4(0u, 0u, 0u, 0u);
  uint4 hi = lo;
  if (lo_at >= 0 && lo_at < v.w) lo = __ldg(reinterpret_cast<const uint4*>(src + lo_at));
  if (hi_at >= 0 && hi_at < v.w) hi = __ldg(reinterpret_cast<const uint4*>(src + hi_at));
  float taps[2 * V];
  unpack(lo, taps, src);
  unpack(hi, taps + V, src);
  float res[V];
  blend_select<V>(taps, r, t, res);
  *reinterpret_cast<uint4*>(dst + x0) = pack(res, src);
}

// One block per row, any width and alignment.
template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
shear_rows_scalar_kernel(const T* __restrict__ in, const float* __restrict__ shift,
                         T* __restrict__ out, View v) {
  const T* src;
  T* dst;
  int f;
  float t;
  locate_row(v, static_cast<long long>(blockIdx.x), in, shift, out, src, dst, f, t);
  for (int x = threadIdx.x; x < v.w; x += blockDim.x) {
    const int i0 = x + f;
    const int i1 = i0 + 1;
    const float a = (i0 >= 0 && i0 < v.w) ? shear::load_as_float(src + i0) : 0.0f;
    const float b = (i1 >= 0 && i1 < v.w) ? shear::load_as_float(src + i1) : 0.0f;
    shear::store_from_float(dst + x, shear::blend(a, b, t));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* in, const void* shift, void* out, View v, int device,
           void* stream) {
  constexpr int V = Lanes<T>::kCount;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(v.n) * v.c * v.h;
  if (rows <= 0 || v.w <= 0) return static_cast<int>(cudaSuccess);
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vectors = v.w % V == 0 && v.stride_n % V == 0 && v.stride_c % V == 0 &&
                       aligned16(in) && aligned16(out);
  if (vectors) {
    const int per_row = v.w / V;
    int tx = 32;  // threads along the row: a power of two, a warp at least
    while (tx < per_row && tx < kVecThreads) tx *= 2;
    const int ty = kVecThreads / tx;
    const long long grid_y = (per_row + tx - 1) / tx;
    if (grid_y > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(tx, ty);
    const dim3 grid(static_cast<unsigned>((rows + ty - 1) / ty),
                    static_cast<unsigned>(grid_y));
    shear_rows_vec_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(in), static_cast<const float*>(shift),
        static_cast<T*>(out), v, rows);
  } else {
    shear_rows_scalar_kernel<T><<<static_cast<unsigned>(rows), kScalarThreads, 0, s>>>(
        static_cast<const T*>(in), static_cast<const float*>(shift),
        static_cast<T*>(out), v);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int shear_rows_f32(const void* in, const void* shift, void* out, int n, int c, int h,
                   int w, long long stride_n, long long stride_c, int device,
                   void* stream) {
  return launch<float>(in, shift, out, View{n, c, h, w, stride_n, stride_c}, device,
                       stream);
}

int shear_rows_bf16(const void* in, const void* shift, void* out, int n, int c, int h,
                    int w, long long stride_n, long long stride_c, int device,
                    void* stream) {
  return launch<__nv_bfloat16>(in, shift, out, View{n, c, h, w, stride_n, stride_c},
                               device, stream);
}

const char* shear_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
