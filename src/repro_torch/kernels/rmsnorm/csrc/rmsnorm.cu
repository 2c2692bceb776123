// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas kernel of repro/kernels/rmsnorm/kernel.py:
//   K3 rmsnorm <- rmsnorm_kernel (body _kernel)
// y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale, in float32,
// written back in x's dtype (float32, or bfloat16 rounded to nearest even).
//
// Bound: bandwidth.  The kernel reads x and scale once and writes y once,
// with a handful of flops per element, so the least time is
// (bytes of x + bytes of scale + bytes of y) / 3.35 TB/s: 8192 x 1536 bf16
// rows, the prefill shape of qwen2-1.5b at batch 8 x 1024, move 50 MB in
// about 15 us.
//
// Design, against the Pallas grid it replaces: the TPU kernel streams
// blocks of 256 rows through VMEM and needs the rows padded to a block
// multiple.  Here one warp owns one row, eight rows to a 256-thread block,
// and reads x in place with no padding, at any width D and any row stride
// (prefill normalises the last position of each request, a strided view).  The warp's lanes
// stride over the row (16-byte vectors where the row is 16-byte aligned
// and D is a multiple of the vector, else element by element), sum x^2 in
// float32, reduce with shuffles, and take rsqrtf of the mean plus eps.
// A second pass over the row, served from L1, scales and writes y; the
// scale is read in its own dtype (float32 or bfloat16) and widened.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

enum : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float load_scale(const void* s, int dt, long long i) {
  return dt == F32 ? static_cast<const float*>(s)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(s)[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of T, loaded and stored as one vector.
template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T e[N];
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_rows(const T* __restrict__ x, long long x_stride,
             const void* __restrict__ scale, int scale_dt, T* __restrict__ y,
             long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK +
                      (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* xr = x + r * x_stride;
  T* yr = y + r * d;
  constexpr int N = Vec<T>::N;
  float ss = 0.f;
  if (VEC) {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xr);
    for (int i = lane; i < d / N; i += 32) {
      const Vec<T> g = xv[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float v = to_f32(g.e[j]);
        ss += v * v;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float v = to_f32(xr[i]);
      ss += v * v;
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  if (VEC) {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xr);
    Vec<T>* yv = reinterpret_cast<Vec<T>*>(yr);
    for (int i = lane; i < d / N; i += 32) {
      Vec<T> g = xv[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = load_scale(scale, scale_dt, static_cast<long long>(i) * N + j);
        g.e[j] = from_f32<T>(to_f32(g.e[j]) * inv * s);
      }
      yv[i] = g;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      yr[i] = from_f32<T>(to_f32(xr[i]) * inv * load_scale(scale, scale_dt, i));
    }
  }
}

template <typename T>
int launch(const void* x, long long x_stride, const void* scale, int scale_dt,
           void* y, long long rows, int d, float eps, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const bool vec = d % Vec<T>::N == 0 && x_stride % Vec<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec)
    rmsnorm_rows<T, true><<<blocks, THREADS, 0, s>>>(xt, x_stride, scale,
                                                     scale_dt, yt, rows, d,
                                                     eps);
  else
    rmsnorm_rows<T, false><<<blocks, THREADS, 0, s>>>(xt, x_stride, scale,
                                                      scale_dt, yt, rows, d,
                                                      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  x is [rows, d] of dtype x_dt with unit
// stride in d and x_stride elements between rows; y is a contiguous
// [rows, d] of the same dtype; scale is a contiguous [d] of dtype scale_dt
// (0 = float32, 1 = bfloat16).  Returns the cudaGetLastError() code of the launch
// (0 = launched); -1 for a dtype code it does not know.
extern "C" int rmsnorm(const void* x, int x_dt, long long x_stride,
                       const void* scale, int scale_dt, void* y,
                       long long rows, int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (scale_dt != F32 && scale_dt != BF16) return -1;
  if (x_dt == F32)
    return launch<float>(x, x_stride, scale, scale_dt, y, rows, d, eps,
                         stream);
  if (x_dt == BF16)
    return launch<__nv_bfloat16>(x, x_stride, scale, scale_dt, y, rows, d,
                                 eps, stream);
  return -1;
}

// The same launch with the arguments that a call signature fixes packed in
// one struct, so that the wrapper passes five arguments instead of ten.
struct RmsnormArgs {
  long long x_stride, rows;
  int x_dt, scale_dt, d;
  float eps;
};

extern "C" int rmsnorm_packed(const void* x, const void* scale, void* y,
                              const RmsnormArgs* a, void* stream) {
  return rmsnorm(x, a->x_dt, a->x_stride, scale, a->scale_dt, y, a->rows,
                 a->d, a->eps, stream);
}

extern "C" const char* kernel_error_string(int code) {
  if (code == -1) return "unknown dtype code";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
