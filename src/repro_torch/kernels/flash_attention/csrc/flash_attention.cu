// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel of repro/kernels/flash_attention/kernel.py:
//   K4 flash_attention <- flash_attention_kernel (body _kernel)
// o = softmax(q k^T / sqrt(D) + mask) v, by blocks of keys with an online
// softmax: float32 running max m, sum l and accumulator acc; masked scores
// are set to -1e30 and p is multiplied by the mask, so a tile whose keys
// are all masked adds nothing; o = acc / max(l, 1e-30).  The mask is the
// Pallas kernel's: k_pos < seq_kv and q_pos < seq_q, then causal
// k_pos <= q_pos, then window k_pos > q_pos - window.  GQA: query head h
// reads KV head h / (Hq / Hkv).
//
// Bound: operations.  Per launch the work is 4 * D flops for every
// unmasked (query, key) pair (q.k and p.v), against bytes that are read
// once (q, k, v) and written once (o).  At the prefill shape of
// qwen2-1.5b (q [8, 1024, 12, 128], k/v [8, 1024, 2, 128] bf16, causal)
// that is 25.8 GFLOP and 29 MB: about 26 us at 989 TFLOP/s of dense bf16
// tensor-core work, against 9 us of memory traffic.
//
// Design, against the Pallas grid it replaces: the TPU grid walks the key
// blocks in order and carries m, l and acc in VMEM scratch from one grid
// step to the next.  A CUDA grid has no order, so one block owns one
// (batch, query head, 64 query rows) and loops over the key tiles itself,
// keeping acc in registers and m, l in shared memory.  q, k and v are read
// in their [B, S, H, D] layout through strides, with no transposes and no
// padding, and o is written as [B, Sq, Hq, D].  Key tiles that the causal
// or window mask hides from every row of the block are skipped, which
// changes nothing: such a tile leaves m, l and acc as they are.
//
// This first form is SIMT float32: tiles are widened to float32 in shared
// memory (rows padded by one word against bank conflicts), 256 threads as
// 16 x 16, each computing a 4 x 2 block of scores and a 4 x D/16 block of
// the output.  It is bound by shared-memory loads, far from the tensor
// cores' rate; wgmma, TMA and pipelined tiles are a later redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile (one per lane in the softmax)
constexpr int THREADS = 256;  // 16 x 16
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

enum : int { F32 = 0, BF16 = 1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of the batch, sequence and head dims (D is unit-stride)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
  int sq, skv, group, causal, window;
  float scale;
};

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool allowed(const Params& p, int qp, int kp) {
  bool ok = kp < p.skv && qp < p.sq;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window) ok = ok && kp > qp - p.window;
  return ok;
}

template <int D>
constexpr int smem_floats() {
  // q [BQ][D+1], k [BK][D+1], v [BK][D], p [BQ][BK+1], m, l, corr [BQ]
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(Params p) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1, KS = D + 1, PS = BK + 1, DJ = D / 16;
  float* qs = smem;
  float* ks = qs + BQ * QS;
  float* vs = ks + BK * KS;
  float* ps = vs + BK * D;
  float* m_s = ps + BQ * PS;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, qp = q0 + r;
    qs[r * QS + c] = qp < p.sq ? to_f32(q[qp * p.q_ss + c]) : 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // the keys some row of this block may see
  const int q_last = min(q0 + BQ, p.sq) - 1;
  int k_lo = 0, k_hi = p.skv - 1;
  if (p.causal) k_hi = min(k_hi, q_last);
  if (p.window) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi >= k_lo ? k_hi / BK : t_lo - 1;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's k, v, p are read; q, m, l are set
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, kp = k0 + r;
      const bool in = kp < p.skv;
      ks[r * KS + c] = in ? to_f32(k[kp * p.k_ss + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(v[kp * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        ps[r * PS + c] =
            allowed(p, q0 + r, k0 + c) ? s[i][j] * p.scale : NEG_INF;
      }
    __syncthreads();

    // online softmax: each warp owns BQ / WARPS rows, one key per lane
    for (int rr = 0; rr < BQ / WARPS; ++rr) {
      const int r = warp * (BQ / WARPS) + rr;
      const float sv = ps[r * PS + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float pv = allowed(p, q0 + r, k0 + lane) ? expf(sv - m_new) : 0.f;
      const float sum = warp_sum(pv);
      ps[r * PS + lane] = pv;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    if (qp >= p.sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[qp * p.o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, int hq, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((p.sq + BQ - 1) / BQ, hq, batch);
  flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int d, int batch, int hq, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, hq, s);
    case 32: return launch<T, 32>(p, batch, hq, s);
    case 64: return launch<T, 64>(p, batch, hq, s);
    case 96: return launch<T, 96>(p, batch, hq, s);
    case 128: return launch<T, 128>(p, batch, hq, s);
    default: return -2;
  }
}

}  // namespace

// C interface, loaded with ctypes.  q [B, Sq, Hq, D], k and v [B, Skv, Hkv,
// D] and o [B, Sq, Hq, D], all of one dtype (0 = float32, 1 = bfloat16),
// unit stride in D; ``strides`` holds 12 int64 element strides: batch,
// sequence and head of q, k, v and o in that order.  Returns the
// cudaGetLastError() code of the launch (0 = launched), -1 for an unknown
// dtype code, -2 for a head dim the kernel is not built for.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int dtype, int batch, int sq, int skv,
                               int hq, int hkv, int d,
                               const long long* strides, int causal,
                               int window, float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv) return -3;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sq = sq;
  p.skv = skv;
  p.group = hq / hkv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32) return dispatch<float>(p, d, batch, hq, s);
  if (dtype == BF16) return dispatch<__nv_bfloat16>(p, d, batch, hq, s);
  return -1;
}

extern "C" const char* kernel_error_string(int code) {
  switch (code) {
    case -1: return "unknown dtype code";
    case -2: return "head dim not supported (16, 32, 64, 96 or 128)";
    case -3: return "query heads are not a multiple of KV heads";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
