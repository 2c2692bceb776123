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
// Against the Pallas grid it replaces: the TPU grid walks the key blocks
// in order and carries m, l and acc in VMEM scratch from one grid step to
// the next.  A CUDA grid has no order, so a block takes one (batch, query
// head, query rows) at a time and loops over its key tiles itself.  Both
// kernels read q, k and v in their [B, S, H, D] layout through strides,
// with no transposes and no padding, write o as [B, Sq, Hq, D], and skip
// key tiles that the causal or window mask hides from every row, which
// changes nothing: such a tile leaves m, l and acc as they are.  The C
// entry point picks the kernel by dtype, a documented route and no
// fallback: every bfloat16 call runs flash_fwd_tc or returns an error.
//
// bfloat16: flash_fwd_tc, on the tensor cores.  A block has two consumer
// warpgroups of 64 query rows each and one producer warpgroup, which
// gives its registers to the consumers (setmaxnreg).  It is persistent:
// one block per SM walks the work items (batch, head, 128 rows), those
// with the most keys first, so that each block's next q and K/V tiles load
// while it finishes the last item.
// - One producer thread loads each item's q (two buffers) and then its K
//   and V tiles of 128 keys into a ring of two stages in shared memory
//   with TMA (cp.async.bulk.tensor over a tensor map of the strided
//   [B, S, H, D] view, built on the host per call).  Each q buffer and
//   each stage's K and V has an mbarrier that counts the bytes in and one
//   that the consumers release, so tile t+1 loads while tile t is
//   multiplied.  TMA writes the 128-byte swizzle that the wgmma
//   descriptors read; D is cut into 64-wide chunks (one 128-byte row of the
//   swizzle), and rows or columns past the tensor's end arrive as zeros,
//   so ragged lengths and D < 64 or D = 96 need no padding in memory.
// - S = q k^T is wgmma.m64n128k16 with both operands in shared memory.
//   The softmax runs on S in the registers the product left it in: each
//   thread holds two rows, and a row's max and sum are reduced across the
//   four lanes that share it (the sum only once, at the end).  m, l and the
//   o accumulator stay in registers as float32; the softmax is taken in
//   base 2 with the scale folded into log2(e), which is the same function.
//   Only tiles on a mask's edge test each element, in a separate copy of
//   the softmax, so that the other tiles issue no mask instructions.
// - O += P V is wgmma.m64nNk16 with P in registers (the accumulator layout
//   of S is the A-operand layout of a k16 slice, so no shuffle) and V in
//   shared memory as a transposed B operand: its D dim is contiguous.  A
//   warpgroup issues P V of one tile and S of the next back to back and
//   waits for both once, and the two warpgroups' softmaxes overlap each
//   other's products.
// - The one numerical departure from the Pallas kernel: P is rounded to
//   bfloat16 for the second product (the Pallas kernel multiplies float32
//   p by float32 v).  l sums the unrounded p.  This keeps the result within
//   the bf16 tolerance (2e-2) of the plain version; the tests pin it.
// - TMA needs a 16-byte aligned base and 16-byte strides; the wrapper
//   refuses other bfloat16 views rather than copying them.
//
// float32: flash_fwd, SIMT.  bf16 tensor cores cannot meet float32's 2e-5
// tolerance, so float32 keeps this first form: tiles widened to float32 in
// shared memory (rows padded by one word against bank conflicts), 256
// threads as 16 x 16, each computing a 4 x 2 block of scores and a
// 4 x D/16 block of the output, m and l in shared memory.  It is bound by
// shared-memory loads, far from the card's rate.

#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda
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
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
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


// ---------------------------------------------------------------------------
// bfloat16: flash_fwd_tc on the tensor cores (see the note at the top).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int CONSUMER_WGS = 2;                  // warpgroups of 64 rows
constexpr int BQ = 64 * CONSUMER_WGS;            // query rows per block
constexpr int BK = 128;                          // keys per tile
constexpr int STAGES = 2;                        // K/V ring depth
constexpr int CONSUMER_WARPS = 4 * CONSUMER_WGS;
constexpr int THREADS = 128 * (CONSUMER_WGS + 1);  // + the producer
// registers per thread after setmaxnreg: the producer warpgroup gives its
// share to the consumers (2 x 128 x 232 + 128 x 40 <= 65536)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int ROW = 128;    // bytes of one 64-wide chunk row: the swizzle
constexpr int Q_CHUNK = BQ * ROW;     // bytes of one 64-wide chunk of q
constexpr int KV_CHUNK = BK * ROW;    // of one chunk of a K or V tile
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  void* o;
  long long o_sb, o_ss, o_sh;  // element strides of o
  int batch, sq, skv, hq, group, causal, window;
  int q_tiles, items;          // BQ-row tiles of q per head; work items
  float scale_log2;            // scale * log2(e): the softmax is in base 2
};

template <int D>
constexpr int smem_bytes() {
  // 1024 for aligning the swizzled tiles; two q tiles; K and V stages;
  // mbarriers
  constexpr int dc = D <= 64 ? 1 : 2;
  return 1024 + 2 * dc * BQ * ROW + 2 * STAGES * dc * BK * ROW +
         8 * (4 + 4 * STAGES);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra LAB_DONE;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-d tensor map (D, S, H, B) into shared memory; completion
// is counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a tile in the 128-byte swizzle (rows of 128 bytes,
// 1024-byte aligned atoms of 8 rows); the offsets are in bytes.
// K-major operands (q, K): lbo unused (16), sbo = 1024 between 8-row
// groups; a k16 step moves the start by 32 bytes inside the row.
// The transposed operand (V): lbo = the stride between 64-wide chunks of
// N, sbo = 1024 between groups of 8 keys.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B^T over k16: A [64, 16] and B [128, 16], both K-major in shared
// memory, through their descriptors; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B over k16: A [64, 16] bf16 in registers, B [16, 64] in shared
// memory with N contiguous (transposed through the descriptor).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B over k16: A [64, 16] bf16 in registers, B [16, 128] in shared
// memory with N contiguous (transposed through the descriptor).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// One work item: a (batch, query head, BQ query rows) and the key tiles
// that some of its rows may see.  Items are numbered with the rows that
// have the most keys first, so that the last items are the short ones.
struct Item {
  int b, h, q0, t_lo, n_tiles;
};

__device__ __forceinline__ Item item_at(const Args& a, int it) {
  const int bh = it % (a.batch * a.hq);
  Item w;
  w.b = bh / a.hq;
  w.h = bh % a.hq;
  w.q0 = (a.q_tiles - 1 - it / (a.batch * a.hq)) * BQ;
  const int q_last = min(w.q0 + BQ, a.sq) - 1;
  int k_lo = 0, k_hi = a.skv - 1;
  if (a.causal) k_hi = min(k_hi, q_last);
  if (a.window) k_lo = max(0, w.q0 - a.window + 1);
  w.t_lo = k_lo / BK;
  w.n_tiles = k_hi >= k_lo ? k_hi / BK - w.t_lo + 1 : 0;
  return w;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Args a) {
  constexpr int DP = D <= 64 ? 64 : 128;  // D in whole 64-wide chunks
  constexpr int DC = DP / 64;
  constexpr int Q_TILE = DC * Q_CHUNK;
  constexpr int KV_STAGE = DC * KV_CHUNK;
  extern __shared__ uint8_t smem_raw[];
  // two q buffers, so that the next item's q loads during this one
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + 2 * Q_TILE;
  const uint32_t s_v = s_k + STAGES * KV_STAGE;
  // mbarriers (8 bytes each): q landed and q released, per q buffer; K
  // and V landed and K and V released, per stage
  const uint32_t q_full = s_v + STAGES * KV_STAGE;
  const uint32_t q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16;
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full + 8 * qb, 1);
      mbar_init(q_empty + 8 * qb, CONSUMER_WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
      mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block walks items blockIdx.x, + gridDim.x, ...  Its K/V tiles go
  // through one ring: the p-th tile of the block (over all its items) is
  // in stage p % STAGES, and its barriers complete their (p / STAGES)-th
  // phase.
  if (wg == CONSUMER_WGS) {
    // The producer warpgroup gives its registers to the consumers; one
    // thread loads each item's q, then its K and V tiles as stages free.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      int p = 0;
      for (int it = blockIdx.x, n = 0; it < a.items; it += gridDim.x, ++n) {
        const Item w = item_at(a, it);
        const int kvh = w.h / a.group;
        const uint32_t qb = n & 1;
        if (n >= 2) mbar_wait(q_empty + 8 * qb, (n / 2 - 1) & 1);
        mbar_expect_tx(q_full + 8 * qb, Q_TILE);
        for (int c = 0; c < DC; ++c)
          tma_load(s_q + qb * Q_TILE + c * Q_CHUNK, &tm_q, q_full + 8 * qb,
                   64 * c, w.q0, w.h, w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++p) {
          const int s = p % STAGES, k0 = (w.t_lo + i) * BK;
          const uint32_t parity = (p / STAGES - 1) & 1;
          if (p >= STAGES) mbar_wait(k_empty + 8 * s, parity);
          mbar_expect_tx(k_full + 8 * s, KV_STAGE);
          for (int c = 0; c < DC; ++c)
            tma_load(s_k + s * KV_STAGE + c * KV_CHUNK, &tm_k, k_full + 8 * s,
                     64 * c, k0, kvh, w.b);
          if (p >= STAGES) mbar_wait(v_empty + 8 * s, parity);
          mbar_expect_tx(v_full + 8 * s, KV_STAGE);
          for (int c = 0; c < DC; ++c)
            tma_load(s_v + s * KV_STAGE + c * KV_CHUNK, &tm_v, v_full + 8 * s,
                     64 * c, k0, kvh, w.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // A consumer warpgroup owns 64 rows of each item.  In the accumulator
    // layout of wgmma this thread holds rows `row` and `row + 8` of them,
    // and in each 8-wide group of columns the two columns from `col`:
    // element 4 j + 2 hh + e is (row + 8 hh, 8 j + col + e).
    const int col = 2 * (lane & 3);
    auto release = [&](uint32_t bars, int p) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (p % STAGES));
    };
    auto wait_full = [&](uint32_t bars, int p) {
      mbar_wait(bars + 8 * (p % STAGES), (p / STAGES) & 1);
      __syncwarp();
    };
    // a tile this warpgroup does not compute, released once it landed so
    // that the releases keep in step with the ring
    auto pass = [&](int p) {
      wait_full(k_full, p);
      wait_full(v_full, p);
      release(k_empty, p);
      release(v_empty, p);
    };

    int p0 = 0;  // ring position of the item's first tile
    for (int it = blockIdx.x, n = 0; it < a.items; it += gridDim.x, ++n) {
      const Item w = item_at(a, it);
      const int r0 = w.q0 + 64 * wg;
      const int row = r0 + 16 * (warp & 3) + (lane >> 2);
      int wk_lo = 0, wk_hi = a.skv - 1;  // the keys these rows may see
      if (a.causal) wk_hi = min(wk_hi, r0 + 63);
      if (a.window) wk_lo = max(0, r0 - a.window + 1);
      // the item's tiles i0..i1 hold keys these rows see (none if all the
      // rows are past the end of q)
      const int i0 = max(0, wk_lo / BK - w.t_lo);
      const int i1 = r0 < a.sq ? min(w.n_tiles - 1, wk_hi / BK - w.t_lo) : -1;
      const uint32_t qb = n & 1;
      const uint32_t q_rows = s_q + qb * Q_TILE + 64 * wg * ROW;

      float o[DP / 2], s[BK / 2], m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f}, corr[2];
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;

      // S = q K^T of the tile at ring position p over D in k16 steps, both
      // K-major; issued, not waited for
      auto issue_qk = [&](int p) {
        const uint32_t k_tile = s_k + (p % STAGES) * KV_STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n128(s,
                       desc(q_rows + (kk >> 2) * Q_CHUNK + (kk & 3) * 32, 16,
                            1024),
                       desc(k_tile + (kk >> 2) * KV_CHUNK + (kk & 3) * 32,
                            16, 1024),
                       kk > 0);
        wgmma_commit();
      };
      // The online softmax of the item's tile i on S in s, in base 2:
      // p = 2^(s c - m) with c = scale log2(e) and m the running max of
      // s c.  It leaves corr = 2^(m_old - m_new), l updated, and P rounded
      // to bf16 A fragments in pa (k16 slice kk is S's columns 16 kk ..
      // +15).  Only a tile on a mask's edge (MASKED) tests each element,
      // against this thread's two rows' bounds on the key index.  A masked
      // score is -1e30, as in the Pallas kernel, and its p is set to 0,
      // which is what the Pallas kernel's p *= mask does.
      auto softmax = [&](int i, auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
        const int k0 = (w.t_lo + i) * BK;
        int lo[2], hi[2];  // visible: lo <= key - k0 <= hi
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qp = row + 8 * hh;
          hi[hh] = (a.causal ? min(qp, a.skv - 1) : a.skv - 1) - k0;
          lo[hh] = a.window ? qp - a.window + 1 - k0 : -BK;
        }
        auto hidden = [&](int j, int hh, int e) {
          const int kk = 8 * j + col + e;
          return kk > hi[hh] || kk < lo[hh];
        };
        if constexpr (MASKED) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (hidden(j, hh, e)) s[4 * j + 2 * hh + e] = NEG_INF;
        }
        float mx[2][2] = {{NEG_INF, NEG_INF}, {NEG_INF, NEG_INF}};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            mx[hh][j & 1] =
                fmaxf(mx[hh][j & 1],
                      fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        float neg_m[2], sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v = fmaxf(mx[hh][0], mx[hh][1]);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          const float m_new = fmaxf(m[hh], v * a.scale_log2);
          corr[hh] = ex2(m[hh] - m_new);
          m[hh] = m_new;
          neg_m[hh] = -m_new;
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float pv =
                  ex2(fmaf(s[4 * j + 2 * hh + e], a.scale_log2, neg_m[hh]));
              if constexpr (MASKED) {
                if (hidden(j, hh, e)) pv = 0.f;
              }
              s[4 * j + 2 * hh + e] = pv;
              sum[hh][j & 1] += pv;
            }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          l[hh] = l[hh] * corr[hh] + (sum[hh][0] + sum[hh][1]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };
      // the tiles on a mask's edge: some key of the tile is hidden from
      // some row of this warpgroup
      auto on_edge = [&](int i) {
        const int k0 = (w.t_lo + i) * BK;
        return k0 + BK > a.skv || (a.causal && k0 + BK - 1 > r0) ||
               (a.window && k0 <= r0 + 63 - a.window);
      };
      auto run_softmax = [&](int i) {
        if (on_edge(i))
          softmax(i, Flag<true>{});
        else
          softmax(i, Flag<false>{});
      };
      // o += P V of the tile at ring position p over its keys in k16
      // steps, V N-major; issued, not waited for
      auto issue_pv = [&](int p) {
        const uint32_t v_tile = s_v + (p % STAGES) * KV_STAGE;
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<DP>(o, pa[kk],
                       desc(v_tile + kk * 16 * ROW, KV_CHUNK, 1024));
        wgmma_commit();
      };

      mbar_wait(q_full + 8 * qb, (n / 2) & 1);
      __syncwarp();
      // Step t issues P V of tile t-1 and S = q K^T of tile t back to
      // back, as far as this warpgroup computes them, waits for both, and
      // runs the softmax of tile t.  While one warpgroup runs its softmax
      // the other's products keep the tensor cores busy.
      for (int t = 0; t <= w.n_tiles; ++t) {
        const bool pv = t >= 1 && t - 1 >= i0 && t - 1 <= i1;
        const bool qk = t < w.n_tiles && t >= i0 && t <= i1;
        if (pv) wait_full(v_full, p0 + t - 1);
        if (qk) wait_full(k_full, p0 + t);
        if (pv) issue_pv(p0 + t - 1);
        if (qk) issue_qk(p0 + t);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(s);
        if (pv) release(v_empty, p0 + t - 1);
        if (t < w.n_tiles) {
          if (qk) {
            release(k_empty, p0 + t);
            run_softmax(t);
#pragma unroll
            for (int j = 0; j < DP / 2; ++j) o[j] *= corr[(j >> 1) & 1];
          } else {
            pass(p0 + t);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty + 8 * qb);  // this item's q is read
      p0 += w.n_tiles;

      // o = acc / max(l, 1e-30), the quad's partial sums added first
      __nv_bfloat16* ob =
          static_cast<__nv_bfloat16*>(a.o) + w.b * a.o_sb + w.h * a.o_sh;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float lt = l[hh];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float inv = 1.f / fmaxf(lt, 1e-30f);
        const int qp = row + 8 * hh;
        if (qp >= a.sq) continue;
        __nv_bfloat16* orow = ob + qp * a.o_ss;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int c = 8 * j + col;
          if (c < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                      o[4 * j + 2 * hh + 1] * inv);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the runtime already loaded,
// so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 [B, S, H, D] view with element strides sb, ss,
// sh (unit stride in D): dims (D, S, H, B), a box of 64 elements of D (one
// 128-byte swizzle row) by `rows` positions of one head.  A dim of extent
// 1 gets a nominal stride, since TMA wants every stride a multiple of 16
// bytes and that one is never stepped.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq,
              int heads, int d, long long sb, long long ss, long long sh,
              int rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  auto bytes = [](long long stride, int extent) -> cuuint64_t {
    return extent > 1 ? static_cast<cuuint64_t>(stride) * 2 : 16;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bytes(ss, seq), bytes(sh, heads),
                                 bytes(sb, batch)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const Params& p, int batch, int hq, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int hkv = hq / p.group;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, batch, p.sq, hq, D, p.q_sb, p.q_ss, p.q_sh, BQ) ||
      !make_map(&tk, p.k, batch, p.skv, hkv, D, p.k_sb, p.k_ss, p.k_sh, BK) ||
      !make_map(&tv, p.v, batch, p.skv, hkv, D, p.v_sb, p.v_ss, p.v_sh, BK))
    return -4;
  Args a;
  a.o = p.o;
  a.o_sb = p.o_sb;
  a.o_ss = p.o_ss;
  a.o_sh = p.o_sh;
  a.batch = batch;
  a.sq = p.sq;
  a.skv = p.skv;
  a.hq = hq;
  a.group = p.group;
  a.causal = p.causal;
  a.window = p.window;
  a.scale_log2 = p.scale * LOG2E;
  a.q_tiles = (p.sq + BQ - 1) / BQ;
  a.items = batch * hq * a.q_tiles;
  // persistent: one block per SM walks the items
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = a.items < sms ? a.items : sms;
  flash_fwd_tc<D><<<blocks, THREADS, bytes, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int d, int batch, int hq, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16>(p, batch, hq, s);
    case 32: return launch<32>(p, batch, hq, s);
    case 64: return launch<64>(p, batch, hq, s);
    case 96: return launch<96>(p, batch, hq, s);
    case 128: return launch<128>(p, batch, hq, s);
    default: return -2;
  }
}

}  // namespace tc

}  // namespace

// C interface, loaded with ctypes.  q [B, Sq, Hq, D], k and v [B, Skv, Hkv,
// D] and o [B, Sq, Hq, D], all of one dtype (0 = float32, 1 = bfloat16),
// unit stride in D; ``strides`` holds 12 int64 element strides: batch,
// sequence and head of q, k, v and o in that order.  The dtype picks the
// kernel: float32 runs flash_fwd, bfloat16 flash_fwd_tc.  Returns the
// cudaGetLastError() code of the launch (0 = launched), -1 for an unknown
// dtype code, -2 for a head dim the kernels are not built for, -3 for a
// GQA mismatch, -4 for a bfloat16 operand that TMA cannot map.
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
  if (dtype == BF16) return tc::dispatch(p, d, batch, hq, s);
  return -1;
}

extern "C" const char* kernel_error_string(int code) {
  switch (code) {
    case -1: return "unknown dtype code";
    case -2: return "head dim not supported (16, 32, 64, 96 or 128)";
    case -3: return "query heads are not a multiple of KV heads";
    case -4:
      return "no TMA tensor map for a bfloat16 operand (its base must be "
             "16-byte aligned and its strides multiples of 16 bytes)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
