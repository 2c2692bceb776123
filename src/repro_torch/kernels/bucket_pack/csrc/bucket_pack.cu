// Merged-gradient bucket pack / unpack for Hopper (sm_90a), paper §5.3.
//
// Replaces the Pallas kernels of repro/kernels/bucket_pack/kernel.py:
//   K1 pack_chunks_kernel  <- pack_kernel        (body _make_pack_kernel)
//   K2 unpack_tiles_kernel <- unpack_one_kernel  (body _copy_kernel)
//
// Layout (the reference's): every member of a bucket owns a TILE-aligned
// slot of the flat buffer; a member of n elements fills the first n
// elements of its slot, cast to the buffer's dtype, and K1 zero-fills the
// slot's tail.  K2 copies each member back out of its slot with a cast.
// K2 writes straight into the member tensors (in the train step: each
// parameter's .grad, or under ZeRO-1 the parameters), so no per-member
// output is allocated.
//
// Bound: bandwidth.  Both kernels read each input byte once and write each
// output byte once and do no arithmetic beyond a dtype conversion, so the
// least time is (bytes read + bytes written) / 3.35 TB/s.  For one step of
// full-width qwen2-1.5b (3.09 GB of bf16 gradients) that is about 1.8 ms
// for K1 and 1.8 ms for K2; ZeRO-1 also packs the parameters, so 3.7 ms
// of K1.
//
// Against the Pallas grid they replace: the TPU kernel writes one
// 512-element tile per sequential grid step and picks the owning source
// with static compares, chunked at 32 sources per call, and unpack is one
// call per member.  Here there is ONE launch per bucket for pack and one
// for unpack, whatever the member count.
//
// K1 walks a chunk list that kernel.py builds once per table and buffer
// dtype: each chunk is a piece of one member, at most STAGE_BYTES long
// (the builder picks the size), with its source address, its place in the
// buffer and the zeros of its slot's tail, so no thread searches for its
// member.  Chunks whose member has the buffer's dtype, a 16-byte aligned
// address and a 16-byte multiple of length form the bulk list: one thread
// per block moves them with Hopper's bulk asynchronous copies
// (cp.async.bulk global -> shared -> global: the TMA, without a tensor
// map) through a ring of STAGES shared-memory stages, each load completed
// on an mbarrier and each store tracked as a bulk group, so the bytes in
// flight cost no registers.  All other chunks (a cast, a misaligned
// member, a length's last odd bytes, a slot's zero tail) form the
// register list, which the block's other warps copy with U 16-byte loads
// in flight per thread where the source is aligned, element by element
// where it is not.  The launch bounds hold the kernel to
// PACK_BLOCKS_PER_SM blocks an SM, so that one wave of the grid is
// resident.  On the card a step's K1 time is set less by the copy than by
// the fixed cost of each of its ~140 launches, most of them on buckets of
// 5-28 MB; PERF.md has the numbers.
//
// K2 is PR 11's design: a grid-stride loop hands one 512-element tile to
// one warp, which finds the owning member by binary search over the slot
// offsets of a device-side member table (data pointer, element count,
// slot offset, dtype code) and moves two groups of 8 elements per lane
// with 16-byte loads and stores where the member pointer is aligned.
// Same-dtype groups are copied as raw bits; bf16 <-> f32 use
// __float2bfloat16_rn and __bfloat162float, which round like torch's
// .to() on finite values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr long long TILE = 512;
constexpr int THREADS = 256;
constexpr int WARPS_PER_BLOCK = THREADS / 32;
constexpr int BLOCKS_PER_SM = 8;   // K2: 8 x 256 threads fill an SM

enum : int { F32 = 0, BF16 = 1 };

// One row of the member table: four int64 words, as built in kernel.py.
struct Member {
  long long ptr;
  long long n;        // elements of the member
  long long offset;   // first element of its slot in the buffer
  long long dtype;    // F32 or BF16
};

union Group {         // 8 elements of either dtype
  uint4 u[2];
  float f[8];
  unsigned short s[16];
};

__device__ __forceinline__ int find_member(const Member* __restrict__ t,
                                           int m, long long start) {
  // largest i with t[i].offset <= start (a zero-size member shares its
  // offset with the next one and owns no tile, so the later one wins)
  int lo = 0, hi = m - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (t[mid].offset <= start) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void load_group(const char* p, int dt, long long e,
                                           Group& g) {
  if (dt == F32) {
    const uint4* q = reinterpret_cast<const uint4*>(p + e * 4);
    g.u[0] = q[0];
    g.u[1] = q[1];
  } else {
    g.u[0] = *reinterpret_cast<const uint4*>(p + e * 2);
  }
}

__device__ __forceinline__ void store_group(char* p, int dt, long long e,
                                            const Group& g) {
  if (dt == F32) {
    uint4* q = reinterpret_cast<uint4*>(p + e * 4);
    q[0] = g.u[0];
    q[1] = g.u[1];
  } else {
    *reinterpret_cast<uint4*>(p + e * 2) = g.u[0];
  }
}

__device__ __forceinline__ void convert_group(int from, int to, Group& g) {
  if (from == to) return;
  Group o;
  if (from == F32) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o.s[i] = __bfloat16_as_ushort(__float2bfloat16_rn(g.f[i]));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o.f[i] = __bfloat162float(__ushort_as_bfloat16(g.s[i]));
  }
  g = o;
}

__device__ __forceinline__ void copy_one(const char* s, int sdt, long long se,
                                         char* d, int ddt, long long de) {
  if (sdt == ddt) {
    if (sdt == F32)
      reinterpret_cast<unsigned*>(d)[de] =
          reinterpret_cast<const unsigned*>(s)[se];
    else
      reinterpret_cast<unsigned short*>(d)[de] =
          reinterpret_cast<const unsigned short*>(s)[se];
  } else if (sdt == F32) {
    reinterpret_cast<unsigned short*>(d)[de] = __bfloat16_as_ushort(
        __float2bfloat16_rn(reinterpret_cast<const float*>(s)[se]));
  } else {
    reinterpret_cast<float*>(d)[de] = __bfloat162float(__ushort_as_bfloat16(
        reinterpret_cast<const unsigned short*>(s)[se]));
  }
}

__device__ __forceinline__ void zero_one(char* d, int ddt, long long de) {
  if (ddt == F32)
    reinterpret_cast<unsigned*>(d)[de] = 0u;
  else
    reinterpret_cast<unsigned short*>(d)[de] = 0;
}

// ---------------------------------------------------------------------------
// K2: buffer -> members, one 512-element tile per warp.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
unpack_tiles_kernel(const Member* __restrict__ table, int n_members,
                    const char* buf, int buf_dt, long long n_tiles) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long t = warp; t < n_tiles; t += n_warps) {
    const long long start = t * TILE;
    const Member mb = table[find_member(table, n_members, start)];
    char* mptr = reinterpret_cast<char*>(mb.ptr);
    const int mdt = static_cast<int>(mb.dtype);
    const long long e0 = start - mb.offset + lane * 8;   // member element
    const long long b0 = start + lane * 8;               // buffer element
    if ((mb.ptr & 15) == 0 && e0 + TILE / 2 + 8 <= mb.n) {
      // both of the lane's groups are whole: two 16-byte vectors in flight
      Group g0, g1;
      load_group(buf, buf_dt, b0, g0);
      load_group(buf, buf_dt, b0 + TILE / 2, g1);
      convert_group(buf_dt, mdt, g0);
      convert_group(buf_dt, mdt, g1);
      store_group(mptr, mdt, e0, g0);
      store_group(mptr, mdt, e0 + TILE / 2, g1);
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long e = e0 + h * (TILE / 2);
      const long long b = b0 + h * (TILE / 2);
      for (int j = 0; j < 8; ++j)
        if (e + j < mb.n) copy_one(buf, buf_dt, b + j, mptr, mdt, e + j);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// ---------------------------------------------------------------------------
// K1: members -> buffer over the chunk list.
// ---------------------------------------------------------------------------

constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 16384;      // kernel.py's CHUNK_BYTES
constexpr int PACK_SMEM = STAGES * STAGE_BYTES + STAGES * 8;
constexpr int PACK_BLOCKS_PER_SM = 3;   // 3 rings of 48 KB, 78 registers
constexpr int U = 2;                    // 16-byte groups in flight a thread

// One chunk: four int64 words as kernel.py packs them (the last two words
// each hold two int32, low half first).
struct Chunk {
  long long src;   // byte address of the chunk's first source element
  long long dst;   // the buffer element it goes to
  int n;           // source elements
  int zeros;       // buffer elements zeroed after them (a slot's tail)
  int dtype;       // source dtype
  int vec;         // register list: 1 if src is 16-byte aligned
};
static_assert(sizeof(Chunk) == 32, "Chunk is four int64 words");

// What a table fixes for one buffer dtype, packed once on the host.
struct PackArgs {
  const Chunk* bulk;   // same dtype, 16-byte aligned, 16-byte multiple
  long long n_bulk;
  const Chunk* reg;    // everything else
  long long n_reg;
  int buf_dtype;
  int unused;
};

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

// global -> shared; completion counted in bytes on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, long long src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global; joins the next committed bulk group
__device__ __forceinline__ void bulk_store(char* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// One thread moves its block's bulk chunks (every gridDim.x-th, from
// blockIdx.x) through the ring: the block's chunk j sits in stage
// j % STAGES.  Loads run up to STAGES - 1 chunks ahead of the stores; a
// stage is refilled once the store that read it has finished reading.
__device__ void bulk_ring(const PackArgs& a, char* buf, unsigned char* smem) {
  const int esz = a.buf_dtype == F32 ? 4 : 2;
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + STAGES * STAGE_BYTES;
  for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long first = blockIdx.x, step = gridDim.x;
  const long long count = (a.n_bulk - first + step - 1) / step;
  auto load = [&](long long j, int s) {
    const Chunk ch = a.bulk[first + j * step];
    const uint32_t bytes = static_cast<uint32_t>(ch.n) * esz;
    mbar_expect_tx(bars + 8 * s, bytes);
    bulk_load(ring + s * STAGE_BYTES, ch.src, bytes, bars + 8 * s);
  };
  for (long long j = 0; j < count && j < STAGES; ++j)
    load(j, static_cast<int>(j));
  uint32_t parity = 0;                 // bit s: the phase stage s waits on
  for (long long j = 0; j < count; ++j) {
    const int s = static_cast<int>(j % STAGES);
    mbar_wait(bars + 8 * s, (parity >> s) & 1u);
    parity ^= 1u << s;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const Chunk ch = a.bulk[first + j * step];
    bulk_store(buf + ch.dst * esz, ring + s * STAGE_BYTES,
               static_cast<uint32_t>(ch.n) * esz);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (j >= 1 && j - 1 + STAGES < count) {
      // the previous iteration's store has read its stage: refill it
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(j - 1 + STAGES, static_cast<int>((j - 1) % STAGES));
    }
  }
  // the ring must outlive the stores' reads, and the writes must land
  // before the block retires
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A chunk of the register list, copied by ``nth`` threads of the block.
__device__ __forceinline__ void copy_chunk(const Chunk& ch, char* buf,
                                           int bdt, int tid, int nth) {
  const char* src = reinterpret_cast<const char*>(ch.src);
  const int sdt = ch.dtype;
  const long long d0 = ch.dst;
  int done = 0;
  if (ch.vec) {
    // source and buffer 16-byte aligned: groups of 8 elements, U in flight
    const int groups = ch.n / 8;
    int g = tid;
    for (; g + (U - 1) * nth < groups; g += U * nth) {
      Group v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_group(src, sdt, static_cast<long long>(g + u * nth) * 8, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        convert_group(sdt, bdt, v[u]);
        store_group(buf, bdt, d0 + static_cast<long long>(g + u * nth) * 8,
                    v[u]);
      }
    }
    for (; g < groups; g += nth) {
      Group v;
      load_group(src, sdt, static_cast<long long>(g) * 8, v);
      convert_group(sdt, bdt, v);
      store_group(buf, bdt, d0 + static_cast<long long>(g) * 8, v);
    }
    done = groups * 8;
  }
  for (int e = done + tid; e < ch.n; e += nth)
    copy_one(src, sdt, e, buf, bdt, d0 + e);
  for (int e = tid; e < ch.zeros; e += nth)
    zero_one(buf, bdt, d0 + ch.n + e);
}

// Thread 0 runs the bulk ring where there are bulk chunks, and the rest of
// warp 0 idles; the other warps, or all of them, walk the register list.
__global__ void __launch_bounds__(THREADS, PACK_BLOCKS_PER_SM)
pack_chunks_kernel(const PackArgs a, char* buf) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool bulk = a.n_bulk > 0;
  if (bulk && threadIdx.x < 32) {
    if (threadIdx.x == 0 && blockIdx.x < a.n_bulk) bulk_ring(a, buf, smem);
    return;
  }
  const int first = bulk ? 32 : 0;
  const int tid = threadIdx.x - first, nth = blockDim.x - first;
  for (long long c = blockIdx.x; c < a.n_reg; c += gridDim.x)
    copy_chunk(a.reg[c], buf, a.buf_dtype, tid, nth);
}

}  // namespace

// C interface, loaded with ctypes.  Each returns the cudaGetLastError()
// code of its launch, or of the attribute call before it (0 = launched).
//
// K1: ``packed`` is the host-side PackArgs a table packed for one buffer
// dtype (a void pointer: a type of this file's unnamed namespace would
// give the function internal linkage), ``buf`` the output buffer.  The
// grid is one block per chunk of the longer list, at most
// PACK_BLOCKS_PER_SM per SM.
extern "C" int bucket_pack_chunks(void* buf, const void* packed,
                                  void* stream) {
  const PackArgs* args = static_cast<const PackArgs*>(packed);
  static int configured = -1;
  if (configured < 0)
    configured = static_cast<int>(cudaFuncSetAttribute(
        pack_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PACK_SMEM));
  if (configured != 0) return configured;
  const long long work =
      args->n_bulk > args->n_reg ? args->n_bulk : args->n_reg;
  if (work == 0) return 0;
  const long long cap =
      static_cast<long long>(sm_count()) * PACK_BLOCKS_PER_SM;
  pack_chunks_kernel<<<static_cast<int>(work < cap ? work : cap), THREADS,
                       PACK_SMEM, static_cast<cudaStream_t>(stream)>>>(
      *args, static_cast<char*>(buf));
  return static_cast<int>(cudaGetLastError());
}

// K2: ``table`` is a device array of n_members rows of four int64 (ptr, n,
// offset, dtype); ``total`` the buffer's element count, a multiple of 512.
extern "C" int bucket_unpack(const void* table, int n_members, void* buf,
                             int buf_dtype, long long total, void* stream) {
  const long long n_tiles = total / TILE;
  if (n_tiles == 0 || n_members <= 0) return 0;
  const long long want = (n_tiles + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const long long cap = static_cast<long long>(sm_count()) * BLOCKS_PER_SM;
  unpack_tiles_kernel<<<static_cast<int>(want < cap ? want : cap), THREADS,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Member*>(table), n_members,
      static_cast<const char*>(buf), buf_dtype, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bucket_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
