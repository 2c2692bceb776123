// Merged-gradient bucket pack / unpack for Hopper (sm_90a), paper §5.3.
//
// Replaces the Pallas kernels of repro/kernels/bucket_pack/kernel.py:
//   K1 bucket_pack   <- pack_kernel        (body _make_pack_kernel)
//   K2 bucket_unpack <- unpack_one_kernel  (body _copy_kernel)
//
// Layout (the reference's): every member of a bucket owns a TILE-aligned
// slot of the flat buffer; a member of n elements fills the first n
// elements of its slot, cast to the buffer's dtype, and K1 zero-fills the
// slot's tail.  K2 copies each member back out of its slot with a cast.
// K2 writes straight into the member tensors (in the train step: each
// parameter's .grad, in place), so no per-member output is allocated.
//
// Bound: bandwidth.  Both kernels read each input byte once and write each
// output byte once and do no arithmetic beyond a dtype conversion, so the
// least time is (bytes read + bytes written) / 3.35 TB/s.  For one step of
// full-width qwen2-1.5b (3.09 GB of bf16 gradients) that is about 1.8 ms
// for K1 and 1.8 ms for K2.
//
// Design, against the Pallas grid it replaces: the TPU kernel writes one
// 512-element tile per sequential grid step and picks the owning source
// with static compares, chunked at 32 sources per call, and unpack is one
// call per member.  Here there is ONE launch per bucket for pack and one
// for unpack, whatever the member count.  The launch is driven by a
// device-side member table (data pointer, element count, slot offset,
// dtype code) built once per plan.  A grid-stride loop hands one 512-element
// tile to one warp; the warp finds the owning member by binary search over
// the slot offsets (the table is small and stays in L1), and each lane
// moves two groups of 8 elements with 16-byte loads and stores where the
// member pointer is 16-byte aligned and the group is whole, else element
// by element.  Same-dtype groups are copied as raw bits; bf16 <-> f32 use
// __float2bfloat16_rn and __bfloat162float, which round like torch's
// .to() on finite values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr long long TILE = 512;
constexpr int THREADS = 256;
constexpr int WARPS_PER_BLOCK = THREADS / 32;
constexpr int BLOCKS_PER_SM = 8;   // 8 x 256 threads fill an SM's 2048

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

// PACK: members -> buffer (zero-filled slot tails).  !PACK: buffer -> members.
template <bool PACK>
__global__ void __launch_bounds__(THREADS)
bucket_copy(const Member* __restrict__ table, int n_members, char* buf,
            int buf_dt, long long n_tiles) {
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
      if (PACK) {
        load_group(mptr, mdt, e0, g0);
        load_group(mptr, mdt, e0 + TILE / 2, g1);
        convert_group(mdt, buf_dt, g0);
        convert_group(mdt, buf_dt, g1);
        store_group(buf, buf_dt, b0, g0);
        store_group(buf, buf_dt, b0 + TILE / 2, g1);
      } else {
        load_group(buf, buf_dt, b0, g0);
        load_group(buf, buf_dt, b0 + TILE / 2, g1);
        convert_group(buf_dt, mdt, g0);
        convert_group(buf_dt, mdt, g1);
        store_group(mptr, mdt, e0, g0);
        store_group(mptr, mdt, e0 + TILE / 2, g1);
      }
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long e = e0 + h * (TILE / 2);
      const long long b = b0 + h * (TILE / 2);
      for (int j = 0; j < 8; ++j) {
        if (e + j < mb.n) {
          if (PACK) copy_one(mptr, mdt, e + j, buf, buf_dt, b + j);
          else copy_one(buf, buf_dt, b + j, mptr, mdt, e + j);
        } else if (PACK) {
          zero_one(buf, buf_dt, b + j);
        }
      }
    }
  }
}

int grid_for(long long n_tiles) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  long long want = (n_tiles + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  return static_cast<int>(want < cap ? want : cap);
}

template <bool PACK>
int launch(const void* table, int n_members, void* buf, int buf_dtype,
           long long total, void* stream) {
  const long long n_tiles = total / TILE;
  if (n_tiles == 0 || n_members <= 0) return 0;
  bucket_copy<PACK><<<grid_for(n_tiles), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Member*>(table), n_members, static_cast<char*>(buf),
      buf_dtype, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  ``table`` is a device array of
// n_members rows of four int64 (ptr, n, offset, dtype); ``total`` is the
// buffer's element count, a multiple of 512.  Each returns the
// cudaGetLastError() code of its launch (0 = launched).
extern "C" int bucket_pack(const void* table, int n_members, void* buf,
                           int buf_dtype, long long total, void* stream) {
  return launch<true>(table, n_members, buf, buf_dtype, total, stream);
}

extern "C" int bucket_unpack(const void* table, int n_members, void* buf,
                             int buf_dtype, long long total, void* stream) {
  return launch<false>(table, n_members, buf, buf_dtype, total, stream);
}

extern "C" const char* bucket_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
