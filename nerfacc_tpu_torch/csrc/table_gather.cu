// Gather of 32-bit words from a small table, for Hopper (sm_90a): the
// gather floor of one hash level.
//
// table_gather replaces scripts/bench_hash.py::p_gather (Pallas
// vmem_gather_kernel): out[i] = table[clamp(idx[i], 0, T - 1)] for (N,)
// int32 indices into a (T,) table of 32-bit words.
//
// Redesign: the Pallas kernel keeps the table resident in the TPU's fast
// memory and reads it serially, one dynamic row slice and a lane select
// per index. A 2 MB level table does not fit a block's shared memory but
// stays in the 50 MB L2 after its first touch, which takes the place of
// that residency.
//
// What bounds it: the random table reads. Indices in and words out are
// coalesced streams from and to device memory; each table read pulls a
// 32-byte sector from L2 for 4 useful bytes, and a random read from L2
// takes hundreds of cycles, so the rate is set by how many reads are in
// flight. What the design does about it:
// - a thread loads four indices with one 16-byte read (two such reads per
//   step of its loop), starts all their table reads before it uses any,
//   and stores four words with one 16-byte write;
// - the grid is sized from the card (a fixed number of blocks per SM) and
//   walks the indices in a grid-stride loop, instead of one short-lived
//   block per 256 indices;
// - the index and output streams are read and written with the streaming
//   hints (__ldcs / __stcs: evict first), so that they do not push the
//   table out of L2; the table goes through the read-only path.
//
// Alignment: the 16-byte path needs idx and out on 16-byte boundaries. A
// contiguous view such as idx[1:] is not, and then a word-by-word kernel
// with the same grid and four independent reads in flight per thread
// runs instead; the last N mod 4 words of the 16-byte path are gathered
// word by word by the first threads of the grid.

#include <cstdint>

#include <cuda_runtime.h>

#include "device_info.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;  // 2048 resident threads per SM

// clamped like an out-of-range gather index, so no read leaves the table
__device__ __forceinline__ int gather_one(const int* __restrict__ table,
                                          int e, int T) {
  return __ldg(table + min(max(e, 0), T - 1));
}

__device__ __forceinline__ int4 gather_four(const int* __restrict__ table,
                                            int4 e, int T) {
  int4 v;
  v.x = gather_one(table, e.x, T);
  v.y = gather_one(table, e.y, T);
  v.z = gather_one(table, e.z, T);
  v.w = gather_one(table, e.w, T);
  return v;
}

// idx and out 16-byte aligned; n4 = N / 4 whole vectors
__global__ void __launch_bounds__(kThreads)
    table_gather_vec4_kernel(const int* __restrict__ idx,
                             const int* __restrict__ table,
                             int* __restrict__ out, long long N, int T) {
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  const long long n4 = N / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long i = first;
  // two vectors per step: eight table reads in flight per thread
  for (; i + stride < n4; i += 2 * stride) {
    const int4 ea = __ldcs(idx4 + i);
    const int4 eb = __ldcs(idx4 + i + stride);
    const int4 va = gather_four(table, ea, T);
    const int4 vb = gather_four(table, eb, T);
    __stcs(out4 + i, va);
    __stcs(out4 + i + stride, vb);
  }
  if (i < n4) __stcs(out4 + i, gather_four(table, __ldcs(idx4 + i), T));
  const long long tail = n4 * 4 + first;
  if (tail < N) out[tail] = gather_one(table, idx[tail], T);
}

// any alignment: four independent words per thread and step
__global__ void __launch_bounds__(kThreads)
    table_gather_word_kernel(const int* __restrict__ idx,
                             const int* __restrict__ table,
                             int* __restrict__ out, long long N, int T) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i < N; i += 4 * stride) {
    int e[4], v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long j = i + k * stride;
      e[k] = j < N ? __ldcs(idx + j) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = gather_one(table, e[k], T);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long j = i + k * stride;
      if (j < N) __stcs(out + j, v[k]);
    }
  }
}

}  // namespace

extern "C" int nerfacc_table_gather(const int* idx, const int* table,
                                    int* out, long long N, int T,
                                    void* stream) {
  if (N == 0 || T == 0) return 0;
  int device = 0, sms = 0;
  const cudaError_t err = nerfacc::current_device_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) %
          16 == 0;
  // one thread per vector (or word) until the card is full, then a loop
  const long long items = aligned ? (N + 3) / 4 : N;
  const long long wanted = (items + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * kBlocksPerSM;
  const unsigned int blocks =
      static_cast<unsigned int>(wanted < resident ? wanted : resident);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    table_gather_vec4_kernel<<<blocks, kThreads, 0, s>>>(idx, table, out, N,
                                                         T);
  } else {
    table_gather_word_kernel<<<blocks, kThreads, 0, s>>>(idx, table, out, N,
                                                         T);
  }
  return static_cast<int>(cudaGetLastError());
}
