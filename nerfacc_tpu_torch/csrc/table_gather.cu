// Gather of 32-bit words from a small table, for Hopper (sm_90a): the
// gather floor of one hash level.
//
// table_gather replaces scripts/bench_hash.py::p_gather (Pallas
// vmem_gather_kernel): out[i] = table[idx[i]] for (N,) int32 indices into
// a (T,) table of 32-bit words.
//
// Redesign: the Pallas kernel keeps the table resident in the TPU's fast
// memory and reads it serially, one dynamic row slice and a lane select
// per index. Here one thread owns one index and issues one read-only load;
// a 2 MB level table does not fit a block's shared memory but stays in the
// 50 MB L2 after its first touch, which takes the place of that residency.
//
// What bounds it: bytes. Indices in and words out are coalesced 4-byte
// streams; the random table reads each pull a 32-byte sector from L2 for
// 4 useful bytes, so the L2's sector rate, not device memory, sets the
// time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void table_gather_kernel(const int* __restrict__ idx,
                                    const int* __restrict__ table,
                                    int* __restrict__ out, long long N,
                                    int T) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  // clamped like an out-of-range gather index, so no read leaves the table
  const int e = min(max(idx[i], 0), T - 1);
  out[i] = __ldg(table + e);
}

}  // namespace

extern "C" int nerfacc_table_gather(const int* idx, const int* table,
                                    int* out, long long N, int T,
                                    void* stream) {
  if (N == 0 || T == 0) return 0;
  const long long blocks = (N + kThreads - 1) / kThreads;
  table_gather_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(idx, table, out,
                                                             N, T);
  return static_cast<int>(cudaGetLastError());
}
