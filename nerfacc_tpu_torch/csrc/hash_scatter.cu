// Hash-table gradient scatter, for Hopper (sm_90a).
//
// hash_grad_scatter replaces nerfacc_tpu/ops/hash_gather.py::
// hash_grad_scatter_packed (Pallas _scatter_kernel): out[idx[i]] += v[i]
// for a level's (B,) corner indices and (B, 2) feature-pair cotangents,
// skipping idx[i] < 0, into a (T, 2) f32 table.
//
// Redesign: the Pallas kernel has no scatter on the TPU, so each program
// walks 4,096 corners serially and read-modify-writes one lane-packed row
// of an accumulator that stays resident across a sequential grid. Here
// blocks run in any order, so the sum across them is atomic: one thread
// owns one corner, reads its index and its feature pair (4 + 8 bytes,
// coalesced) and adds the pair into the table with one 8-byte atomicAdd.
// The caller zeroes the table, or passes a slice of an already zeroed
// gradient. No lane packing and no padding: any B.
//
// What bounds it: bytes. The level table (4 MB at T = 2^19) stays in L2,
// so device memory sees the 12 bytes per corner and the table once; the
// L2 atomic units see one add per corner. A coarse dense level sends all
// its adds to a few thousand entries, where contention on single
// addresses, not bandwidth, sets the time. Corners whose pair is exactly
// zero (slots that took no gradient) are skipped: adding zero changes
// nothing.
//
// Numerics: the f32 sums run in atomic order, which changes from run to
// run; they agree with any other order to f32 summation error.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void hash_grad_scatter_kernel(const int* __restrict__ idx,
                                         const float2* __restrict__ v,
                                         float2* __restrict__ out,
                                         long long B, int T) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int e = idx[i];
  // e < 0 marks padding; e >= T would write outside the table
  if (e < 0 || e >= T) return;
  const float2 val = v[i];
  if (val.x == 0.0f && val.y == 0.0f) return;
  atomicAdd(out + e, val);
}

}  // namespace

extern "C" int nerfacc_hash_grad_scatter(const int* idx, const float* v,
                                         float* out, long long B, int T,
                                         void* stream) {
  if (B == 0 || T == 0) return 0;
  const long long blocks = (B + kThreads - 1) / kThreads;
  hash_grad_scatter_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      idx, reinterpret_cast<const float2*>(v),
      reinterpret_cast<float2*>(out), B, T);
  return static_cast<int>(cudaGetLastError());
}
