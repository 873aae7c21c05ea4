// Variants of the table gather out[i] = table[clamp(idx[i], 0, T - 1)] that
// scripts/bench_gather_variants_torch.py times beside the package's kernel
// (nerfacc_tpu_torch/csrc/table_gather.cu), on Hopper (sm_90a). None of
// them is part of the package. All take 16-byte aligned idx and out and
// gather N / 4 whole vectors.
//
// - vectors per step (1, 2, 4: four, eight, sixteen table reads in flight
//   per thread), blocks per SM (0: one thread per vector, no loop) and the
//   streaming hints on the index and output streams, on or off;
// - the table in the distributed shared memory of a thread block cluster:
//   16 blocks x (T / 16) words, each block loads its slice, and every read
//   goes to the block that holds the word (cluster.map_shared_rank). The
//   nearest thing this card has to a table resident in fast memory.
//
// read_l2 is the yardstick for the gather's L2 traffic: 16-byte reads of a
// buffer that fits L2, past L1 (ld.cg), several passes in one launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 16;
constexpr int kClusterThreads = 1024;

__device__ __forceinline__ int gather_one(const int* __restrict__ table,
                                          int e, int T) {
  return __ldg(table + min(max(e, 0), T - 1));
}

template <int kVectors, bool kStream>
__global__ void __launch_bounds__(kThreads)
    gather_vec4(const int* __restrict__ idx, const int* __restrict__ table,
                int* __restrict__ out, long long N, int T) {
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  const long long n4 = N / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i < n4; i += kVectors * stride) {
    int4 e[kVectors], v[kVectors];
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      const long long j = i + k * stride;
      e[k] = j >= n4 ? make_int4(0, 0, 0, 0)
                     : (kStream ? __ldcs(idx4 + j) : idx4[j]);
    }
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      v[k].x = gather_one(table, e[k].x, T);
      v[k].y = gather_one(table, e[k].y, T);
      v[k].z = gather_one(table, e[k].z, T);
      v[k].w = gather_one(table, e[k].w, T);
    }
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      const long long j = i + k * stride;
      if (j >= n4) continue;
      if (kStream) {
        __stcs(out4 + j, v[k]);
      } else {
        out4[j] = v[k];
      }
    }
  }
}

// words_log2: log2 of the words each block of the cluster holds
__global__ void __launch_bounds__(kClusterThreads)
    gather_cluster(const int* __restrict__ idx, const int* __restrict__ table,
                   int* __restrict__ out, long long N, int T, int words_log2) {
  extern __shared__ int slice[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  const int words = 1 << words_log2;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const long long t = (long long)rank * words + i;
    slice[i] = t < T ? table[t] : 0;
  }
  cluster.sync();
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  const long long n4 = N / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const int4 e = __ldcs(idx4 + i);
    const int ex = min(max(e.x, 0), T - 1), ey = min(max(e.y, 0), T - 1);
    const int ez = min(max(e.z, 0), T - 1), ew = min(max(e.w, 0), T - 1);
    int4 v;
    v.x = cluster.map_shared_rank(slice, ex >> words_log2)[ex & (words - 1)];
    v.y = cluster.map_shared_rank(slice, ey >> words_log2)[ey & (words - 1)];
    v.z = cluster.map_shared_rank(slice, ez >> words_log2)[ez & (words - 1)];
    v.w = cluster.map_shared_rank(slice, ew >> words_log2)[ew & (words - 1)];
    __stcs(out4 + i, v);
  }
  // no block leaves while another may still read its slice
  cluster.sync();
}

__global__ void __launch_bounds__(kThreads)
    read_l2(const int4* __restrict__ buf, long long n4, int passes,
            int* sink) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  int4 acc = make_int4(0, 0, 0, 0);
  for (int pass = 0; pass < passes; ++pass) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (; i + 3 * stride < n4; i += 4 * stride) {
      const int4 a = __ldcg(buf + i), b = __ldcg(buf + i + stride);
      const int4 c = __ldcg(buf + i + 2 * stride);
      const int4 d = __ldcg(buf + i + 3 * stride);
      acc.x ^= a.x ^ b.x ^ c.x ^ d.x;
      acc.y ^= a.y ^ b.y ^ c.y ^ d.y;
      acc.z ^= a.z ^ b.z ^ c.z ^ d.z;
      acc.w ^= a.w ^ b.w ^ c.w ^ d.w;
    }
    for (; i < n4; i += stride) {
      const int4 a = __ldcg(buf + i);
      acc.x ^= a.x;
      acc.y ^= a.y;
      acc.z ^= a.z;
      acc.w ^= a.w;
    }
  }
  // never true for the benchmark's buffer of ones: keeps the reads alive
  if ((acc.x ^ acc.y ^ acc.z ^ acc.w) == 0x5eed5eed) *sink = 1;
}

template <int kVectors, bool kStream>
int launch_vec4(const int* idx, const int* table, int* out, long long N, int T,
                unsigned int blocks, cudaStream_t s) {
  gather_vec4<kVectors, kStream><<<blocks, kThreads, 0, s>>>(idx, table, out,
                                                             N, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* variants_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vectors: 1, 2 or 4; blocks_per_sm 0: one thread per vector
extern "C" int variants_gather_vec4(int vectors, int stream_hints,
                                    int blocks_per_sm, const int* idx,
                                    const int* table, int* out, long long N,
                                    int T, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wanted = (N / 4 + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * blocks_per_sm;
  const unsigned int blocks = static_cast<unsigned int>(
      blocks_per_sm > 0 && wanted > resident ? resident : wanted);
  if (blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool hints = stream_hints != 0;
  switch (vectors) {
    case 1:
      return hints ? launch_vec4<1, true>(idx, table, out, N, T, blocks, s)
                   : launch_vec4<1, false>(idx, table, out, N, T, blocks, s);
    case 2:
      return hints ? launch_vec4<2, true>(idx, table, out, N, T, blocks, s)
                   : launch_vec4<2, false>(idx, table, out, N, T, blocks, s);
    case 4:
      return hints ? launch_vec4<4, true>(idx, table, out, N, T, blocks, s)
                   : launch_vec4<4, false>(idx, table, out, N, T, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Reads n4 16-byte words of buf `passes` times with sms x 8 blocks
extern "C" int variants_read_l2(const void* buf, long long n4, int passes,
                                int* sink, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  read_l2<<<sms * 8, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(buf), n4, passes, sink);
  return static_cast<int>(cudaGetLastError());
}

// *clusters receives how many clusters of 16 the card runs at once
extern "C" int variants_gather_cluster(const int* idx, const int* table,
                                       int* out, long long N, int T,
                                       int* clusters, void* stream) {
  int words_log2 = 0;
  while (((long long)kCluster << words_log2) < T) ++words_log2;
  const size_t bytes = sizeof(int) << words_log2;
  cudaError_t err = cudaFuncSetAttribute(
      gather_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      gather_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, gather_cluster, &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  config.gridDim = dim3(kCluster * *clusters);
  err = cudaLaunchKernelEx(&config, gather_cluster, idx, table, out, N, T,
                           words_log2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
