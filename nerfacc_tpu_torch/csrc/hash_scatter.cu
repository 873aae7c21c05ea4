// Hash-table gradient scatter, for Hopper (sm_90a).
//
// Both entries replace nerfacc_tpu/ops/hash_gather.py::
// hash_grad_scatter_packed (Pallas _scatter_kernel), which the JAX package
// calls once per level from _bwd_pallas:
// - hash_grad_scatter, its counterpart by interface: out[idx[i]] += v[i]
//   for one level's (B,) corner indices and (B, 2) feature-pair
//   cotangents, skipping idx[i] < 0, into a (T, 2) f32 table;
// - hash_grad_scatter_levels, the whole of _bwd_pallas in one launch: for
//   every sample n, level l and corner k, d_table[l, idx - l T] +=
//   w[n, 8 l + k] * (g[n, l], g[n, L + l]) from the encoder's own (N, 8 L)
//   index and weight arrays and the (N, 2 L) feature-major cotangent,
//   skipping indices outside level l's slice and zero pairs. The product
//   is formed in registers (one multiply per feature, rounded as the plain
//   twin rounds it); no per-level copy of the indices and no (8 N, 2)
//   value tensor exist.
//
// Redesign: the Pallas kernel has no scatter on the TPU, so each program
// walks 4,096 corners serially and read-modify-writes one lane-packed row
// of an accumulator that stays resident across a sequential grid. Here
// blocks run in any order, so the sum across them is atomic: an 8-byte
// atomicAdd of the feature pair into the zeroed gradient. No lane packing
// and no padding: any batch size.
//
// What bounds them: not the bytes (12 per corner, and the table once) but
// the number of atomic adds that L2 resolves: sixteen levels of 3.1M
// corners take ~0.61 ms back to back on an H100, ~80 G adds/s, whatever
// the order of the addresses (PyTorch's index_add_ runs at the same rate),
// and a coarse dense level, whose adds go to a few thousand entries, is
// slower still. The only way down is fewer adds. What hash_grad_scatter_levels does about it:
// - The encoder's samples arrive front to back along each ray, a march
//   step apart, so on the coarse levels consecutive samples lie in one
//   cell and share all eight corners. A thread owns four corners of one
//   level (one 16-byte vector of the row) and walks a run of consecutive
//   samples; it keeps the four pending (index, sum) pairs in registers,
//   adds the next sample's term while the index is unchanged and sends
//   the atomicAdd only when the index changes or the run ends. One compare
//   and one select per corner, no shuffle, no shared memory. A run that
//   crosses into the next ray just sees its indices change.
// - Index and weight rows are read with one 16-byte load per thread,
//   neighbouring threads on neighbouring vectors, four samples' loads
//   started before any is used. A sample whose cotangent pair is zero
//   (slots that took no gradient) is skipped before its indices are read.
// - The levels are taken in groups of `group` levels, group-major over
//   the grid, so that the blocks in flight add into the slices of few
//   levels (a 2^19-entry level's slice is 4 MB of the 50 MB L2; all 16
//   are 67 MB).
// Points in no order (uniform random) have no runs: the kernel then makes
// as many adds as the per-level one and runs at its rate.
//
// Alignment: the 16-byte loads need idx and w on 16-byte boundaries (a
// row is 32 L bytes, so only the base pointers matter); otherwise the same
// kernel reads word by word.
//
// Numerics: f32 sums, run sums first and then in atomic order, which
// changes from run to run; they agree with any other order to f32
// summation error, and a run sum has fewer terms per add than the
// per-level kernel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;  // samples whose loads are started together

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

// four consecutive 32-bit words, with one 16-byte load where aligned
template <bool kAligned, typename V, typename S>
__device__ __forceinline__ V load_four(const S* __restrict__ p) {
  if (kAligned) return __ldcs(reinterpret_cast<const V*>(p));
  V v;
  v.x = __ldcs(p);
  v.y = __ldcs(p + 1);
  v.z = __ldcs(p + 2);
  v.w = __ldcs(p + 3);
  return v;
}

// One corner's pending sum: indices are flat (level offset included);
// first <= e < first + T is the level's slice, anything else is skipped.
struct Pending {
  int e;
  float x, y;
};

__device__ __forceinline__ void flush(const Pending& p, float2* out,
                                      int first, int T) {
  if ((unsigned int)p.e - (unsigned int)first >= (unsigned int)T) return;
  if (p.x == 0.0f && p.y == 0.0f) return;
  atomicAdd(out + p.e, make_float2(p.x, p.y));
}

__device__ __forceinline__ void add_term(Pending& p, int e, float w, float g0,
                                         float g1, float2* out, int first,
                                         int T) {
  const float x = __fmul_rn(w, g0), y = __fmul_rn(w, g1);
  if (e == p.e) {
    p.x = __fadd_rn(p.x, x);
    p.y = __fadd_rn(p.y, y);
  } else {
    flush(p, out, first, T);
    p.e = e;
    p.x = x;
    p.y = y;
  }
}

// Thread t of the grid: vector c of `cols` (= 2 * group levels) of run r
// of level group gi, with t = (gi * n_runs + r) * cols + c.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
    hash_grad_scatter_levels_kernel(const int* __restrict__ idx,
                                    const float* __restrict__ w,
                                    const float* __restrict__ g,
                                    float2* __restrict__ out, int N, int L,
                                    int T, int cols, int run_len,
                                    int n_runs) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_group = (long long)n_runs * cols;
  const int gi = (int)(t / per_group);
  const long long rem = t - gi * per_group;
  const int run = (int)(rem / cols);
  const int vec = gi * cols + (int)(rem - (long long)run * cols);
  if (vec >= 2 * L) return;  // past the last level (also: past the grid)
  const int level = vec >> 1;
  const int first = level * T;
  const int row = 8 * L;
  const int s_begin = run * run_len;
  const int s_end = min(N, s_begin + run_len);
  const int* ip = idx + (long long)s_begin * row + 4 * vec;
  const float* wp = w + (long long)s_begin * row + 4 * vec;
  const float* gp = g + (long long)s_begin * 2 * L + level;

  Pending pend[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pend[k] = {-1, 0.0f, 0.0f};

  for (int s = s_begin; s < s_end; s += kAhead) {
    float g0[kAhead], g1[kAhead];
    int4 e[kAhead];
    float4 cw[kAhead];
    bool live[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool in = s + j < s_end;
      g0[j] = in ? __ldg(gp + j * 2 * L) : 0.0f;
      g1[j] = in ? __ldg(gp + j * 2 * L + L) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      live[j] = g0[j] != 0.0f || g1[j] != 0.0f;
      if (live[j]) {
        e[j] = load_four<kAligned, int4>(ip + j * row);
        cw[j] = load_four<kAligned, float4>(wp + j * row);
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (!live[j]) continue;
      add_term(pend[0], e[j].x, cw[j].x, g0[j], g1[j], out, first, T);
      add_term(pend[1], e[j].y, cw[j].y, g0[j], g1[j], out, first, T);
      add_term(pend[2], e[j].z, cw[j].z, g0[j], g1[j], out, first, T);
      add_term(pend[3], e[j].w, cw[j].w, g0[j], g1[j], out, first, T);
    }
    ip += kAhead * row;
    wp += kAhead * row;
    gp += kAhead * 2 * L;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) flush(pend[k], out, first, T);
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

// out is the zeroed (L, T, 2) gradient (or one to add into). group: levels
// per group of the grid, 1..L; run_len: consecutive samples per thread.
extern "C" int nerfacc_hash_grad_scatter_levels(const int* idx, const float* w,
                                                const float* g, float* out,
                                                int N, int L, int T,
                                                int group, int run_len,
                                                void* stream) {
  if (N == 0 || L == 0 || T == 0) return 0;
  if (group < 1 || group > L || run_len < 1 ||
      (long long)L * T > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = 2 * group;
  const int n_runs = (N + run_len - 1) / run_len;
  const int groups = (L + group - 1) / group;
  const long long threads = (long long)groups * n_runs * cols;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(w)) %
          16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* table = reinterpret_cast<float2*>(out);
  if (aligned) {
    hash_grad_scatter_levels_kernel<true>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
            idx, w, g, table, N, L, T, cols, run_len, n_runs);
  } else {
    hash_grad_scatter_levels_kernel<false>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
            idx, w, g, table, N, L, T, cols, run_len, n_runs);
  }
  return static_cast<int>(cudaGetLastError());
}
