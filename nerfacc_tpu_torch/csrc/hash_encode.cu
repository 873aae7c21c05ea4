// Hash-grid encoder forward, for Hopper (sm_90a).
//
// hash_encode replaces no TPU kernel. The JAX package's encoder forward is
// XLA: the corner arithmetic of nerfacc_tpu/models/hash_encoding.py::
// HashEncoder.__call__ and the gathers and corner sums of
// nerfacc_tpu/ops/hash_gather.py::_lookup_fwd_impl, which the compiler
// fuses. PyTorch runs the same forward eagerly, some fifty operations whose
// int64 (N, L, 8) intermediates and (N, 8 L, F) gathered rows go through
// device memory; this kernel is that whole forward in one launch. For
// every sample n and level l (resolution res, T entries, F features):
// - xl = x * res, c0 = floor(xl), frac = xl - c0, one f32 rounding each;
//   per axis the candidates min(max(c0 + o, 0), res) for o = 0, 1 and the
//   weights 1 - frac and frac;
// - corner j takes candidate (j >> 2, j >> 1, j) & 1 of (x, y, z); its
//   index is (cx (res + 1) + cy) (res + 1) + cz where the level is dense,
//   else the xor-of-primes hash in uint32 (the low bits of the plain
//   twin's int64 products), masked to T - 1, plus the level offset l T;
//   its weight is (wx * wy) * wz;
// - the corner's table row is read whole (F f32 values), rounded to bf16
//   (to nearest even) where kRound, and blended as acc = acc + w_j * f_j
//   for j = 0..7 from acc = 0, each product and sum rounded apart (the
//   build has no FMA contraction): the reference's order and rounding;
// - out[n, f L + l] = acc[f] (feature-major) and, where kIndex (the table
//   takes a gradient), the eight indices and weights into columns 8 l ..
//   8 l + 8 of the (N, 8 L) arrays that the table gradient (K7) reads.
//
// What bounds it: the 8 L random table reads per sample, each a 32-byte
// L2 sector for 4 F useful bytes (K8's rate, ~107 G sectors/s, puts the
// 2^19 samples x 16 levels of a training query at ~0.63 ms). x in (12
// bytes a sample), the features out (4 F L bytes) and, with kIndex, the
// 64 L bytes of indices and weights are coalesced streams. What the design
// does about it:
// - one thread per (sample, level), the level fastest: a warp holds 32 / L
//   whole samples, so its feature stores are contiguous runs, and a
//   thread's eight indices and eight weights are 32 contiguous bytes each,
//   written with two 16-byte stores (streaming stores, evict-first in L2,
//   measured no faster);
// - a thread computes all eight indices before it reads any row, so eight
//   row reads (sixteen at F = 8) are in flight per thread; a row goes
//   through the read-only path as one 4-, 8- or 16-byte load;
// - no bf16 copy of the table: the rounding happens in registers;
// - the per-level resolutions and dense flags are copied into shared
//   memory once per block.
// The index is masked to the level's T entries on the dense path too,
// which changes nothing for a level whose grid fits (res + 1)^3 <= T and
// keeps every read inside the table whatever flags the caller passes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// one table row of F f32 values at row e, as one load (two at F = 8)
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table,
                                         int e, float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(table + e);
  } else if constexpr (F == 2) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(table) + e);
    v[0] = r.x;
    v[1] = r.y;
  } else {
    static_assert(F == 4 || F == 8, "rows of 1, 2, 4 or 8 features");
    const float4* p = reinterpret_cast<const float4*>(table) +
                      (long long)e * (F / 4);
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 r = __ldg(p + q);
      v[4 * q] = r.x;
      v[4 * q + 1] = r.y;
      v[4 * q + 2] = r.z;
      v[4 * q + 3] = r.w;
    }
  }
}

template <int F, bool kRound, bool kIndex>
__global__ void __launch_bounds__(kThreads)
    hash_encode_kernel(const float* __restrict__ x,
                       const float* __restrict__ table,
                       const long long* __restrict__ res,
                       const bool* __restrict__ dense,
                       float* __restrict__ out, int* __restrict__ idx,
                       float* __restrict__ w, long long N, int L, int T) {
  extern __shared__ int level_info[];  // L resolutions, then L dense flags
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    level_info[l] = static_cast<int>(res[l]);
    level_info[L + l] = dense[l] ? 1 : 0;
  }
  __syncthreads();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N * L) return;
  const long long n = t / L;
  const int l = static_cast<int>(t - n * L);
  const int r = level_info[l];
  const bool is_dense = level_info[L + l] != 0;
  const float rf = static_cast<float>(r);
  const unsigned int stride = static_cast<unsigned int>(r) + 1u;

  // per axis and candidate: the index term and the weight
  unsigned int term[3][2];
  float wt[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xl = __fmul_rn(__ldg(x + 3 * n + a), rf);
    const float c0 = floorf(xl);
    const float frac = __fsub_rn(xl, c0);
    wt[a][0] = __fsub_rn(1.0f, frac);
    wt[a][1] = frac;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      // clamped in f32: exact for every c0 that the int64 twin holds
      const unsigned int c = static_cast<unsigned int>(
          fminf(fmaxf(__fadd_rn(c0, static_cast<float>(o)), 0.0f), rf));
      // dense strides, and the primes of the hash
      const unsigned int scale =
          a == 0 ? stride * stride : (a == 1 ? stride : 1u);
      const unsigned int prime =
          a == 0 ? 1u : (a == 1 ? 2654435761u : 805459861u);
      term[a][o] = c * (is_dense ? scale : prime);
    }
  }

  const unsigned int mask = static_cast<unsigned int>(T) - 1u;
  const int first = l * T;
  int e[8];
  float cw[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ox = (j >> 2) & 1, oy = (j >> 1) & 1, oz = j & 1;
    const unsigned int h =
        is_dense ? term[0][ox] + term[1][oy] + term[2][oz]
                 : term[0][ox] ^ term[1][oy] ^ term[2][oz];
    e[j] = first + static_cast<int>(h & mask);
    cw[j] = __fmul_rn(__fmul_rn(wt[0][ox], wt[1][oy]), wt[2][oz]);
  }

  float v[8][F];
#pragma unroll
  for (int j = 0; j < 8; ++j) load_row<F>(table, e[j], v[j]);

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float val = v[j][f];
      if (kRound) val = __bfloat162float(__float2bfloat16_rn(val));
      acc[f] = __fadd_rn(acc[f], __fmul_rn(cw[j], val));
    }
  }
  float* o = out + n * F * L + l;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f * L] = acc[f];

  if (kIndex) {
    int4* ip = reinterpret_cast<int4*>(idx + 8 * t);
    float4* wp = reinterpret_cast<float4*>(w + 8 * t);
    ip[0] = make_int4(e[0], e[1], e[2], e[3]);
    ip[1] = make_int4(e[4], e[5], e[6], e[7]);
    wp[0] = make_float4(cw[0], cw[1], cw[2], cw[3]);
    wp[1] = make_float4(cw[4], cw[5], cw[6], cw[7]);
  }
}

struct Args {
  const float* x;
  const float* table;
  const long long* res;
  const bool* dense;
  float* out;
  int* idx;
  float* w;
  long long N;
  int L, T;
};

template <int F, bool kRound>
cudaError_t launch(const Args& a, unsigned int blocks, cudaStream_t s) {
  const size_t smem = 2 * sizeof(int) * a.L;
  if (a.idx != nullptr) {
    hash_encode_kernel<F, kRound, true><<<blocks, kThreads, smem, s>>>(
        a.x, a.table, a.res, a.dense, a.out, a.idx, a.w, a.N, a.L, a.T);
  } else {
    hash_encode_kernel<F, kRound, false><<<blocks, kThreads, smem, s>>>(
        a.x, a.table, a.res, a.dense, a.out, nullptr, nullptr, a.N, a.L,
        a.T);
  }
  return cudaGetLastError();
}

template <int F>
cudaError_t launch(const Args& a, bool round, unsigned int blocks,
                   cudaStream_t s) {
  return round ? launch<F, true>(a, blocks, s)
               : launch<F, false>(a, blocks, s);
}

}  // namespace

// x (N, 3) f32; table (L, T, F) f32 with T a power of two and L T < 2^31;
// res (L,) int64 and dense (L,) bool on the device; out (N, F L) f32. idx
// (N, 8 L) int32 and w (N, 8 L) f32 are both given (the table takes a
// gradient) or both null. round: read the table rounded to bf16.
extern "C" int nerfacc_hash_encode(const float* x, const float* table,
                                   const long long* res, const bool* dense,
                                   float* out, int* idx, float* w,
                                   long long N, int L, int T, int F,
                                   int round, void* stream) {
  if (N == 0 || L == 0) return 0;
  if (T <= 0 || (T & (T - 1)) != 0 || (long long)L * T > 0x7fffffffLL ||
      (idx == nullptr) != (w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (N * L + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, table, res, dense, out, idx, w, N, L, T};
  const unsigned int b = static_cast<unsigned int>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (F) {
    case 1: err = launch<1>(a, round != 0, b, s); break;
    case 2: err = launch<2>(a, round != 0, b, s); break;
    case 4: err = launch<4>(a, round != 0, b, s); break;
    case 8: err = launch<8>(a, round != 0, b, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
