// CP level features of the TensoCP field, forward and table gradients, for
// Hopper (sm_90a).
//
// Replaces, in nerfacc_tpu/ops/cp_encoder.py:
//   K1 _cp_fwd_impl (_fwd_kernel)         -> cp_level_features_shared_kernel
//                                            <.., false>
//   K2 _cp_fwd_res_impl (_fwd_res_kernel) -> cp_level_features_shared_kernel
//                                            <.., true>
//                                            (both: cp_level_features_kernel
//                                            for small batches and where a
//                                            slice of the tables exceeds
//                                            shared memory)
//   K3 _cp_bwd (_bwd_kernel)              -> cp_level_grads_shared_kernel
//                                            (cp_level_grads_kernel for
//                                            small batches and where a
//                                            slice exceeds shared memory)
//   K4 _cp_bwd_res (_bwd_res_kernel)      -> cp_level_grads_res_shared_kernel
//                                            (cp_level_grads_res_kernel where
//                                            the tables exceed shared memory)
//
// What they compute: for each sample b and axis a, u = xu[b, a] * (G - 1)
// and ua[b, r] = sum_j bf16(max(0, 1 - |u - j|)) * bf16(T_a[j, r]), summed
// in f32; out[b, r] = (u0 * u1) * u2. K2 also writes bf16(ua) per axis as
// a residual. The backward kernels compute dT_a = hat_a^T @ d_a over the
// batch, with d_a = bf16(g * u_b * u_c) (K3: f32 u recomputed from the
// tables; K4: the bf16 residuals, bf16(g) and bf16(u_b * u_c)), summed in
// f32. (b, c) are the other two axes in the order ((1, 2), (2, 0), (0, 1)).
//
// Redesign: the TPU kernels build the dense (B, G) hat basis and run
// (B, G) @ (G, R) products on the MXU, because gathers and scatters are
// what the TPU does badly. Each basis row has exactly two nonzeros (nodes
// floor(u) and floor(u) + 1), so here each sample reads those two rows of
// each table in the forward, and in the backward adds w0 * d and w1 * d
// into the same two rows of the gradient: no (B, G) array exists and no
// matrix unit runs. Every product is exact in f32 (bf16 x bf16), so the
// forward rounds its two-term sum once, as the TPU's f32 accumulation of
// two nonzeros and G - 2 exact zeros does; the backward's f32 sum over the
// batch runs in the order the atomics land (K4: per block, then over the
// blocks; the TPU's in block order), so the gradients agree to f32
// summation order, not bit for bit.
//
// What bounds them: the forward, the bytes it writes, R f32 per sample
// (K2: plus 3 R bf16), if it gets its table rows cheaply. Read as f32 from
// L2 (the kernel of the first port, cp_level_features_kernel: a warp per
// sample, six 4-byte loads and six bf16 roundings per feature) the rows are
// 6 R x 4 bytes per sample against R x 4 written, and L2-to-SM traffic and
// the instruction stream set the time, 3-4x the bound. So
// cp_level_features_shared_kernel stages a block's slice of the three
// tables in shared memory, rounded to bf16 once per block instead of once
// per read (3 x G x Rs x 2 bytes: (128, 64) whole in 48 KB, (512, 128) as
// two slices of 64 features in 192 KB, one block per SM, grid = slices x
// chunks of samples), computes a sample's taps once in one lane and passes
// them by shuffle, and gives a lane four consecutive features: 8-byte
// shared loads, a shift per bf16 -> f32, one 16-byte streaming store.
// Batches too small to pay for the staging and tables too large for a
// block keep the first kernel, chosen by shape in
// ops/cp_encoder.py::cp_features_slice_width. The backward, the adds: 2 x
// 3 x R f32 atomic adds per live sample into (G, R) tables. Sent to device
// memory (K3's and K4's kernels for tables too large for a block) they
// are resolved in L2 at about 4x the time the bytes would take. K4 sends
// L2 fewer: a block owns a slice of Rs features of all three gradients as
// partial tables in shared memory (3 x G x Rs floats, up to 227 KB), adds
// there while it walks its chunk of the samples, and adds each nonzero
// entry of the partial tables to the gradient once at its end. The grid is
// (slices of features) x (chunks of samples), one block per SM, so device
// memory sees about SMs x 3 x G x Rs atomics instead of 6 x B x R,
// whatever the order of the samples. With the adds in shared memory the
// kernel is bound by the instructions it executes (a shared-memory f32 add
// is a compare-and-swap loop here, and plain adds in its place are no
// faster), so the rest of its design spends few per term: see
// cp_level_grads_res_shared_kernel. K3 does the same, and where they fit
// keeps the block's slice of the tables beside the partial gradient tables
// as bf16 (K1's staging), 3 x G x Rs x (2 + 4) bytes; where that leaves a
// narrower slice than the partial tables alone would, it reads the table
// rows through L1 / L2 instead. A lane owns two neighbouring features, so
// one 8-byte compare-and-swap adds both (see
// cp_level_grads_shared_kernel). Samples whose g (K4: bf16(g))
// is zero (masked slots get a zero gradient) add nothing and are skipped.
// The layout keeps every access coalesced and every shared-memory add of
// one sample free of bank conflicts: a warp spans consecutive features of
// one sample (K3: of one to four), so table rows, residual rows, gradient
// rows and outputs are contiguous.
//
// Numerics: arithmetic uses the _rn intrinsics and the library is built
// with -fmad=false, so nothing is contracted into an FMA that the plain
// PyTorch twin rounds in two steps. Coordinates are clipped to [0, 1] by
// the field, so u == G - 1 is reached exactly: then floor(u) + 1 == G is
// not a node and only one tap is used. Clamping floor(u) into [0, G - 1]
// reproduces the dense basis for any finite u (the clamped tap's weight
// is then the hat's own value, 0 beyond one node of the grid). The two
// bf16 tap weights need not sum to exactly 1; each is used as rounded.

#include <cstddef>
#include <cstdint>
#include <mutex>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_info.cuh"

namespace {

constexpr int kFeatThreads = 32;  // threads over the R features of a sample
constexpr int kSampleRows = 8;    // samples per block
// K1 / K2 with the tables in shared memory: one block per SM
constexpr int kForwardWarps = 32;
constexpr int kForwardMinSamples = 1024;  // per block: a run for every warp
// K4 with partial tables in shared memory: one block per SM
constexpr int kSharedRows = 32;          // warps per block, a sample each
constexpr int kSharedMinSamples = 256;   // per block, at least
constexpr int kSharedBytesMax = 232448;  // 227 KB, the most a block may use
// K3 with partial tables in shared memory: one block per SM
constexpr int kGradWarps = 32;
constexpr int kGradMinSamples = 32 * kGradWarps;  // per block: a run a warp

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16-rounded hat weight of node j at coordinate u (node units)
__device__ __forceinline__ float hat_weight(float u, int j) {
  return bf16_round(
      fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(u, (float)j)))));
}

// The nonzero taps of one axis: nodes row0 and (if has_row1) row0 + 1
struct Taps {
  int row0;
  bool has_row1;
  float w0, w1;
};

__device__ __forceinline__ Taps axis_taps(float x, int G) {
  Taps t;
  const float u = __fmul_rn(x, (float)(G - 1));
  t.row0 = min(max((int)floorf(u), 0), G - 1);
  t.has_row1 = t.row0 + 1 < G;
  t.w0 = hat_weight(u, t.row0);
  t.w1 = t.has_row1 ? hat_weight(u, t.row0 + 1) : 0.0f;
  return t;
}

// f32 axis feature ua at feature r
__device__ __forceinline__ float axis_feature(const float* __restrict__ table,
                                              const Taps& t, int r, int R) {
  const float* row = table + (long long)t.row0 * R + r;
  float ua = __fmul_rn(t.w0, bf16_round(row[0]));
  if (t.has_row1) {
    ua = __fadd_rn(ua, __fmul_rn(t.w1, bf16_round(row[R])));
  }
  return ua;
}

// dT[row0, r] += w0 * d and dT[row0 + 1, r] += w1 * d (exact products)
__device__ __forceinline__ void scatter_taps(float* grad, const Taps& t,
                                             int r, int R, float d) {
  float* row = grad + (long long)t.row0 * R + r;
  atomicAdd(row, __fmul_rn(t.w0, d));
  if (t.has_row1) atomicAdd(row + R, __fmul_rn(t.w1, d));
}

// K1 (kResidual false) and K2 (true)
template <bool kResidual>
__global__ void cp_level_features_kernel(
    const float* __restrict__ xu, const float* __restrict__ t0,
    const float* __restrict__ t1, const float* __restrict__ t2,
    float* __restrict__ out, __nv_bfloat16* __restrict__ u0,
    __nv_bfloat16* __restrict__ u1, __nv_bfloat16* __restrict__ u2, int B,
    int G, int R) {
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const float* tables[3] = {t0, t1, t2};
  __nv_bfloat16* residuals[3] = {u0, u1, u2};
  Taps taps[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) taps[a] = axis_taps(xu[b * 3 + a], G);
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float feat = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float ua = axis_feature(tables[a], taps[a], r, R);
      if (kResidual) residuals[a][b * R + r] = __float2bfloat16_rn(ua);
      feat = a == 0 ? ua : __fmul_rn(feat, ua);
    }
    out[b * R + r] = feat;
  }
}

// Four floats rounded to bf16 with two packed conversions: features 0 and
// 2 in the low halves of x and y, 1 and 3 in the high halves
__device__ __forceinline__ uint2 bf16_pack4(float a, float b, float c,
                                            float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  return make_uint2(*reinterpret_cast<const unsigned int*>(&lo),
                    *reinterpret_cast<const unsigned int*>(&hi));
}

// the f32 value of the bf16 in the low / high half of a word
__device__ __forceinline__ float bf16_low(unsigned int bits) {
  return __uint_as_float(bits << 16);
}
__device__ __forceinline__ float bf16_high(unsigned int bits) {
  return __uint_as_float(bits & 0xffff0000u);
}

// w0 * t0 + w1 * t1, each product exact, one rounding
__device__ __forceinline__ float two_taps(float w0, float t0, float w1,
                                          float t1) {
  return __fadd_rn(__fmul_rn(w0, t0), __fmul_rn(w1, t1));
}

// K1 (kResidual false) and K2 (true) with the tables in shared memory.
// Block (x, y) owns features [x * 4 kLanes, (x + 1) * 4 kLanes) and samples
// [y * chunk, (y + 1) * chunk); chunk * R fits 31 bits. It stages its
// slice of the three tables once, rounded to bf16 (3 x G x kLanes words of
// four features), which gives the bits that rounding each read gives. A
// warp takes runs of 32 consecutive samples: each lane computes the taps
// of one of them (row and the two bf16 weights packed into one word per
// axis) and the warp passes them round by shuffle; a lane owns four
// consecutive features, so a sample takes kLanes lanes and a warp 32 /
// kLanes samples per step, each lane reading two 8-byte words per axis
// from shared memory and writing its four features with one 16-byte
// streaming store (K2: and three 8-byte ones). A last node has no upper
// neighbour: its w1 is 0 and it reads its own row twice, which adds an
// exact zero.
template <int kLanes, bool kResidual>
__global__ void __launch_bounds__(32 * kForwardWarps, 1)
    cp_level_features_shared_kernel(
        const float* __restrict__ xu, const float* __restrict__ t0,
        const float* __restrict__ t1, const float* __restrict__ t2,
        float* __restrict__ out, __nv_bfloat16* __restrict__ u0,
        __nv_bfloat16* __restrict__ u1, __nv_bfloat16* __restrict__ u2,
        int B, int G, int R, int chunk) {
  extern __shared__ uint2 staged[];
  constexpr unsigned int kAll = 0xffffffffu;
  constexpr int kThreads = 32 * kForwardWarps;
  constexpr int kPerStep = 32 / kLanes;  // samples per warp and step
  const int r_begin = blockIdx.x * 4 * kLanes;
  const int tid = threadIdx.x;
  const int per_axis = G * kLanes;
  {
    const float* tables[3] = {t0, t1, t2};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* slice = tables[a] + r_begin;
      for (int i = tid; i < per_axis; i += kThreads) {
        const int row = i / kLanes;
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            slice + row * R + 4 * (i - row * kLanes)));
        staged[a * per_axis + i] = bf16_pack4(v.x, v.y, v.z, v.w);
      }
    }
  }
  __syncthreads();

  const long long b_begin = (long long)blockIdx.y * chunk;
  const int n_chunk = (int)min((long long)chunk, B - b_begin);
  const long long first = b_begin * R + r_begin;
  const float* xu_chunk = xu + b_begin * 3;
  float* out_chunk = out + first;
  __nv_bfloat16* u_chunk[3] = {u0, u1, u2};
  if (kResidual) {
#pragma unroll
    for (int a = 0; a < 3; ++a) u_chunk[a] += first;
  }
  const int lane = tid & 31;
  const int sub = lane / kLanes;           // which sample of the step
  const int q = lane - sub * kLanes;       // which four features
  for (int run = 32 * (tid >> 5); run < n_chunk; run += kThreads) {
    const int n_run = min(32, n_chunk - run);
    // lane l holds the taps of sample run + l
    int my_row0[3];
    unsigned int my_w[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const Taps t =
          axis_taps(lane < n_run ? xu_chunk[(run + lane) * 3 + a] : 0.0f, G);
      my_row0[a] = t.row0;
      // both weights are bf16 values: w0 in the low half, w1 in the high
      my_w[a] = (__float_as_uint(t.w0) >> 16) |
                (__float_as_uint(t.w1) & 0xffff0000u);
    }
    for (int s = 0; s < n_run; s += kPerStep) {
      const int src = s + sub;
      float feat[4];
      uint2 res[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int row0 = __shfl_sync(kAll, my_row0[a], src);
        const unsigned int w = __shfl_sync(kAll, my_w[a], src);
        const float w0 = bf16_low(w), w1 = bf16_high(w);
        const int at = (a * G + row0) * kLanes + q;
        const uint2 lo = staged[at];
        const uint2 hi = staged[at + (row0 + 1 < G ? kLanes : 0)];
        const float ua[4] = {
            two_taps(w0, bf16_low(lo.x), w1, bf16_low(hi.x)),
            two_taps(w0, bf16_high(lo.x), w1, bf16_high(hi.x)),
            two_taps(w0, bf16_low(lo.y), w1, bf16_low(hi.y)),
            two_taps(w0, bf16_high(lo.y), w1, bf16_high(hi.y))};
        if (kResidual) res[a] = bf16_pack4(ua[0], ua[1], ua[2], ua[3]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          feat[k] = a == 0 ? ua[k] : __fmul_rn(feat[k], ua[k]);
        }
      }
      if (src < n_run) {
        const int at = (run + src) * R + 4 * q;
        __stcs(reinterpret_cast<float4*>(out_chunk + at),
               make_float4(feat[0], feat[1], feat[2], feat[3]));
        if (kResidual) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            __stcs(reinterpret_cast<uint2*>(u_chunk[a] + at), res[a]);
          }
        }
      }
    }
  }
}

// K3: gradients from f32 axis features recomputed from the tables
__global__ void cp_level_grads_kernel(
    const float* __restrict__ xu, const float* __restrict__ t0,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const float* __restrict__ g, float* d0, float* d1, float* d2, int B,
    int G, int R) {
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const float* tables[3] = {t0, t1, t2};
  float* grads[3] = {d0, d1, d2};
  Taps taps[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) taps[a] = axis_taps(xu[b * 3 + a], G);
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float gb = g[b * R + r];
    if (gb == 0.0f) continue;
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) u[a] = axis_feature(tables[a], taps[a], r, R);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float others = __fmul_rn(u[(a + 1) % 3], u[(a + 2) % 3]);
      const float d = bf16_round(__fmul_rn(gb, others));
      if (d != 0.0f) scatter_taps(grads[a], taps[a], r, R, d);
    }
  }
}

// K4: gradients from the bf16 residuals of K2
__global__ void cp_level_grads_res_kernel(
    const float* __restrict__ xu, const float* __restrict__ g,
    const __nv_bfloat16* __restrict__ u0,
    const __nv_bfloat16* __restrict__ u1,
    const __nv_bfloat16* __restrict__ u2, float* d0, float* d1, float* d2,
    int B, int G, int R) {
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const __nv_bfloat16* residuals[3] = {u0, u1, u2};
  float* grads[3] = {d0, d1, d2};
  Taps taps[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) taps[a] = axis_taps(xu[b * 3 + a], G);
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float gb = bf16_round(g[b * R + r]);
    if (gb == 0.0f) continue;
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      u[a] = __bfloat162float(residuals[a][b * R + r]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float others = bf16_round(__fmul_rn(u[(a + 1) % 3], u[(a + 2) % 3]));
      const float d = bf16_round(__fmul_rn(gb, others));
      if (d != 0.0f) scatter_taps(grads[a], taps[a], r, R, d);
    }
  }
}

// bf16 roundings of two floats with one packed conversion (the single
// conversion runs on a slower unit), returned as floats
__device__ __forceinline__ void bf16_round2(float a, float b, float& ra,
                                            float& rb) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(a, b);
  const unsigned int bits = *reinterpret_cast<const unsigned int*>(&pair);
  ra = __uint_as_float(bits << 16);
  rb = __uint_as_float(bits & 0xffff0000u);
}

// K4's six terms of one (sample, feature): per axis w[2a] * d into
// at[2a] and w[2a + 1] * d into at[2a + 1], float offsets into the
// block's partial tables in shared memory. A shared-memory f32 add is a
// compare-and-swap loop on this card; the six reads, then the six swaps,
// are started together so that their latencies overlap, and a swap that
// lost to another warp is repeated. w * d is exact in f32 (bf16 x bf16),
// so the fused multiply-add rounds as the separate add does.
__device__ __forceinline__ void add_res_terms(float* partial,
                                              const int (&at)[6],
                                              const float (&w)[6], float g,
                                              const float (&u)[3]) {
  float gb, o[3], d[3], unused;
  bf16_round2(g, __fmul_rn(u[1], u[2]), gb, o[0]);
  if (gb == 0.0f) return;
  bf16_round2(__fmul_rn(u[2], u[0]), __fmul_rn(u[0], u[1]), o[1], o[2]);
  bf16_round2(__fmul_rn(gb, o[0]), __fmul_rn(gb, o[1]), d[0], d[1]);
  bf16_round2(__fmul_rn(gb, o[2]), 0.0f, d[2], unused);
  unsigned int* cell[6];
  unsigned int seen[6], got[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    cell[k] = reinterpret_cast<unsigned int*>(partial + at[k]);
    seen[k] = *(volatile unsigned int*)cell[k];
  }
  unsigned int lost = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    got[k] = atomicCAS(cell[k], seen[k],
                       __float_as_uint(__fmaf_rn(w[k], d[k / 2],
                                                 __uint_as_float(seen[k]))));
    lost |= got[k] ^ seen[k];
  }
  if (lost == 0) return;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    while (got[k] != seen[k]) {
      seen[k] = got[k];
      got[k] = atomicCAS(cell[k], seen[k],
                         __float_as_uint(__fmaf_rn(w[k], d[k / 2],
                                                   __uint_as_float(seen[k]))));
    }
  }
}

// The taps of sample s of a warp's run, from the lanes that hold them: the
// offsets of the six cells (feature 0 of the slice) and their weights
__device__ __forceinline__ void run_taps(const int (&my_row0)[3],
                                         const float (&my_w0)[3],
                                         const float (&my_w1)[3], int s, int G,
                                         int width, int (&at)[6],
                                         float (&w)[6]) {
  constexpr unsigned int kAll = 0xffffffffu;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int row0 = __shfl_sync(kAll, my_row0[a], s);
    w[2 * a] = __shfl_sync(kAll, my_w0[a], s);
    w[2 * a + 1] = __shfl_sync(kAll, my_w1[a], s);
    at[2 * a] = (a * G + row0) * width;
    // the last node has no upper neighbour: its w1 is 0, added in place
    at[2 * a + 1] = at[2 * a] + (row0 + 1 < G ? width : 0);
  }
}

// K4, partial tables in shared memory. Block (x, y) owns features
// [x * Rs, x * Rs + width) and samples [y * chunk, (y + 1) * chunk);
// chunk * R fits 31 bits, so a block addresses its rows with 32-bit
// offsets. The kernel is bound by the instructions it executes, not by
// bytes or by the adds, so it spends few per term: a warp takes runs of
// 32 consecutive samples, each lane computes the taps of one of them and
// the warp passes them around with shuffles as it walks the run, two
// samples per step with the loads of both started before either is used;
// the slice width is a template constant where it is 32 or 64 (kWidth ==
// 0: any width).
template <int kWidth>
__global__ void __launch_bounds__(kFeatThreads* kSharedRows, 1)
    cp_level_grads_res_shared_kernel(
        const float* __restrict__ xu, const float* __restrict__ g,
        const __nv_bfloat16* __restrict__ u0,
        const __nv_bfloat16* __restrict__ u1,
        const __nv_bfloat16* __restrict__ u2, float* __restrict__ d0,
        float* __restrict__ d1, float* __restrict__ d2, int B, int G, int R,
        int Rs, int chunk) {
  extern __shared__ float partial[];
  const int r_begin = blockIdx.x * Rs;
  const int width = kWidth ? kWidth : min(Rs, R - r_begin);
  const int per_axis = G * width;
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kFeatThreads + lane;
  constexpr int kThreads = kFeatThreads * kSharedRows;
  for (int i = tid; i < 3 * per_axis; i += kThreads) partial[i] = 0.0f;
  __syncthreads();

  const long long b_begin = (long long)blockIdx.y * chunk;
  const int n_chunk = (int)min((long long)chunk, B - b_begin);
  const long long first = b_begin * R + r_begin;
  const float* xu_chunk = xu + b_begin * 3;
  const float* g_chunk = g + first;
  const __nv_bfloat16* u_chunk[3] = {u0 + first, u1 + first, u2 + first};
  for (int run = 32 * threadIdx.y; run < n_chunk; run += 32 * kSharedRows) {
    const int n_run = min(32, n_chunk - run);
    // lane l holds the taps of sample run + l
    int my_row0[3];
    float my_w0[3], my_w1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const Taps t =
          axis_taps(lane < n_run ? xu_chunk[(run + lane) * 3 + a] : 0.0f, G);
      my_row0[a] = t.row0;
      my_w0[a] = t.w0;
      my_w1[a] = t.w1;
    }
    for (int s = 0; s < n_run; s += 2) {
      const bool two = s + 1 < n_run;
      int at[6], atb[6];
      float w[6], wb[6];
      run_taps(my_row0, my_w0, my_w1, s, G, width, at, w);
      run_taps(my_row0, my_w0, my_w1, s + 1, G, width, atb, wb);
      for (int r = lane; r < width; r += kFeatThreads) {
        const int row = (run + s) * R + r;
        const int rowb = row + R;
        const float gv = g_chunk[row];
        const float gvb = two ? g_chunk[rowb] : 0.0f;
        float u[3], ub[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          u[a] = __bfloat162float(u_chunk[a][row]);
          ub[a] = two ? __bfloat162float(u_chunk[a][rowb]) : 0.0f;
        }
        add_res_terms(partial + r, at, w, gv, u);
        add_res_terms(partial + r, atb, wb, gvb, ub);
      }
    }
  }
  __syncthreads();

  float* grads[3] = {d0, d1, d2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int i = tid; i < per_axis; i += kThreads) {
      const float sum = partial[a * per_axis + i];
      if (sum == 0.0f) continue;
      const int row = i / width;
      atomicAdd(grads[a] + (long long)row * R + r_begin + (i - row * width),
                sum);
    }
  }
}

// (seen + w * x, seen + w * y) for the two floats packed in an 8-byte
// word, x in the low half (the lower feature). w * x is exact in f32
// (bf16 x bf16, or w == 1), so the fused multiply-add rounds as the add.
__device__ __forceinline__ unsigned long long add_pair(unsigned long long seen,
                                                       float w, float x,
                                                       float y) {
  const float lo = __fmaf_rn(w, x, __uint_as_float((unsigned int)seen));
  const float hi =
      __fmaf_rn(w, y, __uint_as_float((unsigned int)(seen >> 32)));
  return ((unsigned long long)__float_as_uint(hi) << 32) |
         __float_as_uint(lo);
}

// K3's adds: (w[k] * x[k], w[k] * y[k]) into the pair of floats at
// cell[k] in shared memory, one 8-byte compare-and-swap per pair. As in
// add_res_terms, the N reads and then the N swaps are started together
// so that their latencies overlap, and a swap that lost is repeated (two
// cells may be one: the last node adds its zero weight in place).
template <int N>
__device__ __forceinline__ void add_pairs(unsigned long long* const* cell,
                                          const float* w, const float* x,
                                          const float* y) {
  unsigned long long seen[N], got[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    seen[k] = *(volatile unsigned long long*)cell[k];
  }
  bool lost = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    got[k] = atomicCAS(cell[k], seen[k], add_pair(seen[k], w[k], x[k], y[k]));
    lost |= got[k] != seen[k];
  }
  if (!lost) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    while (got[k] != seen[k]) {
      seen[k] = got[k];
      got[k] =
          atomicCAS(cell[k], seen[k], add_pair(seen[k], w[k], x[k], y[k]));
    }
  }
}

// K3 with its partial gradient tables in shared memory, and (kStaged) its
// slice of the tables too. Block (x, y) owns features [x * 2 kPairs, (x +
// 1) * 2 kPairs) and samples [y * chunk, (y + 1) * chunk); chunk * R fits
// 31 bits. It zeroes its partial gradient tables and (kStaged) stages its
// slice of the three tables as bf16, rounded once (K1's staging: the bits
// rounding each read gives), both laid out [axis][row][pair] with pair q
// holding features 2q and 2q + 1 (an 8-byte word of two f32; a 4-byte
// word of two bf16). A lane owns one pair of features of one sample, so a
// sample takes kPairs lanes (a warp at 64 features), and a warp's 32 /
// kPairs groups of lanes walk as many streams of consecutive samples, far
// apart in the chunk (on other rays where the samples come along rays, so
// that their swaps seldom meet on one cell). A group takes runs of kPairs
// samples of its stream: each of its lanes computes the taps of one (row
// and the two bf16 weights packed into a word per axis) and the group
// passes them round by shuffle, one sample per step. Per step a lane reads
// two features of g (8 bytes) and, per tap of each table, one word of the
// staged slice (kStaged) or its two f32 features from the table through
// L1 / L2, rounded to bf16 as read (the f32 axis features of its two
// features, recomputed from the two taps as the first kernel computes
// them), and adds its six pairs of terms with six 8-byte
// compare-and-swaps. The time follows the shared-memory wavefronts: a
// slice of 64 features puts one sample in a warp, 32 two, each a 128-byte
// row that fills the banks once; 16 features put four samples in a warp,
// whose rows fall on the banks at random (~1.5x the wavefronts per term).
// So where the staged tables leave room for 16 features only, a slice of
// 32 without them is faster though its rows come from L2 (G = 512: 1.13x).
// At the end each nonzero entry of the partial tables is added to the
// gradient once.
template <int kPairs, bool kStaged>
__global__ void __launch_bounds__(32 * kGradWarps, 1)
    cp_level_grads_shared_kernel(
        const float* __restrict__ xu, const float* __restrict__ t0,
        const float* __restrict__ t1, const float* __restrict__ t2,
        const float* __restrict__ g, float* __restrict__ d0,
        float* __restrict__ d1, float* __restrict__ d2, int B, int G, int R,
        int chunk) {
  // (a name of its own: K4's dynamic shared array is a float one)
  extern __shared__ unsigned long long grads_shared[];
  unsigned long long* partial = grads_shared;
  constexpr unsigned int kAll = 0xffffffffu;
  constexpr int kThreads = 32 * kGradWarps;
  constexpr int kWidth = 2 * kPairs;  // features of the slice
  const int per_axis = G * kPairs;  // pairs of one axis
  unsigned int* staged =
      reinterpret_cast<unsigned int*>(partial + 3 * per_axis);
  const int r_begin = blockIdx.x * kWidth;
  const int tid = threadIdx.x;
  const float* tables[3] = {t0 + r_begin, t1 + r_begin, t2 + r_begin};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int i = tid; i < per_axis; i += kThreads) {
      partial[a * per_axis + i] = 0ull;
      if (kStaged) {
        const int row = i / kPairs;
        const float* p = tables[a] + row * R + 2 * (i - row * kPairs);
        const __nv_bfloat162 pair =
            __floats2bfloat162_rn(__ldg(p), __ldg(p + 1));
        staged[a * per_axis + i] =
            *reinterpret_cast<const unsigned int*>(&pair);
      }
    }
  }
  __syncthreads();

  const long long b_begin = (long long)blockIdx.y * chunk;
  const int n_chunk = (int)min((long long)chunk, B - b_begin);
  const float* xu_chunk = xu + b_begin * 3;
  const float2* g_chunk =
      reinterpret_cast<const float2*>(g + b_begin * R + r_begin);
  const int lane = tid & 31;
  const int sub = lane / kPairs;      // which group, which stream
  const int q = lane - sub * kPairs;  // which pair of features
  const int stream_len = (n_chunk + 32 / kPairs - 1) / (32 / kPairs);
  const int first = sub * stream_len;  // the group's first sample
  const int n_mine = max(0, min(stream_len, n_chunk - first));
  for (int run = kPairs * (tid >> 5); run < stream_len;
       run += kPairs * kGradWarps) {
    // lane (sub, q) holds the taps of sample first + run + q
    int my_row0[3];
    unsigned int my_w[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const Taps t = axis_taps(
          run + q < n_mine ? xu_chunk[(first + run + q) * 3 + a] : 0.0f, G);
      my_row0[a] = t.row0;
      // both weights are bf16 values: w0 in the low half, w1 in the high
      my_w[a] = (__float_as_uint(t.w0) >> 16) |
                (__float_as_uint(t.w1) & 0xffff0000u);
    }
    for (int step = 0; step < kPairs; ++step) {
      const int src = sub * kPairs + step;
      int row0[3];
      float w0[3], w1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        row0[a] = __shfl_sync(kAll, my_row0[a], src);
        const unsigned int w = __shfl_sync(kAll, my_w[a], src);
        w0[a] = bf16_low(w);
        w1[a] = bf16_high(w);
      }
      if (run + step >= n_mine) continue;
      const float2 gv = __ldg(g_chunk + (first + run + step) * (R / 2) + q);
      if (gv.x == 0.0f && gv.y == 0.0f) continue;
      // the f32 axis features of both features: two taps of bf16(T_a)
      int at[3];
      float u[3][2];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        at[a] = (a * G + row0[a]) * kPairs + q;
        const bool has_row1 = row0[a] + 1 < G;
        if (kStaged) {
          const unsigned int lo = staged[at[a]];
          const unsigned int hi = staged[at[a] + (has_row1 ? kPairs : 0)];
          u[a][0] = two_taps(w0[a], bf16_low(lo), w1[a], bf16_low(hi));
          u[a][1] = two_taps(w0[a], bf16_high(lo), w1[a], bf16_high(hi));
        } else {
          const float2* p = reinterpret_cast<const float2*>(
                                tables[a] + row0[a] * R) + q;
          const float2 lo = __ldg(p);
          const float2 hi = __ldg(p + (has_row1 ? R / 2 : 0));
          u[a][0] = two_taps(w0[a], bf16_round(lo.x), w1[a], bf16_round(hi.x));
          u[a][1] = two_taps(w0[a], bf16_round(lo.y), w1[a], bf16_round(hi.y));
        }
      }
      // d_a = bf16(g * (u_b * u_c)) per feature
      float d[3][2];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int b = (a + 1) % 3, c = (a + 2) % 3;
        bf16_round2(__fmul_rn(gv.x, __fmul_rn(u[b][0], u[c][0])),
                    __fmul_rn(gv.y, __fmul_rn(u[b][1], u[c][1])), d[a][0],
                    d[a][1]);
      }
      unsigned long long* cell[6];
      float w[6], x[6], y[6];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cell[2 * a] = partial + at[a];
        // the last node has no upper neighbour: its w1 is 0, added in place
        cell[2 * a + 1] = partial + at[a] + (row0[a] + 1 < G ? kPairs : 0);
        w[2 * a] = w0[a];
        w[2 * a + 1] = w1[a];
        x[2 * a] = x[2 * a + 1] = d[a][0];
        y[2 * a] = y[2 * a + 1] = d[a][1];
      }
      add_pairs<6>(cell, w, x, y);
    }
  }
  __syncthreads();

  float* grads[3] = {d0, d1, d2};
  const float* sums = reinterpret_cast<const float*>(partial);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int i = tid; i < G * kWidth; i += kThreads) {
      const float sum = sums[a * G * kWidth + i];
      if (sum == 0.0f) continue;
      const int row = i / kWidth;
      atomicAdd(grads[a] + (long long)row * R + r_begin + (i - row * kWidth),
                sum);
    }
  }
}

inline dim3 sample_grid(int B) {
  return dim3((B + kSampleRows - 1) / kSampleRows);
}

// More than 48 KB of dynamic shared memory has to be asked for, once per
// kernel and device: one of these per family of kernels.
struct SharedAllowance {
  std::mutex lock;
  bool allowed[nerfacc::kMaxDevices] = {};

  template <typename Kernel, size_t kCount>
  cudaError_t ask(const Kernel (&kernels)[kCount], int device) {
    std::lock_guard<std::mutex> guard(lock);
    if (allowed[device]) return cudaSuccess;
    for (const Kernel kernel : kernels) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSharedBytesMax);
      if (err != cudaSuccess) return err;
    }
    allowed[device] = true;
    return cudaSuccess;
  }
};

// One block per SM: `slices` blocks side by side share each chunk of the
// B samples. Chunks hold at least min_samples, a multiple of 32 samples,
// and at most what 32-bit row offsets reach; returns the chunk length (0:
// R too large) and the number of chunks.
inline int sample_chunks(int B, int R, int slices, int sms, int min_samples,
                         int* chunks) {
  int n = sms / slices > 1 ? sms / slices : 1;
  const int most = (B + min_samples - 1) / min_samples;
  if (n > most) n = most;
  int chunk = ((B + n - 1) / n + 31) / 32 * 32;
  const int longest = ((int)(0x7fffffffLL / R) - 64) / 32 * 32;
  if (longest < 32) return 0;
  if (chunk > longest) chunk = longest;
  *chunks = (B + chunk - 1) / chunk;
  return chunk;
}

// K1 / K2. Rs > 0: the kernel with a slice of Rs = 32, 64 or 128 features
// of the tables in shared memory (Rs divides R; 3 x G x Rs x 2 bytes fit a
// block). Rs == 0, or pointers off the 16-byte boundaries its vector loads
// and stores need: the kernel that reads the tables from device memory.
template <bool kResidual>
int launch_features(const float* xu, const float* t0, const float* t1,
                    const float* t2, float* out, void* u0, void* u1,
                    void* u2, int B, int G, int R, int Rs, void* stream) {
  if (B == 0 || R == 0) return 0;
  __nv_bfloat16* r0 = static_cast<__nv_bfloat16*>(u0);
  __nv_bfloat16* r1 = static_cast<__nv_bfloat16*>(u1);
  __nv_bfloat16* r2 = static_cast<__nv_bfloat16*>(u2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t wide = reinterpret_cast<uintptr_t>(t0) |
                         reinterpret_cast<uintptr_t>(t1) |
                         reinterpret_cast<uintptr_t>(t2) |
                         reinterpret_cast<uintptr_t>(out);
  const uintptr_t narrow = reinterpret_cast<uintptr_t>(u0) |
                           reinterpret_cast<uintptr_t>(u1) |
                           reinterpret_cast<uintptr_t>(u2);
  if (Rs <= 0 || wide % 16 || narrow % 8) {
    cp_level_features_kernel<kResidual>
        <<<sample_grid(B), dim3(kFeatThreads, kSampleRows), 0, s>>>(
            xu, t0, t1, t2, out, r0, r1, r2, B, G, R);
    return static_cast<int>(cudaGetLastError());
  }
  const long long bytes = 3LL * G * Rs * sizeof(__nv_bfloat16);
  if ((Rs != 32 && Rs != 64 && Rs != 128) || R % Rs ||
      bytes > kSharedBytesMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = nerfacc::current_device_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  using Kernel = void (*)(const float*, const float*, const float*,
                          const float*, float*, __nv_bfloat16*,
                          __nv_bfloat16*, __nv_bfloat16*, int, int, int, int);
  const Kernel kernels[3] = {
      cp_level_features_shared_kernel<8, kResidual>,
      cp_level_features_shared_kernel<16, kResidual>,
      cp_level_features_shared_kernel<32, kResidual>};
  {
    static SharedAllowance allowance;  // one per kResidual
    err = allowance.ask(kernels, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int chunks = 0;
  const int chunk =
      sample_chunks(B, R, R / Rs, sms, kForwardMinSamples, &chunks);
  if (chunk == 0) return static_cast<int>(cudaErrorInvalidValue);
  kernels[Rs == 32 ? 0 : (Rs == 64 ? 1 : 2)]
      <<<dim3(R / Rs, chunks), 32 * kForwardWarps,
         static_cast<size_t>(bytes), s>>>(xu, t0, t1, t2, out, r0, r1, r2, B,
                                          G, R, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* nerfacc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rs: see launch_features
extern "C" int nerfacc_cp_level_features(const float* xu, const float* t0,
                                         const float* t1, const float* t2,
                                         float* out, int B, int G, int R,
                                         int Rs, void* stream) {
  return launch_features<false>(xu, t0, t1, t2, out, nullptr, nullptr,
                                nullptr, B, G, R, Rs, stream);
}

extern "C" int nerfacc_cp_level_features_res(
    const float* xu, const float* t0, const float* t1, const float* t2,
    float* out, void* u0, void* u1, void* u2, int B, int G, int R, int Rs,
    void* stream) {
  return launch_features<true>(xu, t0, t1, t2, out, u0, u1, u2, B, G, R, Rs,
                               stream);
}

// d0, d1, d2 must be zeroed by the caller: the kernel adds into them.
// Rs > 0: blocks keep the partial gradient tables of a slice of Rs
// features in shared memory (Rs divides R) and, with `staged`, the slice
// of the tables beside them as bf16 (Rs = 16, 32 or 64; 3 x G x Rs x 6
// bytes fit a block); without, the tables are read through L1 / L2 (Rs =
// 32 or 64; 3 x G x Rs x 4 bytes fit). Rs == 0, g off the 8-byte boundary
// its two-feature loads need, or (not staged) a table off it: every term
// is added to the gradient in device memory.
extern "C" int nerfacc_cp_level_grads(const float* xu, const float* t0,
                                      const float* t1, const float* t2,
                                      const float* g, float* d0, float* d1,
                                      float* d2, int B, int G, int R, int Rs,
                                      int staged, void* stream) {
  if (B == 0 || R == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t tables = reinterpret_cast<uintptr_t>(t0) |
                           reinterpret_cast<uintptr_t>(t1) |
                           reinterpret_cast<uintptr_t>(t2);
  if (Rs <= 0 || reinterpret_cast<uintptr_t>(g) % 8 ||
      (!staged && tables % 8)) {
    cp_level_grads_kernel<<<sample_grid(B), dim3(kFeatThreads, kSampleRows),
                            0, s>>>(xu, t0, t1, t2, g, d0, d1, d2, B, G, R);
    return static_cast<int>(cudaGetLastError());
  }
  const long long bytes = 3LL * G * Rs * (sizeof(float) + (staged ? 2 : 0));
  if ((Rs != 16 && Rs != 32 && Rs != 64) || R % Rs ||
      bytes > kSharedBytesMax || (!staged && Rs == 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = nerfacc::current_device_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  using Kernel = void (*)(const float*, const float*, const float*,
                          const float*, const float*, float*, float*, float*,
                          int, int, int, int);
  // staged at 16, 32, 64 features; the partial tables alone at 32, 64
  const Kernel kernels[5] = {cp_level_grads_shared_kernel<8, true>,
                             cp_level_grads_shared_kernel<16, true>,
                             cp_level_grads_shared_kernel<32, true>,
                             cp_level_grads_shared_kernel<16, false>,
                             cp_level_grads_shared_kernel<32, false>};
  {
    static SharedAllowance allowance;
    err = allowance.ask(kernels, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int chunks = 0;
  const int chunk =
      sample_chunks(B, R, R / Rs, sms, kGradMinSamples, &chunks);
  if (chunk == 0) return static_cast<int>(cudaErrorInvalidValue);
  kernels[(Rs == 16 ? 0 : (Rs == 32 ? 1 : 2)) + (staged ? 0 : 2)]
      <<<dim3(R / Rs, chunks), 32 * kGradWarps, static_cast<size_t>(bytes),
         s>>>(xu, t0, t1, t2, g, d0, d1, d2, B, G, R, chunk);
  return static_cast<int>(cudaGetLastError());
}

// d0, d1, d2 must be zeroed by the caller: the kernel adds into them.
// Rs > 0: blocks keep partial tables of Rs features in shared memory (3 x G
// x Rs x 4 bytes, which must fit a block) and add them to the gradient
// once each. Rs == 0: every term is added to the gradient in device memory.
extern "C" int nerfacc_cp_level_grads_res(const float* xu, const float* g,
                                          const void* u0, const void* u1,
                                          const void* u2, float* d0,
                                          float* d1, float* d2, int B, int G,
                                          int R, int Rs, void* stream) {
  if (B == 0 || R == 0) return 0;
  const __nv_bfloat16* r0 = static_cast<const __nv_bfloat16*>(u0);
  const __nv_bfloat16* r1 = static_cast<const __nv_bfloat16*>(u1);
  const __nv_bfloat16* r2 = static_cast<const __nv_bfloat16*>(u2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Rs <= 0) {
    cp_level_grads_res_kernel<<<sample_grid(B),
                                dim3(kFeatThreads, kSampleRows), 0, s>>>(
        xu, g, r0, r1, r2, d0, d1, d2, B, G, R);
    return static_cast<int>(cudaGetLastError());
  }
  const long long bytes = 3LL * G * Rs * sizeof(float);
  if (Rs > R || bytes > kSharedBytesMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = nerfacc::current_device_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the slice width as a template constant where every slice is 32 or 64
  // wide, else at run time
  using Kernel = void (*)(const float*, const float*, const __nv_bfloat16*,
                          const __nv_bfloat16*, const __nv_bfloat16*, float*,
                          float*, float*, int, int, int, int, int);
  const Kernel kernels[3] = {cp_level_grads_res_shared_kernel<0>,
                             cp_level_grads_res_shared_kernel<32>,
                             cp_level_grads_res_shared_kernel<64>};
  {
    static SharedAllowance allowance;
    err = allowance.ask(kernels, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool whole = R % Rs == 0;
  const Kernel kernel =
      kernels[whole && Rs == 32 ? 1 : (whole && Rs == 64 ? 2 : 0)];
  // one block per SM: slices x chunks of equal work, no second wave
  const int slices = (R + Rs - 1) / Rs;
  int chunks = 0;
  const int chunk = sample_chunks(B, R, slices, sms, kSharedMinSamples,
                                  &chunks);
  if (chunk == 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(slices, chunks), dim3(kFeatThreads, kSharedRows),
           static_cast<size_t>(bytes), s>>>(xu, g, r0, r1, r2, d0, d1, d2, B,
                                            G, R, Rs, chunk);
  return static_cast<int>(cudaGetLastError());
}
