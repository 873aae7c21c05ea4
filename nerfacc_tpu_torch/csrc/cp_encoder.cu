// CP level features of the TensoCP field, forward and table gradients, for
// Hopper (sm_90a).
//
// Replaces, in nerfacc_tpu/ops/cp_encoder.py:
//   K1 _cp_fwd_impl (_fwd_kernel)         -> cp_level_features_kernel<false>
//   K2 _cp_fwd_res_impl (_fwd_res_kernel) -> cp_level_features_kernel<true>
//   K3 _cp_bwd (_bwd_kernel)              -> cp_level_grads_kernel
//   K4 _cp_bwd_res (_bwd_res_kernel)      -> cp_level_grads_res_kernel
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
// batch runs in the order the atomics land (the TPU's in block order), so
// the gradients agree to f32 summation order, not bit for bit.
//
// What bounds them: the forward, bytes. Per sample it reads 2 rows x R x 3
// axes of the tables (<= 0.8 MB per level in f32, resident in the 50 MB
// L2) and writes R f32 (K2: plus 3 R bf16) to device memory. The backward,
// atomics: 2 x 3 x R f32 atomic adds per live sample into (G, R) tables
// that stay in L2; at the coarse level (G = 128) thousands of samples share
// a row, so adds to one address serialise. Samples whose d is zero (masked
// slots get a zero gradient) add nothing and are skipped. The layout keeps
// every access coalesced: a warp spans the R features of one sample, so
// table rows, residual rows, gradient rows and outputs are contiguous.
//
// Numerics: arithmetic uses the _rn intrinsics and the library is built
// with -fmad=false, so nothing is contracted into an FMA that the plain
// PyTorch twin rounds in two steps. Coordinates are clipped to [0, 1] by
// the field, so u == G - 1 is reached exactly: then floor(u) + 1 == G is
// not a node and only one tap is used. Clamping floor(u) into [0, G - 1]
// reproduces the dense basis for any finite u (the clamped tap's weight
// is then the hat's own value, 0 beyond one node of the grid). The two
// bf16 tap weights need not sum to exactly 1; each is used as rounded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFeatThreads = 32;  // threads over the R features of a sample
constexpr int kSampleRows = 8;    // samples per block

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

inline dim3 sample_grid(int B) {
  return dim3((B + kSampleRows - 1) / kSampleRows);
}

}  // namespace

extern "C" const char* nerfacc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int nerfacc_cp_level_features(const float* xu, const float* t0,
                                         const float* t1, const float* t2,
                                         float* out, int B, int G, int R,
                                         void* stream) {
  if (B == 0 || R == 0) return 0;
  cp_level_features_kernel<false>
      <<<sample_grid(B), dim3(kFeatThreads, kSampleRows), 0,
         static_cast<cudaStream_t>(stream)>>>(xu, t0, t1, t2, out, nullptr,
                                              nullptr, nullptr, B, G, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerfacc_cp_level_features_res(
    const float* xu, const float* t0, const float* t1, const float* t2,
    float* out, void* u0, void* u1, void* u2, int B, int G, int R,
    void* stream) {
  if (B == 0 || R == 0) return 0;
  cp_level_features_kernel<true>
      <<<sample_grid(B), dim3(kFeatThreads, kSampleRows), 0,
         static_cast<cudaStream_t>(stream)>>>(
          xu, t0, t1, t2, out, static_cast<__nv_bfloat16*>(u0),
          static_cast<__nv_bfloat16*>(u1), static_cast<__nv_bfloat16*>(u2),
          B, G, R);
  return static_cast<int>(cudaGetLastError());
}

// d0, d1, d2 must be zeroed by the caller: the kernel adds into them
extern "C" int nerfacc_cp_level_grads(const float* xu, const float* t0,
                                      const float* t1, const float* t2,
                                      const float* g, float* d0, float* d1,
                                      float* d2, int B, int G, int R,
                                      void* stream) {
  if (B == 0 || R == 0) return 0;
  cp_level_grads_kernel<<<sample_grid(B), dim3(kFeatThreads, kSampleRows), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      xu, t0, t1, t2, g, d0, d1, d2, B, G, R);
  return static_cast<int>(cudaGetLastError());
}

// d0, d1, d2 must be zeroed by the caller: the kernel adds into them
extern "C" int nerfacc_cp_level_grads_res(const float* xu, const float* g,
                                          const void* u0, const void* u1,
                                          const void* u2, float* d0,
                                          float* d1, float* d2, int B, int G,
                                          int R, void* stream) {
  if (B == 0 || R == 0) return 0;
  cp_level_grads_res_kernel<<<sample_grid(B),
                              dim3(kFeatThreads, kSampleRows), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      xu, g, static_cast<const __nv_bfloat16*>(u0),
      static_cast<const __nv_bfloat16*>(u1),
      static_cast<const __nv_bfloat16*>(u2), d0, d1, d2, B, G, R);
  return static_cast<int>(cudaGetLastError());
}
