// CP level features of the TensoCP field, forward and table gradients, for
// Hopper (sm_90a).
//
// Replaces, in nerfacc_tpu/ops/cp_encoder.py:
//   K1 _cp_fwd_impl (_fwd_kernel)         -> cp_level_features_kernel<false>
//   K2 _cp_fwd_res_impl (_fwd_res_kernel) -> cp_level_features_kernel<true>
//   K3 _cp_bwd (_bwd_kernel)              -> cp_level_grads_kernel
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
// What bounds them: the forward, bytes. Per sample it reads 2 rows x R x 3
// axes of the tables (<= 0.8 MB per level in f32, resident in the 50 MB
// L2) and writes R f32 (K2: plus 3 R bf16) to device memory. The backward,
// the adds: 2 x 3 x R f32 atomic adds per live sample into (G, R) tables.
// Sent to device memory (K3, and K4 for tables too large for a block) they
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
// cp_level_grads_res_shared_kernel. Samples whose bf16(g) is zero (masked
// slots get a zero gradient) add nothing and are skipped. The layout keeps
// every access coalesced and every shared-memory add free of bank
// conflicts: a warp spans 32 consecutive features of one sample, so table
// rows, residual rows, gradient rows and outputs are contiguous.
//
// Numerics: arithmetic uses the _rn intrinsics and the library is built
// with -fmad=false, so nothing is contracted into an FMA that the plain
// PyTorch twin rounds in two steps. Coordinates are clipped to [0, 1] by
// the field, so u == G - 1 is reached exactly: then floor(u) + 1 == G is
// not a node and only one tap is used. Clamping floor(u) into [0, G - 1]
// reproduces the dense basis for any finite u (the clamped tap's weight
// is then the hat's own value, 0 beyond one node of the grid). The two
// bf16 tap weights need not sum to exactly 1; each is used as rounded.

#include <mutex>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_info.cuh"

namespace {

constexpr int kFeatThreads = 32;  // threads over the R features of a sample
constexpr int kSampleRows = 8;    // samples per block
// K4 with partial tables in shared memory: one block per SM
constexpr int kSharedRows = 32;          // warps per block, a sample each
constexpr int kSharedMinSamples = 256;   // per block, at least
constexpr int kSharedBytesMax = 232448;  // 227 KB, the most a block may use

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
    // more than 48 KB of dynamic shared memory has to be asked for, once
    // per device
    static std::mutex lock;
    static bool allowed[nerfacc::kMaxDevices] = {};
    std::lock_guard<std::mutex> guard(lock);
    if (!allowed[device]) {
      for (const Kernel kernel : kernels) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kSharedBytesMax);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      allowed[device] = true;
    }
  }
  const bool whole = R % Rs == 0;
  const Kernel kernel =
      kernels[whole && Rs == 32 ? 1 : (whole && Rs == 64 ? 2 : 0)];
  // one block per SM: slices x chunks of equal work, no second wave
  const int slices = (R + Rs - 1) / Rs;
  int chunks = sms / slices > 1 ? sms / slices : 1;
  const int most = (B + kSharedMinSamples - 1) / kSharedMinSamples;
  if (chunks > most) chunks = most;
  int chunk = (B + chunks - 1) / chunks;
  // a block addresses its rows with 32-bit offsets
  const int longest = (int)(0x7fffffffLL / R) - 64;
  if (longest < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (chunk > longest) chunk = longest;
  chunks = (B + chunk - 1) / chunk;
  kernel<<<dim3(slices, chunks), dim3(kFeatThreads, kSharedRows),
           static_cast<size_t>(bytes), s>>>(xu, g, r0, r1, r2, d0, d1, d2, B,
                                            G, R, Rs, chunk);
  return static_cast<int>(cudaGetLastError());
}
