// CP level features of the TensoCP field, forward, for Hopper (sm_90a).
//
// Replaces: nerfacc_tpu/ops/cp_encoder.py::_cp_fwd_impl, the Pallas kernel
// _fwd_kernel (it also serves the (B, R) output of _cp_fwd_res_impl).
//
// What it computes: for each sample b and axis a, u = xu[b, a] * (G - 1)
// and ua[b, r] = sum_j bf16(max(0, 1 - |u - j|)) * bf16(T_a[j, r]), summed
// in f32; out[b, r] = (u0 * u1) * u2.
//
// Redesign: the TPU kernel builds the dense (B, G) hat basis and runs a
// (B, G) @ (G, R) product on the MXU, because gathers are what the TPU
// does badly. Each basis row has exactly two nonzeros (nodes floor(u) and
// floor(u) + 1), so here each sample reads those two rows of each table
// and the product of the basis disappears: no (B, G) array exists and no
// matrix unit runs. The two products are exact in f32 (bf16 x bf16), so
// the sum rounds once, exactly as the TPU's f32 accumulation of two
// nonzeros and G - 2 exact zeros does.
//
// What bounds it: bytes. Per sample it reads 2 rows x R x 3 axes of the
// tables (<= 0.8 MB per level in f32, resident in the 50 MB L2) and
// writes R f32 to device memory; the arithmetic is a few flops per byte.
// The layout keeps both coalesced: a warp spans the R features of one
// sample, so every table-row read and every output write is contiguous.
//
// Numerics: arithmetic uses the _rn intrinsics and the library is built
// with -fmad=false, so nothing is contracted into an FMA that the plain
// PyTorch twin rounds in two steps. Coordinates are clipped to [0, 1] by
// the field, so u == G - 1 is reached exactly: then floor(u) + 1 == G is
// not a node and only one tap is read. Clamping floor(u) into [0, G - 1]
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

__global__ void cp_level_features_kernel(const float* __restrict__ xu,
                                         const float* __restrict__ t0,
                                         const float* __restrict__ t1,
                                         const float* __restrict__ t2,
                                         float* __restrict__ out, int B,
                                         int G, int R) {
  const long long b =
      (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const float* tables[3] = {t0, t1, t2};
  int row0[3];
  bool has_row1[3];
  float w0[3], w1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = __fmul_rn(xu[b * 3 + a], (float)(G - 1));
    const int j = min(max((int)floorf(u), 0), G - 1);
    row0[a] = j;
    has_row1[a] = j + 1 < G;
    w0[a] = hat_weight(u, j);
    w1[a] = has_row1[a] ? hat_weight(u, j + 1) : 0.0f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float feat = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* row = tables[a] + (long long)row0[a] * R + r;
      float ua = __fmul_rn(w0[a], bf16_round(row[0]));
      if (has_row1[a]) {
        ua = __fadd_rn(ua, __fmul_rn(w1[a], bf16_round(row[R])));
      }
      feat = a == 0 ? ua : __fmul_rn(feat, ua);
    }
    out[b * R + r] = feat;
  }
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
  const dim3 block(kFeatThreads, kSampleRows);
  const dim3 grid((B + kSampleRows - 1) / kSampleRows);
  cp_level_features_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      xu, t0, t1, t2, out, B, G, R);
  return static_cast<int>(cudaGetLastError());
}
