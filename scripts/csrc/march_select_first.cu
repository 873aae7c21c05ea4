// The first design of the march kernels (one thread per ray, a serial walk
// over the groups or the source slots), kept for measurement only:
// scripts/bench_march_select_torch.py times it beside the package's
// warp-per-ray kernels (nerfacc_tpu_torch/csrc/march_select.cu) in one
// process. Nothing in the package calls it. Its outputs are the values
// the package's kernels are held to: masks and every t of select_grouped
// bit-equal, reselect's widths within f32 rounding (it sums left to right,
// the package's kernel as a tree).
//
// With one thread per ray, 12,288 rays make 96 blocks of 128 threads on
// 132 SMs, each thread walks its row with a dependent chain, and
// neighbouring threads touch addresses a row apart, so no access is
// coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Lattice {
  float step, cone, dt_max, a_lim, log_grow;
};

// Per-ray phase lengths of the cone lattice (linear dt_min steps, then
// geometric growth, then linear dt_max steps).
struct Phases {
  float nA, nB;
};

__device__ __forceinline__ Phases cone_phases(float t_min, const Lattice& L) {
  const float nA = ceilf(__fdiv_rn(fmaxf(__fsub_rn(L.a_lim, t_min), 0.0f),
                                   L.step));
  const float tA = __fadd_rn(t_min, __fmul_rn(nA, L.step));
  const float ratio =
      __fdiv_rn(L.dt_max, __fmul_rn(L.cone, fmaxf(tA, 1e-10f)));
  const float nB =
      ceilf(__fdiv_rn(fmaxf(logf(fmaxf(ratio, 1.0f)), 0.0f), L.log_grow));
  return {nA, nB};
}

// Closed-form lattice position t(k).
__device__ __forceinline__ float lattice_t(float t_min, float k,
                                           const Lattice& L,
                                           const Phases& P) {
  if (L.cone <= 0.0f) return __fadd_rn(t_min, __fmul_rn(k, L.step));
  const float kA = fminf(k, P.nA);
  const float kB = fminf(fmaxf(__fsub_rn(k, P.nA), 0.0f), P.nB);
  const float kC = fmaxf(__fsub_rn(__fsub_rn(k, P.nA), P.nB), 0.0f);
  return __fadd_rn(
      __fmul_rn(__fadd_rn(t_min, __fmul_rn(kA, L.step)),
                expf(__fmul_rn(L.log_grow, kB))),
      __fmul_rn(kC, L.dt_max));
}

__global__ void select_grouped_kernel(const int* __restrict__ live,
                                      const int* __restrict__ group_size,
                                      const float* __restrict__ t_min,
                                      float* __restrict__ ts,
                                      float* __restrict__ te,
                                      float* __restrict__ dt,
                                      bool* __restrict__ ok, int R, int G,
                                      int K, Lattice L) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int* row = live + (long long)r * G;
  int count = 0;
  for (int g = 0; g < G; ++g) count += row[g];
  const int s = group_size[r];
  const int stride = max((count + K - 1) / K, 1);
  const float t0 = t_min[r];
  const Phases P = L.cone > 0.0f ? cone_phases(t0, L) : Phases{0.0f, 0.0f};

  // walk: g = min(#groups whose running count < tgt, G - 1), and
  // before = running count of the groups before g
  int g = 0, before = 0, through = row[0];
  const long long base = (long long)r * K;
  for (int j = 0; j < K; ++j) {
    const int tgt = j * stride + 1;
    while (g < G - 1 && through < tgt) {
      before = through;
      ++g;
      through += row[g];
    }
    const int offset = min(max(tgt - 1 - before, 0), s - 1);
    const int pos = g * s + offset;
    const int scale = min(max(count - j * stride, 0), stride);
    const float posf = (float)pos;
    const float start = lattice_t(t0, posf, L, P);
    ts[base + j] = start;
    te[base + j] = lattice_t(t0, __fadd_rn(posf, 1.0f), L, P);
    // exact decimation-group width (the group's later intervals are
    // geometrically wider when cone > 0)
    dt[base + j] = __fsub_rn(lattice_t(t0, (float)(pos + scale), L, P), start);
    ok[base + j] = tgt <= count;
  }
}

__global__ void reselect_kernel(const bool* __restrict__ masks,
                                const float* __restrict__ ts,
                                const float* __restrict__ te,
                                const float* __restrict__ dt,
                                float* __restrict__ ts2,
                                float* __restrict__ te2,
                                float* __restrict__ dt2,
                                bool* __restrict__ ok2, int R, int K,
                                int K2) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long in = (long long)r * K;
  const long long outb = (long long)r * K2;
  int count = 0;
  float total = 0.0f;
  for (int k = 0; k < K; ++k) {
    if (masks[in + k]) {
      ++count;
      total = __fadd_rn(total, dt[in + k]);
    }
  }
  const int stride = max((count + K2 - 1) / K2, 1);

  // walk: k = min(#slots whose running rank < tgt, K - 1); through = the
  // inclusive masked-width cumsum at k
  int k = 0;
  int rank = masks[in] ? 1 : 0;
  float through = masks[in] ? dt[in] : 0.0f;
  float prev_start = 0.0f;
  bool prev_ok = false;
  for (int j = 0; j < K2; ++j) {
    const int tgt = j * stride + 1;
    while (k < K - 1 && rank < tgt) {
      ++k;
      if (masks[in + k]) {
        ++rank;
        through = __fadd_rn(through, dt[in + k]);
      }
    }
    const bool okj = tgt <= count;
    const float start =
        __fsub_rn(through, masks[in + k] ? dt[in + k] : 0.0f);
    ts2[outb + j] = ts[in + k];
    te2[outb + j] = te[in + k];
    ok2[outb + j] = okj;
    // groups tile the live slots in rank order: the previous group's
    // width runs to this group's start, or to the total if this slot is
    // empty
    if (j > 0) {
      dt2[outb + j - 1] =
          prev_ok ? __fsub_rn(okj ? start : total, prev_start) : 0.0f;
    }
    prev_start = start;
    prev_ok = okj;
  }
  if (K2 > 0) {
    dt2[outb + K2 - 1] = prev_ok ? __fsub_rn(total, prev_start) : 0.0f;
  }
}

}  // namespace

extern "C" int first_select_grouped(const int* live, const int* group_size,
                                      const float* t_min, float* ts,
                                      float* te, float* dt, bool* ok, int R,
                                      int G, int K, float step, float cone,
                                      float dt_max, float a_lim,
                                      float log_grow, void* stream) {
  if (R == 0 || G == 0 || K == 0) return 0;
  const Lattice L{step, cone, dt_max, a_lim, log_grow};
  select_grouped_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      live, group_size, t_min, ts, te, dt, ok, R, G, K, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int first_reselect(const bool* masks, const float* ts,
                                const float* te, const float* dt, float* ts2,
                                float* te2, float* dt2, bool* ok2, int R,
                                int K, int K2, void* stream) {
  if (R == 0 || K == 0 || K2 == 0) return 0;
  reselect_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      masks, ts, te, dt, ts2, te2, dt2, ok2, R, K, K2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* first_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
