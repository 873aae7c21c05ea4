// March slot selection and stage-2 re-selection, for Hopper (sm_90a).
//
// select_grouped replaces nerfacc_tpu/ops/march_select.py::
// fused_select_grouped (Pallas _select_kernel + _lattice_t_block);
// reselect replaces fused_reselect (Pallas _reselect_kernel).
//
// Design: a warp per ray. The Pallas kernels have no vector gather on the
// TPU, so they unroll compare/select reductions over every group G and
// every slot K for every output slot, O(K * G) per ray. The first CUDA
// kernels gave a ray to one thread that walked its row serially: 96 blocks
// on 132 SMs, a dependent chain of K lattice evaluations per thread, and
// no coalesced access, since neighbouring threads touched addresses a row
// apart. Here the 32 lanes of a warp share one ray, kWarps rays per block:
//
// - rows are read and written by the warp as a whole, lane l at element
//   l, l + 32, ...: 128-byte transactions for the int and float rows,
//   32 consecutive bytes for the bool rows;
// - select_grouped: the running group counts come from a shuffle scan (in
//   chunks of 32 groups with a carried sum) and go to the warp's slice of
//   shared memory; lane l owns slots l, l + 32, ... and finds each slot's
//   group by a binary search of that slice (5-6 steps where the first
//   kernel walked), then evaluates the closed-form lattice for its slots
//   only. Rows longer than kGroupChunk groups are scanned chunk by chunk
//   (after one pass for the count); a slot is settled in the chunk its
//   rank target falls in, so G is unbounded at a fixed shared-memory size;
// - reselect: ranks by ballot + popcount, the masked-width sums by a
//   shuffle scan, both with carried totals over chunks of 32 source slots.
//   The first kernel searched, per output slot, the source slot of rank
//   j * stride + 1; here that search is inverted into a scatter: a live
//   source slot of 0-based rank q is output slot q / stride exactly when
//   stride divides q, and it writes its t_start, t_end and the sum before
//   it into the warp's shared-memory tile. Output slots whose target
//   exceeds the live count take source slot K - 1 (where the search
//   clamps), width 0, mask false. After a __syncwarp lane j forms its
//   width from its own start and its right neighbour's (or the total) and
//   the warp stores the rows. Rows of up to 128 source slots are held in
//   registers (a template over the number of 32-slot chunks, chosen by
//   shape), with all their loads started before the first use, so a ray
//   costs one trip to memory; longer rows are read once for the count
//   and once more per tile of kSlotTile output slots.
//
// What bounds them: the bytes are few (12 MB at 12,288 rays x 64 slots:
// 3.6-4.6 us at the card's memory rate), the arithmetic is a few hundred
// instructions per ray, and a launch's own latency on the card is of the
// same few microseconds. 12,288 warps are 1.5 waves of the card's 8,448
// resident warps, so the time is the latency chain of one or two warps
// per scheduler slot (row load, scan, search or scatter, stores), not a
// rate of the card.
//
// Numerics: the lattice keeps the plain PyTorch chain's f32 operations in
// its order, through the _rn intrinsics (no FMA contraction; the library
// is also built with -fmad=false), true divisions, and expf / logf /
// ceilf, which are the functions PyTorch's CUDA kernels call. The f32
// constants (step, cone, dt_max, step / cone, log1p(cone)) are rounded by
// the host exactly as the plain chain rounds them. Integer results (ok,
// positions, scales) are exact, so the masks are bit-equal to the plain
// chain's and every t of select_grouped is the value the first kernel
// gave. reselect's masked-width sums associate as a tree (the shuffle
// scan), where the first kernel summed left to right; PyTorch's scan on
// the card is a tree as well (f32 rounding only, ~1e-7 of a width).

#include <cuda_runtime.h>

#ifndef MARCH_WARPS_PER_BLOCK
#define MARCH_WARPS_PER_BLOCK 8
#endif
// Blocks of reselect the compiler is to fit on an SM, which caps its
// registers: 4 blocks of 8 warps allow 64. Measured at 12,288 rays x 64 ->
// 32 slots: 4, 5 and 6 blocks level, 8 (32 registers) and 1 (no cap)
// slower.
#ifndef MARCH_RESELECT_MIN_BLOCKS
#define MARCH_RESELECT_MIN_BLOCKS 4
#endif

namespace {

constexpr int kWarps = MARCH_WARPS_PER_BLOCK;  // rays per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// running group counts a warp holds at once (select_grouped)
constexpr int kGroupChunk = 512;
// output slots a warp assembles at once (reselect)
constexpr int kSlotTile = 128;

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

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

__device__ __forceinline__ float warp_inclusive_sum(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = __fadd_rn(up, v);
  }
  return v;
}

// cum[i] = base + row[g0] + ... + row[g0 + i] for i in [0, n); returns
// cum[n - 1]. The whole warp calls it.
__device__ __forceinline__ int scan_groups(const int* __restrict__ row,
                                           int g0, int n, int base,
                                           int* cum, int lane) {
  for (int i = 0; i < n; i += 32) {
    const int g = i + lane;
    const int v =
        base + warp_inclusive_sum(g < n ? row[g0 + g] : 0, lane);
    if (g < n) cum[g] = v;
    base = __shfl_sync(kFull, v, 31);
  }
  return base;
}

__global__ void __launch_bounds__(kThreads)
select_grouped_kernel(const int* __restrict__ live,
                      const int* __restrict__ group_size,
                      const float* __restrict__ t_min,
                      float* __restrict__ ts, float* __restrict__ te,
                      float* __restrict__ dt, bool* __restrict__ ok, int R,
                      int G, int K, Lattice L) {
  __shared__ int cum_all[kWarps][kGroupChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + warp;
  if (r >= R) return;  // the whole warp leaves
  int* cum = cum_all[warp];
  const int* row = live + r * G;
  // read with the row's first words: one trip to memory per ray
  const int s = group_size[r];
  const float t0 = t_min[r];

  // the live count first: every slot's rank target needs the stride
  const bool one_chunk = G <= kGroupChunk;
  int count;
  if (one_chunk) {
    count = scan_groups(row, 0, G, 0, cum, lane);
  } else {
    int v = 0;
    for (int g = lane; g < G; g += 32) v += row[g];
    count = __shfl_sync(kFull, warp_inclusive_sum(v, lane), 31);
  }
  const int stride = max((count + K - 1) / K, 1);
  const Phases P = L.cone > 0.0f ? cone_phases(t0, L) : Phases{0.0f, 0.0f};
  const long long out = r * K;

  int base = 0;  // the running count before the chunk
  for (int g0 = 0; g0 < G; g0 += kGroupChunk) {
    const int n = min(kGroupChunk, G - g0);
    const int end =
        one_chunk ? count : scan_groups(row, g0, n, base, cum, lane);
    const bool last = g0 + n == G;
    __syncwarp();
    for (int j = lane; j < K; j += 32) {
      const int tgt = j * stride + 1;
      // a slot is settled in the chunk where the running count reaches
      // its target; targets beyond the live count in the last chunk
      if (tgt <= base || !(last || tgt <= end)) continue;
      // g = min(#groups whose running count < tgt, G - 1)
      int lo = 0, len = n;
      while (len > 0) {
        const int half = len >> 1;
        if (cum[lo + half] < tgt) {
          lo += half + 1;
          len -= half + 1;
        } else {
          len = half;
        }
      }
      const int i = min(lo, n - 1);
      const int before = i > 0 ? cum[i - 1] : base;
      const int offset = min(max(tgt - 1 - before, 0), s - 1);
      const int pos = (g0 + i) * s + offset;
      const int scale = min(max(count - j * stride, 0), stride);
      const float posf = (float)pos;
      const float start = lattice_t(t0, posf, L, P);
      ts[out + j] = start;
      te[out + j] = lattice_t(t0, __fadd_rn(posf, 1.0f), L, P);
      // exact decimation-group width (the group's later intervals are
      // geometrically wider when cone > 0)
      dt[out + j] =
          __fsub_rn(lattice_t(t0, (float)(pos + scale), L, P), start);
      ok[out + j] = tgt <= count;
    }
    base = end;
    __syncwarp();  // the next chunk overwrites cum
  }
}

// kChunks > 0: the source row fits kChunks chunks of 32 slots and is held
// in registers, every load started before the first use (one trip to
// memory per ray). kChunks == 0: any K; the row is read once for the
// count and once more per tile of output slots.
template <int kChunks>
__global__ void __launch_bounds__(kThreads, MARCH_RESELECT_MIN_BLOCKS)
reselect_kernel(const bool* __restrict__ masks, const float* __restrict__ ts,
                const float* __restrict__ te, const float* __restrict__ dt,
                float* __restrict__ ts2, float* __restrict__ te2,
                float* __restrict__ dt2, bool* __restrict__ ok2, int R, int K,
                int K2) {
  __shared__ float tile_ts[kWarps][kSlotTile];
  __shared__ float tile_te[kWarps][kSlotTile];
  // one more start than slots: the last slot's width ends at the start of
  // the next tile's first slot
  __shared__ float tile_start[kWarps][kSlotTile + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + warp;
  if (r >= R) return;  // the whole warp leaves
  const long long in = r * K;
  const long long out = r * K2;
  const unsigned upto_lane = (2u << lane) - 1u;  // lanes 0..lane

  // the live count first: the stride decides which ranks are kept
  constexpr int kHeld = kChunks > 0 ? kChunks : 1;
  bool held_m[kHeld];
  float held_d[kHeld], held_ts[kHeld], held_te[kHeld];
  int count = 0;
  if constexpr (kChunks > 0) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = 32 * c + lane;
      const bool in_row = k < K;
      held_m[c] = in_row && masks[in + k];
      held_d[c] = in_row ? dt[in + k] : 0.0f;
      held_ts[c] = in_row ? ts[in + k] : 0.0f;
      held_te[c] = in_row ? te[in + k] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      held_d[c] = held_m[c] ? held_d[c] : 0.0f;
      count += __popc(__ballot_sync(kFull, held_m[c]));
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      count += __popc(__ballot_sync(kFull, k < K && masks[in + k]));
    }
  }
  const int stride = max((count + K2 - 1) / K2, 1);
  // output slots whose rank target j * stride + 1 is within the count
  const int filled = min((count + stride - 1) / stride, K2);
  const int chunks = kChunks > 0 ? kChunks : (K + 31) / 32;

  for (int j0 = 0; j0 < K2; j0 += kSlotTile) {
    const int nj = min(kSlotTile, K2 - j0);
    int rank = 0;      // live slots before the chunk
    float sum = 0.0f;  // their widths
#pragma unroll
    for (int c = 0; c < chunks; ++c) {
      bool m;
      float d, a, b;
      if constexpr (kChunks > 0) {
        m = held_m[c], d = held_d[c], a = held_ts[c], b = held_te[c];
      } else {
        const int k = 32 * c + lane;
        const bool in_row = k < K;
        m = in_row && masks[in + k];
        d = m ? dt[in + k] : 0.0f;
        a = in_row ? ts[in + k] : 0.0f;
        b = in_row ? te[in + k] : 0.0f;
      }
      const unsigned live = __ballot_sync(kFull, m);
      const float through = __fadd_rn(sum, warp_inclusive_sum(d, lane));
      if (m) {
        const int q = rank + __popc(live & upto_lane) - 1;  // 0-based rank
        const int j = q / stride;
        if (j * stride == q && j >= j0 && j <= j0 + nj && j < K2) {
          tile_start[warp][j - j0] = __fsub_rn(through, d);
          if (j < j0 + nj) {
            tile_ts[warp][j - j0] = a;
            tile_te[warp][j - j0] = b;
          }
        }
      }
      rank += __popc(live);
      sum = __shfl_sync(kFull, through, 31);
    }
    const float total = sum;
    __syncwarp();
    for (int jj = lane; jj < nj; jj += 32) {
      const int j = j0 + jj;
      const bool okj = j < filled;
      float a, b, w = 0.0f;
      if (okj) {
        a = tile_ts[warp][jj];
        b = tile_te[warp][jj];
        // groups tile the live slots in rank order: this group's width
        // runs to the next group's start, or to the total after the last
        const float next = j + 1 < filled ? tile_start[warp][jj + 1] : total;
        w = __fsub_rn(next, tile_start[warp][jj]);
      } else {
        // the rank search ends at the last source slot
        a = ts[in + K - 1];
        b = te[in + K - 1];
      }
      ts2[out + j] = a;
      te2[out + j] = b;
      dt2[out + j] = w;
      ok2[out + j] = okj;
    }
    __syncwarp();  // the next tile overwrites the shared rows
  }
}

}  // namespace

extern "C" int nerfacc_select_grouped(const int* live, const int* group_size,
                                      const float* t_min, float* ts,
                                      float* te, float* dt, bool* ok, int R,
                                      int G, int K, float step, float cone,
                                      float dt_max, float a_lim,
                                      float log_grow, void* stream) {
  if (R == 0 || G == 0 || K == 0) return 0;
  const Lattice L{step, cone, dt_max, a_lim, log_grow};
  select_grouped_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      live, group_size, t_min, ts, te, dt, ok, R, G, K, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerfacc_reselect(const bool* masks, const float* ts,
                                const float* te, const float* dt, float* ts2,
                                float* te2, float* dt2, bool* ok2, int R,
                                int K, int K2, void* stream) {
  if (R == 0 || K == 0 || K2 == 0) return 0;
  const int blocks = (R + kWarps - 1) / kWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERFACC_RESELECT(kChunks)                           \
  reselect_kernel<kChunks><<<blocks, kThreads, 0, st>>>(    \
      masks, ts, te, dt, ts2, te2, dt2, ok2, R, K, K2)
  // by shape: rows of up to 128 source slots are held in registers
  switch ((K + 31) / 32) {
    case 1: NERFACC_RESELECT(1); break;
    case 2: NERFACC_RESELECT(2); break;
    case 3: NERFACC_RESELECT(3); break;
    case 4: NERFACC_RESELECT(4); break;
    default: NERFACC_RESELECT(0); break;
  }
#undef NERFACC_RESELECT
  return static_cast<int>(cudaGetLastError());
}
