// March slot selection, stage-2 re-selection and the exact stride-1
// march, for Hopper (sm_90a).
//
// select_grouped replaces nerfacc_tpu/ops/march_select.py::
// fused_select_grouped (Pallas _select_kernel + _lattice_t_block);
// reselect replaces fused_reselect (Pallas _reselect_kernel); march_dense
// replaces no TPU kernel (below).
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
//
// march_dense replaces no TPU kernel. The JAX package leaves the exact
// stride-1 march (ray_marching.py::march_rays at coarse_stride 1 with an
// occupancy grid) to XLA, which fuses it. PyTorch runs it eagerly: the
// whole (R, S) lattice of midpoints, its (R, S, 3) positions, the grid's
// contraction, int64 cell indices, the table gather, the AABB test, a
// cumsum and a searchsorted over S columns, some sixty launches with
// hundreds of MB of intermediates. This kernel is that chain in one
// launch, a warp per ray:
// - per-ray constants in registers: o, d, t_min, t_max, the cone phases
//   and the in-range count k_in from the lattice's closed-form inverse
//   (the plain chain's _in_range_count, operation for operation);
// - one pass over the lattice: lane l takes points k = l, l + 32, ...
//   below k_in; per point the midpoint t(k + 0.5), the position, the
//   AABB contraction, floor(unit * res) clamped to [0, res - 1], the flat
//   cell, the inside test and one byte of the exact binary table. Lane l
//   keeps point 32 i + l's live bit as bit i of one register, so a row of
//   up to 1,024 points lives in one register a lane (longer rows are
//   walked in chunks of 1,024: counted first, recomputed when slots are
//   assigned); the live count is a warp sum of the lanes' popcounts;
// - selection from the registers: stride = max(ceil(count / K), 1); for
//   iteration i a ballot of bit i and a prefix popcount give each live
//   point its 0-based rank q; a point whose rank stride divides owns slot
//   q / stride (reselect's inverted search, as a scatter of its lattice
//   index into the warp's shared-memory tile of kSlotTile slots); after a
//   __syncwarp lane j evaluates slot j's start, end and group end and the
//   warp stores the rows coalesced. Slots past the last live target take
//   what the plain chain's clamped search gives them: position S - 1,
//   width 0, mask false.
// What bounds it: the rows out are 13 bytes a slot (68 MB a 40,960-ray
// view at K = 128: ~0.02 ms at the card's memory rate); the 2 MB table of
// a 128^3 grid stays in L2, and consecutive points of a ray share cells;
// the rest is some tens of instructions a lattice point (three true
// divisions among them), so the points' arithmetic and the latency of a
// warp's chain bound it. The positions, cells and tests are the plain
// chain's f32 operations in its order (_rn intrinsics, true divisions,
// the roi's extent formed on the card from the roi tensor as the chain
// forms it), so masks, starts, ends and widths are bit-equal to the
// chain's.

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
// output slots a warp assembles at once (reselect, march_dense)
constexpr int kSlotTile = 128;
// lattice points a warp holds as live bits, 32 a lane (march_dense)
constexpr int kPointChunk = 32 * 32;

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

// Inverse of lattice_t: the fractional index k with t(k) = t.
__device__ __forceinline__ float lattice_k(float t_min, float t,
                                           const Lattice& L,
                                           const Phases& P) {
  const float kA = __fdiv_rn(__fsub_rn(t, t_min), L.step);
  if (L.cone <= 0.0f) return kA;
  const float tA = __fadd_rn(t_min, __fmul_rn(P.nA, L.step));
  if (t <= tA) return kA;
  const float tB = __fmul_rn(tA, expf(__fmul_rn(L.log_grow, P.nB)));
  if (t <= tB) {
    const float ratio = fmaxf(__fdiv_rn(t, fmaxf(tA, 1e-10f)), 1e-30f);
    return __fadd_rn(P.nA, __fdiv_rn(logf(ratio), L.log_grow));
  }
  return __fadd_rn(__fadd_rn(P.nA, P.nB),
                   __fdiv_rn(__fsub_rn(t, tB), L.dt_max));
}

// Lattice points whose midpoint t(k + 1/2) lies below t_max, at most S:
// ceil(k(t_max) - 1/2) clamped to [0, S] (the clamp keeps a NaN at 0, as
// the card's float-to-int conversion does).
__device__ __forceinline__ int in_range_count(float t_min, float t_max,
                                              const Lattice& L,
                                              const Phases& P, int S) {
  const float k = ceilf(__fsub_rn(lattice_k(t_min, t_max, L, P), 0.5f));
  return static_cast<int>(fminf(fmaxf(k, 0.0f), static_cast<float>(S)));
}

// One ray and the AABB grid it is marched through (march_dense).
struct DenseRay {
  float t0, o[3], d[3];
  float lo[3], hi[3], ext[3], res[3];
  int n[3];
  const unsigned char* table;
};

// Whether lattice point k of the ray is live: its midpoint inside the roi
// and on an occupied cell of the exact table.
__device__ __forceinline__ bool point_live(int k, const DenseRay& ray,
                                           const Lattice& L,
                                           const Phases& P) {
  const float t = lattice_t(ray.t0, __fadd_rn(static_cast<float>(k), 0.5f),
                            L, P);
  bool inside = true;
  int cell = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = __fadd_rn(ray.o[a], __fmul_rn(t, ray.d[a]));
    const float u = __fdiv_rn(__fsub_rn(x, ray.lo[a]), ray.ext[a]);
    // floor, then the plain chain's clamp to [0, res - 1]
    const float c = fminf(fmaxf(floorf(__fmul_rn(u, ray.res[a])), 0.0f),
                          __fsub_rn(ray.res[a], 1.0f));
    cell = cell * ray.n[a] + static_cast<int>(c);
    inside = inside && x >= ray.lo[a] && x <= ray.hi[a];
  }
  return inside && __ldg(ray.table + cell) != 0;
}

// Lane l's live bits of the chunk of points c0 .. c0 + kPointChunk - 1
// below n: bit i for point c0 + 32 i + l.
__device__ __forceinline__ unsigned live_bits(int c0, int n, int lane,
                                              const DenseRay& ray,
                                              const Lattice& L,
                                              const Phases& P) {
  unsigned bits = 0;
  const int iters = min(32, (n - c0 + 31) / 32);
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
    const int k = c0 + 32 * i + lane;
    if (k < n && point_live(k, ray, L, P)) bits |= 1u << i;
  }
  return bits;
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

__global__ void __launch_bounds__(kThreads)
march_dense_kernel(const float* __restrict__ rays_o,
                   const float* __restrict__ rays_d,
                   const float* __restrict__ t_min,
                   const float* __restrict__ t_max,
                   const float* __restrict__ roi,
                   const unsigned char* __restrict__ table,
                   float* __restrict__ ts, float* __restrict__ te,
                   float* __restrict__ dt, bool* __restrict__ ok, int R,
                   int S, int K, int rx, int ry, int rz, Lattice L) {
  __shared__ int tile_pos[kWarps][kSlotTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + warp;
  if (r >= R) return;  // the whole warp leaves
  const unsigned below_lane = (1u << lane) - 1u;

  // per-ray constants: every lane reads the same words
  DenseRay ray;
  ray.t0 = t_min[r];
  const int n_axis[3] = {rx, ry, rz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ray.o[a] = rays_o[3 * r + a];
    ray.d[a] = rays_d[3 * r + a];
    ray.lo[a] = roi[a];
    ray.hi[a] = roi[3 + a];
    ray.ext[a] = __fsub_rn(ray.hi[a], ray.lo[a]);
    ray.res[a] = static_cast<float>(n_axis[a]);
    ray.n[a] = n_axis[a];
  }
  ray.table = table;
  const Phases P =
      L.cone > 0.0f ? cone_phases(ray.t0, L) : Phases{0.0f, 0.0f};
  const int n = in_range_count(ray.t0, t_max[r], L, P, S);

  // the live count first: the stride decides which ranks own slots. A
  // row of one chunk keeps its bits; longer rows recompute theirs below
  const bool one_chunk = n <= kPointChunk;
  unsigned held = 0;
  int count = 0;
  for (int c0 = 0; c0 < n; c0 += kPointChunk) {
    held = live_bits(c0, n, lane, ray, L, P);
    count += __reduce_add_sync(kFull, __popc(held));
  }
  const int stride = max((count + K - 1) / K, 1);
  // slots whose rank target j * stride lies below the count
  const int filled = min((count + stride - 1) / stride, K);
  const long long out = r * K;

  for (int j0 = 0; j0 < K; j0 += kSlotTile) {
    const int nj = min(kSlotTile, K - j0);
    // the chunks are walked until the rank of the tile's last filled slot
    const int last = min(j0 + nj, filled) - 1;
    const int q_end = last >= j0 ? last * stride + 1 : 0;
    int base = 0;  // live points before the chunk
    for (int c0 = 0; c0 < n && base < q_end; c0 += kPointChunk) {
      const unsigned bits = one_chunk ? held : live_bits(c0, n, lane, ray,
                                                         L, P);
      const int iters = min(32, (n - c0 + 31) / 32);
      for (int i = 0; i < iters; ++i) {
        const bool m = (bits >> i) & 1u;
        const unsigned live = __ballot_sync(kFull, m);
        if (m) {
          const int q = base + __popc(live & below_lane);  // 0-based rank
          const int j = q / stride;
          if (j * stride == q && j >= j0 && j < j0 + nj) {
            tile_pos[warp][j - j0] = c0 + 32 * i + lane;
          }
        }
        base += __popc(live);
      }
    }
    __syncwarp();
    for (int jj = lane; jj < nj; jj += 32) {
      const int j = j0 + jj;
      const bool okj = j < filled;
      // the plain chain's search clamps a target past the count to S - 1
      const int pos = okj ? tile_pos[warp][jj] : S - 1;
      const int scale = min(max(count - j * stride, 0), stride);
      const float posf = static_cast<float>(pos);
      const float start = lattice_t(ray.t0, posf, L, P);
      ts[out + j] = start;
      te[out + j] = lattice_t(ray.t0, __fadd_rn(posf, 1.0f), L, P);
      // exact decimation-group width, as select_grouped forms it
      dt[out + j] = __fsub_rn(
          lattice_t(ray.t0, static_cast<float>(pos + scale), L, P), start);
      ok[out + j] = okj;
    }
    __syncwarp();  // the next tile overwrites the positions
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

extern "C" int nerfacc_march_dense(const float* rays_o, const float* rays_d,
                                   const float* t_min, const float* t_max,
                                   const float* roi,
                                   const unsigned char* table, float* ts,
                                   float* te, float* dt, bool* ok, int R,
                                   int S, int K, int rx, int ry, int rz,
                                   float step, float cone, float dt_max,
                                   float a_lim, float log_grow,
                                   void* stream) {
  if (R == 0 || K == 0) return 0;
  const Lattice L{step, cone, dt_max, a_lim, log_grow};
  march_dense_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rays_o, rays_d, t_min, t_max, roi, table, ts, te, dt, ok, R, S, K, rx,
      ry, rz, L);
  return static_cast<int>(cudaGetLastError());
}
