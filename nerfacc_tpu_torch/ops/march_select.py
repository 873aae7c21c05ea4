"""March slot selection, stage-2 re-selection and the exact stride-1 march:
CUDA kernels and their plain PyTorch twins.

``fused_select_grouped`` replaces the Pallas kernel
``nerfacc_tpu/ops/march_select.py::fused_select_grouped``: per ray, the
inclusive cumsum of per-group live counts, the decimation stride, the rank
search of each slot's group, and the closed-form lattice at the slot's
start, end and group end. ``fused_reselect`` replaces
``fused_reselect``: per ray, the rank and masked-width cumsums over the K
march slots, the re-selection of ``k2`` slots and their exact group
widths. ``march_dense`` replaces no TPU kernel: it is the stride-1 branch
of ``march_rays`` over an AABB occupancy grid (the lattice midpoints, the
exact grid test, the rank selection and the lattice at each slot), which
the JAX package leaves to XLA, in one launch.

The Pallas kernels unroll compare/select loops over G and K because the
TPU has no vector gather. The CUDA kernels (``csrc/march_select.cu``) give
each ray a warp: rows are read and written coalesced, the running counts
come from shuffle scans, ``fused_select_grouped`` finds each slot's group
by a binary search of the running counts in shared memory, and
``fused_reselect`` inverts its rank search into a scatter (a live source
slot of 0-based rank q is output slot q / stride when stride divides q),
and ``march_dense`` keeps a ray's live bits in registers, one bit a
lattice point, and scatters each point whose rank the stride divides into
its slot. Each wrapper takes the plain twin for CPU tensors only; for CUDA
tensors it launches the kernel or raises. Each counts its launches in
``<wrapper>.launches``.

No kernel runs on the CPU, so the kernels' index algebra is also stated
here in vectorised PyTorch, loop for loop and clamp for clamp
(``select_slots_by_search``, ``reselect_by_scatter``), for the tests to
hold against the twins and the JAX package; nothing else calls them.
``march_dense``'s statement of its algorithm, ``march_dense_plain``, is
its twin as well: it is bit-equal to ``march_rays``' plain chain.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import _build, tracing
from .._consts import constant
from ..contraction import ContractionType
from ..grid import OccupancyGrid
from ..ray_marching import (
    _in_range_count,
    _lattice_t,
    gather_rows_dense,
    reselect_visible,
    RaySegments,
    select_slots_grouped,
)

Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# csrc/march_select.cu: running group counts a warp holds at once, output
# slots it assembles at once, source slots it reads at once, lattice
# points it holds as live bits (32 a lane)
GROUP_CHUNK, SLOT_TILE, WARP = 512, 128, 32
POINT_CHUNK = WARP * WARP


def _lattice_constants(step_size: float, cone_angle: float, dt_max: float):
    """The lattice's f32 constants for a kernel: step, cone, dt_max, step /
    cone and log1p(cone), as the plain chain rounds them to f32."""
    cone = float(cone_angle)
    a_lim = step_size / cone if cone > 0.0 else 0.0
    return float(step_size), cone, float(dt_max), a_lim, math.log1p(cone)


def fused_select_grouped_plain(
    live_groups: torch.Tensor,
    group_size: torch.Tensor,
    t_min: torch.Tensor,
    *,
    k_slots: int,
    step_size: float,
    cone_angle: float = 0.0,
    dt_max: float = 1e10,
) -> Quad:
    """The unfused ``select_slots_grouped`` + ``_lattice_t`` chain."""
    pos, ok, scale = select_slots_grouped(live_groups, group_size, k_slots)

    def lat(k):
        return _lattice_t(t_min[:, None], k.to(torch.float32), step_size,
                          cone_angle, dt_max)

    ts = lat(pos)
    te = lat(pos.to(torch.float32) + 1.0)
    return ts, te, lat(pos + scale) - ts, ok


def fused_select_grouped(
    live_groups: torch.Tensor,
    group_size: torch.Tensor,
    t_min: torch.Tensor,
    *,
    k_slots: int,
    step_size: float,
    cone_angle: float = 0.0,
    dt_max: float = 1e10,
) -> Quad:
    """Slot selection + lattice evaluation of the grouped march.

    Args:
        live_groups: (R, G) int32 live-candidate counts per probe group.
        group_size: (R, 1) int32 per-ray probe stride.
        t_min: (R,) f32 marching origins.
        k_slots: slots per ray.
        step_size / cone_angle / dt_max: lattice parameters.

    Returns:
        (t_starts, t_ends, deltas, ok): three (R, K) f32 and one (R, K)
        bool. ``ok`` is bit-equal to the plain chain's; t agrees to f32
        rounding.
    """
    kw = dict(k_slots=k_slots, step_size=step_size, cone_angle=cone_angle,
              dt_max=dt_max)
    if live_groups.device.type == "cpu":
        return fused_select_grouped_plain(live_groups, group_size, t_min, **kw)
    name = "fused_select_grouped"
    R, G = live_groups.shape
    dev = live_groups.device
    args = [
        _build.cuda_ptr(name, "live_groups", live_groups, torch.int32,
                        (R, G), dev),
        _build.cuda_ptr(name, "group_size", group_size, torch.int32,
                        (R, 1), dev),
        _build.cuda_ptr(name, "t_min", t_min, torch.float32, (R,), dev),
    ]
    outs = [torch.empty((R, k_slots), dtype=torch.float32, device=dev)
            for _ in range(3)]
    outs.append(torch.empty((R, k_slots), dtype=torch.bool, device=dev))
    _build.launch(
        name, "nerfacc_select_grouped", dev,
        *args, *(o.data_ptr() for o in outs), R, G, k_slots,
        *_lattice_constants(step_size, cone_angle, dt_max),
    )
    fused_select_grouped.launches += 1
    return tuple(outs)


fused_select_grouped.launches = 0


def fused_reselect_plain(
    masks: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    deltas: torch.Tensor,
    *,
    k2: int,
) -> Quad:
    """``reselect_visible``'s unfused chain."""
    segs = reselect_visible(
        RaySegments(t_starts=t_starts, t_ends=t_ends, deltas=deltas,
                    masks=masks),
        k2,
        use_pallas=False,
    )
    return segs.t_starts, segs.t_ends, segs.deltas, segs.masks


def fused_reselect(
    masks: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    deltas: torch.Tensor,
    *,
    k2: int,
) -> Quad:
    """Visible-sample re-selection (stage 2 of the two-stage render).

    Re-selects each ray's ``k2`` live slots out of (R, K) masked samples
    with exact decimation-group widths. Returns (t_starts2, t_ends2,
    deltas2, ok2): (R, k2) f32 x3 + bool.
    """
    if masks.device.type == "cpu":
        return fused_reselect_plain(masks, t_starts, t_ends, deltas, k2=k2)
    name = "fused_reselect"
    R, K = masks.shape
    dev = masks.device
    args = [_build.cuda_ptr(name, "masks", masks, torch.bool, (R, K), dev)]
    for arg, t in (("t_starts", t_starts), ("t_ends", t_ends),
                   ("deltas", deltas)):
        args.append(_build.cuda_ptr(name, arg, t, torch.float32, (R, K), dev))
    outs = [torch.empty((R, k2), dtype=torch.float32, device=dev)
            for _ in range(3)]
    outs.append(torch.empty((R, k2), dtype=torch.bool, device=dev))
    _build.launch(name, "nerfacc_reselect", dev,
                  *args, *(o.data_ptr() for o in outs), R, K, k2)
    fused_reselect.launches += 1
    return tuple(outs)


fused_reselect.launches = 0


def select_slots_by_search(
    live_groups: torch.Tensor,
    group_size: torch.Tensor,
    k_slots: int,
    chunk: int = GROUP_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The index algebra of the ``fused_select_grouped`` kernel: (pos, ok,
    scale) as :func:`select_slots_grouped` returns them.

    The row of running group counts is taken ``chunk`` groups at a time on
    top of the count before the chunk. A slot is settled in the chunk
    where the running count reaches its rank target (targets beyond the
    live count: in the last chunk), by the kernel's binary search for the
    first group whose running count is not below the target, clamped to
    the chunk's last group. Raises if a slot is settled twice or never.
    """
    R, G = live_groups.shape
    dev = live_groups.device
    count = live_groups.sum(dim=1, keepdim=True, dtype=torch.int32)
    stride = torch.clamp(
        torch.div(count + k_slots - 1, k_slots, rounding_mode="floor"), min=1)
    j = torch.arange(k_slots, dtype=torch.int32, device=dev)[None]
    tgt = j * stride + 1
    pos = torch.zeros((R, k_slots), dtype=torch.int32, device=dev)
    settled = torch.zeros((R, k_slots), dtype=torch.bool, device=dev)
    base = torch.zeros((R, 1), dtype=torch.int32, device=dev)
    for g0 in range(0, G, chunk):
        n = min(chunk, G - g0)
        cum = base + torch.cumsum(live_groups[:, g0:g0 + n], dim=1,
                                  dtype=torch.int32)
        end = cum[:, -1:]
        here = tgt > base
        if g0 + n < G:
            here = here & (tgt <= end)
        lo = torch.zeros_like(tgt)
        length = torch.full_like(tgt, n)
        while bool((length > 0).any()):
            half = length >> 1
            probe = gather_rows_dense(cum, torch.clamp(lo + half, max=n - 1))
            up = (length > 0) & (probe < tgt)
            down = (length > 0) & ~up
            lo = torch.where(up, lo + half + 1, lo)
            length = torch.where(up, length - half - 1,
                                 torch.where(down, half, length))
        i = torch.clamp(lo, max=n - 1)
        before = torch.where(
            i > 0, gather_rows_dense(cum, torch.clamp(i - 1, min=0)), base)
        offset = torch.minimum(torch.clamp(tgt - 1 - before, min=0),
                               group_size - 1)
        if bool((here & settled).any()):
            raise AssertionError("a slot was settled in two chunks")
        pos = torch.where(here, (g0 + i) * group_size + offset, pos)
        settled = settled | here
        base = end
    if not bool(settled.all()):
        raise AssertionError("a slot was settled in no chunk")
    scale = torch.minimum(torch.clamp(count - j * stride, min=0), stride)
    return pos, tgt <= count, scale


def reselect_by_scatter(
    masks: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    deltas: torch.Tensor,
    *,
    k2: int,
    tile: int = SLOT_TILE,
) -> Quad:
    """The index algebra of the ``fused_reselect`` kernel, as a scatter.

    Ranks and masked-width sums run over the source row ``WARP`` slots at a
    time with carried totals. A live source slot of 0-based rank q lands in
    output slot q / stride when stride divides q; output slots are
    assembled ``tile`` at a time, each tile with one more start than slots
    (the last slot's width ends at the next tile's first start). Slots
    whose rank target exceeds the live count take source slot K - 1, width
    0 and mask False. Tiles start out as NaN, so a slot that no source
    wrote shows.
    """
    R, K = masks.shape
    dev = masks.device
    count = masks.sum(dim=1, keepdim=True, dtype=torch.int32)
    stride = torch.clamp(
        torch.div(count + k2 - 1, k2, rounding_mode="floor"), min=1)
    filled = torch.clamp(
        torch.div(count + stride - 1, stride, rounding_mode="floor"), max=k2)
    d = torch.where(masks, deltas, torch.zeros_like(deltas))
    rank = torch.zeros((R, 1), dtype=torch.int32, device=dev)
    total = torch.zeros((R, 1), dtype=deltas.dtype, device=dev)
    q_parts, through_parts = [], []
    for k0 in range(0, K, WARP):
        m = masks[:, k0:k0 + WARP]
        q_parts.append(rank + torch.cumsum(m, dim=1, dtype=torch.int32) - 1)
        through_parts.append(total + torch.cumsum(d[:, k0:k0 + WARP], dim=1))
        rank = rank + m.sum(dim=1, keepdim=True, dtype=torch.int32)
        total = through_parts[-1][:, -1:]
    q = torch.cat(q_parts, dim=1)
    start = torch.cat(through_parts, dim=1) - d
    j = torch.div(q, stride, rounding_mode="floor")
    kept = masks & (j * stride == q) & (j < k2)

    outs = [torch.empty((R, k2), dtype=t.dtype, device=dev)
            for t in (t_starts, t_ends, deltas)]
    ok2 = torch.arange(k2, device=dev)[None] < filled
    for j0 in range(0, k2, tile):
        nj = min(tile, k2 - j0)
        nan = float("nan")
        tile_ts = torch.full((R, nj), nan, dtype=t_starts.dtype, device=dev)
        tile_te = torch.full((R, nj), nan, dtype=t_ends.dtype, device=dev)
        tile_start = torch.full((R, nj + 1), nan, dtype=deltas.dtype,
                                device=dev)
        rows, cols = torch.nonzero(kept & (j >= j0) & (j <= j0 + nj),
                                   as_tuple=True)
        at = j[rows, cols].long() - j0
        tile_start[rows, at] = start[rows, cols]
        slot = at < nj
        tile_ts[rows[slot], at[slot]] = t_starts[rows[slot], cols[slot]]
        tile_te[rows[slot], at[slot]] = t_ends[rows[slot], cols[slot]]
        j_abs = j0 + torch.arange(nj, device=dev)[None]
        okj = j_abs < filled
        nxt = torch.where(j_abs + 1 < filled, tile_start[:, 1:], total)
        sl = slice(j0, j0 + nj)
        outs[0][:, sl] = torch.where(okj, tile_ts, t_starts[:, K - 1:])
        outs[1][:, sl] = torch.where(okj, tile_te, t_ends[:, K - 1:])
        outs[2][:, sl] = torch.where(okj, nxt - tile_start[:, :nj],
                                     torch.zeros_like(nxt))
    return outs[0], outs[1], outs[2], ok2


def march_dense_plain(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t_min: torch.Tensor,
    t_max: torch.Tensor,
    grid: OccupancyGrid,
    *,
    k_slots: int,
    max_samples: int,
    step_size: float,
    cone_angle: float = 0.0,
    dt_max: float = 1e10,
    chunk: int = POINT_CHUNK,
    tile: int = SLOT_TILE,
) -> Quad:
    """The algorithm of the ``march_dense`` kernel, vectorised: (t_starts,
    t_ends, deltas, ok) as :func:`march_dense` returns them.

    A ray's lattice points below its in-range count are walked ``chunk``
    at a time (point c0 + 32 i + l is lane l's bit i in the kernel: the
    lattice order is the rank order). A point is live when its midpoint
    lies in the roi and on an occupied cell of the exact table, the cell
    being ``floor(unit * res)`` clamped to ``[0, res - 1]`` in f32. The
    live count sets the stride ``max(ceil(count / K), 1)``; output slots
    are assembled ``tile`` at a time, each tile by another walk over the
    chunks with the rank carried across them: a live point of 0-based rank
    q owns slot q / stride when stride divides q. Slots past the last
    target take position S - 1 and width 0, unmasked. Raises if a filled
    slot got no point.
    """
    R, S, K = rays_o.shape[0], max_samples, k_slots
    dev = rays_o.device
    k_in = _in_range_count(t_min, t_max, step_size, cone_angle, dt_max, S)
    lo, hi = grid.roi_aabb[:3], grid.roi_aabb[3:]
    res = constant(tuple(float(r) for r in grid.resolution), torch.float32,
                   dev)
    _, ry, rz = grid.resolution
    table = grid.binary.reshape(-1)

    def live(c0: int) -> torch.Tensor:
        """(R, n) live bits of the points c0 .. c0 + n - 1."""
        k = torch.arange(c0, min(c0 + chunk, S), dtype=torch.float32,
                         device=dev)[None]
        t_mid = _lattice_t(t_min[:, None], k + 0.5, step_size, cone_angle,
                           dt_max)
        x = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
        unit = (x - lo) / (hi - lo)
        cell = torch.minimum(torch.clamp(torch.floor(unit * res), min=0.0),
                             res - 1.0).long()
        flat = (cell[..., 0] * ry + cell[..., 1]) * rz + cell[..., 2]
        inside = torch.all((x >= lo) & (x <= hi), dim=-1)
        return (k < k_in[:, None]) & inside & table[flat]

    count = torch.zeros((R, 1), dtype=torch.int32, device=dev)
    for c0 in range(0, S, chunk):
        count += live(c0).sum(dim=1, keepdim=True, dtype=torch.int32)
    stride = torch.clamp(
        torch.div(count + K - 1, K, rounding_mode="floor"), min=1)
    filled = torch.clamp(
        torch.div(count + stride - 1, stride, rounding_mode="floor"), max=K)
    j_all = torch.arange(K, dtype=torch.int32, device=dev)[None]
    ok = j_all < filled

    pos = torch.full((R, K), S - 1, dtype=torch.int32, device=dev)
    for j0 in range(0, K, tile):
        nj = min(tile, K - j0)
        tile_pos = torch.full((R, nj), -1, dtype=torch.int32, device=dev)
        base = torch.zeros((R, 1), dtype=torch.int32, device=dev)
        for c0 in range(0, S, chunk):
            m = live(c0)
            q = base + torch.cumsum(m, dim=1, dtype=torch.int32) - 1
            j = torch.div(q, stride, rounding_mode="floor")
            kept = m & (j * stride == q) & (j >= j0) & (j < j0 + nj)
            rows, cols = torch.nonzero(kept, as_tuple=True)
            tile_pos[rows, j[rows, cols].long() - j0] = (c0 + cols).to(
                torch.int32)
            base = base + m.sum(dim=1, keepdim=True, dtype=torch.int32)
        here = ok[:, j0:j0 + nj]
        if bool((here & (tile_pos < 0)).any()):
            raise AssertionError("a filled slot got no lattice point")
        pos[:, j0:j0 + nj] = torch.where(here, tile_pos, pos[:, j0:j0 + nj])

    scale = torch.minimum(torch.clamp(count - j_all * stride, min=0), stride)

    def lat(k):
        return _lattice_t(t_min[:, None], k.to(torch.float32), step_size,
                          cone_angle, dt_max)

    ts = lat(pos)
    te = lat(pos.to(torch.float32) + 1.0)
    return ts, te, lat(pos + scale) - ts, ok


def march_dense(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t_min: torch.Tensor,
    t_max: torch.Tensor,
    grid: OccupancyGrid,
    *,
    k_slots: int,
    max_samples: int,
    step_size: float,
    cone_angle: float = 0.0,
    dt_max: float = 1e10,
) -> Quad:
    """The exact stride-1 march over an AABB occupancy grid, in one launch.

    Args:
        rays_o, rays_d: (R, 3) f32 origins and directions.
        t_min, t_max: (R,) f32 t-ranges.
        grid: an AABB occupancy grid; its exact ``binary`` table is read.
        k_slots: slots per ray, at most ``max_samples``.
        max_samples: the candidate lattice S.
        step_size / cone_angle / dt_max: lattice parameters.

    Returns:
        (t_starts, t_ends, deltas, ok): three (R, K) f32 and one (R, K)
        bool, bit-equal to ``march_rays``' plain chain at
        ``coarse_stride`` 1.
    """
    name = "march_dense"
    if grid.contraction_type != ContractionType.AABB:
        raise ValueError(f"{name}: needs an AABB grid, got "
                         f"{grid.contraction_type}")
    if not 0 < k_slots <= max_samples < 1 << 24:
        raise ValueError(f"{name}: need 0 < k_slots <= max_samples < 2^24, "
                         f"got {k_slots}, {max_samples}")
    kw = dict(k_slots=k_slots, max_samples=max_samples, step_size=step_size,
              cone_angle=cone_angle, dt_max=dt_max)
    if rays_o.device.type == "cpu":
        return march_dense_plain(rays_o, rays_d, t_min, t_max, grid, **kw)
    R = rays_o.shape[0]
    dev = rays_o.device
    res = tuple(grid.resolution)
    if math.prod(res) >= 1 << 31:
        raise ValueError(f"{name}: a grid of {res} has 2^31 cells or more")
    f32 = torch.float32
    args = [
        _build.cuda_ptr(name, "rays_o", rays_o, f32, (R, 3), dev),
        _build.cuda_ptr(name, "rays_d", rays_d, f32, (R, 3), dev),
        _build.cuda_ptr(name, "t_min", t_min, f32, (R,), dev),
        _build.cuda_ptr(name, "t_max", t_max, f32, (R,), dev),
        _build.cuda_ptr(name, "roi_aabb", grid.roi_aabb, f32, (6,), dev),
        _build.cuda_ptr(name, "binary", grid.binary, torch.bool, res, dev),
    ]
    outs = [torch.empty((R, k_slots), dtype=f32, device=dev)
            for _ in range(3)]
    outs.append(torch.empty((R, k_slots), dtype=torch.bool, device=dev))
    _build.launch(
        name, "nerfacc_march_dense", dev,
        *args, *(o.data_ptr() for o in outs), R, max_samples, k_slots, *res,
        *_lattice_constants(step_size, cone_angle, dt_max),
    )
    march_dense.launches += 1
    tracing.count("march_kernel_rays", R)
    return tuple(outs)


march_dense.launches = 0
