"""March slot selection and stage-2 re-selection: CUDA kernels and their
plain PyTorch twins.

``fused_select_grouped`` replaces the Pallas kernel
``nerfacc_tpu/ops/march_select.py::fused_select_grouped``: per ray, the
inclusive cumsum of per-group live counts, the decimation stride, the rank
search of each slot's group, and the closed-form lattice at the slot's
start, end and group end. ``fused_reselect`` replaces
``fused_reselect``: per ray, the rank and masked-width cumsums over the K
march slots, the re-selection of ``k2`` slots and their exact group
widths.

The Pallas kernels unroll compare/select loops over G and K because the
TPU has no vector gather. The CUDA kernels (``csrc/march_select.cu``) give
each ray a warp: rows are read and written coalesced, the running counts
come from shuffle scans, ``fused_select_grouped`` finds each slot's group
by a binary search of the running counts in shared memory, and
``fused_reselect`` inverts its rank search into a scatter (a live source
slot of 0-based rank q is output slot q / stride when stride divides q).
Each wrapper takes the plain twin for CPU tensors only; for CUDA tensors
it launches the kernel or raises. Each counts its launches in
``<wrapper>.launches``.

No kernel runs on the CPU, so the kernels' index algebra is also stated
here in vectorised PyTorch, loop for loop and clamp for clamp
(``select_slots_by_search``, ``reselect_by_scatter``), for the tests to
hold against the twins and the JAX package; nothing else calls them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import _build
from ..ray_marching import (
    _lattice_t,
    gather_rows_dense,
    reselect_visible,
    RaySegments,
    select_slots_grouped,
)

Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# csrc/march_select.cu: running group counts a warp holds at once, output
# slots it assembles at once, source slots it reads at once
GROUP_CHUNK, SLOT_TILE, WARP = 512, 128, 32


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
    cone = float(cone_angle)
    # the lattice constants as the plain chain rounds them to f32
    a_lim = step_size / cone if cone > 0.0 else 0.0
    _build.launch(
        name, "nerfacc_select_grouped", dev,
        *args, *(o.data_ptr() for o in outs), R, G, k_slots,
        float(step_size), cone, float(dt_max), a_lim, math.log1p(cone),
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
