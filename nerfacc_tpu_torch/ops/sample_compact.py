"""Live-sample compaction for expensive field encoders (PyTorch port of
:mod:`nerfacc_tpu.ops.sample_compact`).

The dense ``(n_rays, K)`` slot layout evaluates the radiance field on
every slot, live or not. For a gather-bound field (the hash-grid encoder
reads 8 corners x L levels per point) dead slots cost as much as live
ones, so the field is evaluated on the live slots only, compacted into a
buffer of static capacity, and its outputs are put back on the dense
layout.

Shapes are static and nothing syncs with the host: no ``nonzero``.
``rank = cumsum(mask) - 1`` gives each live slot its compact position; the
inverse map ``pos`` (compact -> flat slot) is one scatter of the iota into
an ``(M + 1,)`` buffer whose last entry takes every dropped slot and is
cut off. :func:`expand_compact` is a ``rank`` gather whose backward is the
``pos`` gather. Plain PyTorch: the JAX package has no kernel here either.
"""

from __future__ import annotations

import torch


def compact_live_slots(masks: torch.Tensor, m_budget: int):
    """Plan a compaction of the live slots of ``masks`` into ``m_budget``
    compact positions (flat row-major order: front to back within each
    ray, rays in batch order).

    Over budget, each ray keeps a front-to-back prefix under a
    proportional quota ``max(1, floor(c_r * M / count))``, so every ray
    with a live sample keeps at least one and the far tail is trimmed; a
    global ``rank < M`` backstop keeps the buffer from overflowing even
    with the one-per-ray floor. Callers AND ``keep`` back into their masks
    and surface ``dropped``.

    Args:
        masks: (R, K) bool dense slot liveness.
        m_budget: compact capacity M.

    Returns:
        pos: (M,) int64 flat slot index of each compact entry (0 for
            unused entries: gate with ``ok``).
        ok: (M,) bool, the compact entry holds a real sample.
        rank: (R * K,) int64 compact position of each flat slot (valid
            where ``keep``).
        keep: (R, K) bool, ``masks`` minus any over-budget drops.
        dropped: () int32 number of live slots dropped.
    """
    n, dev = masks.numel(), masks.device
    row_inc = torch.cumsum(masks, dim=1, dtype=torch.int32)
    c_r = row_inc[:, -1]  # per-ray live counts
    count = c_r.sum(dtype=torch.int32)
    # the quota in f32, in the JAX package's order: M / count, then
    # floor(c_r * ratio). A tensor over a tensor is a true division
    ratio = torch.full((), float(m_budget), device=dev) / torch.clamp(
        count, min=1
    ).to(torch.float32)
    quota = torch.where(
        count > m_budget,
        torch.maximum(
            torch.floor(c_r.to(torch.float32) * ratio).to(torch.int32),
            torch.clamp(c_r, max=1),
        ),
        c_r,
    )
    flat = (masks & (row_inc <= quota[:, None])).reshape(-1)
    inc = torch.cumsum(flat, dim=0)
    rank = inc - 1
    keep = flat & (rank < m_budget)
    kept = torch.clamp(inc[-1], max=m_budget)
    # kept destinations are unique and sorted; every dropped or dead slot
    # lands in the extra entry M
    dest = torch.where(keep, rank, torch.full_like(rank, m_budget))
    pos = torch.zeros((m_budget + 1,), dtype=torch.int64, device=dev)
    pos.scatter_(0, dest, torch.arange(n, device=dev))
    ok = torch.arange(m_budget, device=dev) < kept
    dropped = (count - kept).to(torch.int32)
    return pos[:m_budget], ok, rank, keep.reshape(masks.shape), dropped


class _ExpandCompact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, rank, keep_flat, pos, ok):
        ctx.save_for_backward(pos, ok)
        safe = torch.clamp(rank, 0, vals.shape[0] - 1)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        return torch.where(keep_flat[:, None], vals[safe], zero)

    @staticmethod
    def backward(ctx, g):
        pos, ok = ctx.saved_tensors
        return g.to(torch.float32)[pos] * ok[:, None], None, None, None, None


def expand_compact(vals, rank, keep_flat, pos, ok) -> torch.Tensor:
    """Put compact field outputs back on the dense flat layout: a gather
    both ways.

    Args:
        vals: (M, D) f32 compact per-sample outputs (differentiable).
        rank: (HK,) int64 from :func:`compact_live_slots`.
        keep_flat: (HK,) bool flat ``keep``.
        pos: (M,) int64 from :func:`compact_live_slots` (backward side).
        ok: (M,) bool from :func:`compact_live_slots` (backward side).

    Returns:
        (HK, D) f32; dead and dropped slots are exactly 0.
    """
    return _ExpandCompact.apply(vals, rank, keep_flat, pos, ok)
