"""Hash-table encoder core op: multi-level gather forward, table-gradient
scatter backward (PyTorch port of :mod:`nerfacc_tpu.ops.hash_gather`).

Two wrappers replace the Pallas kernel
``nerfacc_tpu/ops/hash_gather.py::hash_grad_scatter_packed`` (K7; CUDA
source ``csrc/hash_scatter.cu``):

- ``hash_grad_scatter``, its counterpart by interface: the scatter-add of
  per-corner feature-pair cotangents into one level's (T, 2) table,
  skipping negative indices. One thread per corner with an 8-byte
  ``atomicAdd``; any batch size, no packing.
- ``hash_grad_scatter_levels``, the whole table gradient in one launch (what
  the JAX package's ``_bwd_pallas`` computes with one kernel call per
  level): it reads the encoder's own ``(N, L * 8)`` indices and weights and
  the ``(N, 2 L)`` cotangent, forms ``w * g`` in registers, sums runs of
  consecutive samples that hit the same entry before it adds them, and
  adds into the flat ``(L * T, 2)`` gradient through the level offsets the
  indices already carry.

The TPU has no scatter, so its kernel walks the corners serially over a
lane-packed accumulator. Each wrapper takes its plain twin for CPU tensors
only; for CUDA tensors it launches the kernel or raises. Each counts its
launches on itself (``.launches``).

``hash_encode_lookup`` is the encoder's autograd op, as the JAX package's
``custom_vjp``: the forward is plain PyTorch indexing (the JAX forward is
XLA gathers outside any kernel) and reads the table **rounded to bf16**
when ``packed_gather`` is set (the JAX package gathers bf16-packed pairs);
the backward gives the table's gradient alone, through per-level
``index_add_`` or, with ``pallas_scatter=True``, through one launch of
``hash_grad_scatter_levels``. Sample positions get no gradient: sampling
is stop-gradient everywhere.

Layouts for this card: the table is ``(L, T, F)``, a level's features of
one entry adjacent, so one row gather reads every feature of a corner and
K7 adds feature pairs into the contiguous ``(L * T, 2)`` gradient. The
output stays feature-major ``(N, F * L)`` as in the JAX package (columns
``[:L]`` are feature 0 of every level), which the heads' weights depend on.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .. import _build


def _check_scatter_args(idx, values, n_entries, out):
    if idx.dim() != 1 or tuple(values.shape) != (idx.shape[0], 2):
        raise ValueError(
            f"hash_grad_scatter: idx must be (B,) and values (B, 2), got "
            f"{tuple(idx.shape)} and {tuple(values.shape)}"
        )
    if out is not None and tuple(out.shape) != (n_entries, 2):
        raise ValueError(
            f"hash_grad_scatter: out must be ({n_entries}, 2), got "
            f"{tuple(out.shape)}"
        )


def hash_grad_scatter_plain(
    idx: torch.Tensor,
    values: torch.Tensor,
    n_entries: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7's twin: ``zeros(T, 2).index_add_`` over the rows with
    ``idx >= 0`` (rows with a negative index add zero to entry 0)."""
    _check_scatter_args(idx, values, n_entries, out)
    if out is None:
        out = torch.zeros((n_entries, 2), dtype=torch.float32,
                          device=values.device)
    live = idx >= 0
    zero = torch.zeros((), dtype=torch.float32, device=values.device)
    return out.index_add_(
        0,
        torch.where(live, idx, torch.zeros_like(idx)).long(),
        torch.where(live[:, None], values.to(torch.float32), zero),
    )


def hash_grad_scatter(
    idx: torch.Tensor,
    values: torch.Tensor,
    n_entries: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scatter-add ``values`` (B, 2) f32 at ``idx`` (B,) int32 into a
    (n_entries, 2) f32 table (K7; the plain twin for CPU tensors).

    Rows with ``idx < 0`` are skipped. ``B`` may be anything. Without
    ``out`` the table starts at zero; with ``out``, a contiguous
    (n_entries, 2) f32 tensor such as one level's slice of a zeroed
    gradient, the sums are added into it in place. Returns the table.
    Sums run in atomic order: equal to any other order up to f32
    summation error.
    """
    if idx.device.type == "cpu":
        return hash_grad_scatter_plain(idx, values, n_entries, out)
    name = "hash_grad_scatter"
    _check_scatter_args(idx, values, n_entries, out)
    B, T, dev = idx.shape[0], int(n_entries), idx.device
    if out is None:
        out = torch.zeros((T, 2), dtype=torch.float32, device=dev)
    ptrs = (
        _build.cuda_ptr(name, "idx", idx, torch.int32, (B,), dev),
        _build.cuda_ptr(name, "values", values, torch.float32, (B, 2), dev),
        _build.cuda_ptr(name, "out", out, torch.float32, (T, 2), dev),
    )
    if ptrs[1] % 8 or ptrs[2] % 8:
        raise ValueError(f"{name}: values and out must be 8-byte aligned")
    _build.launch(name, "nerfacc_hash_grad_scatter", dev, *ptrs, B, T)
    hash_grad_scatter.launches += 1
    return out


hash_grad_scatter.launches = 0


# How hash_grad_scatter_levels cuts its work (csrc/hash_scatter.cu): a
# thread sums the terms of SCATTER_RUN_LENGTH consecutive samples that hit
# the same entry before it adds them, and the grid takes the levels in
# groups of SCATTER_GROUP_LEVELS. Both measured on an H100 at the NGP
# step's shape (scripts/bench_k1_k7_variants_torch.py): groups of 4 are
# fastest on random and on ray-ordered points; a run of 8 already merges
# most of what the coarse levels offer (0.60 adds per corner against 0.57
# at 32) and keeps four times as many threads in flight.
SCATTER_RUN_LENGTH = 8
SCATTER_GROUP_LEVELS = 4


def _check_levels_args(flat_idx, corner_w, g, d_table):
    """``(N, L, T, F)`` of the multi-level table gradient's arguments."""
    if d_table.dim() != 3:
        raise ValueError(
            f"hash_grad_scatter_levels: d_table must be (L, T, F), got "
            f"{tuple(d_table.shape)}"
        )
    L, T, F = d_table.shape
    N = flat_idx.shape[0]
    if (tuple(flat_idx.shape) != (N, L * 8)
            or tuple(corner_w.shape) != (N, L * 8)
            or tuple(g.shape) != (N, F * L)):
        raise ValueError(
            f"hash_grad_scatter_levels: for d_table {tuple(d_table.shape)} "
            f"flat_idx and corner_w must be (N, {L * 8}) and g (N, {F * L})"
            f", got {tuple(flat_idx.shape)}, {tuple(corner_w.shape)} and "
            f"{tuple(g.shape)}"
        )
    return N, L, T, F


def _level_offsets(n_levels: int, n_entries: int, device) -> torch.Tensor:
    """(L * 8,) int32: the first table row of each column's level."""
    first = torch.arange(n_levels, dtype=torch.int32, device=device)
    return (first * n_entries).repeat_interleave(8)


def _index_add_levels(local_idx, corner_w, g, d_table) -> torch.Tensor:
    """Per level, ``index_add_`` of ``corner_w * g`` at the level-local
    indices ``local_idx`` (N, L * 8), all inside ``[0, T)``, into
    ``d_table[level]``; any number of features F."""
    L, T, F = d_table.shape
    N = local_idx.shape[0]
    dtype = d_table.dtype  # f32; the checks also sum in f64
    w = corner_w.to(dtype)
    # (N, F * L) feature-major -> (N, L, F)
    g = g.to(dtype).reshape(N, F, L).permute(0, 2, 1)
    for level in range(L):
        sl = slice(level * 8, level * 8 + 8)
        v = (w[:, sl, None] * g[:, level, None, :]).reshape(-1, F)
        d_table[level].index_add_(0, local_idx[:, sl].reshape(-1).long(), v)
    return d_table


def hash_grad_scatter_levels_plain(
    flat_idx: torch.Tensor,
    corner_w: torch.Tensor,
    g: torch.Tensor,
    d_table: torch.Tensor,
) -> torch.Tensor:
    """The multi-level twin: per level, ``index_add_`` of ``corner_w * g``
    into ``d_table[level]``, any number of features F. Indices outside
    their level's ``[l T, (l + 1) T)`` add nothing (they add a zero to the
    level's entry 0). Returns ``d_table``."""
    _, L, T, _ = _check_levels_args(flat_idx, corner_w, g, d_table)
    local = flat_idx - _level_offsets(L, T, flat_idx.device)
    live = (local >= 0) & (local < T)
    return _index_add_levels(
        torch.where(live, local, torch.zeros_like(local)),
        torch.where(live, corner_w, torch.zeros_like(corner_w)),
        g, d_table)


def hash_grad_scatter_levels(
    flat_idx: torch.Tensor,
    corner_w: torch.Tensor,
    g: torch.Tensor,
    d_table: torch.Tensor,
) -> torch.Tensor:
    """The table gradient of every level in one launch (K7; the plain
    twin for CPU tensors): ``d_table[l, idx - l T] += corner_w * (g[:, l],
    g[:, L + l])`` per corner, added in place into ``d_table``.

    Args:
        flat_idx: (N, L * 8) int32 indices into the (L * T) table rows,
            level offsets included (level l's corners at columns ``l * 8
            .. l * 8 + 8``). An index outside its level's ``[l T, (l + 1)
            T)``, such as -1, adds nothing.
        corner_w: (N, L * 8) f32 corner weights, same layout.
        g: (N, 2 L) f32 cotangent of the encoder's output, feature-major.
        d_table: (L, T, 2) f32, contiguous; zeroed by the caller for a
            gradient.

    Returns ``d_table``. Any N. Runs of consecutive samples that hit the
    same entry are summed first, then added in atomic order: equal to any
    other order up to f32 summation error.
    """
    if flat_idx.device.type == "cpu":
        return hash_grad_scatter_levels_plain(flat_idx, corner_w, g, d_table)
    name = "hash_grad_scatter_levels"
    N, L, T, F = _check_levels_args(flat_idx, corner_w, g, d_table)
    if F != 2:
        raise ValueError(f"{name}: the kernel adds feature pairs, got F={F}")
    if L * T >= 2 ** 31:
        raise ValueError(f"{name}: L * T = {L * T} does not fit 31 bits")
    dev = flat_idx.device
    ptrs = (
        _build.cuda_ptr(name, "flat_idx", flat_idx, torch.int32, (N, L * 8),
                        dev),
        _build.cuda_ptr(name, "corner_w", corner_w, torch.float32,
                        (N, L * 8), dev),
        _build.cuda_ptr(name, "g", g, torch.float32, (N, 2 * L), dev),
        _build.cuda_ptr(name, "d_table", d_table, torch.float32, (L, T, 2),
                        dev),
    )
    if ptrs[3] % 8:
        raise ValueError(f"{name}: d_table must be 8-byte aligned")
    _build.launch(name, "nerfacc_hash_grad_scatter_levels", dev, *ptrs,
                  N, L, T, min(SCATTER_GROUP_LEVELS, L), SCATTER_RUN_LENGTH)
    hash_grad_scatter_levels.launches += 1
    return d_table


hash_grad_scatter_levels.launches = 0


class _HashEncodeLookup(torch.autograd.Function):
    """Gather + trilinear blend; the backward is the table gradient."""

    @staticmethod
    def forward(ctx, table, flat_idx, corner_w, pallas_scatter,
                packed_gather):
        L, T, F = table.shape
        N = flat_idx.shape[0]
        ctx.save_for_backward(flat_idx, corner_w)
        ctx.table_shape, ctx.pallas_scatter = (L, T, F), pallas_scatter
        tf = table.to(torch.float32)
        if packed_gather:
            # the values a bf16-packed table holds
            tf = tf.to(torch.bfloat16).to(torch.float32)
        f = tf.reshape(L * T, F)[flat_idx]  # (N, L * 8, F)
        out = (f * corner_w[..., None]).reshape(N, L, 8, F).sum(dim=2)
        return out.permute(0, 2, 1).reshape(N, F * L)

    @staticmethod
    def backward(ctx, g):
        flat_idx, corner_w = ctx.saved_tensors
        L, T, F = ctx.table_shape
        g = g.to(torch.float32).contiguous()  # (N, F * L), feature-major
        d_table = torch.zeros((L, T, F), dtype=torch.float32,
                              device=g.device)
        if ctx.pallas_scatter:
            hash_grad_scatter_levels(flat_idx, corner_w, g, d_table)
        else:
            # the encoder's own indices lie inside their levels: no mask
            _index_add_levels(
                flat_idx - _level_offsets(L, T, flat_idx.device), corner_w,
                g, d_table)
        return d_table, None, None, None, None


def hash_encode_lookup(
    table: torch.Tensor,
    flat_idx: torch.Tensor,
    corner_w: torch.Tensor,
    n_entries_per_level: int,
    pallas_scatter: bool = False,
    packed_gather: Union[bool, str] = True,
) -> torch.Tensor:
    """Multi-level hash-table lookup and trilinear blend, with a backward
    that produces only the table's gradient.

    Args:
        table: (L, T, F) f32 tables, T entries per level.
        flat_idx: (N, L * 8) int32 indices into the (L * T) rows (level
            offsets added; level l's corners at columns ``l * 8 .. l * 8
            + 8``).
        corner_w: (N, L * 8) f32 trilinear corner weights, same layout.
        n_entries_per_level: T.
        pallas_scatter: the table gradient through K7
            (:func:`hash_grad_scatter_levels`, one launch for all levels)
            instead of per-level ``index_add_``. Needs F = 2: the kernel
            adds feature pairs.
        packed_gather: read the table rounded to bf16 (the JAX package's
            packed pairs); False reads f32. ``"per_level"`` is not
            ported.

    Returns:
        (N, F * L) f32 blended features, feature-major.
    """
    if packed_gather == "per_level":
        raise NotImplementedError(
            "the per-level gather variant (gather_mode='per_level') is not "
            "ported"
        )
    L, T, F = table.shape
    if T != n_entries_per_level or flat_idx.shape[1] != L * 8:
        raise ValueError(
            f"table {tuple(table.shape)} does not match T="
            f"{n_entries_per_level} and flat_idx {tuple(flat_idx.shape)}"
        )
    if pallas_scatter and F != 2:
        raise ValueError(
            "pallas_scatter adds feature pairs: it needs n_features == 2, "
            f"got {F}"
        )
    return _HashEncodeLookup.apply(
        table, flat_idx, corner_w, bool(pallas_scatter), bool(packed_gather)
    )
