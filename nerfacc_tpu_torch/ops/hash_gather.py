"""Hash-table encoder core op: multi-level gather forward, table-gradient
scatter backward (PyTorch port of :mod:`nerfacc_tpu.ops.hash_gather`).

``hash_grad_scatter`` (K7) replaces the Pallas kernel
``nerfacc_tpu/ops/hash_gather.py::hash_grad_scatter_packed``: the
scatter-add of per-corner feature-pair cotangents into one level's (T, 2)
table, skipping negative indices. The TPU has no scatter, so its kernel
walks the corners serially over a lane-packed accumulator; the CUDA kernel
(``csrc/hash_scatter.cu``) runs one thread per corner with an 8-byte
``atomicAdd``, takes any batch size and needs no packing. Its wrapper
takes the plain twin for CPU tensors only; for CUDA tensors it launches
the kernel or raises. It counts its launches in
``hash_grad_scatter.launches``.

``hash_encode_lookup`` is the encoder's autograd op, as the JAX package's
``custom_vjp``: the forward is plain PyTorch indexing (the JAX forward is
XLA gathers outside any kernel) and reads the table **rounded to bf16**
when ``packed_gather`` is set (the JAX package gathers bf16-packed pairs);
the backward gives the table's gradient alone, per level, through
``index_add_`` or, with ``pallas_scatter=True``, through K7. Sample
positions get no gradient: sampling is stop-gradient everywhere.

Layouts for this card: the table is ``(L, T, F)``, a level's features of
one entry adjacent, so one row gather reads every feature of a corner and
K7 adds into a level's contiguous ``(T, 2)`` slice. The output stays
feature-major ``(N, F * L)`` as in the JAX package (columns ``[:L]`` are
feature 0 of every level), which the heads' weights depend on.
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
        N = flat_idx.shape[0]
        # (N, F * L) feature-major -> (N, L, F)
        g = g.to(torch.float32).reshape(N, F, L).permute(0, 2, 1)
        d_table = torch.zeros((L, T, F), dtype=torch.float32,
                              device=g.device)
        for level in range(L):
            sl = slice(level * 8, level * 8 + 8)
            idx_l = (flat_idx[:, sl] - level * T).reshape(-1)  # (8 N,)
            v = (corner_w[:, sl, None] * g[:, level, None, :]).reshape(-1, F)
            if ctx.pallas_scatter:
                hash_grad_scatter(idx_l, v, T, out=d_table[level])
            else:
                d_table[level].index_add_(0, idx_l.long(), v)
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
            (:func:`hash_grad_scatter`, once per level) instead of
            per-level ``index_add_``. Needs F = 2: the kernel adds feature
            pairs.
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
