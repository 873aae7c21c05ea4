"""Hash-table encoder core ops: the fused forward, the multi-level gather
forward, the table-gradient scatter backward (PyTorch port of
:mod:`nerfacc_tpu.ops.hash_gather`).

``hash_encode`` is the whole encoder forward in one launch of
``csrc/hash_encode.cu``: corner indices, trilinear weights, the table read
(rounded to bf16 where ``packed_gather``) and the blend, from the points
themselves. It replaces no TPU kernel: the JAX package's forward is XLA
gathers and elementwise ops. Its plain twin, taken for CPU tensors, is
``hash_grid_indices`` followed by ``hash_encode_lookup``.

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

``hash_encode_lookup`` is the encoder's autograd op on ready indices and
weights, as the JAX package's ``custom_vjp``: the forward is plain PyTorch
indexing (the JAX forward is XLA gathers outside any kernel) and reads the
table **rounded to bf16** when ``packed_gather`` is set (the JAX package
gathers bf16-packed pairs); the backward gives the table's gradient alone,
through per-level ``index_add_`` or, with ``pallas_scatter=True``, through
one launch of ``hash_grad_scatter_levels``. ``hash_encode`` has the same
backward, on the indices and weights its kernel writes when the table
takes a gradient. Sample positions get no gradient: sampling is
stop-gradient everywhere.

Layouts for this card: the table is ``(L, T, F)``, a level's features of
one entry adjacent, so one row gather reads every feature of a corner and
K7 adds feature pairs into the contiguous ``(L * T, 2)`` gradient. The
output stays feature-major ``(N, F * L)`` as in the JAX package (columns
``[:L]`` are feature 0 of every level), which the heads' weights depend on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build

_PRIMES = (1, 2654435761, 805459861)


def hash_grid_indices(
    x: torch.Tensor, res: torch.Tensor, dense: torch.Tensor, n_entries: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner indices and trilinear weights of every level.

    Args:
        x: (N, 3) f32 points in [0, 1]^3.
        res: (L,) int64 level resolutions, on ``x``'s device.
        dense: (L,) bool, the level is indexed densely.
        n_entries: T, entries per level (a power of two).

    Returns:
        ``(flat_idx, corner_w)``: (N, L * 8) int32 indices into the
        (L * T) table rows (level l's corners at columns ``l * 8 .. l * 8
        + 8``, in x-major corner order; level offset ``l * T`` added), and
        the (N, L * 8) f32 weights.

    The hash is uint32 arithmetic in the JAX package; here the products
    are taken in int64 and masked, which leaves the same low bits. The
    products are taken on the two candidate coordinates per axis before
    they are spread over the eight corners.
    """
    N, L, T = x.shape[0], res.shape[0], int(n_entries)
    dev = x.device
    res_f = res.to(x.dtype)
    xl = x[:, None, :] * res_f[None, :, None]  # (N, L, 3)
    c0 = torch.floor(xl)
    frac = xl - c0
    # the two candidates per axis: (N, L, 3, 2); at x == 1 the upper
    # corner clips to res while its weight stays
    o = torch.arange(2, device=dev)
    c = torch.minimum(
        torch.clamp(c0.to(torch.int64)[..., None] + o, min=0),
        res[None, :, None, None],
    )
    w = torch.stack([1.0 - frac, frac], dim=-1)

    stride = res + 1
    hashed = [c[:, :, a] * _PRIMES[a] for a in range(3)]
    strided = [
        c[:, :, 0] * (stride * stride)[None, :, None],
        c[:, :, 1] * stride[None, :, None],
        c[:, :, 2],
    ]
    # corner j of 8 takes candidate (j >> 2, j >> 1, j) & 1 of (x, y, z)
    j = torch.arange(8, device=dev)
    pick = [(j >> 2) & 1, (j >> 1) & 1, j & 1]

    def corners(per_axis):
        return [t[..., p] for t, p in zip(per_axis, pick)]  # 3 x (N, L, 8)

    hx, hy, hz = corners(hashed)
    dx, dy, dz = corners(strided)
    idx = torch.where(
        dense[None, :, None], dx + dy + dz, (hx ^ hy ^ hz) & (T - 1)
    )
    idx = idx + (torch.arange(L, device=dev) * T)[None, :, None]
    wx, wy, wz = corners([w[:, :, a] for a in range(3)])
    corner_w = (wx * wy * wz).to(torch.float32)
    return (
        idx.to(torch.int32).reshape(N, L * 8),
        corner_w.reshape(N, L * 8),
    )


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


def _table_gradient(ctx, g) -> torch.Tensor:
    """The (L, T, F) table gradient from the indices and weights the
    forward saved: K7 in one launch, or per-level ``index_add_``."""
    flat_idx, corner_w = ctx.saved_tensors
    L, T, F = ctx.table_shape
    g = g.to(torch.float32).contiguous()  # (N, F * L), feature-major
    d_table = torch.zeros((L, T, F), dtype=torch.float32, device=g.device)
    if ctx.pallas_scatter:
        hash_grad_scatter_levels(flat_idx, corner_w, g, d_table)
    else:
        # the encoder's own indices lie inside their levels: no mask
        _index_add_levels(
            flat_idx - _level_offsets(L, T, flat_idx.device), corner_w, g,
            d_table)
    return d_table


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
        return _table_gradient(ctx, g), None, None, None, None


def hash_encode_lookup(
    table: torch.Tensor,
    flat_idx: torch.Tensor,
    corner_w: torch.Tensor,
    n_entries_per_level: int,
    pallas_scatter: bool = False,
    packed_gather: bool = True,
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
            packed pairs); False reads f32. The JAX package's
            ``gather_mode="per_level"`` reads the same bf16 values in the
            same layout, so it comes here as True (``HashEncoder``).

    Returns:
        (N, F * L) f32 blended features, feature-major.
    """
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


# the numbers of features per entry that hash_encode's kernel reads as one
# row (csrc/hash_encode.cu); HashEncoder sends any other F down the twin
HASH_ENCODE_FEATURES = (1, 2, 4, 8)


def _check_encode_args(x, table, res, dense, n_entries) -> None:
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(
            f"hash_encode: x must be (N, 3) float32, got {tuple(x.shape)} "
            f"{x.dtype}")
    if table.dim() != 3:
        raise ValueError(f"hash_encode: table must be (L, T, F), got "
                         f"{tuple(table.shape)}")
    L, T, _ = table.shape
    if T != n_entries or T & (T - 1):
        raise ValueError(f"hash_encode: T must be n_entries={n_entries} and "
                         f"a power of two, got table {tuple(table.shape)}")
    if tuple(res.shape) != (L,) or tuple(dense.shape) != (L,):
        raise ValueError(
            f"hash_encode: table {tuple(table.shape)} needs res and dense of "
            f"shape ({L},), got {tuple(res.shape)} and {tuple(dense.shape)}")
    if L * T >= 2 ** 31:
        raise ValueError(f"hash_encode: L * T = {L * T} does not fit 31 bits")


def hash_encode_plain(
    x: torch.Tensor,
    table: torch.Tensor,
    res: torch.Tensor,
    dense: torch.Tensor,
    n_entries: int,
    pallas_scatter: bool = False,
    packed_gather: bool = True,
) -> torch.Tensor:
    """``hash_encode``'s twin: :func:`hash_grid_indices`, then
    :func:`hash_encode_lookup` on what it gives."""
    with torch.no_grad():
        flat_idx, corner_w = hash_grid_indices(x, res, dense, n_entries)
    return hash_encode_lookup(table, flat_idx, corner_w, n_entries,
                              pallas_scatter, packed_gather)


def _encode_launch(x, table, res, dense, packed_gather, with_index):
    """One launch of the fused forward: ``(out, flat_idx, corner_w)``, the
    last two None unless ``with_index``."""
    name = "hash_encode"
    N, (L, T, F), dev = x.shape[0], table.shape, x.device
    out = torch.empty((N, F * L), dtype=torch.float32, device=dev)
    flat_idx = corner_w = None
    if with_index:
        flat_idx = torch.empty((N, L * 8), dtype=torch.int32, device=dev)
        corner_w = torch.empty((N, L * 8), dtype=torch.float32, device=dev)
    ptrs = (
        _build.cuda_ptr(name, "x", x, torch.float32, (N, 3), dev),
        _build.cuda_ptr(name, "table", table, torch.float32, (L, T, F), dev),
        _build.cuda_ptr(name, "res", res, torch.int64, (L,), dev),
        _build.cuda_ptr(name, "dense", dense, torch.bool, (L,), dev),
    )
    if ptrs[1] % min(4 * F, 16):
        raise ValueError(f"{name}: table rows must be aligned to their size")
    _build.launch(
        name, "nerfacc_hash_encode", dev, *ptrs, out.data_ptr(),
        None if flat_idx is None else flat_idx.data_ptr(),
        None if corner_w is None else corner_w.data_ptr(),
        N, L, T, F, int(packed_gather))
    hash_encode.launches += 1
    return out, flat_idx, corner_w


class _HashEncode(torch.autograd.Function):
    """The fused forward, saving the indices and weights its kernel
    writes; the backward is the table gradient."""

    @staticmethod
    def forward(ctx, table, x, res, dense, pallas_scatter, packed_gather):
        out, flat_idx, corner_w = _encode_launch(x, table, res, dense,
                                                 packed_gather, True)
        ctx.save_for_backward(flat_idx, corner_w)
        ctx.table_shape = tuple(table.shape)
        ctx.pallas_scatter = pallas_scatter
        return out

    @staticmethod
    def backward(ctx, g):
        return _table_gradient(ctx, g), None, None, None, None, None


def hash_encode(
    x: torch.Tensor,
    table: torch.Tensor,
    res: torch.Tensor,
    dense: torch.Tensor,
    n_entries: int,
    pallas_scatter: bool = False,
    packed_gather: bool = True,
) -> torch.Tensor:
    """The multi-level hash encoding of ``x`` in one launch, with a backward
    that produces only the table's gradient (the plain twin for CPU
    tensors: :func:`hash_encode_plain`).

    Args:
        x: (N, 3) f32 points, contiguous; outside [0, 1]^3 the corners
            clip to the grid as in :func:`hash_grid_indices`.
        table: (L, T, F) f32 tables, contiguous; F in
            ``HASH_ENCODE_FEATURES`` on the card.
        res: (L,) int64 level resolutions, on ``x``'s device.
        dense: (L,) bool, the level is indexed densely.
        n_entries: T, a power of two, with L * T < 2^31.
        pallas_scatter: the table gradient through K7, as in
            :func:`hash_encode_lookup`; needs F = 2.
        packed_gather: read the table rounded to bf16, as in
            :func:`hash_encode_lookup`.

    Returns:
        (N, F * L) f32 features, feature-major: the values of
        :func:`hash_encode_lookup` on :func:`hash_grid_indices`, blended
        over the eight corners in corner order (``acc + w * f`` from 0), so
        equal to the twin up to the order of its corner sum.

    The kernel writes the (N, L * 8) indices and weights that the backward
    reads only when the table takes a gradient (grad mode on and
    ``table.requires_grad``); otherwise the output carries no graph and
    nothing is saved. Shapes are checked on the host; no value is read
    back.
    """
    _check_encode_args(x, table, res, dense, n_entries)
    F = table.shape[2]
    if pallas_scatter and F != 2:
        raise ValueError(
            "pallas_scatter adds feature pairs: it needs n_features == 2, "
            f"got {F}"
        )
    if x.device.type == "cpu":
        return hash_encode_plain(x, table, res, dense, n_entries,
                                 pallas_scatter, packed_gather)
    if F not in HASH_ENCODE_FEATURES:
        raise ValueError(f"hash_encode: the kernel reads rows of "
                         f"{HASH_ENCODE_FEATURES} features, got F={F}")
    if torch.is_grad_enabled() and table.requires_grad:
        return _HashEncode.apply(table, x, res, dense, bool(pallas_scatter),
                                 bool(packed_gather))
    return _encode_launch(x, table, res, dense, packed_gather, False)[0]


hash_encode.launches = 0
