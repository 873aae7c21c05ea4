"""CP level features of the TensoCP field: CUDA kernels and plain twins.

Four kernels replace the Pallas kernels of
``nerfacc_tpu/ops/cp_encoder.py`` (sources in ``csrc/cp_encoder.cu``):

- K1 ``_cp_fwd_impl``: the (B, R) level features. Per axis the feature is
  ``hat(xu[:, a] * (G - 1)) @ T_a`` with a bf16 hat basis, a bf16-rounded
  table and f32 accumulation; the level feature is the product of the
  three axis features.
- K2 ``_cp_fwd_res_impl``: K1's output plus each axis feature rounded to
  bf16, saved as residuals for K4.
- K3 ``_cp_bwd``: the table gradients ``hat_a^T @ bf16(g * u_b * u_c)``
  with the f32 axis features recomputed from the tables.
- K4 ``_cp_bwd_res``: the same from K2's residuals, with ``bf16(g)`` and
  ``bf16(u_b * u_c)``.

The TPU kernels build the dense (B, G) basis and multiply it on the MXU to
avoid gathers and scatters. Each basis row has exactly two nonzeros, so
the CUDA kernels read (forward) or add into (backward) the two table rows
each sample touches instead: no basis and no matrix product exist. The
forward sums are the same as the TPU's; the backward's f32 sums over the
batch run in atomic order, so they agree to f32 summation order. K1 and
K2 stage a block's slice of the tables in shared memory, rounded to bf16
once (:func:`cp_features_slice_width` says for which shapes; the others
read the tables from device memory). K4 keeps a block's partial gradient
tables in shared memory and adds them to the gradient once per block
(:func:`cp_grads_slice_width`); K3 adds every term to the gradient in
device memory.

Two autograd ops wrap them, as the JAX package's ``custom_vjp``\\ s do:
``cp_level_features`` (K1 forward, K3 backward) and
``cp_level_features_res`` (K2 forward, K4 backward; K1 alone when no
gradient is asked for). Neither gives a gradient for ``xu``: sampling is
stop-gradient everywhere. Each kernel counts its launches on the function
named for it: ``cp_level_features`` (K1), ``cp_level_features_res`` (K2),
``cp_level_grads`` (K3), ``cp_level_grads_res`` (K4).
"""

from __future__ import annotations

import torch

from .. import _build


def hat_basis_bf16(x: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B,) coordinates in [0, 1] -> (B, G) hat basis rounded to bf16, as
    the TPU kernel builds it (``max(0, 1 - |u - j|)`` with u = x (G-1))."""
    u = x * (grid_size - 1)
    nodes = torch.arange(grid_size, dtype=torch.float32, device=x.device)
    return torch.clamp(1.0 - torch.abs(u[:, None] - nodes), min=0.0).to(
        torch.bfloat16
    )


def _bases_and_features(xu, tables):
    """Per axis: the f32 (B, G) bf16-valued basis and the f32 feature
    ``basis @ bf16(T_a)`` (exact products, f32 sums)."""
    G = tables[0].shape[0]
    bases, feats = [], []
    for axis, table in enumerate(tables):
        basis = hat_basis_bf16(xu[:, axis], G).to(torch.float32)
        bases.append(basis)
        feats.append(basis @ table.to(torch.bfloat16).to(torch.float32))
    return bases, feats


def cp_level_features_plain(xu, t0, t1, t2) -> torch.Tensor:
    """K1's twin. Dense formulation: bf16 basis times bf16 table, f32
    accumulation, f32 output (the product runs in f32 on bf16-rounded
    operands, which is exact per term)."""
    _, (u0, u1, u2) = _bases_and_features(xu, (t0, t1, t2))
    return u0 * u1 * u2


def cp_level_features_res_plain(xu, t0, t1, t2):
    """K2's twin: ``(features, (u0, u1, u2))`` with the residuals
    ``bf16(u_a)`` of the f32 axis features."""
    _, (u0, u1, u2) = _bases_and_features(xu, (t0, t1, t2))
    residuals = tuple(u.to(torch.bfloat16) for u in (u0, u1, u2))
    return u0 * u1 * u2, residuals


def cp_level_grads_plain(xu, t0, t1, t2, g):
    """K3's twin: ``dT_a = basis_a^T @ bf16(g * (u_b * u_c))`` in f32, with
    f32 axis features."""
    bases, us = _bases_and_features(xu, (t0, t1, t2))
    grads = []
    for axis in range(3):
        others = us[(axis + 1) % 3] * us[(axis + 2) % 3]
        d = (g * others).to(torch.bfloat16).to(torch.float32)
        grads.append(bases[axis].t() @ d)
    return tuple(grads)


def cp_level_grads_res_plain(xu, g, u0, u1, u2, grid_size: int):
    """K4's twin: ``dT_a = basis_a^T @ bf16(bf16(g) * bf16(u_b * u_c))`` in
    f32, from bf16 residuals."""
    gb = g.to(torch.bfloat16).to(torch.float32)
    us = [u.to(torch.float32) for u in (u0, u1, u2)]
    grads = []
    for axis in range(3):
        others = (us[(axis + 1) % 3] * us[(axis + 2) % 3]).to(torch.bfloat16)
        d = (gb * others.to(torch.float32)).to(torch.bfloat16)
        basis = hat_basis_bf16(xu[:, axis], grid_size).to(torch.float32)
        grads.append(basis.t() @ d.to(torch.float32))
    return tuple(grads)


def _table_ptrs(name, xu, tables):
    B = xu.shape[0]
    G, R = tables[0].shape
    dev = xu.device
    ptrs = [_build.cuda_ptr(name, "xu", xu, torch.float32, (B, 3), dev)]
    for i, t in enumerate(tables):
        ptrs.append(
            _build.cuda_ptr(name, f"t{i}", t, torch.float32, (G, R), dev)
        )
    return ptrs, B, G, R, dev


# shared memory one thread block may use on Hopper (227 KB)
SHARED_BYTES_PER_BLOCK = 232448
# below this many samples K1 and K2 read the tables from device memory:
# staging them in every block would cost more than the batch
FEATURES_SHARED_MIN_BATCH = 65536


def cp_features_slice_width(grid_size: int, n_features: int, batch: int,
                            budget: int = SHARED_BYTES_PER_BLOCK) -> int:
    """How many of the R features one block of K1 / K2 stages in shared
    memory as bf16: its three tables take ``3 * G * width * 2`` bytes.

    The widest of 128, 64 and 32 that divides R and fits the budget (a
    lane owns four features, a sample takes 32, 16 or 8 lanes of a warp).
    0 where none does (R no multiple of 32, or G above ~1200) and for
    batches below ``FEATURES_SHARED_MIN_BATCH``: the kernel that reads
    the tables from device memory then runs.
    """
    if batch < FEATURES_SHARED_MIN_BATCH:
        return 0
    for width in (128, 64, 32):
        if n_features % width == 0 and 3 * grid_size * width * 2 <= budget:
            return width
    return 0


def _features(xu, t0, t1, t2) -> torch.Tensor:
    """K1 (the plain twin for CPU tensors). Two kernels compute it, chosen
    by shape alone (:func:`cp_features_slice_width`) and counted under the
    same ``launches``."""
    if xu.device.type == "cpu":
        return cp_level_features_plain(xu, t0, t1, t2)
    name = "cp_level_features"
    ptrs, B, G, R, dev = _table_ptrs(name, xu, (t0, t1, t2))
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    _build.launch(name, "nerfacc_cp_level_features", dev,
                  *ptrs, out.data_ptr(), B, G, R,
                  cp_features_slice_width(G, R, B))
    cp_level_features.launches += 1
    return out


def cp_level_features_res_fwd(xu, t0, t1, t2):
    """K2: ``(features, (u0, u1, u2))``, the (B, R) f32 features and the
    three (B, R) bf16 residuals (the plain twin for CPU tensors). Shares
    K1's two kernels and their choice by shape."""
    if xu.device.type == "cpu":
        return cp_level_features_res_plain(xu, t0, t1, t2)
    name = "cp_level_features_res"
    ptrs, B, G, R, dev = _table_ptrs(name, xu, (t0, t1, t2))
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    residuals = tuple(
        torch.empty((B, R), dtype=torch.bfloat16, device=dev)
        for _ in range(3)
    )
    _build.launch(
        name, "nerfacc_cp_level_features_res", dev,
        *ptrs, out.data_ptr(), *(u.data_ptr() for u in residuals), B, G, R,
        cp_features_slice_width(G, R, B),
    )
    cp_level_features_res.launches += 1
    return out, residuals


def _zero_grads(G, R, dev):
    """The three zeroed (G, R) f32 gradients, as views of one (3, G, R)
    allocation (one memset), and their device pointers."""
    grads = torch.zeros((3, G, R), dtype=torch.float32, device=dev)
    base, step = grads.data_ptr(), 4 * G * R
    return grads.unbind(0), (base, base + step, base + 2 * step)


def cp_grads_slice_width(grid_size: int, n_features: int,
                         budget: int = SHARED_BYTES_PER_BLOCK) -> int:
    """How many of the R features one block of K4 accumulates in shared
    memory: its partial tables take ``3 * G * width * 4`` bytes.

    All R features where that fits the budget (any R, one slice). Else the
    largest multiple of 32 below R that fits: a warp spans 32 consecutive
    features of a sample, and the blocks of the last slice take what is
    left of R. 0 where not even 32 features fit (G above ~600): K4 then
    launches its kernel that adds every term to the gradient in device
    memory.
    """
    per_feature = 3 * grid_size * 4
    if per_feature * n_features <= budget:
        return n_features
    width = min(budget // per_feature, n_features - 1) // 32 * 32
    return max(width, 0)


def cp_level_grads(xu, t0, t1, t2, g):
    """K3: the three (G, R) f32 table gradients of ``cp_level_features``
    for the (B, R) f32 cotangent ``g`` (the plain twin for CPU tensors)."""
    if xu.device.type == "cpu":
        return cp_level_grads_plain(xu, t0, t1, t2, g)
    name = "cp_level_grads"
    ptrs, B, G, R, dev = _table_ptrs(name, xu, (t0, t1, t2))
    ptrs.append(_build.cuda_ptr(name, "g", g, torch.float32, (B, R), dev))
    grads, grad_ptrs = _zero_grads(G, R, dev)
    _build.launch(name, "nerfacc_cp_level_grads", dev,
                  *ptrs, *grad_ptrs, B, G, R)
    cp_level_grads.launches += 1
    return grads


def cp_level_grads_res(xu, g, u0, u1, u2, grid_size: int):
    """K4: the three (G, R) f32 table gradients of
    ``cp_level_features_res`` from the f32 cotangent ``g`` and K2's bf16
    residuals (the plain twin for CPU tensors).

    Two kernels compute it, chosen by shape alone and counted under the
    same ``launches``: where :func:`cp_grads_slice_width` gives a width,
    blocks accumulate partial tables of that many features in shared
    memory and add them to the gradient once each; where it gives 0 (the
    tables of even 32 features exceed a block's shared memory), every term
    is added to the gradient in device memory."""
    if xu.device.type == "cpu":
        return cp_level_grads_res_plain(xu, g, u0, u1, u2, grid_size)
    name = "cp_level_grads_res"
    B, R = g.shape
    G, dev = int(grid_size), xu.device
    ptrs = [
        _build.cuda_ptr(name, "xu", xu, torch.float32, (B, 3), dev),
        _build.cuda_ptr(name, "g", g, torch.float32, (B, R), dev),
    ]
    for i, u in enumerate((u0, u1, u2)):
        ptrs.append(
            _build.cuda_ptr(name, f"u{i}", u, torch.bfloat16, (B, R), dev)
        )
    grads, grad_ptrs = _zero_grads(G, R, dev)
    _build.launch(name, "nerfacc_cp_level_grads_res", dev,
                  *ptrs, *grad_ptrs, B, G, R, cp_grads_slice_width(G, R))
    cp_level_grads_res.launches += 1
    return grads


def _table_grads(ctx, grads):
    return (None,) + tuple(
        d if need else None for d, need in zip(grads, ctx.needs_input_grad[1:])
    )


class _CPLevelFeatures(torch.autograd.Function):
    """K1 forward, K3 backward."""

    @staticmethod
    def forward(ctx, xu, t0, t1, t2):
        ctx.save_for_backward(xu, t0, t1, t2)
        return _features(xu, t0, t1, t2)

    @staticmethod
    def backward(ctx, g):
        xu, t0, t1, t2 = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        return _table_grads(ctx, cp_level_grads(xu, t0, t1, t2, g))


class _CPLevelFeaturesRes(torch.autograd.Function):
    """K2 forward (saves the bf16 residuals), K4 backward."""

    @staticmethod
    def forward(ctx, xu, t0, t1, t2):
        feats, residuals = cp_level_features_res_fwd(xu, t0, t1, t2)
        ctx.save_for_backward(xu, *residuals)
        ctx.grid_size = t0.shape[0]
        return feats

    @staticmethod
    def backward(ctx, g):
        xu, u0, u1, u2 = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        return _table_grads(
            ctx, cp_level_grads_res(xu, g, u0, u1, u2, ctx.grid_size)
        )


def _wants_table_grads(tables) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tables)


def cp_level_features(xu, t0, t1, t2) -> torch.Tensor:
    """CP level features ``prod_axes hat(xu[:, a]) @ T_a`` (K1), with the
    table gradients of K3 as its backward.

    Args:
        xu: (B, 3) f32 coordinates in [0, 1]^3 (no gradient flows to it).
        t0, t1, t2: (G, R) f32 per-axis factor tables.

    Returns:
        (B, R) f32 features.
    """
    if _wants_table_grads((t0, t1, t2)):
        return _CPLevelFeatures.apply(xu, t0, t1, t2)
    return _features(xu, t0, t1, t2)


def cp_level_features_res(xu, t0, t1, t2) -> torch.Tensor:
    """Like :func:`cp_level_features`, but the forward (K2) saves the bf16
    axis features and the backward (K4) works from them instead of
    re-reading the tables: the training path. Without a gradient to take
    (``torch.no_grad()`` or no table requiring one) it launches K1 and
    saves nothing."""
    if _wants_table_grads((t0, t1, t2)):
        return _CPLevelFeaturesRes.apply(xu, t0, t1, t2)
    return _features(xu, t0, t1, t2)


cp_level_features.launches = 0
cp_level_features_res.launches = 0
cp_level_grads.launches = 0
cp_level_grads_res.launches = 0
