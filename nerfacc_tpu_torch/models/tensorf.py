"""Tensor-factorized (TensoCP) radiance field (PyTorch port of
:mod:`nerfacc_tpu.models.tensorf`).

Per level, ``feature_r(x, y, z) = u_r(x) * v_r(y) * w_r(z)`` with
``u_r(x) = hat(x) @ U[:, r]`` over a 1D grid of G nodes (a linear
interpolation: two nonzeros per basis row). Levels are concatenated and
fed to small bf16 heads: trunc_exp density with a geometric feature,
SH-degree-4 view encoding, sigmoid color. Density outside the unit cube
is zeroed by the selector.

The numerics are the JAX package's. The default path (``use_kernel=False``)
multiplies a bf16 basis by a bf16 table into bf16 features; the kernel path
(``use_kernel=True``) produces f32 features, as the Pallas kernel does;
``quant_int8=True`` (before either) takes each axis's product in int8
steps (:func:`hat_matmul_int8`) into bf16 features. The
heads round inputs and weights to bf16, accumulate in f32 and round each
layer's output to bf16, with f32 parameters and an f32 result; their
gradients round the same way. The kernel path's table gradients come
from the CP encoder's backward kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops.cp_encoder import cp_level_features_res
from .ngp import (
    contract_to_unisphere,
    lecun_normal_linear,
    spherical_harmonics_deg4,
    trunc_exp,
)


def hat_basis(x: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B,) coordinates in [0, 1] -> (B, G) linear-interpolation basis
    (align-corners: node i at ``i / (G - 1)``)."""
    u = x * (grid_size - 1)
    nodes = torch.arange(grid_size, dtype=x.dtype, device=x.device)
    return torch.clamp(1.0 - torch.abs(u[:, None] - nodes), min=0.0)


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> bf16 with f32 accumulation and one final rounding.
    ``b`` is (in, out).

    Autograd differentiates it as XLA transposes a bf16 dot: the incoming
    gradient is bf16-valued, each of ``da`` and ``db`` is an f32 product
    rounded once to bf16 (the ``.float()`` casts' backward), and ``db``
    reaches the f32 parameter as that bf16 value."""
    return (a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()).to(
        torch.bfloat16
    )


class _HatMatmulInt8(torch.autograd.Function):
    """``hat(u) @ table`` with the JAX package's int8 forward numerics, as
    two taps per sample; its backward is the exact bf16 table gradient."""

    @staticmethod
    def forward(ctx, u, table):
        G, dev = table.shape[0], table.device
        c127 = torch.tensor(127.0, device=dev)  # a tensor divisor: see below
        # the int8 basis: v = rint(127 u); 127 hat(v / 127) at node j is
        # max(0, 127 - |v - 127 j|), nonzero at j0 = floor(v / 127) (weight
        # 127 - r) and j0 + 1 (weight r), r = v - 127 j0 in [0, 127)
        v = torch.round(u * 127.0).to(torch.int64)  # half to even, as rint
        j0 = torch.div(v, 127, rounding_mode="floor")
        r = v - 127 * j0
        # per column: s = max|table| / 127, the table in integer steps of s.
        # A CUDA division by a Python float multiplies by its reciprocal, an
        # ulp away from the CPU's and JAX's quotient, which rint can turn
        # into a whole step: divide by a tensor
        s = table.detach().abs().amax(dim=0, keepdim=True) / c127
        tq = torch.round(table.detach() / torch.clamp(s, min=1e-20))
        # the int32 accumulation, exactly: |acc| <= 127 * 127 in f32
        acc = torch.zeros((u.shape[0], table.shape[1]), device=dev)
        for j, w in ((j0, 127 - r), (j0 + 1, r)):
            w = torch.where((j >= 0) & (j < G), w, 0).to(torch.float32)
            acc = acc + w[:, None] * tq[j.clamp(0, G - 1)]
        ctx.save_for_backward(u)
        ctx.grid_size = G
        return acc * (s / c127)

    @staticmethod
    def backward(ctx, g):
        # d_table = bf16(hat(u))^T @ bf16(g), f32 sums: each sample adds
        # its two exact bf16 x bf16 products; u is positional (zero)
        (u,) = ctx.saved_tensors
        G = ctx.grid_size
        gb = g.to(torch.bfloat16).to(torch.float32)
        d_table = torch.zeros((G, g.shape[1]), dtype=torch.float32,
                              device=g.device)
        j0 = torch.floor(u)
        for j in (j0, j0 + 1):
            # the dense basis' entry at node j, as JAX computes it
            w = torch.clamp(1.0 - torch.abs(u - j), min=0.0)
            w = w.to(torch.bfloat16).to(torch.float32)
            inside = (j >= 0) & (j < G)
            w = torch.where(inside, w, torch.zeros_like(w))
            d_table.index_add_(0, j.clamp(0, G - 1).to(torch.int64),
                               w[:, None] * gb)
        return torch.zeros_like(u), d_table


def hat_matmul_int8(u: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``hat(u) @ table`` for (B,) ``u`` in node units ([0, G - 1]) and a
    (G, R) ``table``, with the JAX package's int8 forward
    (``_hat_matmul_int8``): the basis rounded to 1/127 of a node, each
    table column quantised to 127 steps of its largest magnitude, the
    integer product exact, then scaled back; f32 (B, R). Its backward is
    the exact bf16 table gradient with f32 sums and a zero gradient for
    ``u``. Plain PyTorch on both devices: the JAX package's int8 product
    is XLA's, not a kernel of its own."""
    return _HatMatmulInt8.apply(u, table)


class CPLevel(nn.Module):
    """One CP level: three (G, R) axis tables ``axis0..2``.

    ``use_kernel=True`` computes the features with the CUDA kernels of
    :func:`nerfacc_tpu_torch.ops.cp_level_features_res` (the JAX package's
    Pallas switch; here it selects the CUDA kernels, and the plain twins
    on CPU tensors): K2 saves bf16 residuals for K4's table gradients when
    the tables take a gradient, and K1 runs alone when they do not.
    ``quant_int8=True`` takes precedence: each axis through
    :func:`hat_matmul_int8`, rounded to bf16, the product bf16 as on the
    default path.
    """

    def __init__(
        self,
        grid_size: int,
        rank: int,
        init_scale: float = 0.2,
        use_kernel: bool = False,
        quant_int8: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.grid_size, self.rank, self.use_kernel = grid_size, rank, use_kernel
        self.quant_int8 = quant_int8
        for axis in range(3):
            table = torch.empty(grid_size, rank)
            nn.init.normal_(table, std=init_scale, generator=generator)
            setattr(self, f"axis{axis}", nn.Parameter(table))

    def tables(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.axis0, self.axis1, self.axis2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with tracing.span("encoder"):
            return self._features(x)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, 3) in [0, 1]^3 -> (B, rank)
        if self.quant_int8:
            feats = None
            for axis, table in enumerate(self.tables()):
                u = hat_matmul_int8(x[:, axis] * (self.grid_size - 1), table)
                u = u.to(torch.bfloat16)
                feats = u if feats is None else feats * u
            return feats
        if self.use_kernel:
            return cp_level_features_res(x, *self.tables())
        feats = None
        for axis, table in enumerate(self.tables()):
            u = _bf16_matmul(hat_basis(x[:, axis], self.grid_size), table)
            feats = u if feats is None else feats * u
        return feats


class _HeadMLP(nn.Module):
    """Small bf16 MLP head (64 wide, relu, no biases)."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        n_hidden: int = 1,
        width: int = 64,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_dim] + [width] * n_hidden + [out_dim]
        self.layers = nn.ModuleList(
            lecun_normal_linear(d_in, d_out, generator)
            for d_in, d_out in zip(dims[:-1], dims[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.bfloat16)
        for i, layer in enumerate(self.layers):
            x = _bf16_matmul(x, layer.weight.t())
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x.to(torch.float32)


class TensoCPRadianceField(nn.Module):
    """NGP-class radiance field on CP-factorized feature volumes.

    ``query_density(x)`` -> (N, 1) density; ``forward(x, d)`` ->
    (rgb (N, 3), density (N, 1)). Parameters are drawn from ``generator``
    on the CPU and then moved to ``device`` (None: the CUDA device), so a
    seed gives the same weights on both.
    """

    def __init__(
        self,
        aabb: Sequence[float],
        levels: Sequence[Tuple[int, int]] = ((128, 64), (512, 128)),
        use_viewdirs: bool = True,
        unbounded: bool = False,
        geo_feat_dim: int = 15,
        use_kernel: bool = False,
        quant_int8: bool = False,
        density_bias: float = -1.0,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.use_viewdirs, self.unbounded = use_viewdirs, unbounded
        self.density_bias = density_bias
        self.register_buffer(
            "aabb", torch.tensor(aabb, dtype=torch.float32), persistent=False
        )
        self.cp_levels = nn.ModuleList(
            CPLevel(g, r, use_kernel=use_kernel, quant_int8=quant_int8,
                    generator=generator)
            for g, r in levels
        )
        feat_dim = sum(r for _, r in levels)
        self.mlp_base = _HeadMLP(feat_dim, 1 + geo_feat_dim, n_hidden=1,
                                 generator=generator)
        head_in = geo_feat_dim + (16 if use_viewdirs else 0)
        self.mlp_head = _HeadMLP(head_in, 3, n_hidden=2, generator=generator)
        self.to(torch.device("cuda") if device is None else device)

    def _contract(self, x):
        if self.unbounded:
            return contract_to_unisphere(x, self.aabb)
        return (x - self.aabb[:3]) / (self.aabb[3:] - self.aabb[:3])

    def _encode(self, xu):
        return torch.cat([lvl(xu) for lvl in self.cp_levels], dim=-1)

    def query_density(self, x: torch.Tensor, return_feat: bool = False):
        xu = self._contract(x)
        selector = torch.all((xu > 0.0) & (xu < 1.0), dim=-1, keepdim=True)
        h = self.mlp_base(self._encode(torch.clamp(xu, 0.0, 1.0)))
        density_before, feat = h[..., :1], h[..., 1:]
        density = trunc_exp(density_before + self.density_bias) * selector
        if return_feat:
            return density, feat
        return density

    def query_opacity(self, x: torch.Tensor, step_size: float):
        """``query_density(x) * step_size``: what ``update_grid``'s
        ``occ_eval_fn`` returns per cell, (N, 1)."""
        return self.query_density(x) * step_size

    def forward(self, positions, directions=None):
        density, feat = self.query_density(positions, return_feat=True)
        if self.use_viewdirs and directions is not None:
            h = torch.cat([spherical_harmonics_deg4(directions), feat], dim=-1)
        else:
            h = feat
        return torch.sigmoid(self.mlp_head(h)), density
