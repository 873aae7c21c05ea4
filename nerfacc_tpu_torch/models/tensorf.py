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
(``use_kernel=True``) produces f32 features, as the Pallas kernel does. The
heads round inputs and weights to bf16, accumulate in f32 and round each
layer's output to bf16, with f32 parameters and an f32 result.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cp_encoder import cp_level_features
from .ngp import contract_to_unisphere, spherical_harmonics_deg4, trunc_exp


def hat_basis(x: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B,) coordinates in [0, 1] -> (B, G) linear-interpolation basis
    (align-corners: node i at ``i / (G - 1)``)."""
    u = x * (grid_size - 1)
    nodes = torch.arange(grid_size, dtype=x.dtype, device=x.device)
    return torch.clamp(1.0 - torch.abs(u[:, None] - nodes), min=0.0)


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> bf16 with f32 accumulation and one final rounding.
    ``b`` is (in, out)."""
    return (a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()).to(
        torch.bfloat16
    )


class CPLevel(nn.Module):
    """One CP level: three (G, R) axis tables ``axis0..2``.

    ``use_kernel=True`` computes the features with the CUDA kernel
    :func:`nerfacc_tpu_torch.ops.cp_level_features` (the JAX package's
    Pallas switch; here it selects the CUDA kernel, and the plain twin on
    CPU tensors). It is forward only for now.
    """

    def __init__(
        self,
        grid_size: int,
        rank: int,
        init_scale: float = 0.2,
        use_kernel: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.grid_size, self.rank, self.use_kernel = grid_size, rank, use_kernel
        for axis in range(3):
            table = torch.empty(grid_size, rank)
            nn.init.normal_(table, std=init_scale, generator=generator)
            setattr(self, f"axis{axis}", nn.Parameter(table))

    def tables(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.axis0, self.axis1, self.axis2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, 3) in [0, 1]^3 -> (B, rank)
        if self.use_kernel:
            return cp_level_features(x, *self.tables())
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
        self.layers = nn.ModuleList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            layer = nn.Linear(d_in, d_out, bias=False)
            # lecun normal, like flax's Dense default
            std = 1.0 / math.sqrt(d_in) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            self.layers.append(layer)

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
    on the CPU; move the module with ``.to(device)``.
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
    ):
        super().__init__()
        if quant_int8:
            raise NotImplementedError("quant_int8 is not ported yet")
        self.use_viewdirs, self.unbounded = use_viewdirs, unbounded
        self.density_bias = density_bias
        self.register_buffer(
            "aabb", torch.tensor(aabb, dtype=torch.float32), persistent=False
        )
        self.cp_levels = nn.ModuleList(
            CPLevel(g, r, use_kernel=use_kernel, generator=generator)
            for g, r in levels
        )
        feat_dim = sum(r for _, r in levels)
        self.mlp_base = _HeadMLP(feat_dim, 1 + geo_feat_dim, n_hidden=1,
                                 generator=generator)
        head_in = geo_feat_dim + (16 if use_viewdirs else 0)
        self.mlp_head = _HeadMLP(head_in, 3, n_hidden=2, generator=generator)

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

    def forward(self, positions, directions=None):
        density, feat = self.query_density(positions, return_feat=True)
        if self.use_viewdirs and directions is not None:
            h = torch.cat([spherical_harmonics_deg4(directions), feat], dim=-1)
        else:
            h = feat
        return torch.sigmoid(self.mlp_head(h)), density
