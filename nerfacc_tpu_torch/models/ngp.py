"""Instant-NGP radiance field and the helpers shared by the NGP-class
fields (PyTorch port of :mod:`nerfacc_tpu.models.ngp`).

``NGPRadianceField`` is the hash-grid encoder
(:mod:`.hash_encoding`) with two small f32 MLP heads: ``trunc_exp``
density with a geometric feature, SH-degree-4 view encoding, sigmoid
color. Density outside the (contracted) unit cube is zeroed by the
selector.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .hash_encoding import HashEncoder


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=30.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """Density activation ``exp(min(x, 30))`` with the clamped gradient
    ``g * exp(min(x, 15))`` (torch-ngp's ``trunc_exp``).

    The forward clamp keeps an overflowed density from poisoning masked
    slot math (inf * 0 = NaN); the backward clamp keeps one bright sample
    from blowing up a step.
    """
    return _TruncExp.apply(x)


def contract_to_unisphere(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """MipNeRF-360 contraction into [0, 1]^3."""
    aabb_min, aabb_max = aabb[:3], aabb[3:]
    x = (x - aabb_min) / (aabb_max - aabb_min)
    x = x * 2 - 1
    mag = torch.linalg.norm(x, dim=-1, keepdim=True)
    safe = torch.clamp(mag, min=1e-10)
    x = torch.where(mag > 1, (2 - 1 / safe) * (x / safe), x)
    return x / 4 + 0.5


def spherical_harmonics_deg4(d: torch.Tensor) -> torch.Tensor:
    """Real SH basis, degrees 0-3 (16 coefficients) of unit vectors, in
    tcnn's ``SphericalHarmonics`` degree-4 order."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack(
        [
            0.28209479177387814 * torch.ones_like(x),
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ],
        dim=-1,
    )


def lecun_normal_linear(
    d_in: int, d_out: int, generator: Optional[torch.Generator] = None
) -> nn.Linear:
    """A bias-free ``nn.Linear`` with flax ``Dense``'s default init:
    lecun normal, a normal of variance ``1 / d_in`` truncated at two
    standard deviations."""
    layer = nn.Linear(d_in, d_out, bias=False)
    std = 1.0 / math.sqrt(d_in) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return layer


class _SmallMLP(nn.Module):
    """Small f32 MLP head: ``n_hidden`` x 64, relu, no biases."""

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
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class NGPRadianceField(nn.Module):
    """Instant-NGP field.

    ``query_density(x)`` -> (N, 1) density; ``forward(x, d)`` ->
    (rgb (N, 3), density (N, 1)). Parameters are drawn from ``generator``
    on the CPU and then moved to ``device`` (None: the CUDA device), so a
    seed gives the same weights on both. ``pallas_grad=True`` takes the
    hash table's gradient through the CUDA scatter kernel.
    """

    def __init__(
        self,
        aabb: Sequence[float],
        use_viewdirs: bool = True,
        unbounded: bool = False,
        geo_feat_dim: int = 15,
        n_levels: int = 16,
        n_features: int = 2,
        log2_hashmap_size: int = 19,
        pallas_grad: bool = False,
        gather_mode: str = "packed",
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        device = torch.device("cuda") if device is None else device
        self.use_viewdirs, self.unbounded = use_viewdirs, unbounded
        self.register_buffer(
            "aabb", torch.tensor(aabb, dtype=torch.float32), persistent=False
        )
        self.encoder = HashEncoder(
            n_levels=n_levels, n_features=n_features,
            log2_hashmap_size=log2_hashmap_size, pallas_grad=pallas_grad,
            gather_mode=gather_mode, generator=generator, device="cpu",
        )
        self.mlp_base = _SmallMLP(self.encoder.latent_dim, 1 + geo_feat_dim,
                                  n_hidden=1, generator=generator)
        head_in = geo_feat_dim + (16 if use_viewdirs else 0)
        self.mlp_head = _SmallMLP(head_in, 3, n_hidden=2,
                                  generator=generator)
        self.to(device)

    def _contract(self, x):
        if self.unbounded:
            return contract_to_unisphere(x, self.aabb)
        return (x - self.aabb[:3]) / (self.aabb[3:] - self.aabb[:3])

    def query_density(self, x: torch.Tensor, return_feat: bool = False):
        x = self._contract(x)
        selector = torch.all((x > 0.0) & (x < 1.0), dim=-1, keepdim=True)
        h = self.mlp_base(self.encoder(x))
        density_before, feat = h[..., :1], h[..., 1:]
        density = trunc_exp(density_before - 1.0) * selector
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
