"""The plain reference of the ``instant_ngp`` configuration: Instant-NGP's
field (Mueller et al. 2022) as nerfacc's example configures it, in plain
PyTorch and f32, and the draw of its weights from a seed.

Per level l of L, resolution N_l = floor(N_min b^l) (in float64); a
point x in [0, 1]^3 scaled by N_l has eight surrounding corners, clipped
to N_l. A level whose (N_l + 1)^3 corners fit the T entries indexes them
densely (x-major, stride N_l + 1); the others hash them,
``(x * 1) ^ (y * 2654435761) ^ (z * 805459861)`` masked to T - 1. The
features of the corners are read rounded to bfloat16 (the values a
bf16-packed table holds; the gradient still reaches the f32 table) and
blended trilinearly; the encoding is feature-major, (N, F * L).

The density MLP (no biases, relu hidden layers) gives 1 + 15 outputs;
the density is ``trunc_exp(h_0 - 1)``, zero outside the unit cube, with
torch-ngp's clamped gradient; the colour MLP reads the degree-4 spherical
harmonics of the direction and the 15 features and ends in a sigmoid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import linear

PRIMES = (1, 2654435761, 805459861)


def layer_shapes(cfg: dict):
    """([in, out], ...) of the density and the colour MLP."""
    d = cfg["linear_layers"]
    return d["density"], d["color"]


def init_weights(cfg: dict, seed: int, device) -> dict:
    """The weights a seed gives, drawn on ``device`` in two calls: the
    tables uniform in +-``table_init``, every MLP weight from one standard
    normal truncated at 2 and scaled per layer to flax's lecun normal
    (std 1 / sqrt(in) / 0.8796)."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, F, T = cfg["levels"], cfg["features"], 1 << cfg["log2_table"]
    table = torch.empty((L, T, F), device=device)
    table.uniform_(-cfg["table_init"], cfg["table_init"], generator=g)
    dens, color = layer_shapes(cfg)
    shapes = [(o, i) for i, o in dens + color]
    flat = torch.empty(sum(o * i for o, i in shapes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    out, at = {"table": table}, 0
    names = ([f"density.{k}" for k in range(len(dens))]
             + [f"color.{k}" for k in range(len(color))])
    for name, (o, i) in zip(names, shapes):
        std = 1.0 / math.sqrt(i) / 0.87962566103423978
        out[name] = flat[at:at + o * i].reshape(o, i) * std
        at += o * i
    return out


def leaf_names(cfg: dict):
    dens, color = layer_shapes(cfg)
    return (["table"] + [f"density.{k}" for k in range(len(dens))]
            + [f"color.{k}" for k in range(len(color))])


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=30.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degrees 0-3 (16 values)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
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
    ], dim=-1)


class Field:
    """The field over the leaves ``params`` (a dict of tensors in
    :func:`leaf_names` order); ``tf32`` computes its matrix products in
    TF32 (the control)."""

    def __init__(self, cfg: dict, params: dict, tf32: bool = False):
        self.cfg, self.p, self.tf32 = cfg, params, tf32
        L = cfg["levels"]
        res = np.floor(cfg["base_resolution"]
                       * cfg["per_level_scale"] ** np.arange(L))
        self.res = [int(r) for r in res]
        self.T = 1 << cfg["log2_table"]
        self.aabb = cfg["aabb"]
        dens, color = layer_shapes(cfg)
        self.n_density, self.n_color = len(dens), len(color)

    def leaves(self):
        return [self.p[k] for k in leaf_names(self.cfg)]

    def _mlp(self, x, prefix, n):
        for k in range(n):
            x = linear(x, self.p[f"{prefix}.{k}"], tf32=self.tf32)
            if k < n - 1:
                x = torch.relu(x)
        return x

    def encode(self, u: torch.Tensor) -> torch.Tensor:
        table = self.p["table"]
        L, T, F = table.shape
        # bf16 values forward, the f32 table's gradient backward
        rounded = table + (table.to(torch.bfloat16).to(torch.float32)
                           - table).detach()
        feats = []
        for lv, r in enumerate(self.res):
            xl = u * float(r)
            c0 = torch.floor(xl)
            frac = xl - c0
            c0 = c0.to(torch.int64)
            dense = (r + 1) ** 3 <= T
            acc = 0.0
            for corner in range(8):
                bits = ((corner >> 2) & 1, (corner >> 1) & 1, corner & 1)
                c = [torch.clamp(c0[:, a] + bits[a], 0, r) for a in range(3)]
                w = 1.0
                for a in range(3):
                    w = w * (frac[:, a] if bits[a] else 1.0 - frac[:, a])
                if dense:
                    idx = (c[0] * (r + 1) + c[1]) * (r + 1) + c[2]
                else:
                    idx = ((c[0] * PRIMES[0]) ^ (c[1] * PRIMES[1])
                           ^ (c[2] * PRIMES[2])) & (T - 1)
                acc = acc + w[:, None] * rounded[lv][idx]
            feats.append(acc)  # (N, F)
        return torch.stack(feats, dim=-1).reshape(u.shape[0], F * L)

    def _unit(self, x):
        a = torch.tensor(self.aabb, dtype=x.dtype, device=x.device)
        return (x - a[:3]) / (a[3:] - a[:3])

    def _base(self, x):
        u = self._unit(x)
        inside = ((u > 0.0) & (u < 1.0)).all(dim=-1, keepdim=True)
        h = self._mlp(self.encode(u), "density", self.n_density)
        return _TruncExp.apply(h[:, :1] - 1.0) * inside, h[:, 1:]

    def density(self, x):
        return self._base(x)[0]

    def __call__(self, x, d):
        sigma, feat = self._base(x)
        h = torch.cat([sh4(d), feat], dim=-1)
        rgb = torch.sigmoid(self._mlp(h, "color", self.n_color))
        return rgb, sigma
