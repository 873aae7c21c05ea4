"""Field helpers shared by the NGP-class fields (PyTorch port of the
field-independent part of :mod:`nerfacc_tpu.models.ngp`)."""

from __future__ import annotations

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """Density activation ``exp(min(x, 30))``, forward only.

    The forward clamp keeps an overflowed density from poisoning masked
    slot math (inf * 0 = NaN). The JAX package's clamped backward
    (``exp(min(x, 15))``) waits for the training port.
    """
    return torch.exp(torch.clamp(x, max=30.0))


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
