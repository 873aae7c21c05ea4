"""Volume rendering on the dense ``(n_rays, K)`` layout, forward only
(PyTorch port of the dense half of :mod:`nerfacc_tpu.vol_rendering`).

One ray per row, so transmittance is a row cumsum (or cumprod) and
accumulation a row reduction. The closed-form backward passes of the JAX
package belong to training and are not ported yet: these functions are
plain tensor code, and autograd differentiates them as written.
"""

from __future__ import annotations

import torch


def _masked(x: torch.Tensor, masks) -> torch.Tensor:
    return x if masks is None else torch.where(masks, x, torch.zeros_like(x))


def _exclusive_cumprod_rows(x: torch.Tensor) -> torch.Tensor:
    """out[:, i] = prod_{j<i} x[:, j], by shift-then-cumprod (``cumprod(x)
    / x`` returns 0 wherever some x is exactly 0, as for opaque alpha=1)."""
    shifted = torch.cat([torch.ones_like(x[:, :1]), x[:, :-1]], dim=1)
    return torch.cumprod(shifted, dim=1)


def render_weight_from_density_dense(t_starts, t_ends, sigmas, masks=None):
    """Weights ``w_i = T_i (1 - exp(-sigma_i delta_i))``; invalid slots get
    weight 0 and do not influence any other slot."""
    deltas = _masked(t_ends - t_starts, masks)
    sd = _masked(sigmas, masks) * deltas
    acc = torch.cumsum(sd, dim=1) - sd  # exclusive row cumsum
    return torch.exp(-acc) * (1.0 - torch.exp(-sd))


def render_transmittance_from_alpha_dense(alphas, masks=None):
    """Transmittance ``T_i = prod_{j<i} (1 - alpha_j)``."""
    return _exclusive_cumprod_rows(1.0 - _masked(alphas, masks))


def render_visibility_dense(
    alphas, masks=None, early_stop_eps: float = 1e-4, alpha_thre: float = 0.0
):
    """Visibility: ``T >= early_stop_eps`` and ``alpha >= alpha_thre``."""
    alphas = _masked(alphas.detach(), masks)
    vis = render_transmittance_from_alpha_dense(alphas) >= early_stop_eps
    if alpha_thre > 0:
        vis = vis & (alphas >= alpha_thre)
    if masks is not None:
        vis = vis & masks
    return vis


def accumulate_along_rays_dense(weights, values=None, masks=None):
    """``sum_k w_k v_k`` along the slot axis; returns (n_rays, D)."""
    weights = _masked(weights, masks)
    if values is None:
        return torch.sum(weights, dim=1, keepdim=True)
    return torch.einsum("rk,rkd->rd", weights, values)
