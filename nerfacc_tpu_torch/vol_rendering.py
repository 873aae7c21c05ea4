"""Volume rendering on the dense ``(n_rays, K)`` layout (PyTorch port of
the dense half of :mod:`nerfacc_tpu.vol_rendering`).

One ray per row, so transmittance is a row cumsum (or cumprod) and
accumulation a row reduction. The weights from density carry the JAX
package's closed-form backward; the other functions are plain tensor
code that autograd differentiates as written.
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


class _WeightFromDensityDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, deltas):
        sd = sigmas * deltas
        acc = torch.cumsum(sd, dim=1) - sd  # exclusive row cumsum
        trans = torch.exp(-acc)
        weights = trans * (1.0 - torch.exp(-sd))
        ctx.save_for_backward(deltas, trans, weights)
        return weights

    @staticmethod
    def backward(ctx, g):
        # dL/dsigma_i = delta_i * (g_i T_i - sum_{j>=i} g_j w_j), the suffix
        # sum a flipped row cumsum; the deltas get a zero gradient
        deltas, trans, weights = ctx.saved_tensors
        gw = g * weights
        suffix = torch.flip(torch.cumsum(torch.flip(gw, (1,)), dim=1), (1,))
        d_deltas = torch.zeros_like(deltas) if ctx.needs_input_grad[1] else None
        return deltas * (g * trans - suffix), d_deltas


def render_weight_from_density_dense(t_starts, t_ends, sigmas, masks=None):
    """Weights ``w_i = T_i (1 - exp(-sigma_i delta_i))``; invalid slots get
    weight 0 and do not influence any other slot. The sigma gradient is
    the closed form ``delta_i (g_i T_i - sum_{j>=i} g_j w_j)``."""
    deltas = _masked(t_ends - t_starts, masks)
    return _WeightFromDensityDense.apply(_masked(sigmas, masks), deltas)


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
