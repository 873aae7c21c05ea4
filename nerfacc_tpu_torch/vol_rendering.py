"""Volume rendering on the dense ``(n_rays, K)`` layout (PyTorch port of
the dense half of :mod:`nerfacc_tpu.vol_rendering`).

One ray per row, so transmittance is a row cumsum (or cumprod) and
accumulation a row reduction. The weights from density and from alpha
carry the JAX package's closed-form backwards; the other functions are
plain tensor code that autograd differentiates as written.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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


class _WeightFromAlphaDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alphas):
        trans = _exclusive_cumprod_rows(1.0 - alphas)
        weights = trans * alphas
        ctx.save_for_backward(alphas, trans, weights)
        return weights

    @staticmethod
    def backward(ctx, g):
        # dL/dalpha_i = g_i T_i - (sum_{j>i} g_j w_j) / (1 - alpha_i), the
        # exclusive suffix sum a flipped row cumsum less its own term
        alphas, trans, weights = ctx.saved_tensors
        gw = g * weights
        suffix = torch.flip(torch.cumsum(torch.flip(gw, (1,)), dim=1), (1,))
        return g * trans - (suffix - gw) / torch.clamp(1.0 - alphas, min=1e-10)


def render_weight_from_density_dense(t_starts, t_ends, sigmas, masks=None):
    """Weights ``w_i = T_i (1 - exp(-sigma_i delta_i))``; invalid slots get
    weight 0 and do not influence any other slot. The sigma gradient is
    the closed form ``delta_i (g_i T_i - sum_{j>=i} g_j w_j)``."""
    deltas = _masked(t_ends - t_starts, masks)
    return _WeightFromDensityDense.apply(_masked(sigmas, masks), deltas)


def render_weight_from_alpha_dense(alphas, masks=None):
    """Weights ``w_i = T_i alpha_i``. The alpha gradient is the closed form
    ``g_i T_i - (sum_{j>i} g_j w_j) / (1 - alpha_i)``."""
    return _WeightFromAlphaDense.apply(_masked(alphas, masks))


def render_transmittance_from_density_dense(t_starts, t_ends, sigmas,
                                            masks=None):
    """Transmittance ``T_i = exp(-sum_{j<i} sigma_j delta_j)`` (exclusive
    row cumsum)."""
    sd = _masked(sigmas, masks) * _masked(t_ends - t_starts, masks)
    return torch.exp(-(torch.cumsum(sd, dim=1) - sd))


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


def rendering_dense(
    t_starts,
    t_ends,
    masks,
    rgb_sigma_fn: Optional[Callable] = None,
    rgb_alpha_fn: Optional[Callable] = None,
    render_bkgd=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render rays on the dense (n_rays, K) layout.

    The field callback receives dense ``(t_starts, t_ends)`` of shape
    (n_rays, K), detached, and returns ``rgbs (n_rays, K, 3)`` and
    ``sigmas`` (or alphas) of shape (n_rays, K). Returns (colors (n_rays,
    3), opacities (n_rays, 1), depths (n_rays, 1)).
    """
    if rgb_sigma_fn is None and rgb_alpha_fn is None:
        raise ValueError(
            "At least one of `rgb_sigma_fn` and `rgb_alpha_fn` should be "
            "specified."
        )
    t_starts, t_ends = t_starts.detach(), t_ends.detach()
    if rgb_sigma_fn is not None:
        rgbs, sigmas = rgb_sigma_fn(t_starts, t_ends)
        weights = render_weight_from_density_dense(
            t_starts, t_ends, sigmas, masks=masks
        )
    else:
        rgbs, alphas = rgb_alpha_fn(t_starts, t_ends)
        weights = render_weight_from_alpha_dense(alphas, masks=masks)
    colors = accumulate_along_rays_dense(weights, values=rgbs, masks=masks)
    opacities = accumulate_along_rays_dense(weights, masks=masks)
    t_mid = (t_starts + t_ends) / 2.0
    depths = accumulate_along_rays_dense(
        weights, values=t_mid[..., None], masks=masks
    )
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)
    return colors, opacities, depths
