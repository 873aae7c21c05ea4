"""Volume rendering (PyTorch port of :mod:`nerfacc_tpu.vol_rendering`).

Two layouts. The dense ``(n_rays, K)`` one holds one ray per row, so
transmittance is a row cumsum (or cumprod) and accumulation a row
reduction. The flat packed one (the reference's API) holds ``(n_samples,)``
samples with sorted ``ray_indices`` or a ``packed_info``; its
transmittance is a segmented scan (:mod:`nerfacc_tpu_torch.scan`) and its
accumulation a segment sum. Where a flat layout is provably a dense
ray-major buffer (``DENSE_BRIDGE``), the flat entry points take the dense
functions.

The weights and transmittances carry the JAX package's closed-form
backwards (reverse suffix sums, accumulated in f32, ``1 / max(1 - alpha,
1e-10)``); the other functions are plain tensor code that autograd
differentiates as written. Invalid entries flagged by ``masks`` are
treated as vacuum (density or alpha 0), so they affect no ray.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .pack import unpack_info
from .scan import (
    exclusive_segment_cumprod,
    exclusive_segment_cumsum,
    reverse_exclusive_segment_cumsum,
    segment_sum,
)


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


# ---------------------------------------------------------------------------
# The flat packed layout: (n_samples,) samples, sorted ``ray_indices`` or a
# ``packed_info``, and an optional validity mask (the reference's API)
# ---------------------------------------------------------------------------


def _flatten(x):
    """(N, 1) -> (N,); (N,) passes. Returns (tensor, had_last_dim)."""
    if x.dim() == 2 and x.shape[-1] == 1:
        return x[:, 0], True
    return x, False


def _reshape_like(x, had_last_dim):
    return x[:, None] if had_last_dim else x


def _flat_mask(masks):
    return None if masks is None else _flatten(masks)[0]


# Where a flat layout provably is a flat view of a dense ray-major (n_rays,
# K) buffer (iota-like ``ray_indices``, or ``packed_info`` rows [r K, K]),
# the flat entry points take the dense functions: the same math, with row
# cumsums in place of segmented scans and a row sum in place of a segment
# sum, so results differ only in summation order. The check reads its
# answer back to the host, one sync per call on the card. Set to False to
# force the segmented path (equivalence tests, timings).
DENSE_BRIDGE = True


def _detect_dense_layout(ray_indices, packed_info, n_samples, n_rays):
    """(K, n_rays) when the flat layout is a dense ray-major buffer of K
    slots per ray, else None."""
    if not DENSE_BRIDGE or torch.compiler.is_compiling():
        return None
    if packed_info is not None:
        if packed_info.dim() != 2 or packed_info.shape[1] != 2:
            return None
        R = packed_info.shape[0]
        if R == 0 or n_samples % R:
            return None
        K = n_samples // R
        starts = torch.arange(R, device=packed_info.device) * K
        ok = (packed_info[:, 0] == starts) & (packed_info[:, 1] == K)
        return (K, R) if bool(ok.all()) else None
    if (ray_indices is None or not n_rays or n_samples % n_rays
            or ray_indices.numel() != n_samples):
        return None
    K = n_samples // n_rays
    rows = torch.arange(n_rays, device=ray_indices.device)[:, None]
    return (K, n_rays) if bool((ray_indices.reshape(n_rays, K) == rows).all()
                               ) else None


def _as_dense(layout, x):
    """Flat (K R, ...) -> (R, K, ...) for a detected ``(K, R)`` layout."""
    if x is None:
        return None
    K, R = layout
    return x.reshape((R, K) + tuple(x.shape[1:]))


def _resolve_indices(ray_indices, packed_info, n_samples: int,
                     n_rays: Optional[int]):
    """(int32 ray_indices, n_rays) from either description of the layout;
    without ``n_rays``, every sample may be its own ray."""
    if ray_indices is None:
        if packed_info is None:
            raise ValueError(
                "Either ray_indices or packed_info should be provided.")
        ray_indices = unpack_info(packed_info, n_samples)
        n_rays = packed_info.shape[0]
    if n_rays is None:
        n_rays = n_samples
    return ray_indices.to(torch.int32), n_rays


class _TransFromDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, deltas, ray_indices, n_rays):
        acc = exclusive_segment_cumsum(sigmas * deltas, ray_indices, n_rays)
        trans = torch.exp(-acc)
        ctx.n_rays = n_rays
        ctx.save_for_backward(deltas, ray_indices, trans)
        return trans

    @staticmethod
    def backward(ctx, g):
        # dL/dsigma_i = -delta_i sum_{j>i} g_j T_j
        deltas, ray_indices, trans = ctx.saved_tensors
        suffix = reverse_exclusive_segment_cumsum(g * trans, ray_indices,
                                                  ctx.n_rays)
        d_deltas = torch.zeros_like(deltas) if ctx.needs_input_grad[1] else None
        return -deltas * suffix, d_deltas, None, None


class _TransFromAlpha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alphas, ray_indices, n_rays):
        trans = exclusive_segment_cumprod(1.0 - alphas, ray_indices, n_rays)
        ctx.n_rays = n_rays
        ctx.save_for_backward(alphas, ray_indices, trans)
        return trans

    @staticmethod
    def backward(ctx, g):
        # dL/dalpha_i = -(sum_{j>i} g_j T_j) / (1 - alpha_i)
        alphas, ray_indices, trans = ctx.saved_tensors
        suffix = reverse_exclusive_segment_cumsum(g * trans, ray_indices,
                                                  ctx.n_rays)
        return -suffix / torch.clamp(1.0 - alphas, min=1e-10), None, None


class _WeightFromDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, deltas, ray_indices, n_rays):
        sd = sigmas * deltas
        trans = torch.exp(-exclusive_segment_cumsum(sd, ray_indices, n_rays))
        weights = trans * (1.0 - torch.exp(-sd))
        ctx.n_rays = n_rays
        ctx.save_for_backward(deltas, ray_indices, trans, weights)
        return weights

    @staticmethod
    def backward(ctx, g):
        # dL/dsigma_i = delta_i (g_i T_i - sum_{j>=i} g_j w_j)
        deltas, ray_indices, trans, weights = ctx.saved_tensors
        gw = g * weights
        suffix = reverse_exclusive_segment_cumsum(gw, ray_indices,
                                                  ctx.n_rays) + gw
        d_deltas = torch.zeros_like(deltas) if ctx.needs_input_grad[1] else None
        return deltas * (g * trans - suffix), d_deltas, None, None


class _WeightFromAlpha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alphas, ray_indices, n_rays):
        trans = exclusive_segment_cumprod(1.0 - alphas, ray_indices, n_rays)
        weights = trans * alphas
        ctx.n_rays = n_rays
        ctx.save_for_backward(alphas, ray_indices, trans, weights)
        return weights

    @staticmethod
    def backward(ctx, g):
        # dL/dalpha_i = g_i T_i - (sum_{j>i} g_j w_j) / (1 - alpha_i)
        alphas, ray_indices, trans, weights = ctx.saved_tensors
        suffix = reverse_exclusive_segment_cumsum(g * weights, ray_indices,
                                                  ctx.n_rays)
        return (g * trans - suffix / torch.clamp(1.0 - alphas, min=1e-10),
                None, None)


def _accumulate_flat(weights, ray_indices, values, n_rays, masks):
    src = weights[:, None] if values is None else weights[:, None] * values
    return segment_sum(_masked(src, None if masks is None else masks[:, None]),
                       ray_indices, n_rays)


def _from_density(dense_fn, flat_fn, t_starts, t_ends, sigmas, packed_info,
                  ray_indices, n_rays, masks):
    """A per-sample op of densities on either layout: ``dense_fn`` on a
    detected dense view, else ``flat_fn`` on the segments; the output
    keeps the shape of ``sigmas``."""
    sig, had = _flatten(sigmas)
    ts, te, m = _flatten(t_starts)[0], _flatten(t_ends)[0], _flat_mask(masks)
    dl = _detect_dense_layout(ray_indices, packed_info, sig.shape[0], n_rays)
    if dl is not None:
        out = dense_fn(*(_as_dense(dl, x) for x in (ts, te, sig)),
                       masks=_as_dense(dl, m)).reshape(-1)
    else:
        ri, n_rays = _resolve_indices(ray_indices, packed_info, sig.shape[0],
                                      n_rays)
        out = flat_fn.apply(_masked(sig, m), _masked(te - ts, m), ri, n_rays)
    return _reshape_like(out, had)


def _from_alpha(dense_fn, flat_fn, alphas, packed_info, ray_indices, n_rays,
                masks):
    """A per-sample op of opacities on either layout (see
    :func:`_from_density`)."""
    a, had = _flatten(alphas)
    m = _flat_mask(masks)
    dl = _detect_dense_layout(ray_indices, packed_info, a.shape[0], n_rays)
    if dl is not None:
        out = dense_fn(_as_dense(dl, a), masks=_as_dense(dl, m)).reshape(-1)
    else:
        ri, n_rays = _resolve_indices(ray_indices, packed_info, a.shape[0],
                                      n_rays)
        out = flat_fn.apply(_masked(a, m), ri, n_rays)
    return _reshape_like(out, had)


def render_transmittance_from_density(t_starts, t_ends, sigmas, *,
                                      packed_info=None, ray_indices=None,
                                      n_rays: Optional[int] = None,
                                      masks=None):
    """Transmittance ``T_i = exp(-sum_{j<i} sigma_j delta_j)`` per sample
    (reference ``vol_rendering.py:201-266``); ``masks`` marks the valid
    packed entries, the others are vacuum."""
    return _from_density(render_transmittance_from_density_dense,
                         _TransFromDensity, t_starts, t_ends, sigmas,
                         packed_info, ray_indices, n_rays, masks)


def render_transmittance_from_alpha(alphas, *, packed_info=None,
                                    ray_indices=None,
                                    n_rays: Optional[int] = None, masks=None):
    """Transmittance ``T_i = prod_{j<i} (1 - alpha_j)`` per sample
    (reference ``vol_rendering.py:269-323``)."""
    return _from_alpha(render_transmittance_from_alpha_dense, _TransFromAlpha,
                       alphas, packed_info, ray_indices, n_rays, masks)


def render_weight_from_density(t_starts, t_ends, sigmas, *, packed_info=None,
                               ray_indices=None, n_rays: Optional[int] = None,
                               masks=None):
    """Weights ``w_i = T_i (1 - exp(-sigma_i delta_i))`` (reference
    ``vol_rendering.py:326-393``)."""
    return _from_density(render_weight_from_density_dense, _WeightFromDensity,
                         t_starts, t_ends, sigmas, packed_info, ray_indices,
                         n_rays, masks)


def render_weight_from_alpha(alphas, *, packed_info=None, ray_indices=None,
                             n_rays: Optional[int] = None, masks=None):
    """Weights ``w_i = T_i alpha_i`` (reference
    ``vol_rendering.py:396-449``)."""
    return _from_alpha(render_weight_from_alpha_dense, _WeightFromAlpha,
                       alphas, packed_info, ray_indices, n_rays, masks)


def render_visibility(alphas, *, packed_info=None, ray_indices=None,
                      n_rays: Optional[int] = None,
                      early_stop_eps: float = 1e-4, alpha_thre: float = 0.0,
                      masks=None):
    """Visibility per sample, ``T >= early_stop_eps`` and ``alpha >=
    alpha_thre`` (reference ``vol_rendering.py:452-520``); a hard mask,
    not differentiable."""
    a = _flatten(alphas)[0].detach()
    m = _flat_mask(masks)
    dl = _detect_dense_layout(ray_indices, packed_info, a.shape[0], n_rays)
    if dl is not None:
        return render_visibility_dense(
            _as_dense(dl, a), masks=_as_dense(dl, m),
            early_stop_eps=early_stop_eps, alpha_thre=alpha_thre,
        ).reshape(-1)
    ri, n_rays = _resolve_indices(ray_indices, packed_info, a.shape[0],
                                  n_rays)
    a = _masked(a, m)
    vis = exclusive_segment_cumprod(1.0 - a, ri, n_rays) >= early_stop_eps
    if alpha_thre > 0:
        vis = vis & (a >= alpha_thre)
    if m is not None:
        vis = vis & m
    return vis


def accumulate_along_rays(weights, ray_indices, values=None,
                          n_rays: Optional[int] = None, masks=None):
    """``sum_i w_i v_i`` per ray (reference ``vol_rendering.py:132-198``):
    weights (n_samples,) or (n_samples, 1), values (n_samples, D) or None
    (ones); returns (n_rays, D), D = 1 without values. Without ``n_rays``
    every sample may be its own ray."""
    w = _flatten(weights)[0]
    m = _flat_mask(masks)
    dl = _detect_dense_layout(ray_indices, None, w.shape[0], n_rays)
    if dl is not None:
        return accumulate_along_rays_dense(
            _as_dense(dl, w), values=_as_dense(dl, values),
            masks=_as_dense(dl, m))
    n_rays = w.shape[0] if n_rays is None else n_rays
    return _accumulate_flat(w, ray_indices, values, n_rays, m)


def rendering(
    t_starts,
    t_ends,
    ray_indices,
    n_rays: int,
    rgb_sigma_fn: Optional[Callable] = None,
    rgb_alpha_fn: Optional[Callable] = None,
    render_bkgd=None,
    masks=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render rays through a radiance field (reference
    ``vol_rendering.py:15-129``).

    The field is a callback ``rgb_sigma_fn(t_starts, t_ends, ray_indices)
    -> (rgbs (N, 3), sigmas (N, 1))``, or ``rgb_alpha_fn`` returning
    opacities. Differentiable in the callback's outputs; ``t_starts`` and
    ``t_ends`` are detached. One layout check per call (``DENSE_BRIDGE``).
    Returns (colors (n_rays, 3), opacities (n_rays, 1), depths (n_rays,
    1)).
    """
    if rgb_sigma_fn is None and rgb_alpha_fn is None:
        raise ValueError(
            "At least one of `rgb_sigma_fn` and `rgb_alpha_fn` should be "
            "specified."
        )
    t_starts, t_ends = t_starts.detach(), t_ends.detach()
    fn = rgb_sigma_fn if rgb_sigma_fn is not None else rgb_alpha_fn
    rgbs, field_out = fn(t_starts, t_ends, ray_indices)
    if rgbs.shape[-1] != 3:
        raise ValueError(f"rgbs must have 3 channels, got {rgbs.shape}")
    ts, te, m = _flatten(t_starts)[0], _flatten(t_ends)[0], _flat_mask(masks)
    field_out = _flatten(field_out)[0]
    t_mid = ((ts + te) / 2.0)[:, None]
    dl = _detect_dense_layout(ray_indices, None, ts.shape[0], n_rays)
    if dl is not None:
        m2 = _as_dense(dl, m)
        if rgb_sigma_fn is not None:
            weights = render_weight_from_density_dense(
                _as_dense(dl, ts), _as_dense(dl, te),
                _as_dense(dl, field_out), masks=m2)
        else:
            weights = render_weight_from_alpha_dense(
                _as_dense(dl, field_out), masks=m2)
        colors, opacities, depths = (
            accumulate_along_rays_dense(weights, values=_as_dense(dl, v),
                                        masks=m2)
            for v in (rgbs, None, t_mid))
    else:
        ri, n_rays = _resolve_indices(ray_indices, None, ts.shape[0], n_rays)
        if rgb_sigma_fn is not None:
            weights = _WeightFromDensity.apply(
                _masked(field_out, m), _masked(te - ts, m), ri, n_rays)
        else:
            weights = _WeightFromAlpha.apply(_masked(field_out, m), ri,
                                             n_rays)
        colors, opacities, depths = (
            _accumulate_flat(weights, ri, v, n_rays, m)
            for v in (rgbs, None, t_mid))
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)
    return colors, opacities, depths
