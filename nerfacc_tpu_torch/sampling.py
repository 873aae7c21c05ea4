"""Proposal-network sampling on the dense layout (PyTorch port of
:mod:`nerfacc_tpu.sampling`).

MipNeRF-360-style hierarchical sampling: cheap proposal density fields
redistribute a fixed per-ray sample budget toward surfaces by inverse-CDF
resampling (:func:`nerfacc_tpu_torch.cdf.ray_resampling_dense`), with
visibility filtering between rounds. Everything stays on the
(n_rays, K) layout.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from .cdf import ray_resampling_dense
from .grid import OccupancyGrid
from .ray_marching import RaySegments, march_rays
from .vol_rendering import (
    render_visibility_dense,
    render_weight_from_density_dense,
)


def sample_along_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t_min: Union[float, torch.Tensor],
    t_max: Union[float, torch.Tensor],
    step_size: float,
    cone_angle: float = 0.0,
    grid: Optional[OccupancyGrid] = None,
    num_steps: Optional[int] = None,
    slots_per_ray: Optional[int] = None,
    coarse_stride: int = 1,
) -> RaySegments:
    """Sample intervals along rays.

    With float ``t_min`` / ``t_max`` and no grid this is the fixed-count
    uniform lattice (``num_steps = floor((t_max - t_min) / step_size)``
    unless given); with per-ray tensors it marches with optional grid
    skipping and ``num_steps`` must be given (the slot count is static).
    ``coarse_stride`` applies only with a grid.
    """
    n_rays = rays_o.shape[0]
    dev = rays_o.device
    if isinstance(t_min, float) and isinstance(t_max, float) and grid is None:
        if num_steps is None:
            num_steps = int(math.floor((t_max - t_min) / step_size))
    elif num_steps is None:
        raise ValueError("num_steps must be given for tensor t ranges")
    t_min = torch.broadcast_to(
        torch.as_tensor(t_min, dtype=torch.float32, device=dev), (n_rays,))
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n_rays,))
    return march_rays(
        rays_o, rays_d, t_min, t_max, grid,
        render_step_size=step_size,
        cone_angle=cone_angle,
        max_samples_per_ray=num_steps,
        slots_per_ray=slots_per_ray or num_steps,
        coarse_stride=coarse_stride if grid is not None else 1,
    )


def proposal_sampling_with_filter(
    segments: RaySegments,
    sigma_fn: Optional[Callable] = None,
    proposal_sigma_fns: Sequence[Callable] = (),
    proposal_n_samples: Sequence[int] = (),
    proposal_require_grads: bool = False,
    early_stop_eps: float = 1e-4,
    alpha_thre: float = 0.0,
) -> Tuple[RaySegments, list]:
    """Hierarchical proposal sampling.

    Each round evaluates a proposal density on the current (detached)
    intervals, computes the dense weights, refines the masks by the
    visibility filter (``early_stop_eps`` / ``alpha_thre``, on alphas of
    the detached densities) and redistributes ``n`` samples per ray by the
    inverse CDF of the detached weights. A final ``sigma_fn`` round
    filters only. Density callbacks take ``(t_starts, t_ends)`` of shape
    (n_rays, K) and return densities of that shape.

    Returns ``(segments, proposal_samples)``: the final
    :class:`RaySegments` and, when ``proposal_require_grads``, each
    round's ``(t_starts, t_ends, weights, masks)`` with the weights
    carrying their gradient to the proposal field.
    """
    if len(proposal_sigma_fns) != len(proposal_n_samples):
        raise ValueError(
            "proposal_sigma_fns and proposal_n_samples must have the same "
            f"length, got {len(proposal_sigma_fns)} / "
            f"{len(proposal_n_samples)}.")
    t_starts, t_ends, masks = (
        segments.t_starts, segments.t_ends, segments.masks)
    filtered = alpha_thre > 0 or early_stop_eps > 0
    proposal_samples = []
    for proposal_fn, n_samples in zip(proposal_sigma_fns, proposal_n_samples):
        t_starts, t_ends = t_starts.detach(), t_ends.detach()
        sigmas = proposal_fn(t_starts, t_ends)
        if sigmas.shape != t_starts.shape:
            raise ValueError(f"proposal density of shape {tuple(sigmas.shape)}"
                             f" for intervals {tuple(t_starts.shape)}")
        weights = render_weight_from_density_dense(
            t_starts, t_ends, sigmas, masks=masks)
        if filtered:
            alphas = 1.0 - torch.exp(-sigmas.detach() * (t_ends - t_starts))
            masks = masks & render_visibility_dense(
                alphas, masks, early_stop_eps=early_stop_eps,
                alpha_thre=alpha_thre)
        if proposal_require_grads:
            proposal_samples.append((t_starts, t_ends, weights, masks))
        t_starts, t_ends, masks = ray_resampling_dense(
            t_starts, t_ends, weights.detach(), n_samples, masks=masks)

    if filtered and sigma_fn is not None:
        sigmas = sigma_fn(t_starts, t_ends)
        if sigmas.shape != t_starts.shape:
            raise ValueError(f"density of shape {tuple(sigmas.shape)} for "
                             f"intervals {tuple(t_starts.shape)}")
        alphas = 1.0 - torch.exp(-sigmas * (t_ends - t_starts))
        masks = masks & render_visibility_dense(
            alphas, masks, early_stop_eps=early_stop_eps,
            alpha_thre=alpha_thre)

    out = RaySegments(t_starts=t_starts, t_ends=t_ends,
                      deltas=t_ends - t_starts, masks=masks)
    return out, proposal_samples
