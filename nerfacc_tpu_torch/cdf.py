"""CDF importance resampling on the dense layout (PyTorch port of the
dense half of :mod:`nerfacc_tpu.cdf`).

One ray per row: the weights are padded by ``max(1e-5 - sum w, 0)``
spread over the row's live samples and normalised, the row's inclusive
CDF is a cumsum, and each of the ``n + 1`` bin targets
``u_b = 1 / (2 (n + 1)) + b (1 - 1 / (n + 1)) / n`` finds its interval
as the dense rank ``sum_k (cdf[r, k] < u_b)``, clipped to ``K - 1``.
Rays with no live sample resample to nothing: masks False, t = 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .ray_marching import gather_rows_dense


def resampling_targets(n_samples: int, device=None) -> torch.Tensor:
    """The ``n_samples + 1`` bin-boundary targets ``u_b`` in f32."""
    num_bins = n_samples + 1
    cdf_step = (1.0 - 1.0 / num_bins) / n_samples
    b = torch.arange(num_bins, dtype=torch.float32, device=device)
    return 1.0 / (2 * num_bins) + b * cdf_step


def weight_cdf(weights: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Each row's inclusive CDF (n_rays, K) of its live weights, padded by
    ``max(1e-5 - sum w, 0)`` spread over the live samples; a row with a
    live sample ends at 1."""
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    w = torch.where(masks, torch.clamp(weights, min=0.0), zero)
    counts = masks.sum(dim=1, keepdim=True)
    padding = torch.clamp(1e-5 - w.sum(dim=1, keepdim=True), min=0.0)
    pad_step = torch.where(counts > 0, padding / torch.clamp(counts, min=1),
                           zero)
    w = torch.where(masks, w + pad_step, zero)
    w_norm = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-20)
    return torch.cumsum(w_norm, dim=1)


def ray_resampling_dense(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    masks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resample ``n_samples`` intervals per ray uniformly in the weight CDF:
    (n_rays, K) in, (n_rays, n_samples) out.

    Returns ``(t_starts, t_ends, masks)``; the interval bounds are linear
    in the CDF inside the interval each target falls in.
    """
    R, K = weights.shape
    if masks is None:
        masks = torch.ones((R, K), dtype=torch.bool, device=weights.device)
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    cdf = weight_cdf(weights, masks)
    u = resampling_targets(n_samples, weights.device)
    idx = (cdf[:, :, None] < u[None, None, :]).sum(dim=1)  # (R, n + 1)
    idx = torch.clamp(idx, max=K - 1)
    cdf_next = gather_rows_dense(cdf, idx)
    cdf_prev = torch.where(
        idx > 0, gather_rows_dense(cdf, torch.clamp(idx - 1, min=0)), zero)
    ts_sel = gather_rows_dense(t_starts, idx)
    te_sel = gather_rows_dense(t_ends, idx)
    scaling = (te_sel - ts_sel) / torch.clamp(cdf_next - cdf_prev, min=1e-20)
    bounds = (u[None, :] - cdf_prev) * scaling + ts_sel  # (R, n + 1)

    alive = masks.any(dim=1, keepdim=True)
    out_starts = torch.where(alive, bounds[:, :-1], zero)
    out_ends = torch.where(alive, bounds[:, 1:], zero)
    return out_starts, out_ends, alive.expand(R, n_samples)
