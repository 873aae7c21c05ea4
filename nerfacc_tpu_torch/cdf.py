"""CDF importance resampling (PyTorch port of :mod:`nerfacc_tpu.cdf`).

The weights are padded by ``max(1e-5 - sum w, 0)`` spread over the ray's
live samples and normalised; each of the ``n + 1`` bin targets ``u_b = 1 /
(2 (n + 1)) + b (1 - 1 / (n + 1)) / n`` finds the interval its CDF
crosses, and the bound is linear in the CDF inside it. Rays with no live
sample resample to nothing: masks False, t = 0.

Dense layout (``ray_resampling_dense``): one ray per row, the interval is
the rank ``sum_k (cdf[r, k] < u_b)``, clipped to ``K - 1``. Flat layout
(``ray_resampling``): one ``searchsorted`` over the global f32 CDF
``ray_index + cdf``, each hit clamped into its own ray's slots (at large
``n_rays`` the f32 spacing near the offset approaches the bin spacing).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .ray_marching import gather_rows_dense
from .scan import exclusive_segment_cumsum, segment_sum
from .vol_rendering import (
    _as_dense,
    _detect_dense_layout,
    _flat_mask,
    _flatten,
    _resolve_indices,
)


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


class ResampledRays(NamedTuple):
    """Resampling output of static capacity: ray r owns slots ``[r n, (r +
    1) n)``."""

    packed_info: torch.Tensor  # (n_rays, 2) int32: [r n, n or 0]
    t_starts: torch.Tensor  # (n_rays n, 1)
    t_ends: torch.Tensor  # (n_rays n, 1)
    masks: torch.Tensor  # (n_rays n,) bool
    ray_indices: torch.Tensor  # (n_rays n,) int32


def _resampled(starts, ends, alive, n_samples) -> ResampledRays:
    """ResampledRays from (R, n) bounds and the (R,) live rays."""
    R = alive.shape[0]
    dev = alive.device
    counts = torch.where(alive, n_samples, 0).to(torch.int32)
    info = torch.stack(
        [torch.arange(R, dtype=torch.int32, device=dev) * n_samples, counts],
        dim=-1)
    return ResampledRays(
        info, starts.reshape(-1, 1), ends.reshape(-1, 1),
        alive[:, None].expand(R, n_samples).reshape(-1),
        torch.arange(R, dtype=torch.int32,
                     device=dev).repeat_interleave(n_samples),
    )


def ray_resampling(
    packed_info: Optional[torch.Tensor],
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    *,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    masks: Optional[torch.Tensor] = None,
) -> ResampledRays:
    """Resample ``n_samples`` intervals per ray uniformly in the weight CDF
    (reference ``cdf.py:12-46``) on the flat layout: ``packed_info``, or
    ``ray_indices`` with ``n_rays``; t (N, 1) or (N,), weights (N,)
    non-negative, ``masks`` the valid entries. A dense ray-major layout
    takes :func:`ray_resampling_dense` (``DENSE_BRIDGE``)."""
    w, ts, te = (_flatten(x)[0] for x in (weights, t_starts, t_ends))
    m = _flat_mask(masks)
    N = w.shape[0]
    dl = _detect_dense_layout(ray_indices, packed_info, N, n_rays)
    if dl is not None:
        s2, e2, mk2 = ray_resampling_dense(
            *(_as_dense(dl, x) for x in (ts, te, w)), n_samples,
            masks=_as_dense(dl, m))
        return _resampled(s2, e2, mk2[:, 0], n_samples)
    seg, n_rays = _resolve_indices(ray_indices, packed_info, N, n_rays)
    if m is None:
        m = torch.ones((N,), dtype=torch.bool, device=w.device)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    w = torch.where(m, torch.clamp(w, min=0.0), zero)

    segl = seg.long()
    counts = segment_sum(m.to(torch.int32), seg, n_rays)
    w_sum = segment_sum(w, seg, n_rays)
    padding = torch.clamp(1e-5 - w_sum, min=0.0)
    pad_step = torch.where(counts > 0, padding / torch.clamp(counts, min=1),
                           zero)
    w_pad = torch.where(m, w + pad_step[segl], zero)
    w_norm = w_pad / torch.clamp(w_sum + padding, min=1e-20)[segl]

    # the global monotone CDF: ray r spans (r, r + 1]. Masked entries add
    # 0 and repeat the value before them, so a left search lands on the
    # first valid entry that reaches a target
    cdf = exclusive_segment_cumsum(w_norm, seg, n_rays) + w_norm
    g = seg.to(torch.float32) + cdf
    u = resampling_targets(n_samples, w.device)
    num_bins = n_samples + 1
    rid = torch.arange(n_rays, dtype=torch.float32, device=w.device)
    idx = torch.searchsorted(g, (rid[:, None] + u[None, :]).reshape(-1))
    # clamp each hit into its own ray's slots
    full = segment_sum(torch.ones_like(seg), seg, n_rays)
    end = torch.cumsum(full, dim=0)
    lo = (end - full).repeat_interleave(num_bins)
    hi = torch.maximum(end - 1, end - full).repeat_interleave(num_bins)
    idx = torch.clamp(torch.minimum(torch.maximum(idx, lo), hi), 0, N - 1)
    prev = torch.clamp(idx - 1, min=0)
    cdf_prev = torch.where((idx > 0) & (segl[prev] == segl[idx]), cdf[prev],
                           zero)
    scaling = (te[idx] - ts[idx]) / torch.clamp(cdf[idx] - cdf_prev,
                                                min=1e-20)
    u_flat = u.repeat(n_rays)
    bounds = ((u_flat - cdf_prev) * scaling + ts[idx]).reshape(n_rays,
                                                             num_bins)
    alive = counts > 0
    return _resampled(torch.where(alive[:, None], bounds[:, :-1], zero),
                      torch.where(alive[:, None], bounds[:, 1:], zero),
                      alive, n_samples)
