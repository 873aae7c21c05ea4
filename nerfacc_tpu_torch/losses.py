"""Regularisers (PyTorch port of :mod:`nerfacc_tpu.losses`).

The MipNeRF-360 distortion loss (Eq. 15) in its O(S) form: with the
sample midpoints sorted along each ray, ``sum_ij w_i w_j |m_i - m_j| = 2
sum_i w_i (m_i A_i - B_i)``, ``A`` / ``B`` the exclusive prefix sums of
``w`` / ``w m`` (row cumsums on the dense layout, segmented scans on the
flat one).
"""

from __future__ import annotations

from typing import Optional

import torch

from .scan import exclusive_segment_cumsum, segment_sum
from .vol_rendering import (
    _as_dense,
    _detect_dense_layout,
    _flat_mask,
    _flatten,
    _resolve_indices,
)


def distortion_dense(
    weights: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The MipNeRF-360 distortion loss (Eq. 15) per ray on the dense
    (n_rays, K) layout, in its O(K) exclusive-cumsum form:
    ``1/3 sum_i d_i w_i^2 + 2 sum_i w_i (m_i A_i - B_i)`` with ``m`` the
    interval midpoints, ``d`` their widths and ``A`` / ``B`` the exclusive
    row cumsums of ``w`` / ``w m``. Returns (n_rays,); differentiable in
    ``weights``."""
    w = weights
    if masks is not None:
        w = torch.where(masks, w, torch.zeros_like(w))
    interval = t_ends - t_starts
    tmid = (t_starts + t_ends) / 2.0
    loss_uni = (1.0 / 3.0) * torch.sum(interval * w * w, dim=1)
    wa = torch.cumsum(w, dim=1) - w  # exclusive
    wb = torch.cumsum(w * tmid, dim=1) - w * tmid
    loss_bi = 2.0 * torch.sum(w * (tmid * wa - wb), dim=1)
    return loss_uni + loss_bi


def distortion(
    packed_info: Optional[torch.Tensor],
    weights: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    *,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The distortion loss per ray (reference ``losses.py:6-32``) on the
    flat layout: ``packed_info``, or ``ray_indices`` with ``n_rays``;
    weights (N,), t (N, 1) or (N,), midpoints sorted along each ray.
    Returns (n_rays,); differentiable in ``weights``. A dense ray-major
    layout takes :func:`distortion_dense` (``DENSE_BRIDGE``)."""
    w, ts, te = (_flatten(x)[0] for x in (weights, t_starts, t_ends))
    m = _flat_mask(masks)
    dl = _detect_dense_layout(ray_indices, packed_info, w.shape[0], n_rays)
    if dl is not None:
        return distortion_dense(*(_as_dense(dl, x) for x in (w, ts, te)),
                                masks=_as_dense(dl, m))
    seg, n_rays = _resolve_indices(ray_indices, packed_info, w.shape[0],
                                   n_rays)
    if m is not None:
        w = torch.where(m, w, torch.zeros_like(w))
    interval = te - ts
    tmid = (ts + te) / 2.0
    loss_uni = (1.0 / 3.0) * segment_sum(interval * w * w, seg, n_rays)
    wa = exclusive_segment_cumsum(w, seg, n_rays)
    wb = exclusive_segment_cumsum(w * tmid, seg, n_rays)
    return loss_uni + 2.0 * segment_sum(w * (tmid * wa - wb), seg, n_rays)
