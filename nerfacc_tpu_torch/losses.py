"""Regularisers (PyTorch port of the dense half of
:mod:`nerfacc_tpu.losses`)."""

from __future__ import annotations

from typing import Optional

import torch


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
