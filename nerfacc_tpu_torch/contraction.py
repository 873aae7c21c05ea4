"""Scene contractions (PyTorch port of :mod:`nerfacc_tpu.contraction`).

Conventions (identical to the JAX package):
  - ``AABB``: roi -> [0, 1]^3 linear map.
  - ``UN_BOUNDED_TANH``: [-inf, inf]^3 -> [0, 1]^3, roi -> [0.25, 0.75]^3
    via per-axis tanh.
  - ``UN_BOUNDED_SPHERE``: MipNeRF-360 contraction. [-inf, inf]^3 -> unit
    sphere in [0, 1]^3; roi maps into the sphere of [0.25, 0.75]^3.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ._consts import constant


class ContractionType(enum.Enum):
    """How a world-space point is mapped into the unit grid cube."""

    AABB = 0
    UN_BOUNDED_TANH = 1
    UN_BOUNDED_SPHERE = 2


def _split_roi(roi, like: torch.Tensor):
    if torch.is_tensor(roi):
        roi = roi.to(device=like.device, dtype=torch.float32)
    else:  # host numbers: one upload per device, not one a call
        roi = constant(tuple(np.asarray(roi, np.float64).reshape(-1).tolist()),
                       torch.float32, like.device)
    return roi[..., :3], roi[..., 3:]


def contract(
    x: torch.Tensor,
    roi,
    type: ContractionType = ContractionType.AABB,
) -> torch.Tensor:
    """Contract world-space points ``(..., 3)`` into the unit cube."""
    roi_min, roi_max = _split_roi(roi, x)
    unit = (x - roi_min) / (roi_max - roi_min)
    if type == ContractionType.AABB:
        return unit
    if type == ContractionType.UN_BOUNDED_TANH:
        return torch.tanh(unit - 0.5) * 0.5 + 0.5
    if type == ContractionType.UN_BOUNDED_SPHERE:
        u = unit * 2.0 - 1.0  # roi -> [-1, 1]^3
        norm = torch.linalg.norm(u, dim=-1, keepdim=True)
        safe_norm = torch.clamp(norm, min=1e-10)
        contracted = (2.0 - 1.0 / safe_norm) * (u / safe_norm)
        u = torch.where(norm > 1.0, contracted, u)
        return u * 0.25 + 0.5  # [-2, 2]^3 ball -> [0, 1]^3 ball
    raise ValueError(f"Unknown contraction type: {type}")


def contract_inv(
    x: torch.Tensor,
    roi,
    type: ContractionType = ContractionType.AABB,
) -> torch.Tensor:
    """Recover world-space points from contracted coordinates."""
    roi_min, roi_max = _split_roi(roi, x)
    if type == ContractionType.AABB:
        u = x
    elif type == ContractionType.UN_BOUNDED_TANH:
        u = torch.clamp(torch.atanh(x * 2.0 - 1.0), -1e10, 1e10) + 0.5
    elif type == ContractionType.UN_BOUNDED_SPHERE:
        u = (x - 0.5) * 4.0  # [0.25, 0.75]^3 -> [-1, 1]^3
        norm_sq = torch.sum(u * u, dim=-1, keepdim=True)
        norm = torch.sqrt(norm_sq)
        expanded = u / torch.clamp(2.0 * norm - norm_sq, min=1e-10)
        u = torch.where(norm > 1.0, expanded, u)
        u = u * 0.5 + 0.5
    else:
        raise ValueError(f"Unknown contraction type: {type}")
    return u * (roi_max - roi_min) + roi_min
