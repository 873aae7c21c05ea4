"""Ray/AABB intersection (PyTorch port of :mod:`nerfacc_tpu.intersection`)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._consts import constant

MAX_DIST = 1e10


def ray_aabb_intersect(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test of rays against one axis-aligned box.

    ``t_min`` is clamped to be >= 0, and rays that miss the box get
    ``t_min = t_max = 1e10``.

    Args:
        rays_o: (n_rays, 3) ray origins.
        rays_d: (n_rays, 3) normalized ray directions.
        aabb: (6,) box ``{minx, miny, minz, maxx, maxy, maxz}``.

    Returns:
        (t_min, t_max), each (n_rays,).
    """
    if torch.is_tensor(aabb):
        aabb = aabb.to(device=rays_o.device, dtype=rays_o.dtype)
    else:  # host numbers: one upload per device, not one a call
        aabb = constant(tuple(np.asarray(aabb, np.float64).reshape(-1)
                              .tolist()), rays_o.dtype, rays_o.device)
    inv_d = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_near = torch.clamp(t_near, min=0.0)
    hit = t_far >= t_near
    miss = torch.full_like(t_near, MAX_DIST)
    return torch.where(hit, t_near, miss), torch.where(hit, t_far, miss)
