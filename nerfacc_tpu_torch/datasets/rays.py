"""Camera ray generation (PyTorch port of :mod:`nerfacc_tpu.datasets.rays`).

OpenGL/Blender camera convention: pixel (x, y) maps to the camera-space
direction ``[(x + 0.5 - cx)/fx, -(y + 0.5 - cy)/fy, -1]``, rotated by the
camera-to-world matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Rays(NamedTuple):
    origins: torch.Tensor  # (..., 3)
    viewdirs: torch.Tensor  # (..., 3), normalized


def generate_rays(
    x: torch.Tensor,
    y: torch.Tensor,
    c2w: torch.Tensor,
    K: torch.Tensor,
) -> Rays:
    """Rays through pixel centers.

    Args:
        x, y: (...,) pixel column / row indices.
        c2w: (..., 3, 4) or (3, 4) camera-to-world matrices.
        K: (3, 3) intrinsics [[fx, 0, cx], [0, fy, cy], [0, 0, 1]].
    """
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    dirs = torch.stack(
        [(x + 0.5 - cx) / fx, -(y + 0.5 - cy) / fy, -torch.ones_like(x)],
        dim=-1,
    )
    rot = c2w[..., :3, :3]
    trans = c2w[..., :3, 3]
    d = torch.einsum("...ij,...j->...i", rot, dirs)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return Rays(origins=torch.broadcast_to(trans, d.shape), viewdirs=d)


def look_at_poses(
    n_views: int,
    radius: float,
    elevation_deg: float = 30.0,
    hemisphere_seed: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """(n, 3, 4) f32 camera-to-world poses looking at the origin
    (Blender-style -z forward, +y up in camera space): a circle at
    ``elevation_deg``, or with ``hemisphere_seed`` poses drawn uniformly
    over the upper hemisphere (elevations 5-75 deg). On ``device`` (None:
    the CUDA device)."""
    if hemisphere_seed is not None:
        rng = np.random.RandomState(hemisphere_seed)
        phis = rng.uniform(0, 2 * np.pi, n_views)
        s_lo, s_hi = np.sin(np.deg2rad(5.0)), np.sin(np.deg2rad(75.0))
        thetas = np.arcsin(rng.uniform(s_lo, s_hi, n_views))
    else:
        phis = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
        thetas = np.full(n_views, np.deg2rad(elevation_deg))
    poses = []
    for phi, theta in zip(phis, thetas):
        eye = radius * np.array(
            [np.cos(phi) * np.cos(theta), np.sin(phi) * np.cos(theta),
             np.sin(theta)]
        )
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up)
        right = right / np.linalg.norm(right)
        true_up = np.cross(right, forward)
        # columns: x=right, y=up, z=backward (OpenGL)
        R = np.stack([right, true_up, -forward], axis=-1)
        poses.append(np.concatenate([R, eye[:, None]], axis=-1))
    return torch.as_tensor(
        np.stack(poses), dtype=torch.float32,
        device=torch.device("cuda") if device is None else device,
    )
