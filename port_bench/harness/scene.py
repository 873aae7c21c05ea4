"""The procedural scene the traffic is drawn from, frozen here so that
no change to the program changes what the benchmark feeds it: an
analytic radiance field (three smooth density blobs and a ground slab in
the box [-1.5, 1.5]^3, position-dependent colours), its ground truth by a
quadrature of 512 samples per ray on a white background, cameras looking
at the origin, and the rays through pixel centres (OpenGL convention).
The same field as the port's ``datasets/procedural.py``, kept apart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
BLOBS = (((0.0, 0.0, 0.0), 0.5, 40.0),
         ((0.7, 0.3, 0.2), 0.25, 80.0),
         ((-0.5, -0.6, 0.4), 0.3, 60.0))


def density(x: torch.Tensor) -> torch.Tensor:
    sigma = 0.0
    for c, r, amp in BLOBS:
        centre = torch.tensor(c, dtype=x.dtype, device=x.device)
        d = torch.linalg.norm(x - centre, dim=-1, keepdim=True)
        sigma = sigma + amp * torch.sigmoid(24.0 * (r - d))
    slab = (30.0 * torch.sigmoid(40.0 * (0.05 - torch.abs(x[..., 2:3] + 0.8)))
            * torch.sigmoid(8.0 * (1.0 - torch.linalg.norm(
                x[..., :2], dim=-1, keepdim=True))))
    return sigma + slab


def albedo(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    freq = torch.tensor([[3.0, 5.0, 7.0]], dtype=x.dtype, device=x.device)
    phase = torch.tensor([[0.0, 1.0, 2.0]], dtype=x.dtype, device=x.device)
    base = (0.5 + 0.5 * torch.sin(freq * x + phase)) * (
        0.75 + 0.25 * torch.abs(d[..., 2:3]))
    return torch.clamp(base, 0.0, 1.0)


def ground_truth(rays_o, rays_d, n_samples: int = 512,
                 chunk: int = 1 << 14) -> torch.Tensor:
    """Colours (N, 3) of the analytic field on white: ``n_samples``
    midpoints spread evenly over each ray's span in the box."""
    lo = torch.tensor(AABB[:3], device=rays_o.device)
    hi = torch.tensor(AABB[3:], device=rays_o.device)
    out = []
    for i in range(0, rays_o.shape[0], chunk):
        o, d = rays_o[i:i + chunk], rays_d[i:i + chunk]
        t0, t1 = (lo - o) / d, (hi - o) / d
        tn = torch.minimum(t0, t1).amax(-1).clamp(min=0.0)
        tf = torch.maximum(t0, t1).amin(-1)
        hit = tf >= tn
        tn = torch.where(hit, tn, torch.zeros_like(tn))
        tf = torch.where(hit, tf, torch.full_like(tf, 1e-3))
        lin = torch.linspace(0.0, 1.0, n_samples + 1, device=o.device)
        ts = tn[:, None] + (tf - tn)[:, None] * lin
        tm = (ts[:, :-1] + ts[:, 1:]) / 2
        x = o[:, None] + tm[..., None] * d[:, None]
        sd = density(x.reshape(-1, 3)).reshape(tm.shape) * (ts[:, 1:]
                                                            - ts[:, :-1])
        trans = torch.exp(-(torch.cumsum(sd, -1) - sd))
        w = trans * (1.0 - torch.exp(-sd))
        rgb = albedo(x.reshape(-1, 3), torch.broadcast_to(
            d[:, None], x.shape).reshape(-1, 3)).reshape(x.shape)
        out.append((w[..., None] * rgb).sum(1) + (1.0 - w.sum(1, keepdim=True)))
    return torch.cat(out)


def ring_poses(rings, radius: float, azimuth_offset: float = 0.0,
               device=None) -> torch.Tensor:
    """(n, 3, 4) camera-to-world poses looking at the origin from
    ``radius``: for each ``[elevation_deg, count]`` of ``rings``, ``count``
    azimuths evenly spaced, moved by ``azimuth_offset`` of a spacing."""
    poses = []
    for elev, count in rings:
        theta = math.radians(elev)
        for k in range(int(count)):
            phi = 2 * math.pi * (k + azimuth_offset) / count
            eye = radius * np.array([math.cos(phi) * math.cos(theta),
                                     math.sin(phi) * math.cos(theta),
                                     math.sin(theta)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            up = np.cross(right, fwd)
            poses.append(np.concatenate(
                [np.stack([right, up, -fwd], axis=-1), eye[:, None]], -1))
    return torch.as_tensor(np.stack(poses), dtype=torch.float32,
                           device=device)


def intrinsics(width: int, height: int, fov_deg: float, device=None):
    focal = 0.5 * width / math.tan(0.5 * math.radians(fov_deg))
    return torch.tensor([[focal, 0, width / 2], [0, focal, height / 2],
                         [0, 0, 1]], dtype=torch.float32, device=device)


def pixel_rays(x, y, c2w, K):
    """Rays through pixel centres (x, y) of cameras ``c2w`` (..., 3, 4):
    (origins, unit directions)."""
    dirs = torch.stack([(x.float() + 0.5 - K[0, 2]) / K[0, 0],
                        -(y.float() + 0.5 - K[1, 2]) / K[1, 1],
                        -torch.ones_like(x, dtype=torch.float32)], dim=-1)
    d = torch.einsum("...ij,...j->...i", c2w[..., :3, :3], dirs)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return (torch.broadcast_to(c2w[..., :3, 3], d.shape).contiguous(),
            d.contiguous())
