"""The general traffic generator: what a traffic mix's data file asks
for, made on the device from the seed.

``kind: train``: ``episode_steps`` batches of the configuration's ray
count, pixels drawn uniformly over the views of ``train_views`` (rings
of cameras) with the ground truth of the drawn rays only.
``kind: view``: the rays of every pose of ``views`` and the order the
seed gives them. A seed changes which pixels and which order, never how
many or of what size.
"""

from __future__ import annotations

import hashlib

import torch

from . import scene


def subseed(seed: int, tag: str) -> int:
    """A 62-bit seed of its own for each use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).hexdigest()
    return int(h[:15], 16)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def _cameras(spec: dict, device):
    poses = scene.ring_poses(spec["rings"], spec["radius"],
                             spec.get("azimuth_offset", 0.0), device=device)
    K = scene.intrinsics(spec["width"], spec["height"], spec["fov_deg"],
                         device=device)
    return poses, K


def train_batches(traffic: dict, n_rays: int, seed: int, device):
    """(origins, directions, pixels), each (steps, n_rays, 3)."""
    spec, steps = traffic["train_views"], traffic["episode_steps"]
    poses, K = _cameras(spec, device)
    g = generator(seed, "pixels", device)
    n = steps * n_rays
    view = torch.randint(0, poses.shape[0], (n,), generator=g, device=device)
    x = torch.randint(0, spec["width"], (n,), generator=g, device=device)
    y = torch.randint(0, spec["height"], (n,), generator=g, device=device)
    o, d = scene.pixel_rays(x, y, poses[view], K)
    px = scene.ground_truth(o, d, traffic["gt_samples"])
    shape = (steps, n_rays, 3)
    return o.reshape(shape), d.reshape(shape), px.reshape(shape)


def view_requests(traffic: dict, seed: int, device):
    """(rays of each pose [(origins, directions), ...], the pose order)."""
    spec = traffic["views"]
    poses, K = _cameras(spec, device)
    yy, xx = torch.meshgrid(torch.arange(spec["height"], device=device),
                            torch.arange(spec["width"], device=device),
                            indexing="ij")
    rays = [scene.pixel_rays(xx.reshape(-1), yy.reshape(-1), p, K)
            for p in poses]
    g = generator(seed, "order", "cpu")
    order = torch.randperm(len(rays), generator=g).tolist()
    return rays, order
