"""The procedural analytic scene (PyTorch port of
:mod:`nerfacc_tpu.datasets.procedural`): ground-truth images without
external data.

An analytic radiance field (three smooth density blobs and a ground slab
inside the box ``AABB``, position-dependent colors) is rendered by a
dense quadrature of 512 samples per ray. Training against those images
and scoring held-out views in PSNR exercises the same paths as the
reference's Lego benchmark. ``ProceduralDynamicScene`` moves the same
field rigidly over time, one timestamp per view, for the D-NeRF field;
``Procedural360Scene`` sets it in a directional environment with no
constant background, for the unbounded recipes. The GT images are
rendered on the scene's device, ``chunk`` rays at a time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..intersection import ray_aabb_intersect
from .rays import Rays, generate_rays, look_at_poses

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)

# (centre, radius, amplitude) of the density blobs
_BLOBS = (((0.0, 0.0, 0.0), 0.5, 40.0),
          ((0.7, 0.3, 0.2), 0.25, 80.0),
          ((-0.5, -0.6, 0.4), 0.3, 60.0))


def field_density(x: torch.Tensor) -> torch.Tensor:
    """Analytic density (N, 3) -> (N, 1): three smooth blobs + a slab."""
    sigma = None
    for c, r, amp in _BLOBS:
        centre = torch.tensor(c, dtype=x.dtype, device=x.device)
        d = torch.linalg.norm(x - centre, dim=-1, keepdim=True)
        blob = amp * torch.sigmoid(24.0 * (r - d))
        sigma = blob if sigma is None else sigma + blob
    # thin ground slab at z ~ -0.8
    slab = (30.0
            * torch.sigmoid(40.0 * (0.05 - torch.abs(x[..., 2:3] + 0.8)))
            * torch.sigmoid(8.0 * (1.0 - torch.linalg.norm(
                x[..., :2], dim=-1, keepdim=True))))
    return sigma + slab


def field_rgb(x: torch.Tensor, d: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Analytic albedo (N, 3) -> (N, 3), mildly view-dependent."""
    freq = torch.tensor([[3.0, 5.0, 7.0]], dtype=x.dtype, device=x.device)
    phase = torch.tensor([[0.0, 1.0, 2.0]], dtype=x.dtype, device=x.device)
    base = 0.5 + 0.5 * torch.sin(freq * x + phase)
    if d is not None:
        base = base * (0.75 + 0.25 * torch.abs(d[..., 2:3]))
    return torch.clamp(base, 0.0, 1.0)


def _shift(t: torch.Tensor) -> torch.Tensor:
    """Rigid translation of the scene over time, which a D-NeRF warp can
    represent exactly: (..., 1) times -> (..., 3) offsets."""
    return torch.cat([
        0.35 * torch.sin(2.0 * np.pi * t),
        0.25 * (torch.cos(2.0 * np.pi * t) - 1.0),
        torch.zeros_like(t),
    ], dim=-1)


def _render(rays_o, rays_d, bkgd, n_samples, shift=None):
    """Exact volumetric render of the analytic field, optionally shifted by
    a per-ray (n_rays, 3) offset: ``n_samples`` midpoints evenly spaced over
    each ray's span in the box, the f32 exclusive cumsum of sigma * delta
    for the transmittance, composited onto ``bkgd`` (rays that miss the box
    render ``bkgd``)."""
    t_min, t_max = ray_aabb_intersect(rays_o, rays_d, AABB)
    hit = t_max < 1e9
    t_min = torch.where(hit, t_min, torch.zeros_like(t_min))
    t_max = torch.where(hit, t_max, torch.full_like(t_max, 1e-3))
    lin = torch.linspace(0.0, 1.0, n_samples + 1, dtype=rays_o.dtype,
                         device=rays_o.device)
    ts = t_min[:, None] + (t_max - t_min)[:, None] * lin
    t0, t1 = ts[:, :-1], ts[:, 1:]
    tm = (t0 + t1) / 2
    x = rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
    if shift is not None:
        x = x - shift[:, None, :]  # into the canonical frame
    sigma = field_density(x.reshape(-1, 3)).reshape(tm.shape)
    rgb = field_rgb(
        x.reshape(-1, 3),
        torch.broadcast_to(rays_d[:, None, :], x.shape).reshape(-1, 3),
    ).reshape(tm.shape + (3,))
    sd = sigma * (t1 - t0)
    trans = torch.exp(-(torch.cumsum(sd, dim=-1) - sd))
    weights = trans * (1.0 - torch.exp(-sd))
    color = (weights[..., None] * rgb).sum(dim=1)
    opacity = weights.sum(dim=1, keepdim=True)
    return color + bkgd * (1.0 - opacity)


def env_color(d: torch.Tensor) -> torch.Tensor:
    """Directional environment radiance (N, 3): a sky / ground gradient
    plus azimuthal colour bands, constant in position — the analytic
    analogue of a 360 capture's background. Unlike a constant background
    it cannot be faked by per-view fog: an unbounded model has to put it
    in its far field."""
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    up = d[..., 2:3]
    m = 0.5 + 0.5 * torch.tanh(4.0 * up)
    sky = torch.tensor([0.55, 0.68, 0.92], dtype=d.dtype, device=d.device)
    ground = torch.tensor([0.42, 0.33, 0.24], dtype=d.dtype, device=d.device)
    base = m * sky + (1.0 - m) * ground
    az = torch.atan2(d[..., 1:2], d[..., 0:1])
    freq = torch.tensor([[5.0, 9.0, 13.0]], dtype=d.dtype, device=d.device)
    phase = torch.tensor([[0.0, 1.3, 2.1]], dtype=d.dtype, device=d.device)
    bands = 0.18 * torch.sin(az * freq + phase)
    return torch.clamp(base + bands * (1.0 - torch.abs(up)), 0.0, 1.0)


def render_gt_env(rays_o: torch.Tensor, rays_d: torch.Tensor,
                  n_samples: int = 512) -> torch.Tensor:
    """Exact render of the analytic field over the directional environment
    ``env_color`` (the 360 scene's ground truth)."""
    return _render(rays_o, rays_d, env_color(rays_d), n_samples)


def render_gt(rays_o: torch.Tensor, rays_d: torch.Tensor, bkgd: torch.Tensor,
              n_samples: int = 512) -> torch.Tensor:
    """Exact render of the analytic field (see ``_render``)."""
    return _render(rays_o, rays_d, bkgd, n_samples)


def render_gt_dynamic(rays_o: torch.Tensor, rays_d: torch.Tensor,
                      bkgd: torch.Tensor, t: torch.Tensor,
                      n_samples: int = 512) -> torch.Tensor:
    """Exact render of the analytic field shifted rigidly by ``_shift`` of
    the per-ray times ``t`` (n_rays, 1)."""
    return _render(rays_o, rays_d, bkgd, n_samples, shift=_shift(t))


class ProceduralScene:
    """Trainable scene whose GT images come from the analytic field.

    Train and test views lie on two elevation rings (20 and 42 degrees) at
    radius 3.2, the test views interleaved among the train views (eval
    measures interpolation). ``sample_batch`` draws random pixels across
    all training views from ``numpy.random.RandomState(seed)``, as the
    JAX package's numpy path does. Tensors live on ``device`` (None: the
    CUDA device).
    """

    def __init__(
        self,
        n_views: int = 24,
        width: int = 128,
        height: int = 128,
        bkgd: float = 1.0,
        n_test_views: int = 4,
        seed: int = 0,
        device=None,
        chunk: int = 4096,
    ):
        self.device = torch.device("cuda") if device is None else device
        self.width, self.height, self.chunk = width, height, chunk
        focal = 0.5 * width / np.tan(0.5 * np.deg2rad(45.0))
        self.K = torch.tensor(
            [[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
            dtype=torch.float32, device=self.device,
        )
        self.bkgd = torch.full((3,), bkgd, dtype=torch.float32,
                               device=self.device)
        self.aabb = torch.tensor(AABB, dtype=torch.float32, device=self.device)
        n_total = n_views + n_test_views
        ring_a = look_at_poses((n_total + 1) // 2, radius=3.2,
                               elevation_deg=20.0, device=self.device)
        ring_b = look_at_poses(n_total // 2, radius=3.2, elevation_deg=42.0,
                               device=self.device)
        poses = torch.cat([ring_a, ring_b], dim=0)
        idx = np.arange(n_total)
        test_idx = idx[::max(n_total // max(n_test_views, 1), 1)][:n_test_views]
        train_idx = np.setdiff1d(idx, test_idx)
        self.train_poses = poses[torch.as_tensor(train_idx, device=self.device)]
        self.test_poses = poses[torch.as_tensor(test_idx, device=self.device)]
        self._render_splits()
        self._rng = np.random.RandomState(seed)

    def _render_splits(self) -> None:
        """The GT images of the train and test views."""
        self.images = self._render_views(self.train_poses)
        self.test_images = self._render_views(self.test_poses)

    def _pixel_grid(self):
        y, x = torch.meshgrid(
            torch.arange(self.height, device=self.device),
            torch.arange(self.width, device=self.device), indexing="ij")
        return x.reshape(-1), y.reshape(-1)

    def _render_views(self, poses: torch.Tensor,
                      times: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n, h, w, 3) GT images of ``poses``, view ``i`` at time
        ``times[i]`` where ``times`` is given."""
        images = []
        for v, pose in enumerate(poses):
            rays = self.rays_for_view(pose)
            chunks = []
            for i in range(0, rays.origins.shape[0], self.chunk):
                o = rays.origins[i:i + self.chunk]
                d = rays.viewdirs[i:i + self.chunk]
                t = None if times is None else torch.full(
                    (o.shape[0], 1), float(times[v]), dtype=torch.float32,
                    device=self.device)
                chunks.append(self._render_gt(o, d, t))
            images.append(torch.cat(chunks).reshape(self.height, self.width,
                                                    3))
        return torch.stack(images)

    def _render_gt(self, rays_o, rays_d, t=None) -> torch.Tensor:
        """The GT colours of a chunk of rays (at per-ray times ``t``)."""
        if t is None:
            return render_gt(rays_o, rays_d, self.bkgd)
        return render_gt_dynamic(rays_o, rays_d, self.bkgd, t)

    def rays_for_view(self, pose: torch.Tensor) -> Rays:
        """The rays through every pixel of one view, row-major."""
        x, y = self._pixel_grid()
        return generate_rays(x, y, pose, self.K)

    def _sample(self, num_rays: int):
        """Random pixels across all training images -> (view indices,
        rays, pixels)."""
        n, h, w = self.images.shape[:3]
        img_idx = self._rng.randint(0, n, (num_rays,))
        ys = self._rng.randint(0, h, (num_rays,))
        xs = self._rng.randint(0, w, (num_rays,))
        img_idx, ys, xs = (torch.as_tensor(a, device=self.device)
                           for a in (img_idx, ys, xs))
        pixels = self.images[img_idx, ys, xs]
        rays = generate_rays(xs, ys, self.train_poses[img_idx], self.K)
        return img_idx, rays, pixels

    def sample_batch(self, num_rays: int):
        """Random pixels across all training images -> (rays, pixels)."""
        _, rays, pixels = self._sample(num_rays)
        return rays, pixels


class ProceduralDynamicScene(ProceduralScene):
    """The analytic scene moving rigidly over time (``_shift``), one
    timestamp per view as in the D-NeRF dataset: ``timestamps`` =
    ``linspace(0, 1, n_train)`` for the train views (also the times the
    grid update draws from) and ``test_timestamps`` = ``linspace(0.05,
    0.95, n_test)``. ``sample_batch`` returns ``(rays, pixels, t)`` with
    ``t`` (num_rays, 1) each ray's view time."""

    def _render_splits(self) -> None:
        self.timestamps = torch.linspace(
            0.0, 1.0, self.train_poses.shape[0], device=self.device)
        self.test_timestamps = torch.linspace(
            0.05, 0.95, self.test_poses.shape[0], device=self.device)
        self.images = self._render_views(self.train_poses, self.timestamps)
        self.test_images = self._render_views(self.test_poses,
                                              self.test_timestamps)

    def sample_batch(self, num_rays: int):
        """Random pixels across all training images -> (rays, pixels, t)."""
        img_idx, rays, pixels = self._sample(num_rays)
        return rays, pixels, self.timestamps[img_idx][:, None]


class Procedural360Scene(ProceduralScene):
    """The 360-style unbounded scene: the bounded analytic content over
    the directional environment ``env_color``. ``bkgd`` is ``None``: there
    is no constant background to composite onto, so an unbounded model
    must place the environment in its far field (the contracted outer
    shell), as in a real 360 capture. Poses and ``sample_batch`` are the
    parent's."""

    def __init__(self, *args, **kwargs):
        kwargs.pop("bkgd", None)
        super().__init__(*args, **kwargs)
        self.bkgd = None

    def _render_gt(self, rays_o, rays_d, t=None) -> torch.Tensor:
        return render_gt_env(rays_o, rays_d)
