"""The training step of the JAX package's ``bench.py`` (train mode), and
the losses and schedules of its trainers (``examples/train_ngp_nerf.py``,
``train_mlp_nerf.py``, ``train_mlp_dnerf.py``), as plain functions.

One step renders a ray batch with ``render_rays(..., aux=pixels,
return_compact=True)`` on a white background, takes the full-batch MSE
algebraically from the compacted rays (rays the compaction left out render
exactly the background), backpropagates and takes one optimizer step. The
optimizer is the caller's: ``bench.py`` uses Adam at lr 5e-4
(``torch.optim.Adam(field.parameters(), lr=5e-4)``).
"""

from __future__ import annotations

import math

import torch

from . import tracing
from .utils import render_rays


def huber(x, y, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss of ``x`` against ``y``: ``d^2 / 2`` below
    ``delta``, linear above (the trainer's photometric loss)."""
    d = torch.abs(x - y)
    return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def hit_ray_loss(colors, pixels, opacities) -> torch.Tensor:
    """The trainer's loss on a scene with a known background: the per-ray
    mean of ``huber`` over the channels, averaged over the rays whose
    opacity is above 0. A ray that hits nothing composites exactly onto
    the background, so it carries no useful gradient and is left out."""
    per_ray = huber(colors, pixels).mean(-1)
    alive = (opacities[:, 0] > 0).to(per_ray.dtype)
    return (per_ray * alive).sum() / torch.clamp(alive.sum(), min=1.0)


def normalized_disparity(t, near: float, far: float) -> torch.Tensor:
    """``t`` in normalised disparity on [near, far] (0 at the near plane,
    1 at the far one): where the unbounded trainers take the distortion
    loss (MipNeRF-360 Eq. 15 uses normalised ray distance; in raw t the
    far field's scale over-weights it)."""
    inv_n, inv_f = 1.0 / near, 1.0 / far
    return (inv_n - 1.0 / torch.clamp(t, min=1e-6)) / (inv_n - inv_f)


def cosine_lr(optimizer, horizon: int, alpha: float = 0.1):
    """optax's ``cosine_decay_schedule(lr, horizon, alpha)``: the learning
    rate falls along a half cosine to ``alpha`` times its start over
    ``horizon`` steps and stays there. Step it after each optimizer
    step."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda t: (1.0 - alpha) * 0.5 * (1.0 + math.cos(
            math.pi * min(t, horizon) / horizon)) + alpha)


def multistep_lr(optimizer, horizon: int, gamma: float = 0.33):
    """The MLP trainers' schedule: the learning rate times ``gamma`` from
    steps ``horizon // 2``, ``3 horizon // 4`` and ``9 horizon // 10`` on
    (optax's ``piecewise_constant_schedule`` with those boundaries, where
    equal boundaries of a short horizon count once). Step it after each
    optimizer step."""
    milestones = sorted({horizon // 2, horizon * 3 // 4, horizon * 9 // 10})
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones, gamma)


def warp_regularizer(field, x, t, mag: float, smooth: float) -> torch.Tensor:
    """The D-NeRF trainer's warp penalties at points ``x`` (N, 3) and times
    ``t`` (N, 1): ``mag`` times the mean squared displacement, plus
    ``smooth`` times the mean squared change of the displacement from ``t``
    to ``min(t + 0.05, 1)``."""
    d1 = field.warp_displacement(x, t)
    loss = torch.zeros((), dtype=d1.dtype, device=d1.device)
    if mag > 0:
        loss = loss + mag * torch.mean(d1**2)
    if smooth > 0:
        d2 = field.warp_displacement(x, torch.clamp(t + 0.05, 0.0, 1.0))
        loss = loss + smooth * torch.mean((d2 - d1) ** 2)
    return loss


def compact_mse(colors, sel, pixels) -> torch.Tensor:
    """Full-batch MSE against ``pixels`` (n_rays, 3) from the compacted
    render: ``colors`` (H, 3) of the selected rays, ``sel`` from
    ``render_rays(..., aux=pixels, return_compact=True)``, and every ray
    outside the selection rendering the white background (1, 1, 1)."""
    p_h, okm = sel["aux"], sel["ray_ok"][:, None]
    zero = torch.zeros((), dtype=colors.dtype, device=colors.device)
    sh = torch.sum(torch.where(okm, (colors - p_h) ** 2, zero))
    sbg = torch.sum((1.0 - pixels) ** 2) - torch.sum(
        torch.where(okm, (1.0 - p_h) ** 2, zero)
    )
    return (sh + sbg) / pixels.numel()


def train_step(field, optimizer, grid, rays_o, rays_d, pixels,
               **render_kwargs):
    """One step: zero the gradients, render, ``compact_mse``, backward,
    ``optimizer.step()``. Returns ``(loss, n_samples)`` as tensors on the
    rays' device (no host sync); the parameters' ``.grad`` hold this
    step's gradients afterwards."""
    with tracing.span("train_step"):
        with tracing.span("optimizer"):
            optimizer.zero_grad(set_to_none=True)
        colors, _, _, n_samples, sel = render_rays(
            field, rays_o, rays_d, grid=grid,
            render_bkgd=torch.ones(3, device=rays_o.device), aux=pixels,
            return_compact=True, **render_kwargs,
        )
        with tracing.span("loss"):
            loss = compact_mse(colors, sel, pixels)
        with tracing.span("backward"):
            loss.backward()
        with tracing.span("optimizer"):
            optimizer.step()
    return loss.detach(), n_samples
