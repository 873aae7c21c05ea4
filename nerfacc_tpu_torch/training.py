"""The training step of the JAX package's ``bench.py`` (train mode), and
the losses of its trainer (``examples/train_ngp_nerf.py``), as plain
functions.

One step renders a ray batch with ``render_rays(..., aux=pixels,
return_compact=True)`` on a white background, takes the full-batch MSE
algebraically from the compacted rays (rays the compaction left out render
exactly the background), backpropagates and takes one optimizer step. The
optimizer is the caller's: ``bench.py`` uses Adam at lr 5e-4
(``torch.optim.Adam(field.parameters(), lr=5e-4)``).
"""

from __future__ import annotations

import torch

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
    optimizer.zero_grad(set_to_none=True)
    colors, _, _, n_samples, sel = render_rays(
        field, rays_o, rays_d, grid=grid,
        render_bkgd=torch.ones(3, device=rays_o.device), aux=pixels,
        return_compact=True, **render_kwargs,
    )
    loss = compact_mse(colors, sel, pixels)
    loss.backward()
    optimizer.step()
    return loss.detach(), n_samples
