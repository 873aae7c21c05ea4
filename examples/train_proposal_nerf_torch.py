"""Train a NeRF with proposal-network sampling (grid-free) with
nerfacc_tpu_torch (PyTorch, hand-written CUDA kernels for Hopper).

The twin of ``examples/train_proposal_nerf.py``: a cheap density-only
TensoCP proposal field (one level, no view directions) redistributes a
fixed per-ray sample budget toward surfaces by inverse-CDF resampling
(``nerfacc_tpu_torch.sampling``), and the main TensoCP field renders from
the resampled intervals. Both fields train photometrically (the proposal
renders its own coarse colour, as the classic coarse / fine scheme does)
under one Adam (eps 1e-15, cosine decay to 0.1x), with the MipNeRF-360
distortion loss (Eq. 15) on the main render; with ``--unbounded`` the
coarse intervals are uniform in disparity on ``[near, far]``, both fields
contract space into the unit sphere and the distortion is taken in
normalised disparity. The drives:

    python examples/train_proposal_nerf_torch.py --max_steps 2000 \\
      --train_views 64 --eval_views 3 --use_kernel
    python examples/train_proposal_nerf_torch.py --scene procedural360 \\
      --unbounded --max_steps 4000 --image_size 96 --train_views 64 \\
      --eval_views 3 --test_chunk_size 2048 --lr 5e-3 --prop_grid 192 \\
      --n_coarse 96 --n_fine 48

``--use_kernel`` sends both fields' CP levels through the CUDA kernels K2
/ K4 (K1 where no gradient is taken); without it the plain PyTorch paths
run, as the JAX script does (the 360 drive is run so: the kernel path's
numerics collapse it at some seeds, ROADMAP.md Queue 3). It runs
on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nerfacc_tpu_torch import (  # noqa: E402
    RaySegments,
    loss_distortion_dense,
    proposal_sampling_with_filter,
    sample_along_rays,
)
from nerfacc_tpu_torch.datasets import (  # noqa: E402
    Procedural360Scene,
    ProceduralScene,
)
from nerfacc_tpu_torch.intersection import ray_aabb_intersect  # noqa: E402
from nerfacc_tpu_torch.models import TensoCPRadianceField  # noqa: E402
from nerfacc_tpu_torch.training import (  # noqa: E402
    cosine_lr,
    huber,
    normalized_disparity,
)
from nerfacc_tpu_torch.vol_rendering import (  # noqa: E402
    accumulate_along_rays_dense,
    render_weight_from_density_dense,
)

# the drives' flags (scripts/run_quality.py proposal_2k and
# proposal360_4k; the kernels are chosen apart)
DRIVE = ("--max_steps", "2000", "--num_rays", "4096", "--image_size", "128",
         "--train_views", "64", "--eval_views", "3")
DRIVE_360 = ("--scene", "procedural360", "--unbounded", "--max_steps", "4000",
             "--num_rays", "4096", "--image_size", "96", "--train_views", "64",
             "--eval_views", "3", "--test_chunk_size", "2048", "--lr", "5e-3",
             "--prop_grid", "192", "--n_coarse", "96", "--n_fine", "48")
KERNELS = ("--use_kernel",)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max_steps", type=int, default=2000)
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--train_views", type=int, default=24)
    p.add_argument("--n_coarse", type=int, default=64)
    p.add_argument("--n_fine", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--distortion_loss", type=float, default=-1.0,
                   help="MipNeRF-360 Eq. 15 weight; -1: 1e-3 bounded, 1e-2 "
                   "unbounded (taken in normalised disparity there)")
    p.add_argument("--unbounded", action="store_true",
                   help="sphere contraction and coarse intervals uniform in "
                   "disparity on [near_plane, far_plane]")
    p.add_argument("--near_plane", type=float, default=1.0)
    p.add_argument("--prop_grid", type=int, default=64,
                   help="proposal-field grid nodes per axis")
    p.add_argument("--far_plane", type=float, default=64.0)
    p.add_argument("--scene", type=str, default="procedural",
                   choices=["procedural", "procedural360"])
    p.add_argument("--eval_views", type=int, default=2)
    p.add_argument("--test_chunk_size", type=int, default=4096)
    p.add_argument("--seed", type=int, default=42,
                   help="field init and the coarse intervals' jitter")
    p.add_argument("--use_kernel", action="store_true",
                   help="both fields' CP levels through the CUDA kernels K1 "
                   "/ K2 / K4")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _dense_points(rays_o, rays_d, t_starts, t_ends):
    """The (R * K, 3) interval midpoints of (R, K) intervals."""
    tm = (t_starts + t_ends) * 0.5
    return (rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
            ).reshape(-1, 3)


def dense_density(field, rays_o, rays_d, t_starts, t_ends):
    """The field's density at the interval midpoints, (R, K)."""
    x = _dense_points(rays_o, rays_d, t_starts, t_ends)
    return field.query_density(x).reshape(t_starts.shape)


def dense_rgb_sigma(field, rays_o, rays_d, t_starts, t_ends):
    """The field's colour (R, K, 3) and density (R, K) at the interval
    midpoints, seen along each ray's direction."""
    R, K = t_starts.shape
    x = _dense_points(rays_o, rays_d, t_starts, t_ends)
    d = torch.broadcast_to(rays_d[:, None, :], (R, K, 3)).reshape(-1, 3)
    rgb, sig = field(x, d)
    return rgb.reshape(R, K, 3), sig.reshape(R, K)


class Trainer:
    """The scene, the two fields, the optimizer and the forward of one
    run, and its training step."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        dev = self.device = torch.device(args.device)
        scene_cls = (Procedural360Scene if args.scene == "procedural360"
                     else ProceduralScene)
        self.scene = scene_cls(n_views=args.train_views,
                               width=args.image_size,
                               height=args.image_size, device=dev)
        self.has_bkgd = self.scene.bkgd is not None
        self.dist_w = args.distortion_loss
        if self.dist_w < 0:
            self.dist_w = 1e-2 if args.unbounded else 1e-3
        self.aabb = tuple(float(v) for v in self.scene.aabb.cpu())
        init = torch.Generator().manual_seed(args.seed)
        self.field = TensoCPRadianceField(
            aabb=self.aabb, unbounded=args.unbounded,
            use_kernel=args.use_kernel, generator=init, device=dev)
        self.proposal = TensoCPRadianceField(
            aabb=self.aabb, levels=((args.prop_grid, 32),),
            use_viewdirs=False, geo_feat_dim=7, unbounded=args.unbounded,
            use_kernel=args.use_kernel, generator=init, device=dev)
        params = [*self.field.parameters(), *self.proposal.parameters()]
        self.optimizer = torch.optim.Adam(params, lr=args.lr, eps=1e-15)
        self.schedule = cosine_lr(self.optimizer, args.max_steps)
        # the coarse intervals' jitter
        self.generator = torch.Generator(device=dev).manual_seed(args.seed)

    def jitter(self, n_rays: int, generator=None) -> torch.Tensor:
        """(n_rays,) uniform draws for the coarse intervals' jitter."""
        gen = self.generator if generator is None else generator
        return torch.rand((n_rays,), generator=gen, device=gen.device).to(
            self.device)

    def coarse_segments(self, rays_o, rays_d, u) -> RaySegments:
        """The coarse intervals, jittered by ``u`` (n_rays,) in [0, 1):
        bounded, ``n_coarse`` steps of diag / n_coarse from the box entry
        shifted by ``0.02 u``; unbounded, ``n_coarse`` intervals uniform in
        disparity on [near, far], shifted by ``u / n_coarse`` of a bin."""
        args = self.args
        K = args.n_coarse
        if args.unbounded:
            s = torch.linspace(0.0, 1.0, K + 1, device=rays_o.device)
            s = torch.clamp(s[None, :] + u[:, None] / K, 0.0, 1.0)
            t_edges = 1.0 / ((1.0 - s) / args.near_plane + s / args.far_plane)
            return RaySegments(
                t_starts=t_edges[:, :-1], t_ends=t_edges[:, 1:],
                deltas=t_edges[:, 1:] - t_edges[:, :-1],
                masks=torch.ones((rays_o.shape[0], K), dtype=torch.bool,
                                 device=rays_o.device))
        t_min, t_max = ray_aabb_intersect(rays_o, rays_d, self.aabb)
        diag = float(np.linalg.norm(np.asarray(self.aabb[3:])
                                    - np.asarray(self.aabb[:3])))
        return sample_along_rays(rays_o, rays_d, t_min + u * 0.02, t_max,
                                 step_size=diag / K, num_steps=K)

    def forward(self, rays_o, rays_d, u):
        """The render of a ray batch with coarse jitter ``u``: ``(colors,
        opacities, distortion per ray, the proposal's colors, live
        samples)``."""
        segs0 = self.coarse_segments(rays_o, rays_d, u)

        def prop_sigma_fn(ts, te):
            return dense_density(self.proposal, rays_o, rays_d, ts, te)

        segs, prop_rounds = proposal_sampling_with_filter(
            segs0, proposal_sigma_fns=[prop_sigma_fn],
            proposal_n_samples=[self.args.n_fine],
            proposal_require_grads=True, early_stop_eps=0.0, alpha_thre=0.0)
        # the proposal's own coarse render, for its photometric loss
        ts0, te0, w_prop, m0 = prop_rounds[0]
        rgb_prop, _ = dense_rgb_sigma(self.proposal, rays_o, rays_d, ts0, te0)
        colors_prop = accumulate_along_rays_dense(w_prop, rgb_prop, masks=m0)
        opac_prop = accumulate_along_rays_dense(w_prop, masks=m0)
        if self.has_bkgd:
            colors_prop = colors_prop + 1.0 * (1.0 - opac_prop)
        # the main render on the resampled intervals
        rgbs, sigmas = dense_rgb_sigma(self.field, rays_o, rays_d,
                                       segs.t_starts, segs.t_ends)
        w = render_weight_from_density_dense(segs.t_starts, segs.t_ends,
                                             sigmas, masks=segs.masks)
        colors = accumulate_along_rays_dense(w, rgbs, masks=segs.masks)
        opac = accumulate_along_rays_dense(w, masks=segs.masks)
        if self.has_bkgd:
            colors = colors + 1.0 * (1.0 - opac)  # white background
        ts, te = segs.t_starts, segs.t_ends
        if self.args.unbounded:
            near, far = self.args.near_plane, self.args.far_plane
            ts = normalized_disparity(ts, near, far)
            te = normalized_disparity(te, near, far)
        dist = loss_distortion_dense(w, ts, te, segs.masks)
        live = m0.sum() + segs.masks.sum()
        return colors, opac, dist, colors_prop, live

    def loss(self, colors, colors_prop, dist, pixels):
        """Both fields' Huber losses over every ray plus the weighted
        distortion."""
        return (huber(colors, pixels).mean()
                + huber(colors_prop, pixels).mean()
                + self.dist_w * dist.mean())

    def train_step(self, rays_o, rays_d, pixels):
        """One optimizer step on a ray batch; returns ``(loss, live
        samples)`` as tensors (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        colors, _, dist, colors_prop, live = self.forward(
            rays_o, rays_d, self.jitter(rays_o.shape[0]))
        loss = self.loss(colors, colors_prop, dist, pixels)
        loss.backward()
        self.optimizer.step()
        self.schedule.step()
        return loss.detach(), live

    def evaluate(self, n_views: int) -> list:
        """PSNR of ``n_views`` held-out views, in chunks of
        ``--test_chunk_size`` rays (the last padded), each chunk with the
        jitter of a generator seeded 0."""
        scene, chunk = self.scene, self.args.test_chunk_size
        psnrs = []
        for i in range(min(n_views, scene.test_poses.shape[0])):
            rays = scene.rays_for_view(scene.test_poses[i])
            n = rays.origins.shape[0]
            pad = (-n) % chunk
            o = torch.cat([rays.origins, torch.zeros((pad, 3),
                                                     device=self.device)])
            d = torch.cat([rays.viewdirs,
                           torch.ones((pad, 3), device=self.device)
                           / np.sqrt(3.0)])
            outs = []
            with torch.no_grad():
                for j in range(0, n + pad, chunk):
                    gen = torch.Generator(device=self.device).manual_seed(0)
                    outs.append(self.forward(o[j:j + chunk], d[j:j + chunk],
                                             self.jitter(chunk, gen))[0])
            colors = torch.cat(outs)[:n]
            gt = scene.test_images[i].reshape(-1, 3)
            mse = float(torch.mean((colors - gt) ** 2))
            psnrs.append(-10.0 * math.log10(mse))
        return psnrs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, trainer=None) -> dict:
    """Train and evaluate; prints the JAX trainer's lines (``step=``,
    ``train_samples_per_s:``, ``PSNR:``, ``train_time_s:``) and returns
    the run's numbers: the PSNRs, the seconds of the training loop and of
    the whole run, the samples per second as the JAX trainer counts them
    (rays times ``n_coarse + n_fine`` per step after step 0), the live
    samples summed over the steps (the coarse and the fine intervals that
    were composited) and the ``trainer``. A ``trainer`` made by the caller
    from ``parse_args(argv)`` is trained in place of a new one."""
    if trainer is None:
        trainer = Trainer(parse_args(argv))
    args = trainer.args
    dev = trainer.device
    total_samples = torch.zeros((), dtype=torch.int64, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    t_warm = t0  # re-set after step 0: the samples/s leave step 0 out
    for step in range(args.max_steps):
        rays, pixels = trainer.scene.sample_batch(args.num_rays)
        loss, live = trainer.train_step(rays.origins, rays.viewdirs, pixels)
        total_samples += live
        if step == 0:
            float(loss)
            t_warm = time.perf_counter()
        if step % 500 == 0 or step == args.max_steps - 1:
            print(f"step={step} loss={float(loss):.5f} "
                  f"elapsed={time.perf_counter() - t0:.1f}s")
    _sync(dev)
    loop_s = time.perf_counter() - t0
    sps = (args.max_steps - 1) * args.num_rays * (
        args.n_coarse + args.n_fine) / max(time.perf_counter() - t_warm, 1e-9)
    print(f"train_samples_per_s: {sps:.0f}")
    psnrs = trainer.evaluate(args.eval_views)
    train_time = time.perf_counter() - t0
    print(f"PSNR: {np.mean(psnrs):.2f} (views: {[f'{x:.2f}' for x in psnrs]})")
    print(f"train_time_s: {train_time:.1f}")
    return dict(psnr=float(np.mean(psnrs)), psnrs=psnrs,
                train_time_s=train_time, loop_s=loop_s,
                train_samples_per_s=sps, samples=int(total_samples),
                field_budget_dropped=0, steps=args.max_steps, trainer=trainer)


if __name__ == "__main__":
    main()
