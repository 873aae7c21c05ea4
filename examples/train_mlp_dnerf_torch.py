"""Train a D-NeRF (time-conditioned deformation) field on the moving
procedural scene or an on-disk D-NeRF dataset with nerfacc_tpu_torch
(PyTorch on the card).

The twin of ``examples/train_mlp_dnerf.py``: its flags and defaults, the
D-NeRF field (a warp MLP of the point's and the time's encodings in front
of the vanilla field), Adam at lr 5e-4 with PyTorch's default eps, the
learning rate times 0.33 at 1/2, 3/4 and 9/10 of ``--sched_steps`` (or of
the steps), one occupancy grid for all times, updated every 16 steps at
one training timestamp drawn per cell, ``alpha_thre`` 0 up to step 1000
and 0.01 after, the Huber loss over the rays that hit something plus the
optional warp penalties, and the held-out PSNR at the test views' times on
a white background. The drive:

    python examples/train_mlp_dnerf_torch.py --max_steps 2000 \\
      --image_size 96

It runs on the CUDA device unless ``--device cpu`` is given. A given
``--data_root`` always trains through the D-NeRF loader (the subject
``--scene`` under it), with its test split's views and times for the
evaluation, as the JAX trainer does.
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

from nerfacc_tpu_torch import create_grid, render_image, render_rays  # noqa: E402
from nerfacc_tpu_torch import update_grid  # noqa: E402
from nerfacc_tpu_torch.datasets import ProceduralDynamicScene  # noqa: E402
from nerfacc_tpu_torch.datasets import dnerf_synthetic  # noqa: E402
from nerfacc_tpu_torch.models import DNeRFRadianceField  # noqa: E402
from nerfacc_tpu_torch.training import (  # noqa: E402
    hit_ray_loss,
    multistep_lr,
    warp_regularizer,
)

# the drive's flags: 2,000 steps at 96^2, the other defaults
DRIVE = ("--max_steps", "2000", "--image_size", "96")
# points and times per step of the warp penalties
WARP_REG_POINTS = 1024


def make_scene(args, device):
    """The moving procedural scene where no ``--data_root`` is given, else
    the D-NeRF loader of ``--scene`` under it, whose test split's poses,
    images and times replace the train loader's."""
    if args.data_root is None:
        if args.scene != "procedural":
            raise ValueError(f"--scene {args.scene} needs --data_root")
        return ProceduralDynamicScene(
            width=args.image_size, height=args.image_size,
            n_views=args.train_views, device=device)
    kw = dict(subject_id=args.scene, root_fp=args.data_root, device=device)
    scene = dnerf_synthetic.SubjectLoader(split="train", **kw)
    test = dnerf_synthetic.SubjectLoader(split="test", **kw)
    scene.test_poses, scene.test_images = test.test_poses, test.test_images
    scene.test_timestamps = test.timestamps
    return scene


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", type=str, default="procedural")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--max_steps", type=int, default=30000)
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--grid_resolution", type=int, default=128)
    p.add_argument("--render_step_size", type=float, default=5e-3)
    p.add_argument("--max_samples_per_ray", type=int, default=1024)
    p.add_argument("--samples_budget", type=int, default=1 << 17)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--eval_every", type=int, default=0,
                   help="if > 0, render one held-out view every N steps and "
                   "print its PSNR (left out of train_time_s)")
    p.add_argument("--sched_steps", type=int, default=0,
                   help="lr-decay milestone horizon (0: max_steps)")
    p.add_argument("--test_chunk_size", type=int, default=4096)
    p.add_argument("--eval_views", type=int, default=2)
    p.add_argument("--coarse_stride", type=int, default=1,
                   help="occupancy-probe stride (1: exact per sample)")
    p.add_argument("--probe_groups", type=int, default=0,
                   help="adaptive-stride probing: probe groups per ray "
                   "(0: fixed stride)")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--train_views", type=int, default=24,
                   help="training views, each at its own timestamp")
    p.add_argument("--warp_depth", type=int, default=4)
    p.add_argument("--warp_width", type=int, default=64)
    p.add_argument("--time_degree", type=int, default=4)
    p.add_argument("--warp_reg_mag", type=float, default=0.0,
                   help="weight of the mean squared warp displacement at "
                   "random points and times")
    p.add_argument("--warp_reg_smooth", type=float, default=0.0,
                   help="weight of the mean squared change of the warp "
                   "displacement over dt = 0.05")
    p.add_argument("--seed", type=int, default=42,
                   help="field init, stratified jitter, grid-update cells "
                   "and times, and the warp penalties' points")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def alpha_thre(step: int) -> float:
    """The training render's alpha threshold: 0 up to step 1000, then
    0.01."""
    return 0.01 if step > 1000 else 0.0


class Trainer:
    """The scene, field, grid, optimizer and render settings of one run,
    and its training step."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        dev = self.device = torch.device(args.device)
        self.scene = make_scene(args, dev)
        aabb = tuple(float(v) for v in self.scene.aabb.cpu())
        self.field = DNeRFRadianceField(
            warp_depth=args.warp_depth, warp_width=args.warp_width,
            time_degree=args.time_degree,
            generator=torch.Generator().manual_seed(args.seed), device=dev)
        self.grid = create_grid(aabb, resolution=args.grid_resolution,
                                device=dev)
        self.optimizer = torch.optim.Adam(self.field.parameters(), lr=args.lr)
        self.schedule = multistep_lr(self.optimizer,
                                     args.sched_steps or args.max_steps)
        # the stratified jitter, the grid update's cells, jitter and times,
        # and the warp penalties' points
        self.generator = torch.Generator(device=dev).manual_seed(args.seed)
        self.render_kwargs = dict(
            scene_aabb=aabb, render_step_size=args.render_step_size,
            cone_angle=0.0, max_samples_per_ray=args.max_samples_per_ray,
            samples_budget=args.samples_budget,
            coarse_stride=args.coarse_stride,
            probe_groups=args.probe_groups or None,
        )
        self._aabb = self.scene.aabb

    def update_grid(self, step: int) -> None:
        """The occupancy update of step ``step`` (every cell below 256),
        each cell at one training timestamp drawn at random."""
        times = self.scene.timestamps[:, None]
        self.grid = update_grid(
            self.grid, self.generator, step=0 if step < 256 else 10**9,
            occ_eval_fn=lambda x: self.field.query_opacity(
                x, times, self.args.render_step_size, self.generator),
            occ_thre=1e-2)

    def warp_penalty(self) -> torch.Tensor:
        """The warp penalties at WARP_REG_POINTS uniform points of the box
        and times in [0, 1)."""
        g = self.generator
        lo, hi = self._aabb[:3], self._aabb[3:]
        u = torch.rand((WARP_REG_POINTS, 3), generator=g, device=g.device)
        x = lo + u.to(self.device) * (hi - lo)
        t = torch.rand((WARP_REG_POINTS, 1), generator=g,
                       device=g.device).to(self.device)
        return warp_regularizer(self.field, x, t, self.args.warp_reg_mag,
                                self.args.warp_reg_smooth)

    def train_step(self, rays_o, rays_d, pixels, timestamps, step: int):
        """One optimizer step on a ray batch at its rays' times; returns
        ``(loss, live samples)`` as tensors (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        colors, opacities, _, n = render_rays(
            self.field, rays_o, rays_d, grid=self.grid,
            render_bkgd=self.scene.bkgd, stratified=True, key=self.generator,
            timestamps=timestamps, alpha_thre=alpha_thre(step),
            **self.render_kwargs)
        loss = hit_ray_loss(colors, pixels, opacities)
        if self.args.warp_reg_mag > 0 or self.args.warp_reg_smooth > 0:
            loss = loss + self.warp_penalty()
        loss.backward()
        self.optimizer.step()
        self.schedule.step()
        return loss.detach(), n

    def evaluate(self, n_views: int) -> list:
        """PSNR of ``n_views`` held-out views at their times, rendered
        exactly on a white background with ``alpha_thre`` 0.01."""
        scene = self.scene
        kw = dict(self.render_kwargs, coarse_stride=1)
        psnrs = []
        for i in range(min(n_views, scene.test_poses.shape[0])):
            rays = scene.rays_for_view(scene.test_poses[i])
            t = torch.full((rays.origins.shape[0], 1),
                           float(scene.test_timestamps[i]),
                           device=self.device)
            colors, _, _ = render_image(
                self.field, rays.origins, rays.viewdirs, grid=self.grid,
                render_bkgd=torch.ones(3, device=self.device), timestamps=t,
                test_chunk_size=self.args.test_chunk_size, alpha_thre=0.01,
                **kw)
            mse = float(torch.mean(
                (colors - scene.test_images[i].reshape(-1, 3)) ** 2))
            psnrs.append(-10.0 * math.log10(mse))
        return psnrs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train and evaluate; prints the JAX trainer's log lines, ``PSNR:``
    and ``train_time_s:`` (the whole run less the ``--eval_every``
    renders), and returns the run's numbers as the TensoCP twin's ``main``
    does (no field budget here: ``field_budget_dropped`` is 0) and the
    ``trainer``."""
    args = parse_args(argv)
    trainer = Trainer(args)
    total_samples = torch.zeros((), dtype=torch.int64, device=trainer.device)
    eval_s = 0.0
    _sync(trainer.device)
    t_start = time.perf_counter()
    for step in range(args.max_steps):
        if step % 16 == 0:
            trainer.update_grid(step)
        rays, pixels, timestamps = trainer.scene.sample_batch(args.num_rays)
        loss, n = trainer.train_step(rays.origins, rays.viewdirs, pixels,
                                     timestamps, step)
        total_samples += n
        if step % 1000 == 0 or step == args.max_steps - 1:
            el = time.perf_counter() - t_start
            print(f"step={step} loss={float(loss):.5f} n_samples={int(n)} "
                  f"elapsed={el:.1f}s")
        if args.eval_every > 0 and step > 0 and step % args.eval_every == 0:
            e0 = time.perf_counter()
            v = trainer.evaluate(1)
            eval_s += time.perf_counter() - e0
            print(f"eval@{step}: {v[0]:.2f}")
    _sync(trainer.device)
    loop_s = time.perf_counter() - t_start - eval_s
    psnrs = trainer.evaluate(args.eval_views)
    train_time = time.perf_counter() - t_start - eval_s
    print(f"PSNR: {np.mean(psnrs):.2f} (views: {[f'{x:.2f}' for x in psnrs]})")
    print(f"train_time_s: {train_time:.1f}")
    return dict(psnr=float(np.mean(psnrs)), psnrs=psnrs,
                train_time_s=train_time, loop_s=loop_s,
                samples=int(total_samples), field_budget_dropped=0,
                steps=args.max_steps, trainer=trainer)


if __name__ == "__main__":
    main()
