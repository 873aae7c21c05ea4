"""Train a vanilla NeRF on the procedural scene or an on-disk blender
dataset with nerfacc_tpu_torch (PyTorch on the card).

The twin of ``examples/train_mlp_nerf.py``: its flags and defaults, the
vanilla field (an 8 x 256 f32 trunk, ``nn.Linear`` in cuBLAS), Adam at
lr 5e-4 with PyTorch's default eps, the learning rate times 0.33 at 1/2,
3/4 and 9/10 of the steps, the occupancy grid updated every 16 steps
(every cell below step 256, then a quarter uniform and a quarter
occupied; threshold 1e-2), the Huber loss over the rays that hit
something, exact marching (``coarse_stride`` 1), and the held-out PSNR on
the scene's background at the end. The drive:

    python examples/train_mlp_nerf_torch.py --max_steps 300 \\
      --num_rays 1024 --image_size 64 --grid_resolution 64 \\
      --max_samples_per_ray 512 --samples_budget 32768 \\
      --test_chunk_size 1024 --eval_views 2

It runs on the CUDA device unless ``--device cpu`` is given. A given
``--data_root`` always trains through the blender loader (the subject
``--scene`` under it), with its test split's views for the evaluation, as
the JAX trainer does.
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
from nerfacc_tpu_torch.datasets import ProceduralScene  # noqa: E402
from nerfacc_tpu_torch.datasets import nerf_synthetic  # noqa: E402
from nerfacc_tpu_torch.models import VanillaNeRFRadianceField  # noqa: E402
from nerfacc_tpu_torch.training import hit_ray_loss, multistep_lr  # noqa: E402

# the drive's flags (.claude/skills/verify/SKILL.md)
DRIVE = ("--max_steps", "300", "--num_rays", "1024", "--image_size", "64",
         "--grid_resolution", "64", "--max_samples_per_ray", "512",
         "--samples_budget", "32768", "--test_chunk_size", "1024",
         "--eval_views", "2")


def make_scene(args, device):
    """The procedural scene where no ``--data_root`` is given, else the
    blender loader of ``--scene`` under it, whose test split's poses and
    images replace the train loader's."""
    if args.data_root is None:
        if args.scene != "procedural":
            raise ValueError(f"--scene {args.scene} needs --data_root")
        return ProceduralScene(width=args.image_size, height=args.image_size,
                               device=device)
    kw = dict(subject_id=args.scene, root_fp=args.data_root, device=device)
    scene = nerf_synthetic.SubjectLoader(split="train", **kw)
    test = nerf_synthetic.SubjectLoader(split="test", **kw)
    scene.test_poses, scene.test_images = test.test_poses, test.test_images
    return scene


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", type=str, default="procedural")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--max_steps", type=int, default=5000)
    p.add_argument("--num_rays", type=int, default=1024)
    p.add_argument("--grid_resolution", type=int, default=128)
    p.add_argument("--render_step_size", type=float, default=5e-3)
    p.add_argument("--max_samples_per_ray", type=int, default=1024)
    p.add_argument("--samples_budget", type=int, default=1 << 16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--test_chunk_size", type=int, default=4096)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--eval_views", type=int, default=2)
    p.add_argument("--coarse_stride", type=int, default=1,
                   help="occupancy-probe stride (1: exact per sample)")
    p.add_argument("--probe_groups", type=int, default=0,
                   help="adaptive-stride probing: probe groups per ray "
                   "(0: fixed stride)")
    p.add_argument("--seed", type=int, default=42,
                   help="field init, stratified jitter and grid-update cells")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


class Trainer:
    """The scene, field, grid, optimizer and render settings of one run,
    and its training step."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        dev = self.device = torch.device(args.device)
        self.scene = make_scene(args, dev)
        aabb = tuple(float(v) for v in self.scene.aabb.cpu())
        self.field = VanillaNeRFRadianceField(
            generator=torch.Generator().manual_seed(args.seed), device=dev)
        self.grid = create_grid(aabb, resolution=args.grid_resolution,
                                device=dev)
        self.optimizer = torch.optim.Adam(self.field.parameters(), lr=args.lr)
        self.schedule = multistep_lr(self.optimizer, args.max_steps)
        # the stratified jitter and the grid update's cells and jitter
        self.generator = torch.Generator(device=dev).manual_seed(args.seed)
        self.render_kwargs = dict(
            scene_aabb=aabb, render_step_size=args.render_step_size,
            cone_angle=0.0, alpha_thre=0.0,
            max_samples_per_ray=args.max_samples_per_ray,
            samples_budget=args.samples_budget,
            coarse_stride=args.coarse_stride,
            probe_groups=args.probe_groups or None,
        )

    def update_grid(self, step: int) -> None:
        """The occupancy update of step ``step`` (every cell below 256)."""
        self.grid = update_grid(
            self.grid, self.generator, step=0 if step < 256 else 10**9,
            occ_eval_fn=lambda x: self.field.query_opacity(
                x, self.args.render_step_size),
            occ_thre=1e-2)

    def train_step(self, rays_o, rays_d, pixels):
        """One optimizer step on a ray batch; returns ``(loss, live
        samples)`` as tensors (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        colors, opacities, _, n = render_rays(
            self.field, rays_o, rays_d, grid=self.grid,
            render_bkgd=self.scene.bkgd, stratified=True, key=self.generator,
            **self.render_kwargs)
        loss = hit_ray_loss(colors, pixels, opacities)
        loss.backward()
        self.optimizer.step()
        self.schedule.step()
        return loss.detach(), n

    def evaluate(self, n_views: int) -> list:
        """PSNR of ``n_views`` held-out views, rendered exactly on the
        scene's background."""
        scene = self.scene
        kw = dict(self.render_kwargs, coarse_stride=1)
        psnrs = []
        for i in range(min(n_views, scene.test_poses.shape[0])):
            rays = scene.rays_for_view(scene.test_poses[i])
            colors, _, _ = render_image(
                self.field, rays.origins, rays.viewdirs, grid=self.grid,
                render_bkgd=scene.bkgd,
                test_chunk_size=self.args.test_chunk_size, **kw)
            mse = float(torch.mean(
                (colors - scene.test_images[i].reshape(-1, 3)) ** 2))
            psnrs.append(-10.0 * math.log10(mse))
        return psnrs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train and evaluate; prints the JAX trainer's log lines, ``PSNR:``
    and ``train_time_s:``, and returns the run's numbers as the TensoCP
    twin's ``main`` does (no field budget here: ``field_budget_dropped``
    is 0) and the ``trainer``."""
    args = parse_args(argv)
    trainer = Trainer(args)
    total_samples = torch.zeros((), dtype=torch.int64, device=trainer.device)
    _sync(trainer.device)
    t_start = time.perf_counter()
    for step in range(args.max_steps):
        if step % 16 == 0:
            trainer.update_grid(step)
        rays, pixels = trainer.scene.sample_batch(args.num_rays)
        loss, n = trainer.train_step(rays.origins, rays.viewdirs, pixels)
        total_samples += n
        if step % 500 == 0 or step == args.max_steps - 1:
            el = time.perf_counter() - t_start
            print(f"step={step} loss={float(loss):.5f} n_samples={int(n)} "
                  f"elapsed={el:.1f}s")
    _sync(trainer.device)
    loop_s = time.perf_counter() - t_start
    psnrs = trainer.evaluate(args.eval_views)
    train_time = time.perf_counter() - t_start
    print(f"PSNR: {np.mean(psnrs):.2f} (views: {[f'{x:.2f}' for x in psnrs]})")
    print(f"train_time_s: {train_time:.1f}")
    return dict(psnr=float(np.mean(psnrs)), psnrs=psnrs,
                train_time_s=train_time, loop_s=loop_s,
                samples=int(total_samples), field_budget_dropped=0,
                steps=args.max_steps, trainer=trainer)


if __name__ == "__main__":
    main()
