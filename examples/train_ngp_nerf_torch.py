"""Train a TensoCP or hash-NGP radiance field on the procedural scene with
nerfacc_tpu_torch (PyTorch, hand-written CUDA kernels for Hopper).

The twin of ``examples/train_ngp_nerf.py`` in its bounded configuration:
its flags and defaults (no cone stepping, the adaptive occupancy
threshold, held-out views only), Adam (lr 1e-2, eps 1e-15, optional cosine
decay to 0.1x), the occupancy grid updated every 16 steps (every cell
below step 256, then a quarter uniform and a quarter occupied; threshold
1e-2, adaptive), the Huber loss over the rays that hit something, and the
held-out PSNR at the end. The flagship (TensoCP) drive:

    python examples/train_ngp_nerf_torch.py --max_steps 1000 \\
      --num_rays 8192 --image_size 128 --grid_resolution 128 \\
      --samples_budget 262144 --visible_samples_budget 131072 \\
      --test_chunk_size 4096 --eval_views 3 --use_kernel --fused_march

and the NGP drive (``--model ngp``: 16 levels x 2 features x 2^19 entries;
the field is evaluated on the live slots only, half the sample budget):

    python examples/train_ngp_nerf_torch.py --model ngp --max_steps 200 \\
      --num_rays 4096 --image_size 96 --grid_resolution 96 \\
      --samples_budget 131072 --visible_samples_budget 16384 \\
      --test_chunk_size 2048 --eval_views 2 --use_kernel --fused_march

``--use_kernel`` sends the CP levels through the CUDA kernels K2 / K4 (and
K1 where no gradient is taken), or the hash table's gradient through K7;
``--fused_march`` the march selection and re-selection through K5 / K6;
without them the plain PyTorch paths run. ``--ckpt_dir`` saves the run
every ``--ckpt_every`` steps and at its end, and resumes from the latest
checkpoint there. It runs on the CUDA device unless ``--device cpu`` is
given. Unbounded scenes, the on-disk datasets, the extra regularisers and
``--quant_int8`` are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nerfacc_tpu_torch import create_grid, render_image, render_rays  # noqa: E402
from nerfacc_tpu_torch import update_grid, with_binary  # noqa: E402
from nerfacc_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from nerfacc_tpu_torch.datasets import ProceduralScene  # noqa: E402
from nerfacc_tpu_torch.models import (  # noqa: E402
    NGPRadianceField,
    TensoCPRadianceField,
)
from nerfacc_tpu_torch.training import hit_ray_loss  # noqa: E402
from nerfacc_tpu_torch.utils import DynamicRayBucketer  # noqa: E402

# the flagship drive's flags (the kernels are chosen apart)
FLAGSHIP = ("--max_steps", "1000", "--num_rays", "8192",
            "--image_size", "128", "--grid_resolution", "128",
            "--samples_budget", "262144", "--visible_samples_budget", "131072",
            "--test_chunk_size", "4096", "--eval_views", "3")
# the NGP drive's flags (the kernels are chosen apart)
NGP = ("--model", "ngp", "--max_steps", "200", "--num_rays", "4096",
       "--image_size", "96", "--grid_resolution", "96",
       "--samples_budget", "131072", "--visible_samples_budget", "16384",
       "--test_chunk_size", "2048", "--eval_views", "2")
KERNELS = ("--use_kernel", "--fused_march")

# the options of the JAX trainer this one lacks: (flag, ROADMAP.md Queue 1
# item that ports it)
_NOT_PORTED = (
    ("unbounded", "item 10 (proposal and unbounded)"),
    ("data_root", "item 12 (datasets)"),
    ("distortion_loss", "item 10 (proposal and unbounded)"),
    ("opacity_entropy", "item 10 (proposal and unbounded)"),
    ("quant_int8", "item 14 (measured-rejected knobs)"),
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", type=str, default="procedural")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--unbounded", action="store_true")
    p.add_argument("--max_steps", type=int, default=20000)
    p.add_argument("--num_rays", type=int, default=8192)
    p.add_argument("--grid_resolution", type=int, default=128)
    p.add_argument("--max_samples_per_ray", type=int, default=1024)
    p.add_argument("--samples_budget", type=int, default=1 << 18)
    p.add_argument("--visible_samples_budget", type=int, default=1 << 16)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--test_chunk_size", type=int, default=8192)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--train_views", type=int, default=24)
    p.add_argument("--levels", type=str, default="128x64,512x128",
                   help="TensoCP levels: comma-separated GRIDxRANK")
    p.add_argument("--lr_decay", action="store_true",
                   help="cosine lr decay to 0.1x over max_steps")
    p.add_argument("--eval_views", type=int, default=2)
    p.add_argument("--quant_int8", action="store_true")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="save every --ckpt_every steps and at the end, and "
                   "resume from the latest checkpoint there")
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42,
                   help="field init, stratified jitter and grid-update cells")
    p.add_argument("--target_sample_batch_size", type=int, default=0,
                   help="if > 0, adapt the ray batch on a ladder of sizes "
                   "to keep the live samples per batch near this target")
    p.add_argument("--model", type=str, default="tensorf",
                   choices=["ngp", "tensorf"])
    p.add_argument("--distortion_loss", type=float, default=0.0)
    p.add_argument("--opacity_entropy", type=float, default=0.0)
    p.add_argument("--compact_rays", type=float, default=0.0,
                   help="if > 0, drop rays that hit no occupancy and spread "
                   "the sample budget over this fraction of the batch")
    p.add_argument("--probe_dilation", type=int, default=2)
    p.add_argument("--exact_recheck", type=int, default=1)
    p.add_argument("--probe_groups", type=int, default=0)
    p.add_argument("--coarse_stride", type=int, default=8)
    p.add_argument("--field_budget_ratio", type=float, default=-1.0,
                   help="evaluate the field on ratio * samples_budget live "
                   "slots (-1: 0.5 for ngp, off for tensorf)")
    p.add_argument("--occ_ema_decay", type=float, default=0.95)
    p.add_argument("--fused_march", action="store_true",
                   help="march selection and re-selection through the CUDA "
                   "kernels K5 / K6")
    p.add_argument("--use_kernel", action="store_true",
                   help="the CP levels through the CUDA kernels K1 / K2 / "
                   "K4, or the hash table's gradient through K7")
    p.add_argument("--ngp_gather_mode", type=str, default="packed",
                   choices=["packed", "per_level"])
    p.add_argument("--ngp_log2_size", type=int, default=19,
                   help="--model ngp: log2 hash-table entries per level")
    p.add_argument("--ngp_levels", type=int, default=16,
                   help="--model ngp: number of hash levels")
    p.add_argument("--ngp_features", type=int, default=2,
                   help="--model ngp: features per level")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _check_ported(args) -> None:
    if args.model == "ngp" and args.ngp_gather_mode == "per_level":
        raise NotImplementedError(
            "--ngp_gather_mode per_level is not ported: ROADMAP.md Queue 1 "
            "item 14 (measured-rejected knobs)")
    if args.model == "ngp" and args.use_kernel and args.ngp_features != 2:
        raise ValueError(
            f"--ngp_features {args.ngp_features} with --use_kernel: the "
            "table-gradient kernel adds feature pairs, and the JAX "
            "package's pallas_grad fails the same way for F != 2 (a defect "
            "of the reference, ROADMAP.md Queue 3); drop --use_kernel")
    if args.scene != "procedural":
        raise NotImplementedError(
            f"--scene {args.scene}: only the procedural scene is ported "
            "(the others: ROADMAP.md Queue 1 items 10 and 12)")
    for flag, item in _NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet: ROADMAP.md Queue 1 {item}")


class Trainer:
    """The scene, field, grid, optimizer and render settings of one run,
    and its training step."""

    def __init__(self, args: argparse.Namespace):
        _check_ported(args)
        self.args = args
        dev = self.device = torch.device(args.device)
        self.scene = ProceduralScene(
            n_views=args.train_views, width=args.image_size,
            height=args.image_size, device=dev)
        aabb = tuple(float(v) for v in self.scene.aabb.cpu())
        # bounded: step = diag * sqrt(3) / 1024 (train_ngp_nerf.py:149-153)
        self.step_size = math.dist(aabb[:3], aabb[3:]) * math.sqrt(3) / 1024
        init = torch.Generator().manual_seed(args.seed)
        if args.model == "ngp":
            self.field = NGPRadianceField(
                aabb=aabb, gather_mode=args.ngp_gather_mode,
                log2_hashmap_size=args.ngp_log2_size,
                n_levels=args.ngp_levels, n_features=args.ngp_features,
                pallas_grad=args.use_kernel, generator=init, device=dev)
        else:
            levels = tuple(tuple(int(v) for v in lv.split("x"))
                           for lv in args.levels.split(","))
            self.field = TensoCPRadianceField(
                aabb=aabb, levels=levels, use_kernel=args.use_kernel,
                generator=init, device=dev)
        self.grid = create_grid(aabb, resolution=args.grid_resolution,
                                device=dev)
        self.optimizer = torch.optim.Adam(self.field.parameters(), lr=args.lr,
                                          eps=1e-15)
        # optax.cosine_decay_schedule(lr, max_steps, 0.1)
        decay = (lambda t: 0.9 * 0.5 * (1.0 + math.cos(
            math.pi * min(t, args.max_steps) / args.max_steps)) + 0.1)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, decay if args.lr_decay else (lambda t: 1.0))
        # the stratified jitter and the grid update's cells and jitter
        self.generator = torch.Generator(device=dev).manual_seed(args.seed)
        self.render_kwargs = dict(
            scene_aabb=aabb, render_step_size=self.step_size,
            max_samples_per_ray=args.max_samples_per_ray,
            samples_budget=args.samples_budget,
            coarse_stride=args.coarse_stride,
            probe_dilation=args.probe_dilation,
            compact_rays_fraction=args.compact_rays or None,
            visible_samples_budget=args.visible_samples_budget,
            exact_recheck=bool(args.exact_recheck),
            probe_groups=args.probe_groups or None,
            use_pallas=True if args.fused_march else None,
        )
        self.field_ratio = args.field_budget_ratio
        if self.field_ratio < 0:  # auto: the hash field is gather-bound
            self.field_ratio = 0.5 if args.model == "ngp" else 0.0
        if self.field_ratio > 0:
            self.render_kwargs["field_samples_budget"] = int(
                args.samples_budget * self.field_ratio)
        # a growing batch keeps the slots per ray of the base configuration
        self._slots = -(-args.samples_budget // args.num_rays)
        self._visible_slots = -(-args.visible_samples_budget // args.num_rays)

    def bucket_kwargs(self, n_rays: int) -> dict:
        """The render settings for a batch of ``n_rays`` rays."""
        if self.args.target_sample_batch_size <= 0:
            return self.render_kwargs
        kw = dict(self.render_kwargs, samples_budget=n_rays * self._slots,
                  visible_samples_budget=n_rays * self._visible_slots)
        if "field_samples_budget" in kw:
            kw["field_samples_budget"] = int(
                n_rays * self._slots * self.field_ratio)
        return kw

    def update_grid(self, step: int) -> None:
        """The occupancy update of step ``step`` (every cell below 256)."""
        self.grid = update_grid(
            self.grid, self.generator, step=0 if step < 256 else 10**9,
            occ_eval_fn=lambda x: self.field.query_opacity(x, self.step_size),
            occ_thre=1e-2, ema_decay=self.args.occ_ema_decay)

    def state(self, step: int) -> dict:
        """What a checkpoint of step ``step`` holds: the field's, the
        optimizer's and the schedule's state, the grid's tensors, the
        generator's state and the scene's numpy RNG state."""
        _, keys, pos, has_gauss, cached = self.scene._rng.get_state()
        return {
            "field": self.field.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "schedule": self.schedule.state_dict(),
            "grid": {"occs": self.grid.occs, "binary": self.grid.binary},
            "generator": self.generator.get_state(),
            "scene_rng": (torch.as_tensor(keys.astype(np.int64)), pos,
                          has_gauss, cached),
            "step": step,
        }

    def load_state(self, state: dict) -> int:
        """Restore ``state``; returns its step."""
        self.field.load_state_dict(state["field"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.schedule.load_state_dict(state["schedule"])
        self.grid = with_binary(
            dataclasses.replace(self.grid,
                                occs=state["grid"]["occs"].to(self.device)),
            state["grid"]["binary"])
        self.generator.set_state(state["generator"])
        keys, pos, has_gauss, cached = state["scene_rng"]
        self.scene._rng.set_state(("MT19937", keys.numpy().astype(np.uint32),
                                   pos, has_gauss, cached))
        return int(state["step"])

    def train_step(self, rays_o, rays_d, pixels):
        """One optimizer step on a ray batch; returns ``(loss, live
        samples, field_budget_dropped)`` as tensors (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        colors, opacities, _, n, extras = render_rays(
            self.field, rays_o, rays_d, grid=self.grid,
            render_bkgd=self.scene.bkgd, stratified=True, key=self.generator,
            return_extras=True, **self.bucket_kwargs(rays_o.shape[0]))
        loss = hit_ray_loss(colors, pixels, opacities)
        loss.backward()
        self.optimizer.step()
        self.schedule.step()
        return loss.detach(), n, extras["field_budget_dropped"]

    def evaluate(self, n_views: int) -> list:
        """PSNR of ``n_views`` held-out views, rendered exactly
        (``coarse_stride=1``) on a white background."""
        scene = self.scene
        poses, images = scene.test_poses, scene.test_images
        kw = dict(self.render_kwargs, coarse_stride=1)
        psnrs = []
        for i in range(min(n_views, poses.shape[0])):
            rays = scene.rays_for_view(poses[i])
            colors, _, _ = render_image(
                self.field, rays.origins, rays.viewdirs, grid=self.grid,
                render_bkgd=torch.ones(3, device=self.device),
                test_chunk_size=self.args.test_chunk_size,
                eval_visible_samples_per_ray=64, **kw)
            mse = float(torch.mean((colors - images[i].reshape(-1, 3)) ** 2))
            psnrs.append(-10.0 * math.log10(mse))
        return psnrs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train and evaluate; prints the JAX trainer's log lines, ``PSNR:``
    and ``train_time_s:``, and returns the run's numbers: the PSNRs, the
    seconds of the training loop and of the whole run (evaluation
    included, as ``train_time_s``), the live samples summed over the steps
    and the field budget's drops."""
    args = parse_args(argv)
    trainer = Trainer(args)
    bucketer = (DynamicRayBucketer(args.target_sample_batch_size,
                                   init_num_rays=args.num_rays)
                if args.target_sample_batch_size > 0 else None)
    num_rays = args.num_rays
    ckpt, start_step = None, 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if ckpt.latest_step() is not None:
            start_step = trainer.load_state(ckpt.restore()) + 1
            print(f"resumed from step {start_step - 1}")
    total_samples = torch.zeros((), dtype=torch.int64, device=trainer.device)
    total_dropped = torch.zeros((), dtype=torch.int64, device=trainer.device)
    _sync(trainer.device)
    t_start = time.perf_counter()
    for step in range(start_step, args.max_steps):
        if step % 16 == 0:
            trainer.update_grid(step)
        rays, pixels = trainer.scene.sample_batch(num_rays)
        loss, n, dropped = trainer.train_step(rays.origins, rays.viewdirs,
                                              pixels)
        total_samples += n
        total_dropped += dropped
        if step == 0 and int(dropped) > 0:
            print(f"WARNING: field_samples_budget trims {int(dropped)} live "
                  "samples on step 0; raise --field_budget_ratio")
        if bucketer is not None:
            num_rays = bucketer.update(int(n), num_rays)
        if ckpt is not None and (step % args.ckpt_every == 0
                                 or step == args.max_steps - 1):
            ckpt.save(step, trainer.state(step))
        if step % 1000 == 0 or step == args.max_steps - 1:
            el = time.perf_counter() - t_start
            print(f"step={step} loss={float(loss):.5f} n_samples={int(n)} "
                  f"elapsed={el:.1f}s"
                  + (f" budget_dropped={int(dropped)}" if int(dropped)
                     else ""))
    _sync(trainer.device)
    loop_s = time.perf_counter() - t_start
    n_test = trainer.scene.test_poses.shape[0]
    print(f"eval: {min(args.eval_views, n_test)} of {n_test} test poses "
          f"({args.image_size}x{args.image_size})")
    psnrs = trainer.evaluate(args.eval_views)
    train_time = time.perf_counter() - t_start
    print(f"PSNR: {np.mean(psnrs):.2f} (views: {[f'{x:.2f}' for x in psnrs]})")
    print(f"train_time_s: {train_time:.1f}")
    return dict(psnr=float(np.mean(psnrs)), psnrs=psnrs,
                train_time_s=train_time, loop_s=loop_s,
                samples=int(total_samples),
                field_budget_dropped=int(total_dropped),
                steps=args.max_steps - start_step)


if __name__ == "__main__":
    main()
