"""Train a TensoCP or hash-NGP radiance field on the procedural scene or an
on-disk dataset with nerfacc_tpu_torch (PyTorch, hand-written CUDA kernels
for Hopper).

The twin of ``examples/train_ngp_nerf.py``: its flags and defaults, Adam
(lr 1e-2, eps 1e-15, optional cosine decay to 0.1x), the occupancy grid
updated every 16 steps (every cell below step 256, then a quarter uniform
and a quarter occupied; threshold 1e-2, adaptive unless
``--fixed_occ_thre``), the Huber loss over the rays that hit something
(over every ray on a scene without a background), the optional
distortion and opacity-entropy terms, and the held-out PSNR at the end.
``--unbounded`` is the JAX trainer's grid-unbounded recipe: a 256^3
sphere-contracted grid, no scene box, near 0.2 and far 1e4, step 1e-2,
cone 0.004, ``alpha_thre`` 1e-2, the lattice auto-sized to cover [near,
far] and the distortion in normalised disparity. The flagship (TensoCP)
drive:

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

and the grid-unbounded drive (``U360``):

    python examples/train_ngp_nerf_torch.py --scene procedural360 \
      --unbounded --max_steps 2000 --num_rays 4096 --image_size 96 \
      --grid_resolution 256 --samples_budget 524288 \
      --visible_samples_budget 262144 --test_chunk_size 2048 \
      --eval_views 3 --train_views 64 --coarse_stride 16 --probe_groups 32 \
      --fixed_occ_thre 0 --occ_cone_coupling 0 --distortion_loss 0.03 \
      --use_kernel --fused_march

``--use_kernel`` sends the CP levels through the CUDA kernels K2 / K4 (and
K1 where no gradient is taken), or the hash table's gradient through K7;
``--fused_march`` the march selection and re-selection through K5 / K6;
without them the plain PyTorch paths run. ``--ckpt_dir`` saves the run
every ``--ckpt_every`` steps and at its end, and resumes from the latest
checkpoint there. It runs on the CUDA device unless ``--device cpu`` is
given. A given ``--data_root`` always trains through an on-disk loader,
as the JAX trainer does: the COLMAP one (``nerf_360_v2``) for the
MipNeRF-360 scene names or ``--dataset 360``, the blender one otherwise
(``--factor`` downsamples; 0 keeps the loader's default), with the test
split's views for the evaluation. ``--quant_int8`` takes the TensoCP
levels' products in int8 steps (before ``--use_kernel``, as the JAX
trainer does), and ``--ngp_gather_mode per_level`` gathers each hash level
from its own slice of the table (the packed gather's values).
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

from nerfacc_tpu_torch import (  # noqa: E402
    ContractionType,
    create_grid,
    loss_distortion_dense,
    render_image,
    render_rays,
    samples_needed_for_range,
    update_grid,
    with_binary,
)
from nerfacc_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from nerfacc_tpu_torch.datasets import (  # noqa: E402
    Procedural360Scene,
    ProceduralScene,
    nerf_360_v2,
    nerf_synthetic,
)
from nerfacc_tpu_torch.models import (  # noqa: E402
    NGPRadianceField,
    TensoCPRadianceField,
)
from nerfacc_tpu_torch.training import (  # noqa: E402
    cosine_lr,
    huber,
    hit_ray_loss,
    normalized_disparity,
)
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
# the grid-unbounded drive's flags (scripts/run_round4_until_done.sh U360;
# the kernels are chosen apart)
U360 = ("--scene", "procedural360", "--unbounded", "--max_steps", "2000",
        "--num_rays", "4096", "--image_size", "96",
        "--grid_resolution", "256", "--samples_budget", "524288",
        "--visible_samples_budget", "262144", "--test_chunk_size", "2048",
        "--eval_views", "3", "--train_views", "64", "--coarse_stride", "16",
        "--probe_groups", "32", "--fixed_occ_thre", "0",
        "--occ_cone_coupling", "0", "--distortion_loss", "0.03")
KERNELS = ("--use_kernel", "--fused_march")

# MipNeRF-360 capture names: these route --data_root through the COLMAP
# loader under --dataset auto
_MIPNERF360_SCENES = (
    "garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump",
)
# the lattice the unbounded recipe may auto-size to, at most
_AUTO_SAMPLES_CAP = 8192


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", type=str, default="procedural")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--dataset", type=str, default="auto",
                   choices=["auto", "blender", "360"])
    p.add_argument("--unbounded", action="store_true",
                   help="the grid-unbounded recipe (sphere contraction, cone "
                   "stepping over [near, far], no scene box)")
    p.add_argument("--factor", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=20000)
    p.add_argument("--num_rays", type=int, default=8192)
    p.add_argument("--grid_resolution", type=int, default=None,
                   help="occupancy grid resolution (default: 128 bounded, "
                   "256 unbounded)")
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
    p.add_argument("--cone_angle", type=float, default=None,
                   help="per-ray step growth (default: 0 bounded, 0.004 "
                   "unbounded)")
    p.add_argument("--quant_int8", action="store_true",
                   help="TensoCP: the levels' products in int8 steps, the "
                   "tables' gradients exact in bf16 (before --use_kernel)")
    p.add_argument("--auto_aabb", action="store_true",
                   help="bound the scene by the camera positions")
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
    p.add_argument("--distortion_loss", type=float, default=0.0,
                   help="weight of the MipNeRF-360 distortion loss on the "
                   "rendered weights (in normalised disparity when "
                   "--unbounded)")
    p.add_argument("--compact_rays", type=float, default=0.0,
                   help="if > 0, drop rays that hit no occupancy and spread "
                   "the sample budget over this fraction of the batch")
    p.add_argument("--probe_dilation", type=int, default=2)
    p.add_argument("--exact_recheck", type=int, default=1)
    p.add_argument("--probe_groups", type=int, default=0)
    p.add_argument("--coarse_stride", type=int, default=8)
    p.add_argument("--far_plane", type=float, default=0.0,
                   help="the unbounded far plane (0: 1e4)")
    p.add_argument("--near_plane", type=float, default=0.0,
                   help="the unbounded near plane (0: 0.2)")
    p.add_argument("--fixed_occ_thre", type=int, default=0,
                   help="binarize the grid at the fixed threshold after "
                   "warm-up instead of min(mean(occs), 1e-2)")
    p.add_argument("--occ_cone_coupling", type=int, default=0,
                   help="the occupancy estimate times the cone step at the "
                   "cell's distance from a random training camera")
    p.add_argument("--field_budget_ratio", type=float, default=-1.0,
                   help="evaluate the field on ratio * samples_budget live "
                   "slots (-1: 0.5 for ngp, off for tensorf)")
    p.add_argument("--distortion_warmup", type=int, default=0,
                   help="ramp the distortion weight in linearly over "
                   "[warmup, 2 warmup] steps (0: on from step 0)")
    p.add_argument("--eval_on_train_views", action="store_true",
                   help="score the evaluation on the training views")
    p.add_argument("--opacity_entropy", type=float, default=0.0,
                   help="weight of the binary entropy of each ray's opacity")
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


def _check_flags(args) -> None:
    if args.model == "ngp" and args.use_kernel and args.ngp_features != 2:
        raise ValueError(
            f"--ngp_features {args.ngp_features} with --use_kernel: the "
            "table-gradient kernel adds feature pairs, and the JAX "
            "package's pallas_grad fails the same way for F != 2 (a defect "
            "of the reference, ROADMAP.md Queue 3); drop --use_kernel")


def make_scene(args, device):
    """The run's scene: a procedural one where no ``--data_root`` is
    given, else the on-disk loader of ``--scene`` under ``--data_root``
    (COLMAP under ``--dataset 360``, or ``auto`` with a MipNeRF-360 scene
    name; blender otherwise), whose test split's poses and images replace
    the train loader's."""
    if args.data_root is None:
        if args.scene not in ("procedural", "procedural360"):
            raise ValueError(f"--scene {args.scene} needs --data_root")
        scene_cls = (Procedural360Scene if args.scene == "procedural360"
                     else ProceduralScene)
        return scene_cls(n_views=args.train_views, width=args.image_size,
                         height=args.image_size, device=device)
    is_360 = args.dataset == "360" or (args.dataset == "auto"
                                       and args.scene in _MIPNERF360_SCENES)
    loader = (nerf_360_v2 if is_360 else nerf_synthetic).SubjectLoader
    kw = dict(subject_id=args.scene, root_fp=args.data_root, device=device)
    if args.factor:
        kw["factor"] = args.factor
    scene = loader(split="train", **kw)
    test = loader(split="test", **kw)
    scene.test_poses, scene.test_images = test.test_poses, test.test_images
    return scene


def unbounded_lattice(args, near: float, far: float, step: float,
                      cone: float) -> None:
    """Size ``args.max_samples_per_ray`` to cover [near, far] (plus a
    probe group of jitter margin, a multiple of the stride) and raise
    ``args.probe_groups`` where its groups would truncate the lattice, as
    the JAX trainer does, with its messages."""
    S_need = samples_needed_for_range(near, far, step, cone)
    C = max(args.coarse_stride, 1)
    if args.max_samples_per_ray < S_need:
        if S_need <= _AUTO_SAMPLES_CAP:
            new_s = -(-(S_need + C) // C) * C
            print(f"[unbounded] max_samples_per_ray "
                  f"{args.max_samples_per_ray} cannot cover [near={near}, "
                  f"far={far}] at step={step}, cone={cone} (needs {S_need}); "
                  f"auto-raising to {new_s}")
            args.max_samples_per_ray = new_s
        else:
            print(f"WARNING: [unbounded] lattice needs {S_need} samples to "
                  f"cover [near={near}, far={far}] at step={step}, "
                  f"cone={cone} — beyond the {_AUTO_SAMPLES_CAP} auto-cap. "
                  "The far field is UNSAMPLABLE and training will collapse. "
                  + ("Set --cone_angle > 0: cone stepping is what makes "
                     "unbounded ranges coverable (reference default 0.004)."
                     if cone <= 0 else
                     "Raise --max_samples_per_ray, or shrink the range with "
                     "--near_plane/--far_plane (the unbounded base step is "
                     "fixed at 1e-2, the reference's)."))
    if args.probe_groups and args.probe_groups * C < args.max_samples_per_ray:
        new_g = -(-args.max_samples_per_ray // C)
        print(f"[unbounded] probe_groups {args.probe_groups} x stride {C} "
              f"truncates the {args.max_samples_per_ray}-sample lattice; "
              f"raising probe_groups to {new_g}")
        args.probe_groups = new_g


class Trainer:
    """The scene, field, grid, optimizer and render settings of one run,
    and its training step."""

    def __init__(self, args: argparse.Namespace):
        _check_flags(args)
        self.args = args
        dev = self.device = torch.device(args.device)
        self.scene = make_scene(args, dev)
        self.has_bkgd = self.scene.bkgd is not None
        # the training cameras' positions (the cone coupling's cameras)
        self.cam_origins = self.scene.train_poses[:, :3, -1]
        if args.auto_aabb:  # the box of the camera positions
            cams = torch.cat([self.cam_origins,
                              self.scene.test_poses[:, :3, -1]]).cpu()
            aabb = tuple(float(v) for v in cams.amin(0)) + tuple(
                float(v) for v in cams.amax(0))
            print("Using auto aabb", aabb)
        else:
            aabb = tuple(float(v) for v in self.scene.aabb.cpu())
        if args.unbounded:
            contraction = ContractionType.UN_BOUNDED_SPHERE
            self.near = args.near_plane or 0.2
            self.far = args.far_plane or 1e4
            self.step_size, alpha_thre = 1e-2, 1e-2
            self.cone = 0.004 if args.cone_angle is None else args.cone_angle
            grid_res = args.grid_resolution or 256
            scene_aabb = None
            unbounded_lattice(args, self.near, self.far, self.step_size,
                              self.cone)
        else:
            contraction = ContractionType.AABB
            self.near = self.far = None
            # step = diag * sqrt(3) / 1024 (train_ngp_nerf.py:149-153)
            self.step_size = (math.dist(aabb[:3], aabb[3:]) * math.sqrt(3)
                              / 1024)
            alpha_thre = 0.0
            self.cone = args.cone_angle or 0.0
            grid_res = args.grid_resolution or 128
            scene_aabb = aabb
        init = torch.Generator().manual_seed(args.seed)
        if args.model == "ngp":
            self.field = NGPRadianceField(
                aabb=aabb, unbounded=args.unbounded,
                gather_mode=args.ngp_gather_mode,
                log2_hashmap_size=args.ngp_log2_size,
                n_levels=args.ngp_levels, n_features=args.ngp_features,
                pallas_grad=args.use_kernel, generator=init, device=dev)
        else:
            levels = tuple(tuple(int(v) for v in lv.split("x"))
                           for lv in args.levels.split(","))
            self.field = TensoCPRadianceField(
                aabb=aabb, unbounded=args.unbounded, levels=levels,
                use_kernel=args.use_kernel, quant_int8=args.quant_int8,
                generator=init, device=dev)
        self.grid = create_grid(aabb, resolution=grid_res,
                                contraction_type=contraction, device=dev)
        self.optimizer = torch.optim.Adam(self.field.parameters(), lr=args.lr,
                                          eps=1e-15)
        self.schedule = (
            cosine_lr(self.optimizer, args.max_steps) if args.lr_decay
            else torch.optim.lr_scheduler.LambdaLR(self.optimizer,
                                                   lambda t: 1.0))
        # the stratified jitter and the grid update's cells and jitter
        self.generator = torch.Generator(device=dev).manual_seed(args.seed)
        self.render_kwargs = dict(
            scene_aabb=scene_aabb, near_plane=self.near, far_plane=self.far,
            render_step_size=self.step_size, cone_angle=self.cone,
            alpha_thre=alpha_thre,
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

    def occ_eval(self, x: torch.Tensor) -> torch.Tensor:
        """The grid update's occupancy estimate at points ``x`` (N, 3):
        density times the step, or with ``--occ_cone_coupling`` (and a
        cone) times the cone step at the distance from a random training
        camera, zero outside (near, far)."""
        if not (self.cone > 0.0 and self.args.occ_cone_coupling):
            return self.field.query_opacity(x, self.step_size)
        ids = torch.randint(0, self.cam_origins.shape[0], (x.shape[0],),
                            generator=self.generator,
                            device=self.generator.device).to(x.device)
        t = torch.linalg.norm(self.cam_origins[ids] - x, dim=-1, keepdim=True)
        step = torch.clamp(t * self.cone, min=self.step_size)
        if self.near is not None and self.far is not None:
            step = torch.where((t > self.near) & (t < self.far), step,
                               torch.zeros_like(step))
        return self.field.query_density(x) * step

    def update_grid(self, step: int) -> None:
        """The occupancy update of step ``step`` (every cell below 256)."""
        self.grid = update_grid(
            self.grid, self.generator, step=0 if step < 256 else 10**9,
            occ_eval_fn=self.occ_eval, occ_thre=1e-2,
            ema_decay=self.args.occ_ema_decay,
            adaptive_thre=not self.args.fixed_occ_thre)

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

    def distortion_weight(self, step: int) -> float:
        """``--distortion_loss``, ramped in over [warmup, 2 warmup] steps
        when ``--distortion_warmup`` is given."""
        w = self.args.distortion_warmup
        ramp = min(1.0, max(0.0, (step - w) / max(w, 1))) if w > 0 else 1.0
        return self.args.distortion_loss * ramp

    def loss(self, colors, opacities, extras, pixels, step: int = 0):
        """The step's loss: the Huber loss over the rays that hit something
        (every ray on a scene without a background: a dead ray renders
        black, not the GT), plus the distortion (in normalised disparity
        when unbounded) and the opacity entropy where weighted."""
        if self.has_bkgd:
            loss = hit_ray_loss(colors, pixels, opacities)
        else:
            loss = huber(colors, pixels).mean(-1).mean()
        if self.args.distortion_loss > 0:
            ts0 = extras["t_starts"]
            ts1 = extras["t_starts"] + extras["deltas"]
            if self.args.unbounded:
                ts0 = normalized_disparity(ts0, self.near, self.far)
                ts1 = normalized_disparity(ts1, self.near, self.far)
            dist = loss_distortion_dense(extras["weights"], ts0, ts1,
                                         masks=extras["masks"])
            loss = loss + self.distortion_weight(step) * dist.mean()
        if self.args.opacity_entropy > 0:
            o = torch.clamp(opacities[:, 0], 1e-5, 1.0 - 1e-5)
            ent = -(o * torch.log(o) + (1.0 - o) * torch.log(1.0 - o))
            loss = loss + self.args.opacity_entropy * ent.mean()
        return loss

    def train_step(self, rays_o, rays_d, pixels, step: int = 0):
        """One optimizer step on a ray batch (``step`` ramps the
        distortion weight in); returns ``(loss, live samples,
        field_budget_dropped)`` as tensors (no host sync)."""
        self.optimizer.zero_grad(set_to_none=True)
        colors, opacities, _, n, extras = render_rays(
            self.field, rays_o, rays_d, grid=self.grid,
            render_bkgd=self.scene.bkgd, stratified=True, key=self.generator,
            return_extras=True, **self.bucket_kwargs(rays_o.shape[0]))
        loss = self.loss(colors, opacities, extras, pixels, step)
        loss.backward()
        self.optimizer.step()
        self.schedule.step()
        return loss.detach(), n, extras["field_budget_dropped"]

    def eval_views(self):
        """The evaluation's poses and images: the held-out views, or the
        training views with ``--eval_on_train_views``."""
        if self.args.eval_on_train_views:
            return self.scene.train_poses, self.scene.images
        return self.scene.test_poses, self.scene.test_images

    def evaluate(self, n_views: int) -> list:
        """PSNR of ``n_views`` evaluation views, rendered exactly
        (``coarse_stride=1``) on a white background where the scene has
        one."""
        scene = self.scene
        poses, images = self.eval_views()
        bkgd = torch.ones(3, device=self.device) if self.has_bkgd else None
        kw = dict(self.render_kwargs, coarse_stride=1)
        psnrs = []
        for i in range(min(n_views, poses.shape[0])):
            rays = scene.rays_for_view(poses[i])
            colors, _, _ = render_image(
                self.field, rays.origins, rays.viewdirs, grid=self.grid,
                render_bkgd=bkgd,
                test_chunk_size=self.args.test_chunk_size,
                eval_visible_samples_per_ray=64, **kw)
            mse = float(torch.mean((colors - images[i].reshape(-1, 3)) ** 2))
            psnrs.append(-10.0 * math.log10(mse))
        return psnrs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, trainer=None) -> dict:
    """Train and evaluate; prints the JAX trainer's log lines, ``PSNR:``
    and ``train_time_s:``, and returns the run's numbers: the PSNRs, the
    seconds of the training loop and of the whole run (evaluation
    included, as ``train_time_s``), the live samples summed over the
    steps, the field budget's drops and the ``trainer``. A ``trainer``
    made by the caller from ``parse_args(argv)`` is trained in place of a
    new one."""
    if trainer is None:
        trainer = Trainer(parse_args(argv))
    args = trainer.args
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
                                              pixels, step)
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
    n_test = trainer.eval_views()[0].shape[0]
    print(f"eval: {min(args.eval_views, n_test)} of {n_test} test poses "
          f"({trainer.scene.width}x{trainer.scene.height})")
    psnrs = trainer.evaluate(args.eval_views)
    train_time = time.perf_counter() - t_start
    print(f"PSNR: {np.mean(psnrs):.2f} (views: {[f'{x:.2f}' for x in psnrs]})")
    print(f"train_time_s: {train_time:.1f}")
    return dict(psnr=float(np.mean(psnrs)), psnrs=psnrs,
                train_time_s=train_time, loop_s=loop_s,
                samples=int(total_samples),
                field_budget_dropped=int(total_dropped),
                steps=args.max_steps - start_step, trainer=trainer)


if __name__ == "__main__":
    main()
