"""The port's procedural scene, ray bucketer, trainer losses and
schedules, its trainers (``examples/train_ngp_nerf_torch.py`` with the
TensoCP and hash-NGP fields, bounded and with the grid-unbounded recipe,
``train_mlp_nerf_torch.py``, ``train_mlp_dnerf_torch.py``,
``train_proposal_nerf_torch.py``) and their checkpoints, against the JAX
package where it has the same piece.

Inputs come from numpy seeds; both packages render the same tiny views
(8x8 pixels, a few poses) on the CPU. Tolerances, with their reasons:
- the analytic field and ``render_gt``: f32 arithmetic in the same order,
  but ``sigmoid``, ``exp`` and ``sin`` of two libraries and a 512-term
  cumsum: atol 1e-5 on colors in [0, 1];
- poses, intrinsics and rays: f32 rounding of the same numpy poses and
  the same formulas, atol 1e-6;
- ``sample_batch``: the same numpy draws, so the same pixel indices; the
  pixels are the GT images' (atol 1e-5), the rays atol 1e-6;
- the bucketer: host arithmetic on Python floats, equal sequences;
- the losses: f32 elementwise arithmetic, rtol 1e-6; the warp penalties
  (the D-NeRF field's f32 GEMMs, another summation order): rtol 1e-5;
- the learning-rate schedules: optax computes them in f32, rtol 1e-6;
- a run resumed from a checkpoint: bit-equal to the run without a stop;
- the proposal trainer's forward against the JAX script's composition:
  within 1e-4 of each output's largest value (measured up to 3.1e-5: bf16
  rounding flips in the heads, carried through the CDF resampling, which
  is continuous in the weights), its loss rtol 1e-4; twelve training
  steps from the same weights, batches and jitter, each step's loss rtol
  1e-3 (measured up to 1.6e-4: the forward's differences compound through
  Adam's normalised updates);
- the grid trainer's regularisers (s-space distortion, opacity entropy)
  and the cone-coupled occupancy: rtol 1e-6 (f32 elementwise); the
  unbounded lattice sizing: equal integers;
- one NGP step against the JAX trainer's ``loss_fn`` (field budget and
  two-stage cull on, stratified jitter off): the loss rtol 1e-5, the
  gradients within ``test_torch_hash.py``'s bounds (table rtol 1e-4 / atol
  1e-6, the f32 heads rtol 1e-4 / atol 1e-5 of the largest |gradient|);
- 32 NGP steps against the JAX trainer's step (Adam, grid update every 16
  steps, the JAX draws of cells, jitter and stratified jitter given to
  the port): the first 4 losses rtol 1e-5 (the one-step bound; measured
  up to 7.8e-7), every loss rtol 2e-3 (measured up to 6.1e-4 at step 30:
  from 3e-7 at step 1 the difference grows about twofold every four
  steps, as Adam at eps 1e-15 scales each gradient entry by its own
  running size and so turns rounding-level differences of small entries
  into steps of the learning rate's size), the live samples equal; the
  grid's occupancies rtol 1e-2 after 16 steps (measured 3.4e-3) and a
  binary bit different only within that band of the threshold (measured:
  none differ).
"""

import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerfacc_tpu.data_io as jax_data_io
from nerfacc_tpu.datasets import procedural as jax_procedural
from nerfacc_tpu.models import DNeRFRadianceField as JaxDNeRF
from nerfacc_tpu.utils import DynamicRayBucketer as JaxBucketer
from nerfacc_tpu_torch.checkpoint import CheckpointManager
from nerfacc_tpu_torch.convert import dnerf_from_flax
from nerfacc_tpu_torch.datasets import ProceduralScene
from nerfacc_tpu_torch.datasets import procedural
from nerfacc_tpu_torch.models import DNeRFRadianceField, NGPRadianceField
from nerfacc_tpu_torch.training import (
    huber,
    hit_ray_loss,
    multistep_lr,
    warp_regularizer,
)
from nerfacc_tpu_torch.utils import DynamicRayBucketer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SCENE_KW = dict(n_views=4, width=8, height=8, n_test_views=2)
# the trainer at a tiny size on the CPU
TINY = ["--device", "cpu", "--num_rays", "64", "--image_size", "8",
        "--train_views", "4", "--grid_resolution", "16",
        "--levels", "8x4,16x8", "--samples_budget", "2048",
        "--visible_samples_budget", "1024", "--test_chunk_size", "64",
        "--eval_views", "1", "--use_kernel", "--fused_march"]
TINY_NGP = [a for a in TINY if a not in ("--levels", "8x4,16x8")] + [
    "--model", "ngp", "--ngp_levels", "4", "--ngp_log2_size", "10"]
TINY_MLP = ["--device", "cpu", "--num_rays", "32", "--image_size", "8",
            "--grid_resolution", "16", "--max_samples_per_ray", "512",
            "--render_step_size", "0.02",
            "--samples_budget", "1024", "--test_chunk_size", "64",
            "--eval_views", "1"]
TINY_DNERF = TINY_MLP + ["--train_views", "4"]
# trainer -> (script, its tiny flags)
NEW_TRAINERS = {
    "ngp": ("examples/train_ngp_nerf_torch.py", TINY_NGP),
    "mlp": ("examples/train_mlp_nerf_torch.py", TINY_MLP),
    "dnerf": ("examples/train_mlp_dnerf_torch.py", TINY_DNERF),
}


def _load(name, path):
    """A script of the repo as a module, by path, leaving the process's
    environment as it found it."""
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return module


@pytest.fixture(scope="module")
def trainer():
    return _load("train_ngp_nerf_torch", "examples/train_ngp_nerf_torch.py")


@pytest.fixture(scope="module")
def jax_trainer():
    return _load("train_ngp_nerf", "examples/train_ngp_nerf.py")


@pytest.fixture(scope="module")
def mlp_trainer():
    return _load("train_mlp_nerf_torch", "examples/train_mlp_nerf_torch.py")


@pytest.fixture(scope="module")
def dnerf_trainer():
    return _load("train_mlp_dnerf_torch", "examples/train_mlp_dnerf_torch.py")


@pytest.fixture(scope="module")
def scenes():
    return (ProceduralScene(device=CPU, **SCENE_KW),
            jax_procedural.ProceduralScene(**SCENE_KW))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0.0,
                               atol=atol)


def _rays(n, seed):
    """Rays from a sphere of radius 2.6 toward the box, some missing it."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = 2.6 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 1.2
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("with_dirs", [False, True])
def test_analytic_field_matches_jax(with_dirs):
    rng = np.random.RandomState(0)
    x = (rng.rand(4096, 3) * 3.2 - 1.6).astype(np.float32)
    d = rng.randn(4096, 3).astype(np.float32)
    _close(procedural.field_density(torch.as_tensor(x)),
           jax_procedural.field_density(jnp.asarray(x)), 1e-4)
    got = procedural.field_rgb(torch.as_tensor(x),
                               torch.as_tensor(d) if with_dirs else None)
    want = jax_procedural.field_rgb(jnp.asarray(x),
                                    jnp.asarray(d) if with_dirs else None)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("n_samples", [64, 512])
def test_render_gt_matches_jax(n_samples):
    o, d = _rays(300, 1)
    bkgd = np.float32([1.0, 1.0, 1.0])
    got = procedural.render_gt(torch.as_tensor(o), torch.as_tensor(d),
                               torch.as_tensor(bkgd), n_samples=n_samples)
    want = jax_procedural.render_gt(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(bkgd), n_samples=n_samples)
    assert got.shape == (300, 3)
    _close(got, want, 1e-5)
    # some rays miss the box and render the background exactly
    t_min, _ = procedural.ray_aabb_intersect(
        torch.as_tensor(o), torch.as_tensor(d), procedural.AABB)
    miss = t_min > 1e9
    assert bool(miss.any()) and bool((got[miss] == 1.0).all())


def test_scene_poses_and_images_match_jax(scenes):
    scene, jax_scene = scenes
    for name in ("train_poses", "test_poses", "K", "bkgd", "aabb"):
        _close(getattr(scene, name), getattr(jax_scene, name), 1e-6)
    assert scene.images.shape == (4, 8, 8, 3)
    assert scene.test_images.shape == (2, 8, 8, 3)
    _close(scene.images, jax_scene.images, 1e-5)
    _close(scene.test_images, jax_scene.test_images, 1e-5)
    # the GT images see the scene: not all background
    assert float(scene.images.min()) < 0.9


def test_rays_for_view_matches_jax(scenes):
    scene, jax_scene = scenes
    got = scene.rays_for_view(scene.test_poses[1])
    want = jax_scene.rays_for_view(jax_scene.test_poses[1])
    _close(got.origins, want.origins, 1e-6)
    _close(got.viewdirs, want.viewdirs, 1e-6)


def test_sample_batch_matches_jax_numpy_path(monkeypatch):
    # the JAX scene's numpy path: its native assembler out of the way
    monkeypatch.setattr(jax_data_io, "lib", lambda: None)
    scene = ProceduralScene(device=CPU, seed=3, **SCENE_KW)
    jax_scene = jax_procedural.ProceduralScene(seed=3, **SCENE_KW)
    for n in (37, 64):
        rays, pixels = scene.sample_batch(n)
        jrays, jpixels = jax_scene.sample_batch(n)
        assert pixels.shape == (n, 3)
        _close(pixels, jpixels, 1e-5)
        _close(rays.origins, jrays.origins, 1e-6)
        _close(rays.viewdirs, jrays.viewdirs, 1e-6)


def test_bucketer_matches_jax():
    # live samples per ray over the steps: the feed is that times the
    # rays of the batch, a zero count among them
    per_ray = [32] * 5 + [8] * 10 + [2] * 10 + [0] * 3 + [64] * 20
    ours = DynamicRayBucketer(262144, init_num_rays=8192)
    theirs = JaxBucketer(262144, init_num_rays=8192)
    assert ours.buckets == theirs.buckets and ours.num_rays == theirs.num_rays
    rays_ours = rays_theirs = 8192
    seq_ours, seq_theirs = [], []
    for spr in per_ray:
        rays_ours = ours.update(int(spr * rays_ours), rays_ours)
        rays_theirs = theirs.update(int(spr * rays_theirs), rays_theirs)
        seq_ours.append(rays_ours)
        seq_theirs.append(rays_theirs)
    assert seq_ours == seq_theirs
    assert len(set(seq_ours)) >= 4, seq_ours  # over the ladder


@pytest.mark.parametrize("delta", [1.0, 0.1])
def test_huber_matches_jax_trainer(jax_trainer, delta):
    rng = np.random.RandomState(4)
    x = rng.rand(500, 3).astype(np.float32) * 2.0 - 0.5
    y = rng.rand(500, 3).astype(np.float32)
    np.testing.assert_allclose(
        huber(torch.as_tensor(x), torch.as_tensor(y), delta).numpy(),
        np.asarray(jax_trainer.huber(jnp.asarray(x), jnp.asarray(y), delta)),
        rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("dead", ["some", "all"])
def test_hit_ray_loss_matches_jax_trainer(jax_trainer, dead):
    rng = np.random.RandomState(5)
    colors = rng.rand(256, 3).astype(np.float32)
    pixels = rng.rand(256, 3).astype(np.float32)
    opac = rng.rand(256, 1).astype(np.float32)
    opac[::3] = 0.0 if dead == "some" else opac[::3]
    if dead == "all":
        opac[:] = 0.0
    got = hit_ray_loss(*(torch.as_tensor(a) for a in (colors, pixels, opac)))
    # examples/train_ngp_nerf.py:484-492, the loss with a known background
    per_ray = jax_trainer.huber(jnp.asarray(colors), jnp.asarray(pixels))
    per_ray = per_ray.mean(-1)
    alive = (jnp.asarray(opac)[:, 0] > 0).astype(jnp.float32)
    want = (per_ray * alive).sum() / jnp.maximum(alive.sum(), 1.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-30)


def test_lr_schedule_matches_optax(trainer):
    t = trainer.Trainer(trainer.parse_args(TINY + ["--max_steps", "40",
                                                   "--lr_decay"]))
    want = optax.cosine_decay_schedule(1e-2, 40, 0.1)
    for step in range(45):
        lr = t.optimizer.param_groups[0]["lr"]
        assert math.isclose(lr, float(want(step)), rel_tol=1e-6), step
        t.optimizer.step()
        t.schedule.step()


def test_trainer_steps_on_cpu(trainer, capsys):
    # three steps of main: finite losses, the JAX trainer's log and the
    # held-out PSNR
    out = trainer.main(TINY + ["--max_steps", "3"])
    log = capsys.readouterr().out
    assert "step=0 loss=" in log and "step=2 loss=" in log
    assert "PSNR: " in log and "train_time_s: " in log
    assert len(out["psnrs"]) == 1 and np.isfinite(out["psnr"])
    assert out["samples"] > 0 and out["field_budget_dropped"] == 0
    # the loss falls on a repeated batch
    t = trainer.Trainer(trainer.parse_args(TINY + ["--max_steps", "3"]))
    t.update_grid(0)
    rays, pixels = t.scene.sample_batch(64)
    losses = [float(t.train_step(rays.origins, rays.viewdirs, pixels)[0])
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for p in t.field.parameters():
        assert bool(torch.isfinite(p).all())


@pytest.mark.parametrize("flags", [
    ["--data_root", "somewhere"], ["--quant_int8"],
    ["--model", "ngp", "--ngp_gather_mode", "per_level"],
    ["--dataset", "360"], ["--factor", "4"],
])
def test_trainer_refuses_what_it_does_not_port(trainer, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        trainer.Trainer(trainer.parse_args(TINY + flags))


@pytest.mark.parametrize("name", ["mlp", "dnerf"])
def test_mlp_trainers_refuse_the_datasets(name):
    script, tiny = NEW_TRAINERS[name]
    module = _load(f"t_{name}", script)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        module.Trainer(module.parse_args(tiny + ["--data_root", "x"]))


def test_ngp_trainer_refuses_four_features_with_the_kernel(trainer):
    with pytest.raises(ValueError, match="reference"):
        trainer.Trainer(trainer.parse_args(TINY_NGP + ["--ngp_features",
                                                       "4"]))
    # without the kernel the four features take index_add_
    t = trainer.Trainer(trainer.parse_args(
        [a for a in TINY_NGP if a != "--use_kernel"]
        + ["--ngp_features", "4"]))
    assert t.field.encoder.n_features == 4


def test_ngp_trainer_field_budget_and_kernel_switch(trainer):
    t = trainer.Trainer(trainer.parse_args(TINY_NGP))
    assert isinstance(t.field, NGPRadianceField)
    assert t.field.encoder.pallas_grad  # --use_kernel: K7
    assert t.field.encoder.n_levels == 4
    assert t.field.encoder.n_entries == 1 << 10
    # -1 (auto): half the sample budget for the gather-bound hash field
    assert t.render_kwargs["field_samples_budget"] == 1024
    # a batch twice as large doubles it with the sample budget
    bucketed = trainer.Trainer(trainer.parse_args(
        TINY_NGP + ["--target_sample_batch_size", "4096"]))
    assert bucketed.bucket_kwargs(128)["field_samples_budget"] == 1024 * 2
    plain = trainer.Trainer(trainer.parse_args(
        [a for a in TINY_NGP if a != "--use_kernel"]
        + ["--field_budget_ratio", "0.25"]))
    assert not plain.field.encoder.pallas_grad
    assert plain.render_kwargs["field_samples_budget"] == 512
    off = trainer.Trainer(trainer.parse_args(
        TINY_NGP + ["--field_budget_ratio", "0"]))
    assert "field_samples_budget" not in off.render_kwargs
    # auto is off for TensoCP
    tensocp = trainer.Trainer(trainer.parse_args(TINY))
    assert "field_samples_budget" not in tensocp.render_kwargs


@pytest.mark.parametrize("name", list(NEW_TRAINERS))
def test_new_trainer_steps_on_cpu(name, capsys):
    # three steps of main: finite losses, the JAX trainer's log and the
    # held-out PSNR; then the loss falls on a repeated batch
    script, tiny = NEW_TRAINERS[name]
    module = _load(f"t_{name}", script)
    out = module.main(tiny + ["--max_steps", "3"])
    log = capsys.readouterr().out
    assert "step=0 loss=" in log and "step=2 loss=" in log
    assert "PSNR: " in log and "train_time_s: " in log
    assert len(out["psnrs"]) == 1 and np.isfinite(out["psnr"])
    assert out["samples"] > 0 and out["field_budget_dropped"] == 0
    assert out["steps"] == 3 and out["loop_s"] <= out["train_time_s"]
    t = module.Trainer(module.parse_args(tiny + ["--max_steps", "3"]))
    t.update_grid(0)
    batch = t.scene.sample_batch(t.args.num_rays)
    rays, rest = batch[0], batch[1:]
    if name == "dnerf":
        rest = (*rest, 0)
    losses = [float(t.train_step(rays.origins, rays.viewdirs, *rest)[0])
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for p in t.field.parameters():
        assert bool(torch.isfinite(p).all())


@pytest.mark.parametrize("horizon", [1, 3, 4, 10, 300, 2000])
def test_multistep_schedule_matches_optax(horizon):
    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(2))], lr=5e-4)
    sched = multistep_lr(opt, horizon)
    # examples/train_mlp_nerf.py:105-109
    want = optax.piecewise_constant_schedule(
        5e-4, {horizon // 2: 0.33, horizon * 3 // 4: 0.33,
               horizon * 9 // 10: 0.33})
    for step in range(horizon + 5):
        lr = opt.param_groups[0]["lr"]
        assert math.isclose(lr, float(want(step)), rel_tol=1e-6), step
        opt.step()
        sched.step()


@pytest.mark.parametrize("name,flag", [("mlp", "--max_steps"),
                                       ("dnerf", "--sched_steps")])
def test_mlp_trainers_use_the_schedule(name, flag):
    script, tiny = NEW_TRAINERS[name]
    module = _load(f"t_{name}", script)
    t = module.Trainer(module.parse_args(tiny + ["--max_steps", "40", flag,
                                                 "20"]))
    sched = t.schedule
    assert isinstance(sched, torch.optim.lr_scheduler.MultiStepLR)
    assert sorted(sched.milestones) == [10, 15, 18]
    assert math.isclose(t.optimizer.param_groups[0]["lr"], 5e-4)
    assert t.optimizer.param_groups[0]["eps"] == 1e-8  # Adam's default


def test_dnerf_alpha_thre_switches_after_step_1000(dnerf_trainer,
                                                   monkeypatch):
    assert [dnerf_trainer.alpha_thre(s) for s in (0, 999, 1000, 1001,
                                                  5000)] == [
        0.0, 0.0, 0.0, 0.01, 0.01]  # train_mlp_dnerf.py:251
    seen = []
    render = dnerf_trainer.render_rays

    def spy(*args, **kw):
        seen.append(kw["alpha_thre"])
        return render(*args, **kw)

    monkeypatch.setattr(dnerf_trainer, "render_rays", spy)
    t = dnerf_trainer.Trainer(dnerf_trainer.parse_args(TINY_DNERF))
    t.update_grid(0)
    rays, pixels, times = t.scene.sample_batch(32)
    for step in (1000, 1001):
        t.train_step(rays.origins, rays.viewdirs, pixels, times, step)
    assert seen == [0.0, 0.01]


@pytest.mark.parametrize("mag,smooth", [(0.1, 0.0), (0.0, 0.5), (0.1, 0.5)])
def test_warp_regularizer_matches_jax_trainer(mag, smooth):
    jf = JaxDNeRF()
    params = jf.init(jax.random.PRNGKey(5), jnp.zeros((8, 3)),
                     jnp.zeros((8, 1)), jnp.zeros((8, 3)))
    tf = DNeRFRadianceField(device=CPU)
    dnerf_from_flax(jax.tree_util.tree_map(np.asarray, params), tf)
    rng = np.random.RandomState(6)
    xr = (rng.rand(1024, 3) * 3.0 - 1.5).astype(np.float32)
    tr = rng.rand(1024, 1).astype(np.float32)
    tr[::7] = 0.98  # t + 0.05 clips at 1
    # examples/train_mlp_dnerf.py:190-200
    d1 = jf.apply(params, jnp.asarray(xr), jnp.asarray(tr),
                  method=jf.warp_displacement)
    want = 0.0
    if mag > 0:
        want = want + mag * jnp.mean(d1**2)
    if smooth > 0:
        d2 = jf.apply(params, jnp.asarray(xr),
                      jnp.clip(jnp.asarray(tr) + 0.05, 0.0, 1.0),
                      method=jf.warp_displacement)
        want = want + smooth * jnp.mean((d2 - d1) ** 2)
    got = warp_regularizer(tf, torch.as_tensor(xr), torch.as_tensor(tr),
                           mag, smooth).detach()
    assert float(got) > 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_dnerf_trainer_adds_the_warp_penalty(dnerf_trainer):
    # with a weight the step's loss is the photometric loss plus the
    # penalty at the generator's points
    t = dnerf_trainer.Trainer(dnerf_trainer.parse_args(
        TINY_DNERF + ["--warp_reg_mag", "1e3"]))
    t.update_grid(0)
    rays, pixels, times = t.scene.sample_batch(32)
    state = t.generator.get_state()
    loss = t.train_step(rays.origins, rays.viewdirs, pixels, times, 0)[0]
    t0 = dnerf_trainer.Trainer(dnerf_trainer.parse_args(TINY_DNERF))
    t0.update_grid(0)
    t0.generator.set_state(state)
    loss0 = t0.train_step(rays.origins, rays.viewdirs, pixels, times, 0)[0]
    assert float(loss) > float(loss0)


def _checkpoint_equal(a, b, where="state"):
    assert type(a) is type(b), where
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _checkpoint_equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _checkpoint_equal(u, v, f"{where}[{i}]")
    else:
        assert a == b, where


def test_checkpoint_resume_is_bit_equal(trainer, tmp_path, capsys):
    # 18 steps without a stop, and 10 steps then 8 more resumed from step
    # 9's checkpoint; the grid update of step 16 falls after the resume
    flags = TINY_NGP + ["--ckpt_every", "8"]
    whole, split = tmp_path / "whole", tmp_path / "split"
    trainer.main(flags + ["--max_steps", "18", "--ckpt_dir", str(whole)])
    trainer.main(flags + ["--max_steps", "10", "--ckpt_dir", str(split)])
    out = trainer.main(flags + ["--max_steps", "18", "--ckpt_dir",
                                str(split)])
    assert "resumed from step 9" in capsys.readouterr().out
    assert out["steps"] == 8
    # saved at every 8th step and the last; the newest three kept
    assert CheckpointManager(whole).steps() == [8, 16, 17]
    assert CheckpointManager(split).steps() == [9, 16, 17]
    a = CheckpointManager(whole).restore()
    b = CheckpointManager(split).restore(17)
    assert a["step"] == 17
    _checkpoint_equal(a, b)
    # the state loads back into a trainer
    t = trainer.Trainer(trainer.parse_args(flags))
    assert t.load_state(a) == 17
    for name, p in t.field.state_dict().items():
        assert torch.equal(p, a["field"][name])


def test_checkpoint_manager(tmp_path):
    ckpt = CheckpointManager(tmp_path / "run", max_to_keep=2)
    assert ckpt.latest_step() is None and ckpt.steps() == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    for step in (0, 5, 10):
        ckpt.save(step, {"step": step, "w": torch.full((3,), float(step)),
                         "nested": [torch.arange(step + 1), (1, 2.5)]})
    assert ckpt.steps() == [5, 10] and ckpt.latest_step() == 10
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "ckpt_10.pt", "ckpt_5.pt"]  # no temporary file is left
    got = ckpt.restore()
    assert got["step"] == 10 and torch.equal(got["w"], torch.full((3,), 10.0))
    assert torch.equal(ckpt.restore(5)["nested"][0], torch.arange(6))
    ckpt.save(10, {"step": 11})  # the same step again replaces it
    assert ckpt.restore()["step"] == 11
    ckpt.close()


def test_trainer_imports_no_jax():
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('t', "
        "'examples/train_ngp_nerf_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "for name in ('train_mlp_nerf_torch', 'train_mlp_dnerf_torch',\n"
        "             'train_proposal_nerf_torch'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'examples/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "sys.path.insert(0, 'scripts')\n"
        "import train_drive_torch, bench_k1_k7_variants_torch\n"
        "import nerfacc_tpu_torch.sampling, nerfacc_tpu_torch.cdf\n"
        "import nerfacc_tpu_torch.losses, nerfacc_tpu_torch.datasets\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nerfacc_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# the proposal trainer at a tiny size on the CPU
TINY_PROP = ["--device", "cpu", "--num_rays", "64", "--image_size", "8",
             "--train_views", "4", "--n_coarse", "8", "--n_fine", "4",
             "--prop_grid", "8", "--test_chunk_size", "64", "--eval_views",
             "1"]
UNBOUNDED_360 = ["--scene", "procedural360", "--unbounded"]
# the grid trainer's unbounded recipe at a tiny size (the U360 drive's
# stride and probe groups)
TINY_U360 = TINY + UNBOUNDED_360 + ["--coarse_stride", "16",
                                    "--probe_groups", "32"]
# the proposal forward's bounds (see the module docstring)
PROP_FORWARD_ATOL, PROP_LOSS_RTOL = 1e-4, 1e-4
PROP_TRAJECTORY_RTOL = 1e-3


@pytest.fixture(scope="module")
def proposal_trainer():
    return _load("train_proposal_nerf_torch",
                 "examples/train_proposal_nerf_torch.py")


def _jax_proposal_fields(aabb, unbounded, use_kernel, prop_grid):
    """The JAX package's two fields as ``examples/train_proposal_nerf.py``
    builds them (:118-127)."""
    from nerfacc_tpu.models import TensoCPRadianceField as JaxTensoCP

    field = JaxTensoCP(aabb=aabb, unbounded=unbounded, use_kernel=use_kernel)
    proposal = JaxTensoCP(aabb=aabb, levels=((prop_grid, 32),),
                          use_viewdirs=False, geo_feat_dim=7,
                          unbounded=unbounded, use_kernel=use_kernel)
    return field, proposal


def jax_proposal_init(prop_grid, seed=42):
    """The JAX proposal script's initial parameters at ``PRNGKey(seed)``
    (``examples/train_proposal_nerf.py:128-133``; the script fixes 42), as
    numpy flax trees ``{"field": ..., "proposal": ...}``. The draw does not
    depend on the aabb or on ``--unbounded``."""
    field, proposal = _jax_proposal_fields((-1.0,) * 3 + (1.0,) * 3, False,
                                           False, prop_grid)
    _, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {
        "field": field.init(k1, jnp.zeros((4, 3)), jnp.zeros((4, 3))),
        "proposal": proposal.init(k2, jnp.zeros((4, 3)), None),
    }
    return jax.tree_util.tree_map(np.asarray, params)


def export_jax_proposal_init(path, prop_grid, seeds=(42, 43, 44)):
    """Write :func:`jax_proposal_init` at each seed to ``path`` as the
    ``--init_npz`` file of ``scripts/train_drive_torch.py`` (keys
    ``<seed>/field/...`` and ``<seed>/proposal/...``):

        JAX_PLATFORMS=cpu python -c "from tests.test_torch_trainer import
        export_jax_proposal_init as e; e('build/jax_init_p360.npz', 192)"
    """
    flat = {}
    for seed in seeds:
        leaves = jax.tree_util.tree_flatten_with_path(
            jax_proposal_init(prop_grid, seed))[0]
        for keys, leaf in leaves:
            name = "/".join(str(getattr(k, "key", k)) for k in keys)
            flat[f"{seed}/{name}"] = leaf
    np.savez(path, **flat)


def _proposal_pair(module, unbounded, use_kernel):
    """The port's proposal trainer (tiny) and the JAX package's two fields
    as the JAX script builds them, the port's loaded with their
    parameters."""
    from nerfacc_tpu_torch.convert import tensocp_from_flax

    flags = TINY_PROP + (UNBOUNDED_360 if unbounded else []) + (
        ["--use_kernel"] if use_kernel else [])
    t = module.Trainer(module.parse_args(flags))
    field, proposal = _jax_proposal_fields(t.aabb, unbounded, use_kernel, 8)
    np_params = jax_proposal_init(8)
    tensocp_from_flax(np_params["field"], t.field)
    tensocp_from_flax(np_params["proposal"], t.proposal)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    return t, field, proposal, params


def _jax_proposal_forward(args, field, proposal, p, rays_o, rays_d, u, aabb,
                          has_bkgd):
    """examples/train_proposal_nerf.py:159-239, with the jitter ``u`` (R,)
    given: (colors, opac, dist, colors_prop)."""
    from nerfacc_tpu import (
        loss_distortion_dense,
        proposal_sampling_with_filter,
        sample_along_rays,
    )
    from nerfacc_tpu.intersection import ray_aabb_intersect
    from nerfacc_tpu.ray_marching import RaySegments
    from nerfacc_tpu.vol_rendering import (
        accumulate_along_rays_dense,
        render_weight_from_density_dense,
    )

    def dense_density(module, mparams, ts, te):
        tm = (ts + te) * 0.5
        x = rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
        sig = module.apply(mparams, x.reshape(-1, 3),
                           method=module.query_density)
        return sig.reshape(tm.shape)

    def dense_rgb_sigma(module, mparams, ts, te):
        tm = (ts + te) * 0.5
        x = rays_o[:, None, :] + tm[..., None] * rays_d[:, None, :]
        R, K = tm.shape
        d = jnp.broadcast_to(rays_d[:, None, :], (R, K, 3)).reshape(-1, 3)
        rgb, sig = module.apply(mparams, x.reshape(-1, 3), d)
        return rgb.reshape(R, K, 3), sig.reshape(R, K)

    R, K = rays_o.shape[0], args.n_coarse
    if args.unbounded:
        s = jnp.clip(jnp.linspace(0.0, 1.0, K + 1)[None, :]
                     + u[:, None] / K, 0.0, 1.0)
        t_edges = 1.0 / ((1.0 - s) / args.near_plane + s / args.far_plane)
        segs0 = RaySegments(t_starts=t_edges[:, :-1], t_ends=t_edges[:, 1:],
                            deltas=t_edges[:, 1:] - t_edges[:, :-1],
                            masks=jnp.ones((R, K), bool))
    else:
        t_min, t_max = ray_aabb_intersect(rays_o, rays_d, jnp.asarray(aabb))
        segs0 = sample_along_rays(
            rays_o, rays_d, t_min + u * 0.02, t_max,
            step_size=float(np.linalg.norm(np.asarray(aabb[3:])
                                           - np.asarray(aabb[:3]))) / K,
            num_steps=K)
    segs, rounds = proposal_sampling_with_filter(
        segs0,
        proposal_sigma_fns=[lambda ts, te: dense_density(
            proposal, p["proposal"], ts, te)],
        proposal_n_samples=[args.n_fine], proposal_require_grads=True,
        early_stop_eps=0.0, alpha_thre=0.0)
    ts0, te0, w_prop, m0 = rounds[0]
    rgb_prop, _ = dense_rgb_sigma(proposal, p["proposal"], ts0, te0)
    colors_prop = accumulate_along_rays_dense(w_prop, rgb_prop, masks=m0)
    opac_prop = accumulate_along_rays_dense(w_prop, masks=m0)
    if has_bkgd:
        colors_prop = colors_prop + 1.0 * (1.0 - opac_prop)
    rgbs, sigmas = dense_rgb_sigma(field, p["field"], segs.t_starts,
                                   segs.t_ends)
    w = render_weight_from_density_dense(segs.t_starts, segs.t_ends, sigmas,
                                         masks=segs.masks)
    colors = accumulate_along_rays_dense(w, rgbs, masks=segs.masks)
    opac = accumulate_along_rays_dense(w, masks=segs.masks)
    if has_bkgd:
        colors = colors + 1.0 * (1.0 - opac)
    if args.unbounded:
        inv_n, inv_f = 1.0 / args.near_plane, 1.0 / args.far_plane

        def to_s(t):
            return (inv_n - 1.0 / jnp.maximum(t, 1e-6)) / (inv_n - inv_f)

        dist = loss_distortion_dense(w, to_s(segs.t_starts),
                                     to_s(segs.t_ends), segs.masks)
    else:
        dist = loss_distortion_dense(w, segs.t_starts, segs.t_ends,
                                     segs.masks)
    return colors, opac, dist, colors_prop


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("unbounded", [False, True])
def test_proposal_forward_matches_jax(proposal_trainer, jax_trainer,
                                      unbounded, use_kernel):
    t, field, proposal, params = _proposal_pair(proposal_trainer, unbounded,
                                                use_kernel)
    rays, pixels = t.scene.sample_batch(64)
    u = np.random.RandomState(11).rand(64).astype(np.float32)
    got = t.forward(rays.origins, rays.viewdirs, torch.as_tensor(u))
    want = _jax_proposal_forward(
        t.args, field, proposal, params, jnp.asarray(rays.origins.numpy()),
        jnp.asarray(rays.viewdirs.numpy()), jnp.asarray(u), t.aabb,
        t.has_bkgd)
    for name, a, b in zip(("colors", "opac", "dist", "colors_prop"),
                          got[:4], want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0.0,
                                   atol=PROP_FORWARD_ATOL * scale,
                                   err_msg=name)
    assert int(got[4]) > 0  # live samples
    # the loss over every ray, as examples/train_proposal_nerf.py:243-246
    loss = t.loss(got[0], got[3], got[2], pixels)
    jp = jnp.asarray(pixels.numpy())
    want_loss = (jax_trainer.huber(want[0], jp).mean()
                 + jax_trainer.huber(want[3], jp).mean()
                 + t.dist_w * want[2].mean())
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=PROP_LOSS_RTOL)
    assert t.dist_w == (1e-2 if unbounded else 1e-3)



@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("unbounded", [False, True])
def test_proposal_trainer_steps_on_cpu(proposal_trainer, unbounded,
                                       use_kernel, capsys):
    flags = TINY_PROP + (UNBOUNDED_360 if unbounded else []) + (
        ["--use_kernel"] if use_kernel else [])
    out = proposal_trainer.main(flags + ["--max_steps", "3"])
    log = capsys.readouterr().out
    for line in ("step=0 loss=", "step=2 loss=", "train_samples_per_s: ",
                 "PSNR: ", "train_time_s: "):
        assert line in log, line
    assert len(out["psnrs"]) == 1 and np.isfinite(out["psnr"])
    assert out["steps"] == 3 and out["samples"] > 0
    assert out["loop_s"] <= out["train_time_s"]
    t = proposal_trainer.Trainer(proposal_trainer.parse_args(flags))
    assert t.field.cp_levels[0].use_kernel == use_kernel
    assert t.proposal.cp_levels[0].use_kernel == use_kernel
    assert (t.scene.bkgd is None) == unbounded
    rays, pixels = t.scene.sample_batch(64)
    losses = [float(t.train_step(rays.origins, rays.viewdirs, pixels)[0])
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for p in (*t.field.parameters(), *t.proposal.parameters()):
        assert bool(torch.isfinite(p).all())
        assert p.grad is not None  # both fields train


def test_proposal_trainer_schedule_covers_both_fields(proposal_trainer):
    t = proposal_trainer.Trainer(proposal_trainer.parse_args(
        TINY_PROP + ["--max_steps", "40"]))
    params = t.optimizer.param_groups[0]["params"]
    assert len(params) == (len(list(t.field.parameters()))
                           + len(list(t.proposal.parameters())))
    assert t.optimizer.param_groups[0]["eps"] == 1e-15
    want = optax.cosine_decay_schedule(1e-2, 40, 0.1)
    for step in range(45):
        lr = t.optimizer.param_groups[0]["lr"]
        assert math.isclose(lr, float(want(step)), rel_tol=1e-6), step
        t.optimizer.step()
        t.schedule.step()
    # the proposal field: one level of 32 features, no view directions
    assert [(lv.grid_size, lv.rank) for lv in t.proposal.cp_levels] == [
        (8, 32)]
    assert not t.proposal.use_viewdirs


@pytest.fixture(scope="module")
def drive_script():
    return _load("train_drive_torch", "scripts/train_drive_torch.py")


def test_jax_init_file_loads_into_the_proposal_trainer(proposal_trainer,
                                                      drive_script,
                                                      tmp_path):
    """``export_jax_proposal_init``'s file, loaded by the drive script's
    ``--init_npz``, gives each field the JAX script's draw at the run's
    seed: every parameter equal to the tree converted directly."""
    from nerfacc_tpu_torch.convert import tensocp_from_flax

    path = tmp_path / "init.npz"
    export_jax_proposal_init(path, 8, seeds=(42, 43))
    t, ref = (proposal_trainer.Trainer(proposal_trainer.parse_args(TINY_PROP))
              for _ in range(2))
    for seed in (43, 42):
        drive_script.load_jax_init(t, path, seed)
        want = jax_proposal_init(8, seed)
        for name in ("field", "proposal"):
            tensocp_from_flax(want[name], getattr(ref, name))
            got = getattr(t, name).state_dict()
            for key, value in getattr(ref, name).state_dict().items():
                assert torch.equal(got[key], value), (seed, name, key)
    with pytest.raises(KeyError):
        drive_script.load_jax_init(t, path, 44)


@pytest.mark.parametrize("name,modes,want", [
    # a trainer without kernel flags runs its one mode, whatever is asked
    ("mlp", ["kernels", "plain"], ["default"]),
    ("dnerf", ["twins"], ["default"]),
    ("tensocp", ["kernels", "plain", "twins"], ["kernels", "plain", "twins"]),
    ("proposal360", ["kernels_field", "kernels_proposal"],
     ["kernels_field", "kernels_proposal"]),
    ("tensocp", ["kernels_field"], ValueError),
    ("u360", ["kernel"], ValueError),
])
def test_drive_script_modes(drive_script, name, modes, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            drive_script.check_modes(name, modes)
        return
    assert drive_script.check_modes(name, modes) == want
    trainer = _load(name, "examples/" + drive_script.TRAINERS[name][0])
    for mode in want:
        kernels = drive_script.MODES.get(mode, (False,))[0]
        argv = drive_script.drive_argv(name, trainer, 42, kernels)
        assert ("--use_kernel" in argv) == (mode != "plain"
                                            and mode != "default"), mode


def test_drive_script_twins_stand_in_for_the_kernels(drive_script):
    """Mode ``twins`` puts each kernel's plain twin where the path calls
    the wrapper, and puts the wrapper back after the run."""
    from nerfacc_tpu_torch.ops import cp_encoder as cpe
    from nerfacc_tpu_torch.ops import march_select as msel

    wrappers = (cpe._features, cpe.cp_level_features_res_fwd,
                cpe.cp_level_grads_res, msel.fused_select_grouped,
                msel.fused_reselect)
    with drive_script.twins_in_place(drive_script.TWINS):
        assert (cpe._features, cpe.cp_level_features_res_fwd,
                cpe.cp_level_grads_res, msel.fused_select_grouped,
                msel.fused_reselect) == (
            cpe.cp_level_features_plain, cpe.cp_level_features_res_plain,
            cpe.cp_level_grads_res_plain, msel.fused_select_grouped_plain,
            msel.fused_reselect_plain)
    assert (cpe._features, cpe.cp_level_features_res_fwd,
            cpe.cp_level_grads_res, msel.fused_select_grouped,
            msel.fused_reselect) == wrappers


@pytest.mark.parametrize("extra", [
    [], ["--distortion_loss", "0.03"], ["--opacity_entropy", "0.01"],
    ["--occ_cone_coupling", "1", "--fixed_occ_thre", "1"],
    ["--distortion_loss", "0.03", "--distortion_warmup", "2"],
    ["--eval_on_train_views", "--cone_angle", "0.01"],
    ["--model", "ngp", "--ngp_levels", "4", "--ngp_log2_size", "10"],
])
def test_grid_trainer_unbounded_steps_on_cpu(trainer, extra, capsys):
    flags = TINY_U360 + extra
    if "ngp" in extra:
        flags = [a for a in flags if a not in ("--levels", "8x4,16x8")]
    out = trainer.main(flags + ["--max_steps", "3"])
    log = capsys.readouterr().out
    assert "auto-raising to 2336" in log or "--cone_angle" in " ".join(extra)
    assert "raising probe_groups to" in log
    for line in ("step=0 loss=", "step=2 loss=", "PSNR: ", "train_time_s: "):
        assert line in log, line
    assert np.isfinite(out["psnr"]) and out["samples"] > 0
    assert out["field_budget_dropped"] == 0
    t = trainer.Trainer(trainer.parse_args(flags))
    kw = t.render_kwargs
    assert kw["scene_aabb"] is None and kw["alpha_thre"] == 1e-2
    assert (kw["near_plane"], kw["far_plane"]) == (0.2, 1e4)
    assert kw["render_step_size"] == 1e-2
    assert t.grid.contraction_type == trainer.ContractionType.UN_BOUNDED_SPHERE
    assert t.field.unbounded and t.scene.bkgd is None
    # a sampled grid update after the warm-up, with the recipe's threshold
    t.update_grid(0)
    t.update_grid(1000)
    assert bool(torch.isfinite(t.grid.occs).all())
    rays, pixels = t.scene.sample_batch(64)
    losses = [float(t.train_step(rays.origins, rays.viewdirs, pixels, s)[0])
              for s in range(3)]
    assert all(np.isfinite(losses)), losses
    for p in t.field.parameters():
        assert bool(torch.isfinite(p).all())


def test_grid_trainer_defaults_follow_the_jax_trainer(trainer):
    # --grid_resolution None: 128 bounded, 256 unbounded; the cone 0 and
    # 0.004; a bounded scene keeps its box and white background
    args = [a for a in TINY if a not in ("--grid_resolution", "16")]
    bounded = trainer.Trainer(trainer.parse_args(args))
    assert bounded.grid.resolution == (128,) * 3
    assert bounded.render_kwargs["cone_angle"] == 0.0
    assert bounded.render_kwargs["scene_aabb"] == tuple(
        float(v) for v in bounded.scene.aabb)
    assert bounded.has_bkgd
    unbounded = trainer.Trainer(trainer.parse_args(
        args + UNBOUNDED_360 + ["--coarse_stride", "16"]))
    assert unbounded.grid.resolution == (256,) * 3
    assert unbounded.render_kwargs["cone_angle"] == 0.004
    assert unbounded.args.max_samples_per_ray == 2336
    # --auto_aabb: the box of the camera positions
    auto = trainer.Trainer(trainer.parse_args(TINY + ["--auto_aabb"]))
    cams = torch.cat([auto.scene.train_poses[:, :3, -1],
                      auto.scene.test_poses[:, :3, -1]])
    want = tuple(float(v) for v in cams.amin(0)) + tuple(
        float(v) for v in cams.amax(0))
    assert auto.render_kwargs["scene_aabb"] == want
    np.testing.assert_allclose(auto.field.aabb.numpy(), want)


@pytest.mark.parametrize("near,far,cone,stride,S,groups", [
    (0.2, 1e4, 0.004, 16, 1024, 32),   # the U360 drive: 2336 and 146
    (0.2, 1e4, 0.004, 8, 1024, 0),     # no adaptive probes
    (0.2, 1e4, 0.004, 16, 4096, 32),   # covered: only the groups rise
    (0.5, 200.0, 0.0, 8, 1024, 16),    # no cone: 19,950 > 8192, a warning
    (1.0, 1e3, 0.01, 1, 256, 64),
])
def test_unbounded_lattice_matches_the_jax_arithmetic(trainer, near, far,
                                                      cone, stride, S,
                                                      groups, capsys):
    args = trainer.parse_args(TINY + ["--coarse_stride", str(stride),
                                      "--max_samples_per_ray", str(S),
                                      "--probe_groups", str(groups)])
    trainer.unbounded_lattice(args, near, far, 1e-2, cone)
    log = capsys.readouterr().out
    # examples/train_ngp_nerf.py:336-378
    S_need = jx_samples_needed(near, far, 1e-2, cone)
    C = max(stride, 1)
    want_s, want_g = S, groups
    if S < S_need and S_need <= 8192:
        want_s = -(-(S_need + C) // C) * C
        assert f"auto-raising to {want_s}" in log
    elif S < S_need:
        assert "UNSAMPLABLE" in log
    if want_g and want_g * C < want_s:
        want_g = -(-want_s // C)
        assert f"raising probe_groups to {want_g}" in log
    assert (args.max_samples_per_ray, args.probe_groups) == (want_s, want_g)


def jx_samples_needed(*a):
    from nerfacc_tpu import samples_needed_for_range

    return samples_needed_for_range(*a)


@pytest.mark.parametrize("unbounded", [False, True])
@pytest.mark.parametrize("term", ["distortion", "entropy", "both"])
def test_regularisers_match_the_jax_trainer(trainer, jax_trainer, unbounded,
                                            term):
    from nerfacc_tpu import loss_distortion_dense as jax_dist

    extra = []
    if term in ("distortion", "both"):
        extra += ["--distortion_loss", "0.03", "--distortion_warmup", "4"]
    if term in ("entropy", "both"):
        extra += ["--opacity_entropy", "0.02"]
    t = trainer.Trainer(trainer.parse_args(
        (TINY_U360 if unbounded else TINY) + extra))
    rng = np.random.RandomState(12)
    R, K = 64, 16
    colors = rng.rand(R, 3).astype(np.float32)
    pixels = rng.rand(R, 3).astype(np.float32)
    opac = rng.rand(R, 1).astype(np.float32)
    opac[::5] = 0.0
    opac[1::9] = 1.0  # clipped at 1 - 1e-5
    lo, hi = (0.2, 1e4) if unbounded else (0.5, 4.0)
    ts = np.sort(np.exp(rng.uniform(np.log(lo), np.log(hi), (R, K))),
                 axis=1).astype(np.float32)
    deltas = (np.diff(np.concatenate([ts, ts[:, -1:] * 1.01], 1), axis=1)
              ).astype(np.float32)
    weights = (rng.rand(R, K) * 0.2).astype(np.float32)
    masks = rng.rand(R, K) < 0.8
    extras = {k: torch.as_tensor(v) for k, v in (
        ("t_starts", ts), ("deltas", deltas), ("weights", weights),
        ("masks", masks))}
    for step in (0, 5, 6, 100):
        got = t.loss(*(torch.as_tensor(a) for a in (colors, opac)), extras,
                     torch.as_tensor(pixels), step)
        # examples/train_ngp_nerf.py:480-530 and 540-546
        per_ray = jax_trainer.huber(jnp.asarray(colors),
                                    jnp.asarray(pixels)).mean(-1)
        if unbounded:  # no background: every ray
            want = per_ray.mean()
        else:
            alive = (jnp.asarray(opac)[:, 0] > 0).astype(jnp.float32)
            want = (per_ray * alive).sum() / jnp.maximum(alive.sum(), 1.0)
        if term in ("distortion", "both"):
            w = 4
            dw = 0.03 * min(1.0, max(0.0, (step - w) / max(w, 1)))
            ts0, ts1 = jnp.asarray(ts), jnp.asarray(ts + deltas)
            if unbounded:
                inv_n, inv_f = 1.0 / 0.2, 1.0 / 1e4

                def to_s(x):
                    return (inv_n - 1.0 / jnp.maximum(x, 1e-6)) / (
                        inv_n - inv_f)

                ts0, ts1 = to_s(ts0), to_s(ts1)
            dist = jax_dist(jnp.asarray(weights), ts0, ts1,
                            masks=jnp.asarray(masks))
            want = want + dw * dist.mean()
            assert t.distortion_weight(step) == pytest.approx(dw, rel=1e-12)
        if term in ("entropy", "both"):
            o = jnp.clip(jnp.asarray(opac)[:, 0], 1e-5, 1.0 - 1e-5)
            ent = -(o * jnp.log(o) + (1.0 - o) * jnp.log(1.0 - o))
            want = want + 0.02 * ent.mean()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_occ_cone_coupling_matches_the_jax_trainer(trainer):
    t = trainer.Trainer(trainer.parse_args(
        TINY_U360 + ["--occ_cone_coupling", "1"]))
    rng = np.random.RandomState(13)
    d = rng.randn(500, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (d * np.exp(rng.uniform(np.log(0.01), np.log(2e4), (500, 1)))
         ).astype(np.float32)
    state = t.generator.get_state()
    with torch.no_grad():
        got = t.occ_eval(torch.as_tensor(x))
        dens = t.field.query_density(torch.as_tensor(x))
    t.generator.set_state(state)
    ids = torch.randint(0, t.cam_origins.shape[0], (500,),
                        generator=t.generator)
    # examples/train_ngp_nerf.py:548-566, with the same cameras
    cams = jnp.asarray(t.cam_origins.numpy())[jnp.asarray(ids.numpy())]
    dist = jnp.linalg.norm(cams - jnp.asarray(x), axis=-1, keepdims=True)
    step = jnp.maximum(dist * 0.004, 1e-2)
    step = jnp.where((dist > 0.2) & (dist < 1e4), step, 0.0)
    want = np.asarray(dens) * np.asarray(step)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0.0)
    assert (np.asarray(step) == 0).any() and (np.asarray(step) > 1e-2).any()
    # without the coupling: density times the step
    plain = trainer.Trainer(trainer.parse_args(TINY_U360))
    plain.field.load_state_dict(t.field.state_dict())
    with torch.no_grad():
        assert torch.equal(plain.occ_eval(torch.as_tensor(x)), dens * 1e-2)


def test_scene_without_background_renders_none(trainer, monkeypatch):
    seen = []
    render = trainer.render_image

    def spy(*args, **kw):
        seen.append(kw["render_bkgd"])
        return render(*args, **kw)

    monkeypatch.setattr(trainer, "render_image", spy)
    for flags, want in ((TINY_U360, None), (TINY, 1.0)):
        t = trainer.Trainer(trainer.parse_args(flags))
        t.update_grid(0)
        t.evaluate(1)
        if want is None:
            assert seen[-1] is None
        else:
            assert torch.equal(seen[-1], torch.ones(3))
    t = trainer.Trainer(trainer.parse_args(TINY + ["--eval_on_train_views"]))
    assert t.eval_views()[1] is t.scene.images


def test_ngp_step_matches_the_jax_loss_fn(trainer, jax_trainer, monkeypatch):
    """One step of the NGP trainer against the JAX trainer's ``loss_fn``
    (examples/train_ngp_nerf.py:480-530) from the same weights, batch and
    grid, with the field budget and the two-stage cull on (the NGP drive's
    shape, tiny) and the stratified jitter off on both sides."""
    import nerfacc_tpu as jx
    from nerfacc_tpu.models import NGPRadianceField as JaxNGP
    from nerfacc_tpu.utils import render_rays as jax_render_rays
    from nerfacc_tpu_torch.convert import grid_from_arrays, ngp_from_flax

    render = trainer.render_rays
    monkeypatch.setattr(trainer, "render_rays", lambda *a, **kw: render(
        *a, **dict(kw, stratified=False)))
    t = trainer.Trainer(trainer.parse_args(TINY_NGP))
    aabb = tuple(float(v) for v in t.scene.aabb)
    jfield = JaxNGP(aabb=aabb, n_levels=4, log2_hashmap_size=10,
                    n_features=2)
    params = jfield.init(jax.random.PRNGKey(5), jnp.zeros((8, 3)),
                         jnp.zeros((8, 3)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(14)
    # a table of order 1, so that the encoder moves the outputs
    params["params"]["encoder"]["table"] = (rng.randn(
        params["params"]["encoder"]["table"].shape[0]) * 0.5).astype(
        np.float32)
    ngp_from_flax(params, t.field)
    binary = rng.rand(16, 16, 16) < 0.4
    jgrid = jx.with_binary(jx.create_grid(jnp.asarray(aabb), resolution=16),
                           jnp.asarray(binary))
    t.grid = grid_from_arrays(aabb, binary, device="cpu")
    rays, pixels = t.scene.sample_batch(64)
    o, d, px = (jnp.asarray(a.numpy()) for a in (rays.origins, rays.viewdirs,
                                                  pixels))
    kw = dict(t.render_kwargs, scene_aabb=jnp.asarray(aabb))

    def loss_fn(p):
        colors, opacities, _, n, extras = jax_render_rays(
            p, jfield, o, d, grid=jgrid, render_bkgd=jnp.ones(3),
            stratified=False, return_extras=True, **kw)
        per_ray = jax_trainer.huber(colors, px).mean(-1)
        alive = (opacities[:, 0] > 0).astype(jnp.float32)
        loss = (per_ray * alive).sum() / jnp.maximum(alive.sum(), 1.0)
        return loss, (n, extras["field_budget_dropped"])

    (loss_j, (n_j, drop_j)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    loss_t, n_t, drop_t = t.train_step(rays.origins, rays.viewdirs, pixels)
    assert kw["field_samples_budget"] == 1024 and kw["visible_samples_budget"]
    assert int(n_t) == int(n_j) > 0 and int(drop_t) == int(drop_j) == 0
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    holder = NGPRadianceField(aabb=aabb, n_levels=4, log2_hashmap_size=10,
                              device="cpu")
    ngp_from_flax(jax.tree_util.tree_map(np.asarray, grads), holder)
    for (name, p), (_, q) in zip(t.field.named_parameters(),
                                 holder.named_parameters()):
        want = q.detach().numpy()
        scale = float(np.abs(want).max())
        assert p.grad is not None and scale > 0, name
        # test_torch_hash.py's bounds: the table rtol 1e-4 / atol 1e-6,
        # the f32 heads within 1e-5 of the largest |gradient|
        atol = 1e-6 if name == "encoder.table" else 1e-5 * scale
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=atol, err_msg=name)


# the NGP trajectory against the JAX trainer (see the module docstring)
NGP_TRAJECTORY_STEPS = 32
NGP_EARLY_STEPS, NGP_EARLY_RTOL = 4, 1e-5
NGP_TRAJECTORY_RTOL, NGP_OCC_RTOL = 2e-3, 1e-2


def test_ngp_trajectory_matches_the_jax_trainer(trainer, jax_trainer,
                                                monkeypatch):
    """NGP_TRAJECTORY_STEPS steps of the port's NGP ``Trainer`` against the
    JAX trainer's ``train_step`` composition (examples/train_ngp_nerf.py:
    480-530, optax Adam at eps 1e-15 under the cosine schedule) from the
    same converted weights, on the same batches, with the grid update every
    16 steps and the stratified jitter both drawn by JAX and given to the
    port (the grid update's cells and jitter through ``_update_grid_at``,
    the jitter through the port's t-range). The first NGP_EARLY_STEPS
    losses within the one-step bound, every loss within
    NGP_TRAJECTORY_RTOL and the live samples equal; after each grid update
    the occupancies within NGP_OCC_RTOL and a binary bit different only
    within that band of the threshold."""
    import nerfacc_tpu as jx
    import nerfacc_tpu_torch.utils as port_utils
    from nerfacc_tpu.models import NGPRadianceField as JaxNGP
    from nerfacc_tpu.utils import render_rays as jax_render_rays
    from nerfacc_tpu_torch.convert import ngp_from_flax
    from nerfacc_tpu_torch.grid import _update_grid_at

    steps = NGP_TRAJECTORY_STEPS
    t = trainer.Trainer(trainer.parse_args(
        TINY_NGP + ["--max_steps", str(steps)]))
    args = t.args
    aabb = tuple(float(v) for v in t.scene.aabb)
    jfield = JaxNGP(aabb=aabb, n_levels=4, log2_hashmap_size=10,
                    n_features=2)
    params = jfield.init(jax.random.PRNGKey(5), jnp.zeros((8, 3)),
                         jnp.zeros((8, 3)))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(14)
    params["params"]["encoder"]["table"] = (rng.randn(
        params["params"]["encoder"]["table"].shape[0]) * 0.5).astype(
        np.float32)
    ngp_from_flax(params, t.field)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jgrid = jx.create_grid(jnp.asarray(aabb), resolution=16)
    assert torch.equal(t.grid.binary.cpu(),
                       torch.as_tensor(np.array(jgrid.binary)))
    sched = (optax.cosine_decay_schedule(args.lr, steps, 0.1)
             if args.lr_decay else args.lr)
    opt = optax.adam(sched, eps=1e-15)
    opt_state = opt.init(params)
    kw = dict(t.render_kwargs, scene_aabb=jnp.asarray(aabb))
    step_size = t.step_size

    @jax.jit
    def jstep(p, s, grid, o, d, px, key):
        def loss_fn(p):
            colors, opacities, _, n, _ = jax_render_rays(
                p, jfield, o, d, grid=grid, render_bkgd=jnp.ones(3),
                stratified=True, key=key, return_extras=True, **kw)
            per_ray = jax_trainer.huber(colors, px).mean(-1)
            alive = (opacities[:, 0] > 0).astype(jnp.float32)
            return (per_ray * alive).sum() / jnp.maximum(alive.sum(),
                                                         1.0), n

        (loss, n), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss, n

    def occ_j(p):
        return lambda x: jfield.apply(p, x, method=jfield.query_density) * (
            step_size)

    # the port draws through these two; the test hands them JAX's draws
    drawn = {}

    def fake_update_grid(grid, generator, step, occ_eval_fn, occ_thre,
                         ema_decay, adaptive_thre):
        warmup = step < 256
        return _update_grid_at(grid, drawn["cells"], drawn["jitter"],
                               occ_eval_fn, occ_thre=occ_thre,
                               ema_decay=ema_decay,
                               adaptive_thre=adaptive_thre or warmup)

    resolve = port_utils._resolve_t_range

    def fake_resolve(rays_o, rays_d, t_min, t_max, aabb_, near, far,
                     stratified, generator, step_, **kws):
        lo, hi = resolve(rays_o, rays_d, t_min, t_max, aabb_, near, far,
                         False, None, step_, **kws)
        if stratified:
            lo = lo + drawn["u"] * step_
        return lo, hi

    monkeypatch.setattr(trainer, "update_grid", fake_update_grid)
    monkeypatch.setattr(port_utils, "_resolve_t_range", fake_resolve)

    key = jax.random.PRNGKey(21)
    got, want = [], []
    for step in range(steps):
        key, k_grid, k_render = jax.random.split(key, 3)
        if step % 16 == 0:
            jgrid = jx.update_grid(
                jgrid, k_grid, step=0 if step < 256 else 10**9,
                occ_eval_fn=occ_j(params), occ_thre=1e-2,
                ema_decay=args.occ_ema_decay,
                adaptive_thre=not args.fixed_occ_thre)
            k_sel, k_jit = jax.random.split(k_grid)
            cells = jnp.arange(jgrid.num_cells)
            drawn["cells"] = torch.as_tensor(np.array(cells))
            drawn["jitter"] = torch.as_tensor(np.array(
                jax.random.uniform(k_jit, (cells.shape[0], 3))))
            t.update_grid(step)
            occs = np.asarray(jgrid.occs)
            np.testing.assert_allclose(t.grid.occs.numpy(), occs,
                                       rtol=NGP_OCC_RTOL, atol=1e-9,
                                       err_msg=f"step {step}")
            thre = min(float(occs.mean()), 1e-2)
            flips = (t.grid.binary.numpy().reshape(-1)
                     != np.asarray(jgrid.binary).reshape(-1))
            assert np.all(np.abs(occs[flips] - thre)
                          <= NGP_OCC_RTOL * thre), (step, int(flips.sum()))
        rays, pixels = t.scene.sample_batch(args.num_rays)
        drawn["u"] = torch.as_tensor(np.array(jax.random.uniform(
            k_render, (args.num_rays,))))
        loss_t, n_t, _ = t.train_step(rays.origins, rays.viewdirs, pixels,
                                      step)
        params, opt_state, loss_j, n_j = jstep(
            params, opt_state, jgrid,
            *(jnp.asarray(a.numpy()) for a in (rays.origins, rays.viewdirs,
                                                pixels)), k_render)
        got.append((float(loss_t), int(n_t)))
        want.append((float(loss_j), int(n_j)))
    losses = np.asarray([g[0] for g in got])
    losses_j = np.asarray([w[0] for w in want])
    np.testing.assert_allclose(losses[:NGP_EARLY_STEPS],
                               losses_j[:NGP_EARLY_STEPS], rtol=NGP_EARLY_RTOL)
    np.testing.assert_allclose(losses, losses_j, rtol=NGP_TRAJECTORY_RTOL)
    assert [g[1] for g in got] == [w[1] for w in want]
    assert got[-1][0] < got[0][0]


@pytest.mark.parametrize("unbounded", [False, True])
def test_proposal_training_matches_jax_step_by_step(proposal_trainer,
                                                    jax_trainer, unbounded):
    # the port's training loop against the JAX script's optimizer (optax
    # Adam, eps 1e-15, cosine decay) from the same weights, on the same
    # batches and jitter: the loss of each step within PROP_TRAJECTORY_RTOL
    t, field, proposal, params = _proposal_pair(proposal_trainer, unbounded,
                                                False)
    steps = 12
    t.schedule = torch.optim.lr_scheduler.LambdaLR(
        t.optimizer, lambda s: 0.9 * 0.5 * (1.0 + math.cos(
            math.pi * min(s, steps) / steps)) + 0.1)
    opt = optax.adam(optax.cosine_decay_schedule(t.args.lr, steps, 0.1),
                     eps=1e-15)
    state = opt.init(params)

    def loss_fn(p, o, d, px, u):
        c, _, dist, cp = _jax_proposal_forward(t.args, field, proposal, p, o,
                                               d, u, t.aabb, t.has_bkgd)
        return (jax_trainer.huber(c, px).mean()
                + jax_trainer.huber(cp, px).mean() + t.dist_w * dist.mean())

    @jax.jit
    def jstep(p, s, o, d, px, u):
        loss, g = jax.value_and_grad(loss_fn)(p, o, d, px, u)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss

    rng = np.random.RandomState(15)
    got, want = [], []
    for _ in range(steps):
        rays, px = t.scene.sample_batch(64)
        u = rng.rand(64).astype(np.float32)
        t.optimizer.zero_grad(set_to_none=True)
        c, _, dist, cp, _ = t.forward(rays.origins, rays.viewdirs,
                                      torch.as_tensor(u))
        loss = t.loss(c, cp, dist, px)
        loss.backward()
        t.optimizer.step()
        t.schedule.step()
        params, state, lj = jstep(params, state, *(
            jnp.asarray(a.numpy()) for a in (rays.origins, rays.viewdirs,
                                              px)), jnp.asarray(u))
        got.append(float(loss.detach()))
        want.append(float(lj))
    np.testing.assert_allclose(got, want, rtol=PROP_TRAJECTORY_RTOL)
    assert got[-1] < got[0]
