"""The port's procedural scene, ray bucketer, trainer losses and
schedules, its trainers (``examples/train_ngp_nerf_torch.py`` with the
TensoCP and hash-NGP fields, ``train_mlp_nerf_torch.py``,
``train_mlp_dnerf_torch.py``) and their checkpoints, against the JAX
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
- a run resumed from a checkpoint: bit-equal to the run without a stop.
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
    ["--unbounded"], ["--data_root", "somewhere"],
    ["--distortion_loss", "0.01"], ["--opacity_entropy", "0.01"],
    ["--quant_int8"], ["--scene", "procedural360"],
    ["--model", "ngp", "--ngp_gather_mode", "per_level"],
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
        "for name in ('train_mlp_nerf_torch', 'train_mlp_dnerf_torch'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'examples/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "sys.path.insert(0, 'scripts')\n"
        "import train_drive_torch, bench_k1_k7_variants_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nerfacc_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
