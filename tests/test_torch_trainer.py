"""The port's procedural scene, ray bucketer, trainer losses and TensoCP
trainer (``examples/train_ngp_nerf_torch.py``) against the JAX package.

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
- the losses: f32 elementwise arithmetic, rtol 1e-6.
"""

import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerfacc_tpu.data_io as jax_data_io
from nerfacc_tpu.datasets import procedural as jax_procedural
from nerfacc_tpu.utils import DynamicRayBucketer as JaxBucketer
from nerfacc_tpu_torch.datasets import ProceduralScene
from nerfacc_tpu_torch.datasets import procedural
from nerfacc_tpu_torch.training import huber, hit_ray_loss
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
    ["--model", "ngp"], ["--unbounded"], ["--data_root", "somewhere"],
    ["--ckpt_dir", "somewhere"], ["--distortion_loss", "0.01"],
    ["--opacity_entropy", "0.01"], ["--quant_int8"],
    ["--scene", "procedural360"],
])
def test_trainer_refuses_what_it_does_not_port(trainer, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        trainer.Trainer(trainer.parse_args(TINY + flags))


def test_trainer_imports_no_jax():
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('t', "
        "'examples/train_ngp_nerf_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "sys.path.insert(0, 'scripts')\n"
        "import train_drive_torch, bench_k1_k7_variants_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nerfacc_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
