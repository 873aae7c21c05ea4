"""The port's time-conditioned render path and moving procedural scene
against the JAX package's.

``render_rays`` / ``render_image`` with per-ray ``timestamps`` and the
D-NeRF field (the same flax parameters on both sides) in the four ways the
JAX package queries a field: one dense pass with the cull refining the
mask; the two-stage cull with re-selection; empty-ray compaction, where
the timestamps travel with the compacted rays; and live-sample compaction
of the field (``field_samples_budget``), where each compacted sample takes
its ray's time. Both run on the CPU, the march unfused on both sides.

Tolerances: the masks bit-equal (the random field is thin, opacities
~0.05, so no slot's transmittance sits near the early-stop threshold);
colours,
opacities and depths within 1e-5 (f32 GEMMs summed in another order; depth
in scene units, t <= 5). The scene: ``render_gt_dynamic`` atol 1e-5 as
``render_gt`` (two libraries' ``sigmoid`` / ``exp`` / ``sin`` and a
512-term cumsum), poses and rays 1e-6, timestamps 1e-7 (``linspace`` of
two libraries), ``sample_batch`` the same numpy draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu as jx
from nerfacc_tpu.datasets import procedural as jax_procedural
from nerfacc_tpu.models import DNeRFRadianceField as JaxDNeRF
from nerfacc_tpu.utils import render_image as jax_render_image
from nerfacc_tpu.utils import render_rays as jax_render_rays
from nerfacc_tpu_torch import render_image, render_rays
from nerfacc_tpu_torch.convert import dnerf_from_flax, grid_from_arrays
from nerfacc_tpu_torch.datasets import ProceduralDynamicScene, procedural
from nerfacc_tpu_torch.models import DNeRFRadianceField

torch.set_num_threads(1)

CPU = torch.device("cpu")
AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
N_RAYS = 64
RENDER_ATOL = 1e-5
SCENE_KW = dict(n_views=4, width=8, height=8, n_test_views=2)
KW = dict(scene_aabb=AABB, render_step_size=1e-2, max_samples_per_ray=512,
          samples_budget=N_RAYS * 24)
# the four ways the field is queried
MODES = {
    "dense": dict(),
    "two-stage": dict(visible_samples_budget=N_RAYS * 12),
    "ray compaction": dict(coarse_stride=8, probe_dilation=1,
                           probe_groups=16, compact_rays_fraction=0.75),
    "field budget": dict(field_samples_budget=N_RAYS * 12,
                         visible_samples_budget=N_RAYS * 12),
}


@pytest.fixture(scope="module")
def scene():
    """Both packages' D-NeRF field (same flax parameters) and 32^3 grid."""
    rng = np.random.RandomState(0)
    binary = np.zeros((32, 32, 32), bool)
    binary[4:28, 4:28, 4:28] = rng.rand(24, 24, 24) < 0.6
    jgrid = jx.with_binary(jx.create_grid(jnp.asarray(AABB), resolution=32),
                           jnp.asarray(binary))
    tgrid = grid_from_arrays(AABB, binary, device="cpu")
    jfield = JaxDNeRF()
    params = jfield.init(jax.random.PRNGKey(1), jnp.zeros((8, 3)),
                         jnp.zeros((8, 1)), jnp.zeros((8, 3)))
    tfield = DNeRFRadianceField(device=CPU)
    dnerf_from_flax(jax.tree_util.tree_map(np.asarray, params), tfield)
    return jfield, params, jgrid, tfield, tgrid


def _camera_rays(n, seed):
    """Rays from outside the box aimed near its centre, some missing it,
    and one random time per ray."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = 2.8 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 0.8
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.rand(n, 1)
    return o.astype(np.float32), d.astype(np.float32), t.astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0,
                               atol=atol)


@pytest.mark.parametrize("mode", list(MODES))
def test_render_rays_with_timestamps_matches_jax(scene, mode):
    jfield, params, jgrid, tfield, tgrid = scene
    o, d, t = _camera_rays(N_RAYS, seed=2)
    kw = dict(KW, **MODES[mode], return_extras=True)
    cj, oj, dj, nj, ej = jax_render_rays(
        params, jfield, jnp.asarray(o), jnp.asarray(d), grid=jgrid,
        render_bkgd=jnp.ones(3), timestamps=jnp.asarray(t), **kw)
    with torch.no_grad():
        ct, ot, dt, nt, et = render_rays(
            tfield, torch.as_tensor(o), torch.as_tensor(d), grid=tgrid,
            render_bkgd=torch.ones(3), timestamps=torch.as_tensor(t), **kw)
    np.testing.assert_array_equal(et["masks"].numpy(), np.asarray(ej["masks"]))
    assert int(nt) == int(nj) > 100
    for got, want in ((ct, cj), (ot, oj), (dt, dj)):
        assert got.shape == (N_RAYS, got.shape[1])
        _close(got, want, RENDER_ATOL)
    assert int(et["field_budget_dropped"]) == int(ej["field_budget_dropped"])
    # the scene is seen, and rays that miss render the background
    assert float(ot.max()) > 0.01 and float(ot.min()) == 0.0
    if mode == "ray compaction":
        assert et["masks"].shape[0] == round(0.75 * N_RAYS)


def test_timestamps_reach_the_field(scene):
    # one ray batch at two times renders two different images
    *_, tfield, tgrid = scene
    o, d, _ = _camera_rays(N_RAYS, seed=3)
    outs = []
    for time in (0.0, 1.0):
        t = torch.full((N_RAYS, 1), time)
        with torch.no_grad():
            outs.append(render_rays(tfield, torch.as_tensor(o),
                                    torch.as_tensor(d), grid=tgrid,
                                    timestamps=t, **KW)[0])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-6


def test_render_image_with_timestamps_matches_jax(scene):
    # 256 rays in chunks of 96: the last chunk pads 32 rays with time 0
    jfield, params, jgrid, tfield, tgrid = scene
    o, d, t = _camera_rays(256, seed=4)
    kw = dict(scene_aabb=AABB, render_step_size=1e-2,
              max_samples_per_ray=512, test_chunk_size=96,
              eval_samples_per_ray=24, alpha_thre=0.01,
              field_samples_budget=64)
    out_j = jax_render_image(params, jfield, jnp.asarray(o), jnp.asarray(d),
                             grid=jgrid, render_bkgd=jnp.ones(3),
                             timestamps=jnp.asarray(t), **kw)
    out_t = render_image(tfield, torch.as_tensor(o), torch.as_tensor(d),
                         grid=tgrid, render_bkgd=torch.ones(3),
                         timestamps=torch.as_tensor(t), **kw)
    for a, b in zip(out_t, out_j):
        assert a.shape[0] == 256 and bool(torch.isfinite(a).all())
        _close(a, b, RENDER_ATOL)
    assert float(out_t[1].max()) > 0.01


def test_shift_matches_jax():
    t = np.linspace(0.0, 1.0, 37, dtype=np.float32)[:, None]
    got = procedural._shift(torch.as_tensor(t))
    _close(got, jax_procedural._shift(jnp.asarray(t)), 1e-7)
    assert got.shape == (37, 3) and float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("n_samples", [64, 512])
def test_render_gt_dynamic_matches_jax(n_samples):
    o, d, t = _camera_rays(300, seed=5)
    bkgd = np.float32([1.0, 1.0, 1.0])
    got = procedural.render_gt_dynamic(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(bkgd),
        torch.as_tensor(t), n_samples=n_samples)
    want = jax_procedural.render_gt_dynamic(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(bkgd), jnp.asarray(t),
        n_samples=n_samples)
    assert got.shape == (300, 3)
    _close(got, want, 1e-5)
    # at t = 0 the scene is the static one
    t0 = np.zeros_like(t)
    _close(procedural.render_gt_dynamic(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(bkgd),
        torch.as_tensor(t0), n_samples=n_samples),
        procedural.render_gt(torch.as_tensor(o), torch.as_tensor(d),
                             torch.as_tensor(bkgd), n_samples=n_samples),
        0.0)


def test_dynamic_scene_matches_jax():
    scene = ProceduralDynamicScene(device=CPU, seed=3, **SCENE_KW)
    jax_scene = jax_procedural.ProceduralDynamicScene(seed=3, **SCENE_KW)
    for name in ("train_poses", "test_poses", "K", "bkgd", "aabb"):
        _close(getattr(scene, name), getattr(jax_scene, name), 1e-6)
    _close(scene.timestamps, jax_scene.timestamps, 1e-7)
    _close(scene.test_timestamps, jax_scene.test_timestamps, 1e-7)
    assert scene.timestamps.shape == (4,)
    assert scene.test_timestamps.shape == (2,)
    assert scene.images.shape == (4, 8, 8, 3)
    assert scene.test_images.shape == (2, 8, 8, 3)
    _close(scene.images, jax_scene.images, 1e-5)
    _close(scene.test_images, jax_scene.test_images, 1e-5)
    # the views see the scene at their own times, not the static scene
    static = procedural.ProceduralScene(device=CPU, seed=3, **SCENE_KW)
    assert float((scene.images[1:] - static.images[1:]).abs().max()) > 1e-3
    # the same numpy draws: the same pixels, rays and times
    for n in (37, 64):
        rays, pixels, t = scene.sample_batch(n)
        jrays, jpixels, jt = jax_scene.sample_batch(n)
        assert pixels.shape == (n, 3) and t.shape == (n, 1)
        _close(pixels, jpixels, 1e-5)
        _close(rays.origins, jrays.origins, 1e-6)
        _close(rays.viewdirs, jrays.viewdirs, 1e-6)
        _close(t, jt, 1e-7)
