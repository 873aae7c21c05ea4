"""The port's march path vs the JAX package: contraction, ray/AABB
intersection, the closed-form lattice, occupancy-grid queries, the grouped
march and the dense forward rendering.

Inputs come from numpy seeds and go to both packages. Integer and boolean
results (grid bits, slot masks) must be bit-equal. Float results agree to
f32 rounding: XLA contracts multiply-adds into FMAs and sums cumsums in its
own order, so t values move by ~1e-7 (rtol 1e-5 / atol 1e-6).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu as jx
import nerfacc_tpu.vol_rendering as jvr
import nerfacc_tpu_torch as pt
import nerfacc_tpu_torch.ray_marching as prm
import nerfacc_tpu_torch.vol_rendering as pvr
from nerfacc_tpu_torch.convert import grid_from_arrays

torch.set_num_threads(1)

# the JAX package exports a function of the same name as this module
jrm = importlib.import_module("nerfacc_tpu.ray_marching")

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _rays(n, seed, spread=1.4):
    rng = np.random.RandomState(seed)
    o = (rng.rand(n, 3) * 2 - 1).astype(np.float32) * spread
    d = rng.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _binary(res=32, seed=0, frac=0.6):
    rng = np.random.RandomState(seed)
    b = np.zeros((res,) * 3, bool)
    lo, hi = res // 4, 3 * res // 4
    b[lo:hi, lo:hi, lo:hi] = rng.rand(hi - lo, hi - lo, hi - lo) < frac
    return b


def _grids(binary):
    jgrid = jx.with_binary(jx.create_grid(jnp.asarray(AABB), resolution=32),
                           jnp.asarray(binary))
    return jgrid, grid_from_arrays(AABB, binary)


@pytest.mark.parametrize("ctype", list(pt.ContractionType))
def test_contraction_and_inverse_match_jax(ctype):
    x = np.random.RandomState(1).randn(500, 3).astype(np.float32) * 2.0
    roi = np.asarray([-1.0, -2.0, -1.5, 1.0, 2.0, 1.5], np.float32)
    jtype = jx.ContractionType(ctype.value)
    u_j = jx.contract(jnp.asarray(x), jnp.asarray(roi), jtype)
    u_t = pt.contract(torch.as_tensor(x), roi, ctype)
    _close(u_t, u_j)
    u = np.clip(np.asarray(u_j), 0.01, 0.99)
    _close(pt.contract_inv(torch.as_tensor(u), roi, ctype),
           jx.contract_inv(jnp.asarray(u), jnp.asarray(roi), jtype),
           rtol=1e-5, atol=1e-5)


def test_ray_aabb_intersect_matches_jax():
    o, d = _rays(400, seed=2, spread=3.0)
    d[:5] = np.asarray([0.0, 0.0, 1.0], np.float32)  # axis-parallel rays
    t_j = jx.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(AABB))
    t_t = pt.ray_aabb_intersect(torch.as_tensor(o), torch.as_tensor(d), AABB)
    for a, b in zip(t_t, t_j):
        np.testing.assert_array_equal(a.numpy() >= 1e9, np.asarray(b) >= 1e9)
        _close(a, b)


@pytest.mark.parametrize("cone", [0.0, 0.004])
def test_lattice_and_inverse_match_jax(cone):
    rng = np.random.RandomState(3)
    t_min = (rng.rand(64, 1) * 2.0 + 0.05).astype(np.float32)
    k = np.arange(0, 1024, 7, dtype=np.float32)[None]
    kw = dict(step_size=5e-3, cone_angle=cone, dt_max=0.05)
    t_j = jrm._lattice_t(jnp.asarray(t_min), jnp.asarray(k), **kw)
    t_t = prm._lattice_t(torch.as_tensor(t_min), torch.as_tensor(k), **kw)
    _close(t_t, t_j)
    # the inverse at the lattice points and half-way between them (the
    # f32 seam the in-range rule ceil(k(t_max) - 1/2) decides on)
    t_mid = np.asarray(t_j) + 1e-4
    k_j = jrm._lattice_k(jnp.asarray(t_min), jnp.asarray(t_mid), **kw)
    k_t = prm._lattice_k(torch.as_tensor(t_min), torch.as_tensor(t_mid), **kw)
    _close(k_t, k_j, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        np.ceil(k_t.numpy() - 0.5), np.ceil(np.asarray(k_j) - 0.5)
    )


def test_samples_needed_for_range_matches_jax():
    for args in [(0.0, 3.0, 5e-3, 0.0), (0.1, 50.0, 5e-3, 0.004),
                 (2.0, 1e3, 1e-2, 0.01, 0.5)]:
        assert pt.samples_needed_for_range(*args) == (
            jx.samples_needed_for_range(*args)
        )


@pytest.mark.parametrize("radius", [0, 1, 2, 4])
def test_grid_queries_match_jax_bit_for_bit(radius):
    binary = _binary()
    jgrid, tgrid = _grids(binary)
    rng = np.random.RandomState(10 + radius)
    pts = (rng.rand(4000, 3) * 2.4 - 1.2).astype(np.float32)
    # points just outside the box, inside the dilated margin (< r voxels)
    pts[:200, 0] = np.float32(1.0) + rng.rand(200).astype(np.float32) * 0.1
    pts[200:400, 2] = np.float32(-1.0) - rng.rand(200).astype(np.float32) * 0.3
    want = np.asarray(jgrid.query_occ_fast(jnp.asarray(pts), dilated=radius))
    got = tgrid.query_occ_fast(torch.as_tensor(pts), dilated=radius).numpy()
    np.testing.assert_array_equal(got, want)
    if radius == 0:
        np.testing.assert_array_equal(
            tgrid.query_occ(torch.as_tensor(pts)).numpy(), want
        )


@pytest.mark.parametrize("use_pallas", [True, False])
def test_grouped_march_matches_jax(use_pallas):
    binary = _binary(seed=5)
    jgrid, tgrid = _grids(binary)
    o, d = _rays(64, seed=5)
    t_min = np.zeros(64, np.float32)
    t_max = np.full(64, 4.0, np.float32)
    kw = dict(render_step_size=1e-2, max_samples_per_ray=512,
              slots_per_ray=32, coarse_stride=8, probe_dilation=1,
              probe_groups=16, use_pallas=use_pallas)
    a = jrm.march_rays(*map(jnp.asarray, (o, d, t_min, t_max)), jgrid, **kw)
    b = prm.march_rays(*map(torch.as_tensor, (o, d, t_min, t_max)), tgrid,
                       **kw)
    np.testing.assert_array_equal(b.masks.numpy(), np.asarray(a.masks))
    assert int(b.masks.sum()) > 50
    for x, y in ((b.t_starts, a.t_starts), (b.t_ends, a.t_ends),
                 (b.deltas, a.deltas)):
        _close(x, y)


def test_dense_march_and_probe_counts_match_jax():
    # the coarse_stride == 1 path (exact per-candidate grid test) and the
    # probe counts that drive empty-ray compaction
    binary = _binary(seed=6)
    jgrid, tgrid = _grids(binary)
    o, d = _rays(48, seed=6)
    t_j = jx.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(AABB))
    t_t = pt.ray_aabb_intersect(torch.as_tensor(o), torch.as_tensor(d), AABB)
    kw = dict(render_step_size=1e-2, max_samples_per_ray=256,
              slots_per_ray=24)
    a = jrm.march_rays(jnp.asarray(o), jnp.asarray(d), *t_j, jgrid, **kw)
    b = prm.march_rays(torch.as_tensor(o), torch.as_tensor(d), *t_t, tgrid,
                       **kw)
    np.testing.assert_array_equal(b.masks.numpy(), np.asarray(a.masks))
    _close(b.deltas, a.deltas)
    pkw = dict(render_step_size=1e-2, max_samples_per_ray=256,
               coarse_stride=8, probe_dilation=2, probe_groups=8)
    lj = jrm.probe_live_groups(jnp.asarray(o), jnp.asarray(d), *t_j, jgrid,
                               **pkw)
    lt = prm.probe_live_groups(torch.as_tensor(o), torch.as_tensor(d), *t_t,
                               tgrid, **pkw)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_dense_rendering_forward_matches_jax():
    rng = np.random.RandomState(7)
    R, K = 32, 24
    ts = np.sort(rng.rand(R, K), axis=1).astype(np.float32)
    te = ts + 0.02
    sig = (rng.rand(R, K) * 30).astype(np.float32)
    sig[:4] = 1e4  # saturated alpha == 1: the exclusive cumprod must hold
    masks = rng.rand(R, K) < 0.7
    rgb = rng.rand(R, K, 3).astype(np.float32)
    J = dict(t_starts=jnp.asarray(ts), t_ends=jnp.asarray(te),
             sigmas=jnp.asarray(sig), masks=jnp.asarray(masks))
    T = {k: torch.as_tensor(np.array(v)) for k, v in J.items()}
    w_j = jvr.render_weight_from_density_dense(**J)
    w_t = pvr.render_weight_from_density_dense(**T)
    _close(w_t, w_j)
    alphas = 1.0 - np.exp(-sig * (te - ts))
    _close(pvr.render_transmittance_from_alpha_dense(
               torch.as_tensor(alphas), T["masks"]),
           jvr.render_transmittance_from_alpha_dense(jnp.asarray(alphas),
                                                     J["masks"]))
    for thre in (0.0, 0.3):
        np.testing.assert_array_equal(
            pvr.render_visibility_dense(torch.as_tensor(alphas), T["masks"],
                                        early_stop_eps=1e-3,
                                        alpha_thre=thre).numpy(),
            np.asarray(jvr.render_visibility_dense(
                jnp.asarray(alphas), J["masks"], early_stop_eps=1e-3,
                alpha_thre=thre)),
        )
    _close(pvr.accumulate_along_rays_dense(w_t, torch.as_tensor(rgb),
                                           T["masks"]),
           jvr.accumulate_along_rays_dense(w_j, jnp.asarray(rgb), J["masks"]))
    _close(pvr.accumulate_along_rays_dense(w_t), jvr.accumulate_along_rays_dense(w_j))
