"""The port's march path vs the JAX package: contraction, ray/AABB
intersection, the closed-form lattice, occupancy-grid queries, the grouped
march and the dense rendering (forward, the alpha weights' closed-form
gradient, ``rendering_dense``), and the names the port exports.

Inputs come from numpy seeds and go to both packages. Integer and boolean
results (grid bits, slot masks) must be bit-equal. Float results agree to
f32 rounding: XLA contracts multiply-adds into FMAs and sums cumsums in its
own order, so t values move by ~1e-7 (rtol 1e-5 / atol 1e-6).
"""

import importlib

import jax
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
    return jgrid, grid_from_arrays(AABB, binary, device="cpu")


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


def _dense_case(seed, with_masks, R=16, K=24):
    rng = np.random.RandomState(seed)
    ts = np.sort(rng.rand(R, K) * 3, axis=1).astype(np.float32)
    te = (ts + rng.rand(R, K) * 0.05 + 1e-3).astype(np.float32)
    sig = (rng.rand(R, K) * 20).astype(np.float32)
    masks = rng.rand(R, K) < 0.8 if with_masks else None
    rgb = rng.rand(R, K, 3).astype(np.float32)
    return ts, te, sig, masks, rgb


def _opt(fn, a):
    return None if a is None else fn(a)


@pytest.mark.parametrize("with_masks", [True, False])
def test_alpha_weights_and_gradient_match_jax(with_masks):
    ts, te, sig, masks, _ = _dense_case(11, with_masks)
    alphas = (1.0 - np.exp(-sig * (te - ts))).astype(np.float32)
    alphas[0, 3] = 1.0  # an opaque slot: every later weight is exactly 0
    g = np.random.RandomState(12).randn(*alphas.shape).astype(np.float32)
    w_j, vjp = jax.vjp(
        lambda a: jvr.render_weight_from_alpha_dense(
            a, masks=_opt(jnp.asarray, masks)),
        jnp.asarray(alphas))
    a_t = torch.as_tensor(alphas).requires_grad_()
    w_t = pt.render_weight_from_alpha_dense(
        a_t, masks=_opt(torch.as_tensor, masks))
    _close(w_t.detach(), w_j)
    if not with_masks or masks[0, 3]:
        assert bool((w_t[0, 4:] == 0).all())
    w_t.backward(torch.as_tensor(g))
    _close(a_t.grad, vjp(jnp.asarray(g))[0], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("with_masks", [True, False])
def test_transmittance_from_density_dense_matches_jax(with_masks):
    ts, te, sig, masks, _ = _dense_case(13, with_masks)
    got = pt.render_transmittance_from_density_dense(
        *map(torch.as_tensor, (ts, te, sig)),
        masks=_opt(torch.as_tensor, masks))
    want = jvr.render_transmittance_from_density_dense(
        *map(jnp.asarray, (ts, te, sig)), masks=_opt(jnp.asarray, masks))
    _close(got, want)
    assert bool((got[:, 0] == 1).all())


@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("kind", ["sigma", "alpha"])
def test_rendering_dense_matches_jax(kind, with_masks):
    ts, te, sig, masks, rgb = _dense_case(14, with_masks)

    def callbacks(xp, exp):
        rgbs, sigmas = xp(rgb), xp(sig)
        if kind == "sigma":
            return dict(rgb_sigma_fn=lambda a, b: (rgbs, sigmas))
        return dict(
            rgb_alpha_fn=lambda a, b: (rgbs, 1.0 - exp(-sigmas * (b - a))))

    want = jx.rendering_dense(
        jnp.asarray(ts), jnp.asarray(te), _opt(jnp.asarray, masks),
        render_bkgd=jnp.ones(3), **callbacks(jnp.asarray, jnp.exp))
    got = pt.rendering_dense(
        torch.as_tensor(ts), torch.as_tensor(te),
        _opt(torch.as_tensor, masks), render_bkgd=torch.ones(3),
        **callbacks(torch.as_tensor, torch.exp))
    for a, b, width in zip(got, want, (3, 1, 1)):
        assert a.shape == (ts.shape[0], width)
        _close(a, b)
    with pytest.raises(ValueError):
        pt.rendering_dense(torch.as_tensor(ts), torch.as_tensor(te), None)


def test_rendering_dense_gradient_matches_jax():
    # the field callback's sigma gradient through the closed-form backward
    ts, te, sig, masks, rgb = _dense_case(15, True)

    def loss_j(s):
        c, o, d = jx.rendering_dense(
            jnp.asarray(ts), jnp.asarray(te), jnp.asarray(masks),
            rgb_sigma_fn=lambda a, b: (jnp.asarray(rgb), s))
        return jnp.sum(c ** 2) + jnp.sum(o) + jnp.sum(d * 0.5)

    s_t = torch.as_tensor(sig).requires_grad_()
    c, o, d = pt.rendering_dense(
        torch.as_tensor(ts).requires_grad_(), torch.as_tensor(te),
        torch.as_tensor(masks),
        rgb_sigma_fn=lambda a, b: (torch.as_tensor(rgb), s_t))
    (torch.sum(c ** 2) + torch.sum(o) + torch.sum(d * 0.5)).backward()
    _close(s_t.grad, jax.grad(loss_j)(jnp.asarray(sig)), rtol=1e-4,
           atol=1e-6)


def test_port_exports_the_reference_names_it_claims():
    # every name the port lists is one the JAX package lists or a name of
    # the port's own path, and each resolves
    for name in pt.__all__:
        assert getattr(pt, name) is not None, name
    shared = set(pt.__all__) & set(jx.__all__)
    for name in ("Grid", "OccupancyGrid", "rendering_dense",
                 "render_weight_from_alpha_dense",
                 "render_weight_from_density_dense",
                 "render_visibility_dense", "accumulate_along_rays_dense",
                 "march_rays", "RaySegments", "update_grid"):
        assert name in shared, name
    for name in ("render_transmittance_from_alpha_dense",
                 "render_transmittance_from_density_dense"):
        assert name in pt.__all__ and hasattr(jvr, name)
    assert pt.Grid is pt.OccupancyGrid and jx.Grid is jx.OccupancyGrid
