"""The port's proposal sampling (``sampling.py``), dense CDF resampling
(``cdf.py``) and dense distortion loss (``losses.py``) against the JAX
package, on the same numpy-seeded inputs.

Tolerances, with their reasons:
- ``ray_resampling_dense``: the JAX package's own bound for the dense
  resampler against the flat one (``tests/test_sampling.py``), rtol 1e-4,
  atol 1e-5 on t; masks equal. The interval of a bin target is the rank
  ``sum_k (cdf < u)``, and the two libraries' normalised row cumsums
  differ in the last bits: where a rank differs, the target must lie
  between the two CDF values there, and those within 6 ulps of each other
  (measured: up to 6, on rows whose padding puts ``k / count`` exactly on
  a target; the "zero" case has such flips, the others none). Such bins
  are counted and left out of the t check.
- ``distortion_dense``: the JAX package's bound (``tests/test_sampling.py``),
  rtol 1e-4, atol 1e-7, on the value and on its gradient in the weights.
- ``sample_along_rays``: masks bit-equal; t rtol 1e-5, atol 1e-6 (the
  march's bound in ``tests/test_pallas_ops.py``).
- ``proposal_sampling_with_filter``: the resampled segments as the
  resampler's; each round's weights rtol 1e-4, atol 1e-6 (f32 dense
  weights of densities equal to f32 rounding); the proposal field's
  parameter gradients through round 0's weights within 1e-4 of the
  largest |gradient| (bf16 heads: a bf16 rounding flip of one head
  activation moves a gradient entry by ~4e-3 of itself, not the whole).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu as jx
from nerfacc_tpu.cdf import ray_resampling_dense as jax_resample
from nerfacc_tpu.losses import distortion_dense as jax_distortion
from nerfacc_tpu.models import TensoCPRadianceField as JaxTensoCP
from nerfacc_tpu_torch import (
    loss_distortion_dense,
    proposal_sampling_with_filter,
    ray_resampling_dense,
    sample_along_rays,
)
from nerfacc_tpu_torch.cdf import resampling_targets, weight_cdf
from nerfacc_tpu_torch.convert import grid_from_arrays, tensocp_from_flax
from nerfacc_tpu_torch.models import TensoCPRadianceField

torch.set_num_threads(1)

RESAMPLE_TOL = dict(rtol=1e-4, atol=1e-5)
T_TOL = dict(rtol=1e-5, atol=1e-6)
# the two libraries' CDFs differ by up to this many f32 ulps at a target
SEAM_ULPS = 6
AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
PROP_LEVELS = ((16, 32),)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _resample_inputs(case, R=48, K=24, seed=1):
    """(t_starts, t_ends, weights, masks) of one case, numpy f32."""
    rng = np.random.RandomState(seed)
    edges = np.cumsum(rng.rand(R, K + 1) * 0.1, axis=1).astype(np.float32)
    t0, t1 = edges[:, :-1], edges[:, 1:]
    if case == "overlapping":  # the JAX package's own inputs
        t0 = np.sort(rng.rand(R, K), axis=1).astype(np.float32)
        t1 = t0 + np.float32(0.05)
    w = rng.rand(R, K).astype(np.float32)
    w[rng.rand(R, K) < 0.3] = 0.0
    masks = np.ones((R, K), bool)
    if case in ("masked", "overlapping"):
        masks = rng.rand(R, K) < 0.8
    elif case == "zero":  # padding only: uniform in the live intervals
        w[:] = 0.0
        masks = rng.rand(R, K) < 0.5
    elif case == "dead":  # rays with no live sample, and tiny weights
        masks = rng.rand(R, K) < 0.7
        masks[::5] = False
        w[1::7] *= 1e-7
    return t0, t1, w, masks


def _ranks(cdf, u):
    return (cdf[:, :, None] < u[None, None, :]).sum(axis=1)


@pytest.mark.parametrize("n_samples", [8, 31])
@pytest.mark.parametrize("case", ["random", "masked", "overlapping", "zero",
                                  "dead"])
def test_ray_resampling_dense_matches_jax(case, n_samples):
    t0, t1, w, masks = _resample_inputs(case)
    ts, te, m = ray_resampling_dense(_t(t0), _t(t1), _t(w), n_samples,
                                     masks=_t(masks))
    ts_j, te_j, m_j = jax_resample(jnp.asarray(t0), jnp.asarray(t1),
                                   jnp.asarray(w), n_samples,
                                   masks=jnp.asarray(masks))
    assert ts.shape == (48, n_samples) and m.dtype == torch.bool
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    alive = masks.any(axis=1)
    assert np.array_equal(m.numpy()[:, 0], alive)
    assert (ts.numpy()[~alive] == 0).all() and (te.numpy()[~alive] == 0).all()
    # the rank of each bin target in both libraries' CDF (the JAX side's
    # as nerfacc_tpu/cdf.py:192-202 computes it)
    cdf_t = weight_cdf(_t(w), _t(masks)).numpy()
    mj = jnp.asarray(masks)
    wj = jnp.where(mj, jnp.maximum(jnp.asarray(w), 0.0), 0.0)
    cnt = mj.sum(axis=1)
    pad = jnp.maximum(1e-5 - wj.sum(axis=1, keepdims=True), 0.0)
    wj = jnp.where(mj, wj + jnp.where(cnt[:, None] > 0, pad / jnp.maximum(
        cnt[:, None], 1), 0.0), 0.0)
    cdf_j = np.asarray(jnp.cumsum(
        wj / jnp.maximum(wj.sum(axis=1, keepdims=True), 1e-20), axis=1))
    u = resampling_targets(n_samples).numpy()
    np.testing.assert_array_equal(u, np.asarray(
        1.0 / (2 * (n_samples + 1)) + jnp.arange(n_samples + 1,
                                                 dtype=jnp.float32)
        * ((1.0 - 1.0 / (n_samples + 1)) / n_samples)))
    r_t, r_j = _ranks(cdf_t, u), _ranks(cdf_j, u)
    flips = np.argwhere(r_t != r_j)
    # a bin on a seam: some CDF entry within a few ulps of its target (the
    # padding-only rows put k / count exactly on a target)
    seam = (np.abs(cdf_t[:, :, None] - u[None, None, :])
            <= SEAM_ULPS * np.spacing(u)[None, None, :]).any(axis=1)
    for r, b in flips:
        k = min(r_t[r, b], r_j[r, b])
        lo, hi = sorted((cdf_t[r, k], cdf_j[r, k]))
        assert lo < u[b] <= hi, (r, b)
        assert hi - lo <= SEAM_ULPS * np.spacing(u[b]), (r, b)
    assert len(flips) <= int(seam.sum()), (len(flips), int(seam.sum()))
    if case != "zero":
        assert len(flips) == 0, len(flips)
    # t wherever the bound took the same interval on both sides (bound b
    # starts interval b and ends interval b - 1)
    bounds_ok = np.ones((48, n_samples + 1), bool)
    bounds_ok[flips[:, 0], flips[:, 1]] = False
    ok_s, ok_e = bounds_ok[:, :-1], bounds_ok[:, 1:]
    np.testing.assert_allclose(ts.numpy()[ok_s], np.asarray(ts_j)[ok_s],
                               **RESAMPLE_TOL)
    np.testing.assert_allclose(te.numpy()[ok_e], np.asarray(te_j)[ok_e],
                               **RESAMPLE_TOL)
    if case != "overlapping":  # contiguous intervals resample in order
        live = m.numpy()
        assert (te.numpy()[live] >= ts.numpy()[live]).all()


def test_ray_resampling_dense_concentrates():
    # resampled intervals cluster where the mass is (t in [10, 14))
    R, K = 4, 32
    t0 = torch.arange(K, dtype=torch.float32)[None].expand(R, K)
    w = torch.zeros((R, K))
    w[:, 10:14] = 1.0
    ts, te, m = ray_resampling_dense(t0, t0 + 1.0, w, 16)
    assert ts.shape == (R, 16) and bool(m.all())
    assert bool((ts >= 9.0).all() and (te <= 15.0).all() and (te > ts).all())


@pytest.mark.parametrize("masked", [False, True])
def test_distortion_dense_value_and_gradient_match_jax(masked):
    rng = np.random.RandomState(3)
    R, K = 40, 20
    t0 = np.sort(rng.rand(R, K), axis=1).astype(np.float32)
    t1 = (t0 + 0.02).astype(np.float32)
    w = (rng.rand(R, K) * 0.1).astype(np.float32)
    masks = rng.rand(R, K) < 0.7 if masked else None
    g = rng.randn(R).astype(np.float32)
    jm = None if masks is None else jnp.asarray(masks)
    want = jax_distortion(jnp.asarray(w), jnp.asarray(t0), jnp.asarray(t1),
                          masks=jm)
    want_g = jax.grad(lambda w_: jnp.sum(jax_distortion(
        w_, jnp.asarray(t0), jnp.asarray(t1), masks=jm) * g))(jnp.asarray(w))
    wt = _t(w).requires_grad_()
    got = loss_distortion_dense(wt, _t(t0), _t(t1),
                                masks=None if masks is None else _t(masks))
    (got * _t(g)).sum().backward()
    assert got.shape == (R,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-7)
    if masked:
        assert (wt.grad.numpy()[~masks] == 0).all()


def test_distortion_dense_zero_for_a_point_mass():
    t0 = torch.arange(10, dtype=torch.float32)[None]
    t1 = t0 + 0.01
    point = torch.zeros((1, 10))
    point[0, 5] = 1.0
    spread = torch.zeros((1, 10))
    spread[0, 1] = spread[0, 8] = 0.5
    l_point = float(loss_distortion_dense(point, t0, t1)[0])
    l_spread = float(loss_distortion_dense(spread, t0, t1)[0])
    want = float(jax_distortion(jnp.asarray(point.numpy()),
                                jnp.asarray(t0.numpy()),
                                jnp.asarray(t1.numpy()))[0])
    assert l_point < 0.01 and l_spread > l_point + 1.0
    np.testing.assert_allclose(l_point, want, rtol=1e-4, atol=1e-7)


def _rays(n=64, seed=0):
    """Rays from a sphere of radius 2.6 toward the box, some missing it."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = 2.6 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 1.2
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _grids():
    rng = np.random.RandomState(2)
    binary = np.zeros((16, 16, 16), bool)
    binary[3:13, 3:13, 3:13] = rng.rand(10, 10, 10) < 0.4
    jgrid = jx.with_binary(jx.create_grid(jnp.asarray(AABB), resolution=16),
                           jnp.asarray(binary))
    return jgrid, grid_from_arrays(AABB, binary, device="cpu")


def _assert_segments(got, want):
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    for name in ("t_starts", "t_ends", "deltas"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **T_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["float", "float_steps", "tensor",
                                  "grid_exact", "grid_strided", "cone"])
def test_sample_along_rays_matches_jax(mode):
    o, d = _rays()
    rng = np.random.RandomState(4)
    t_min = (rng.rand(64) * 0.5 + 0.8).astype(np.float32)
    t_max = (t_min + rng.rand(64) * 2.0).astype(np.float32)
    kw, jkw = {}, {}
    if mode == "float":
        args = (0.5, 4.2, 0.05)
    elif mode == "float_steps":
        args, kw = (0.5, 4.2, 0.05), dict(num_steps=40)
    else:
        args = (t_min, t_max, 0.02)
        kw = dict(num_steps=128, slots_per_ray=64)
    if mode == "cone":
        kw.update(cone_angle=0.05)
    if mode.startswith("grid"):
        jgrid, tgrid = _grids()
        kw.update(coarse_stride=8 if mode == "grid_strided" else 1)
        jkw, kw = dict(kw, grid=jgrid), dict(kw, grid=tgrid)
    else:
        jkw = dict(kw)
    conv = ((lambda a: jnp.asarray(a)) if mode not in ("float", "float_steps")
            else (lambda a: a))
    want = jx.sample_along_rays(jnp.asarray(o), jnp.asarray(d),
                                conv(args[0]), conv(args[1]),
                                step_size=args[2], **jkw)
    tconv = (_t if mode not in ("float", "float_steps") else (lambda a: a))
    got = sample_along_rays(_t(o), _t(d), tconv(args[0]), tconv(args[1]),
                            step_size=args[2], **kw)
    _assert_segments(got, want)
    if mode == "float":  # floor((4.2 - 0.5) / 0.05) steps, every one live
        assert got.t_starts.shape == (64, 74) and bool(got.masks.all())
    if mode.startswith("grid"):
        assert 0 < int(got.masks.sum()) < got.masks.numel()


def test_sample_along_rays_needs_steps_for_tensor_ranges():
    o, d = _rays(4)
    with pytest.raises(ValueError, match="num_steps"):
        sample_along_rays(_t(o), _t(d), torch.zeros(4), torch.ones(4), 0.1)


def _slab_j(ts, te):
    tm = (ts + te) / 2
    return jnp.where((tm > 1.6) & (tm < 2.2), 50.0, 0.05)


def _slab_t(ts, te):
    tm = (ts + te) / 2
    return torch.where((tm > 1.6) & (tm < 2.2), torch.tensor(50.0),
                       torch.tensor(0.05))


@pytest.fixture(scope="module")
def proposal_pair():
    """The proposal field of the proposal trainer (one level of 32
    features, no view directions, a 7-wide geometric feature) in both
    packages, from the same flax parameters."""
    kw = dict(aabb=AABB, levels=PROP_LEVELS, use_viewdirs=False,
              geo_feat_dim=7, density_bias=1.0)
    jfield = JaxTensoCP(**kw)
    params = jfield.init(jax.random.PRNGKey(3), jnp.zeros((4, 3)), None)
    tfield = TensoCPRadianceField(device="cpu", **kw)
    tensocp_from_flax(jax.tree_util.tree_map(np.asarray, params), tfield)
    return jfield, params, tfield


def _field_density_fns(pair, o, d):
    jfield, _, tfield = pair

    def jfn(params):
        def fn(ts, te):
            x = (jnp.asarray(o)[:, None] + ((ts + te) * 0.5)[..., None]
                 * jnp.asarray(d)[:, None])
            return jfield.apply(params, x.reshape(-1, 3),
                                method=jfield.query_density).reshape(ts.shape)
        return fn

    def tfn(ts, te):
        x = _t(o)[:, None] + ((ts + te) * 0.5)[..., None] * _t(d)[:, None]
        return tfield.query_density(x.reshape(-1, 3)).reshape(ts.shape)

    return jfn, tfn


@pytest.mark.parametrize("density", ["slab", "field"])
@pytest.mark.parametrize("rounds,filtered,final", [
    (1, False, False), (1, True, False), (2, False, False), (2, True, True),
])
def test_proposal_sampling_matches_jax(proposal_pair, density, rounds,
                                       filtered, final):
    o, d = _rays(48, seed=5)
    jfield, params, tfield = proposal_pair
    segs_j = jx.sample_along_rays(jnp.asarray(o), jnp.asarray(d), 0.5, 4.5,
                                  step_size=4.0 / 48)
    segs_t = sample_along_rays(_t(o), _t(d), 0.5, 4.5, step_size=4.0 / 48)
    if density == "slab":
        jfn, tfn = (lambda p: _slab_j), _slab_t
    else:
        jfn, tfn = _field_density_fns(proposal_pair, o, d)
    n = (24, 16)[:rounds]
    kw = dict(proposal_n_samples=n, proposal_require_grads=True,
              early_stop_eps=1e-4 if filtered else 0.0,
              alpha_thre=1e-2 if filtered else 0.0)
    rng = np.random.RandomState(6)
    g0 = rng.randn(48, 48).astype(np.float32)

    def run_j(p):
        out, props = jx.proposal_sampling_with_filter(
            segs_j, sigma_fn=_slab_j if final else None,
            proposal_sigma_fns=[jfn(p)] * rounds, **kw)
        return jnp.sum(props[0][2] * g0), (out, props)

    (_, (out_j, props_j)), grads_j = jax.value_and_grad(
        run_j, has_aux=True)(params)
    tfield.zero_grad(set_to_none=True)
    out_t, props_t = proposal_sampling_with_filter(
        segs_t, sigma_fn=_slab_t if final else None,
        proposal_sigma_fns=[tfn] * rounds, **kw)
    assert len(props_t) == rounds
    assert out_t.t_starts.shape == (48, n[-1])
    np.testing.assert_array_equal(out_t.masks.numpy(), np.asarray(out_j.masks))
    np.testing.assert_allclose(out_t.t_starts.numpy(),
                               np.asarray(out_j.t_starts), **RESAMPLE_TOL)
    np.testing.assert_allclose(out_t.t_ends.numpy(), np.asarray(out_j.t_ends),
                               **RESAMPLE_TOL)
    if filtered:  # the filter culled something in the last round
        live = int(props_t[-1][3].sum())
        assert 0 < live < props_t[-1][3].numel()
    for (ts, te, w, m), (tsj, tej, wj, mj) in zip(props_t, props_j):
        np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
        np.testing.assert_allclose(ts.numpy(), np.asarray(tsj),
                                   **RESAMPLE_TOL)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(wj),
                                   rtol=1e-4, atol=1e-6)
    if density == "slab":
        return
    # the resampling took the detached weights: the gradient of round 0's
    # weights reaches the field only through them
    (props_t[0][2] * _t(g0)).sum().backward()
    want = jax.tree_util.tree_map(np.asarray, grads_j)
    holder = TensoCPRadianceField(device="cpu", aabb=AABB, levels=PROP_LEVELS,
                                  use_viewdirs=False, geo_feat_dim=7)
    tensocp_from_flax(want, holder)
    for (name, p), (_, q) in zip(tfield.named_parameters(),
                                 holder.named_parameters()):
        q = q.detach()
        if name.startswith("mlp_head"):  # the colour head: no density path
            assert p.grad is None and float(q.abs().max()) == 0.0, name
            continue
        scale = float(q.abs().max())
        assert p.grad is not None and scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), q.numpy(), rtol=0.0,
                                   atol=1e-4 * scale, err_msg=name)


def test_proposal_sampling_concentrates_on_the_slab():
    o, d = _rays(16, seed=2)
    segs = sample_along_rays(_t(o), _t(d), 0.5, 4.5, step_size=4.0 / 64)
    out, props = proposal_sampling_with_filter(
        segs, sigma_fn=_slab_t, proposal_sigma_fns=[_slab_t, _slab_t],
        proposal_n_samples=[32, 16], proposal_require_grads=True,
        early_stop_eps=1e-4, alpha_thre=1e-3)
    assert out.t_starts.shape == (16, 16) and len(props) == 2
    m = out.masks.numpy()
    tm = ((out.t_starts + out.t_ends) / 2).numpy()[m]
    assert m.any() and ((tm > 1.5) & (tm < 2.3)).mean() > 0.8
    with pytest.raises(ValueError, match="same length"):
        proposal_sampling_with_filter(segs, proposal_sigma_fns=[_slab_t],
                                      proposal_n_samples=[8, 8])
