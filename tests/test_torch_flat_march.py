"""The port's flat user path against the JAX package's: ``ray_marching()``
into ``PackedSamples``, ``make_field_fns``' closures, ``rendering()`` over
them, flat ``ray_resampling`` and ``loss_distortion``, and the package's
names, on the same numpy-seeded inputs. JAX runs its Pallas kernels in
interpret mode; the port's wrappers run their plain twins on the CPU.

Tolerances, with their reasons:
- the march: masks and int32 ``ray_indices`` bit-equal, t within T_RTOL /
  T_ATOL = 1e-5 / 1e-6 (``tests/test_torch_march.py``: XLA contracts
  multiply-adds into FMAs and sums cumsums in its own order). The cull's
  densities are an analytic function, the same f32 operations on both
  sides, so its masks are bit-equal too.
- the closures: the TensoCP field within rtol 1e-4 / atol 1e-5
  (``tests/test_torch_tensorf.py``), the D-NeRF field within rtol 1e-5 /
  atol 1e-5 (``tests/test_torch_dnerf.py``'s f32 MLPs).
- the flat path end to end (TensoCP field on its kernel path): a slot's
  visibility flips at ``early_stop_eps`` only where the field's f32
  rounding moves its transmittance across it, at most 2 slots
  (``tests/test_torch_render.py``); renders within 1e-4 absolute.
- ``ray_resampling``: as ``tests/test_torch_sampling.py`` holds the dense
  resampler, masks equal and t within rtol 1e-4 / atol 1e-5, except bins
  whose target lies within SEAM_ULPS f32 ulps of the searched CDF value
  (the two libraries' scans differ in the last bits; such bins are
  counted, bounded and left out of the t check).
- ``loss_distortion``: rtol 1e-4 / atol 1e-7 against JAX on value and
  gradient (``tests/test_torch_sampling.py``); rtol 1e-4 / atol 1e-5
  against the O(S^2) oracle (``tests/test_loss.py``).
"""

import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu as jx
import nerfacc_tpu_torch as pt
import nerfacc_tpu_torch.vol_rendering as pvr
from nerfacc_tpu.models import DNeRFRadianceField as JaxDNeRF
from nerfacc_tpu.models import TensoCPRadianceField as JaxTensoCP
from nerfacc_tpu.utils import make_field_fns as jax_make_field_fns
from nerfacc_tpu_torch.convert import (
    dnerf_from_flax,
    grid_from_arrays,
    tensocp_from_flax,
)
from nerfacc_tpu_torch.models import DNeRFRadianceField, TensoCPRadianceField

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
T_RTOL, T_ATOL = 1e-5, 1e-6
FIELD_TOL = dict(rtol=1e-4, atol=1e-5)
RESAMPLE_TOL = dict(rtol=1e-4, atol=1e-5)
SEAM_ULPS = 6
N_RAYS = 64


def _t(a):
    return torch.as_tensor(np.array(a))


def _rays(n, seed, radius=2.5):
    """Rays from outside the box aimed near its centre; some miss it."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = radius * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 0.8
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _binary(seed=0, res=32):
    rng = np.random.RandomState(seed)
    b = np.zeros((res,) * 3, bool)
    b[6:26, 6:26, 6:26] = rng.rand(20, 20, 20) < 0.5
    return b


def _grids(binary):
    jgrid = jx.with_binary(jx.create_grid(jnp.asarray(AABB), resolution=32),
                           jnp.asarray(binary))
    return jgrid, grid_from_arrays(AABB, binary, device="cpu")


def _ball_density(lib):
    """sigma = 40 inside the ball of radius 0.6: an analytic field with the
    same f32 operations in both libraries."""
    xp = jnp if lib == "jax" else torch

    def fn(o, d):
        def sigma_fn(ts, te, ri):
            ri = ri if lib == "jax" else ri.long()
            x = o[ri] + (ts + te) / 2.0 * d[ri]
            r2 = (x * x).sum(-1, keepdims=True)
            return xp.where(r2 < 0.36, 40.0, 0.0) * xp.ones_like(ts)
        return sigma_fn

    return fn


CASES = {
    "near-far": dict(near_plane=0.5, far_plane=4.0, render_step_size=2e-2,
                     max_samples_per_ray=256),
    "grid": dict(scene_aabb=AABB, grid=True, render_step_size=1e-2,
                 max_samples_per_ray=512, samples_budget=N_RAYS * 32,
                 coarse_stride=8, probe_dilation=1, probe_groups=16),
    "grid, exact probes": dict(scene_aabb=AABB, grid=True,
                               render_step_size=1e-2,
                               max_samples_per_ray=256,
                               samples_budget=N_RAYS * 24),
    "cone": dict(scene_aabb=AABB, grid=True, render_step_size=1e-2,
                 cone_angle=0.004, max_samples_per_ray=512,
                 samples_budget=N_RAYS * 32, coarse_stride=8,
                 probe_groups=16),
    "cull": dict(scene_aabb=AABB, grid=True, render_step_size=1e-2,
                 max_samples_per_ray=512, samples_budget=N_RAYS * 32,
                 coarse_stride=8, probe_dilation=2, probe_groups=16,
                 sigma_fn=True),
    "cull, visible budget": dict(
        scene_aabb=AABB, grid=True, render_step_size=1e-2,
        max_samples_per_ray=512, samples_budget=N_RAYS * 32, coarse_stride=8,
        probe_dilation=2, probe_groups=16, sigma_fn=True,
        visible_samples_budget=N_RAYS * 12),
    "alpha cull": dict(scene_aabb=AABB, render_step_size=2e-2,
                       max_samples_per_ray=256, alpha_fn=True,
                       alpha_thre=0.01, visible_samples_budget=N_RAYS * 8),
}


def _march_kwargs(case, lib, o, d, grids):
    kw = dict(CASES[case])
    arr = jnp.asarray if lib == "jax" else _t
    if kw.pop("grid", False):
        kw["grid"] = grids[0] if lib == "jax" else grids[1]
    if "scene_aabb" in kw:
        kw["scene_aabb"] = arr(np.asarray(AABB, np.float32))
    sigma = _ball_density(lib)(o, d)
    if kw.pop("sigma_fn", False):
        kw["sigma_fn"] = sigma
    if kw.pop("alpha_fn", False):
        kw["alpha_fn"] = lambda ts, te, ri: 1.0 - (jnp if lib == "jax"
                                                  else torch).exp(
            -sigma(ts, te, ri) * (te - ts))
    return kw


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_ray_marching_matches_jax(case, use_pallas):
    o, d = _rays(N_RAYS, seed=2)
    grids = _grids(_binary())
    a = jx.ray_marching(jnp.asarray(o), jnp.asarray(d), use_pallas=use_pallas,
                        **_march_kwargs(case, "jax", jnp.asarray(o),
                                        jnp.asarray(d), grids))
    b = pt.ray_marching(_t(o), _t(d), use_pallas=use_pallas,
                        **_march_kwargs(case, "torch", _t(o), _t(d), grids))
    assert isinstance(b, pt.PackedSamples)
    assert b.ray_indices.dtype == torch.int32
    np.testing.assert_array_equal(b.ray_indices.numpy(),
                                  np.asarray(a.ray_indices))
    np.testing.assert_array_equal(b.masks.numpy(), np.asarray(a.masks))
    assert 0 < int(b.masks.sum()) < b.masks.numel()
    for x, y in ((b.t_starts, a.t_starts), (b.t_ends, a.t_ends)):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=T_RTOL,
                                   atol=T_ATOL)


def test_visible_budget_repacks_the_visible_samples():
    o, d = _rays(N_RAYS, seed=4)
    grids = _grids(_binary())
    kw = _march_kwargs("cull", "torch", _t(o), _t(d), grids)
    culled = pt.ray_marching(_t(o), _t(d), **kw)
    small = pt.ray_marching(_t(o), _t(d), visible_samples_budget=N_RAYS * 12,
                            **kw)
    assert small.masks.shape == (N_RAYS * 12,)
    assert int(small.masks.sum()) > 0
    # no ray keeps more visible samples than it had, and none more than 12
    per_ray = small.masks.reshape(N_RAYS, 12).sum(1)
    before = culled.masks.reshape(N_RAYS, -1).sum(1)
    assert (per_ray <= torch.clamp(before, max=12)).all()
    assert ((per_ray > 0) == (before > 0)).all()
    plain = pt.ray_marching(_t(o), _t(d), sigma_fn=kw["sigma_fn"],
                            scene_aabb=_t(np.asarray(AABB, np.float32)),
                            render_step_size=1e-2, max_samples_per_ray=512,
                            samples_budget=N_RAYS * 32)
    assert int(plain.masks.sum()) >= int(culled.masks.sum())


def test_stratified_needs_a_generator_and_jitters():
    o, d = _rays(16, seed=5)
    kw = dict(near_plane=0.5, far_plane=4.0, render_step_size=2e-2,
              max_samples_per_ray=256)
    with pytest.raises(ValueError, match="generator"):
        pt.ray_marching(_t(o), _t(d), stratified=True, **kw)
    base = pt.ray_marching(_t(o), _t(d), **kw)
    a = pt.ray_marching(_t(o), _t(d), stratified=True,
                        generator=torch.Generator().manual_seed(0), **kw)
    b = pt.ray_marching(_t(o), _t(d), stratified=True,
                        generator=torch.Generator().manual_seed(0), **kw)
    assert torch.equal(a.t_starts, b.t_starts)
    shift = (a.t_starts - base.t_starts)[a.masks & base.masks]
    assert (shift >= 0).all() and (shift < 2e-2).all() and shift.max() > 0


def test_starvation_warning():
    o, d = _rays(8, seed=6)
    kw = dict(near_plane=0.25, far_plane=7.75, render_step_size=1e-2,
              max_samples_per_ray=64)
    with pytest.warns(RuntimeWarning, match="max_samples_per_ray=64"):
        pt.ray_marching(_t(o), _t(d), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per configuration
        pt.ray_marching(_t(o), _t(d), **kw)


def test_ray_segments_flat_views():
    segs = pt.RaySegments(*(torch.zeros(3, 4) for _ in range(3)),
                          torch.ones(3, 4, dtype=torch.bool))
    assert segs.n_rays == 3 and segs.slots_per_ray == 4
    assert segs.ray_indices.dtype == torch.int32
    assert segs.ray_indices.tolist() == [0] * 4 + [1] * 4 + [2] * 4


@pytest.fixture(scope="module")
def tensocp():
    kw = dict(aabb=AABB, levels=((16, 8), (32, 16)), use_kernel=True,
              density_bias=3.0)
    jfield = JaxTensoCP(**kw)
    x0 = jnp.zeros((8, 3))
    params = jfield.init(jax.random.PRNGKey(1), x0, x0)
    tfield = TensoCPRadianceField(device="cpu", **kw)
    tensocp_from_flax(jax.tree_util.tree_map(np.asarray, params), tfield)
    return jfield, params, tfield


def _some_samples(n_rays, seed):
    o, d = _rays(n_rays, seed)
    s = pt.ray_marching(_t(o), _t(d), near_plane=1.0, far_plane=4.0,
                        render_step_size=0.1, max_samples_per_ray=32)
    return o, d, s


def test_make_field_fns_match_jax(tensocp):
    jfield, params, tfield = tensocp
    o, d, s = _some_samples(16, seed=7)
    sigma_j, rgb_sigma_j = jax_make_field_fns(jfield, params, jnp.asarray(o),
                                              jnp.asarray(d))
    sigma_t, rgb_sigma_t = pt.make_field_fns(tfield, _t(o), _t(d))
    args_t = (s.t_starts, s.t_ends, s.ray_indices)
    args_j = tuple(jnp.asarray(a.numpy()) for a in args_t)
    with torch.no_grad():
        sig = sigma_t(*args_t)
        rgb, sig2 = rgb_sigma_t(*args_t)
    n = s.t_starts.shape[0]
    assert sig.shape == (n, 1) and rgb.shape == (n, 3) and sig2.shape == (n, 1)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sigma_j(*args_j)),
                               **FIELD_TOL)
    rgb_j, sig_j = rgb_sigma_j(*args_j)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), **FIELD_TOL)
    np.testing.assert_allclose(sig2.numpy(), np.asarray(sig_j), **FIELD_TOL)
    assert float(sig.max()) > 0


def test_make_field_fns_take_each_rays_time():
    jfield = JaxDNeRF()
    x0 = jnp.zeros((8, 3))
    params = jfield.init(jax.random.PRNGKey(1), x0, jnp.zeros((8, 1)), x0)
    tfield = DNeRFRadianceField(device="cpu")
    dnerf_from_flax(jax.tree_util.tree_map(np.asarray, params), tfield)
    o, d, s = _some_samples(12, seed=8)
    times = np.random.RandomState(8).rand(12, 1).astype(np.float32)
    sigma_j, rgb_sigma_j = jax_make_field_fns(
        jfield, params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(times))
    sigma_t, rgb_sigma_t = pt.make_field_fns(tfield, _t(o), _t(d), _t(times))
    args_t = (s.t_starts, s.t_ends, s.ray_indices)
    args_j = tuple(jnp.asarray(a.numpy()) for a in args_t)
    tol = dict(rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(sigma_t(*args_t).numpy(),
                                   np.asarray(sigma_j(*args_j)), **tol)
        rgb, sig = rgb_sigma_t(*args_t)
        # the time reaches the field: another time, other densities
        other = pt.make_field_fns(tfield, _t(o), _t(d), _t(1.0 - times))[0]
        assert not torch.allclose(other(*args_t), sig)
    rgb_j, sig_j = rgb_sigma_j(*args_j)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), **tol)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), **tol)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_flat_path_end_to_end_matches_jax(tensocp, use_pallas):
    # the reference's two calls: ray_marching() with the cull, then
    # rendering(), both over make_field_fns' closures
    jfield, params, tfield = tensocp
    jgrid, tgrid = _grids(_binary())
    o, d = _rays(N_RAYS, seed=3)
    kw = dict(render_step_size=1e-2, max_samples_per_ray=512,
              samples_budget=N_RAYS * 32, visible_samples_budget=N_RAYS * 12,
              coarse_stride=8, probe_dilation=2, probe_groups=16,
              use_pallas=use_pallas)
    sj, rsj = jax_make_field_fns(jfield, params, jnp.asarray(o),
                                 jnp.asarray(d))
    pj = jx.ray_marching(jnp.asarray(o), jnp.asarray(d),
                         scene_aabb=jnp.asarray(AABB), grid=jgrid,
                         sigma_fn=sj, **kw)
    out_j = jx.rendering(pj.t_starts, pj.t_ends, pj.ray_indices, N_RAYS,
                         rgb_sigma_fn=rsj, render_bkgd=jnp.ones(3),
                         masks=pj.masks)
    st, rst = pt.make_field_fns(tfield, _t(o), _t(d))
    with torch.no_grad():
        p = pt.ray_marching(_t(o), _t(d), scene_aabb=AABB, grid=tgrid,
                            sigma_fn=st, **kw)
        out_t = pt.rendering(p.t_starts, p.t_ends, p.ray_indices, N_RAYS,
                             rgb_sigma_fn=rst, render_bkgd=torch.ones(3),
                             masks=p.masks)
    flips = int((p.masks.numpy() != np.asarray(pj.masks)).sum())
    assert flips <= 2 and int(p.masks.sum()) > 100
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    assert float(out_t[1].max()) > 0.5


def _ragged(seed, n_rays=24, max_count=30):
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, max_count, n_rays)
    counts[[2, n_rays - 1]] = 0
    ri = np.repeat(np.arange(n_rays), counts).astype(np.int32)
    edges = [np.cumsum(rng.rand(c + 1) * 0.1) for c in counts]
    ts = np.concatenate([e[:-1] for e in edges]).astype(np.float32)
    te = np.concatenate([e[1:] for e in edges]).astype(np.float32)
    w = rng.rand(ri.shape[0]).astype(np.float32)
    w[rng.rand(ri.shape[0]) < 0.3] = 0.0
    m = rng.rand(ri.shape[0]) < 0.8
    return ri, ts, te, w, m, n_rays


def _check_resampled(got, want, n_samples):
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_array_equal(got.packed_info.numpy(),
                                  np.asarray(want.packed_info))
    np.testing.assert_array_equal(got.ray_indices.numpy(),
                                  np.asarray(want.ray_indices))
    # bins whose target sits within SEAM_ULPS ulps of a CDF value may pick
    # the neighbouring interval in one library: count them, skip them
    ts_g, te_g = got.t_starts.numpy()[:, 0], got.t_ends.numpy()[:, 0]
    ts_w, te_w = np.asarray(want.t_starts)[:, 0], np.asarray(want.t_ends)[:, 0]
    ok_s = np.isclose(ts_g, ts_w, **RESAMPLE_TOL)
    ok_e = np.isclose(te_g, te_w, **RESAMPLE_TOL)
    bad = ~(ok_s & ok_e)
    assert bad.sum() <= 0.02 * bad.size, bad.sum()
    return int(bad.sum())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("via", ["ray_indices", "packed_info"])
def test_ray_resampling_matches_jax(seed, via):
    ri, ts, te, w, m, n_rays = _ragged(seed)
    info = np.asarray(jx.pack_info(jnp.asarray(ri), n_rays))
    n = 16
    if via == "ray_indices":
        kj = dict(ray_indices=jnp.asarray(ri), n_rays=n_rays)
        kt = dict(ray_indices=_t(ri), n_rays=n_rays)
        pj = pi = None
    else:
        kj = kt = {}
        pj, pi = jnp.asarray(info), _t(info)
    want = jx.ray_resampling(pj, jnp.asarray(ts[:, None]),
                             jnp.asarray(te[:, None]), jnp.asarray(w), n,
                             masks=jnp.asarray(m), **kj)
    got = pt.ray_resampling(pi, _t(ts[:, None]), _t(te[:, None]), _t(w), n,
                            masks=_t(m), **kt)
    assert isinstance(got, pt.ResampledRays)
    assert got.t_starts.shape == (n_rays * n, 1)
    assert got.packed_info.dtype == torch.int32
    assert _check_resampled(got, want, n) == 0
    live = got.masks.numpy()
    assert not live.reshape(n_rays, n)[[2, n_rays - 1]].any()
    assert (got.t_ends.numpy()[live] >= got.t_starts.numpy()[live]
            - 1e-6).all()


@pytest.mark.parametrize("bridge", [True, False])
def test_dense_layout_resampling_matches_jax(bridge, monkeypatch):
    # a dense ray-major buffer: bridged to the dense twin, or forced
    # through the global searchsorted
    monkeypatch.setattr(pvr, "DENSE_BRIDGE", bridge)
    rng = np.random.RandomState(3)
    R, K, n = 20, 16, 12
    ts = np.sort(rng.rand(R, K), axis=1).astype(np.float32)
    te = (ts + 0.05).astype(np.float32)
    w = rng.rand(R, K).astype(np.float32)
    m = rng.rand(R, K) < 0.8
    m[4] = False
    ri = np.repeat(np.arange(R, dtype=np.int32), K)
    want = jx.ray_resampling(None, jnp.asarray(ts.reshape(-1, 1)),
                             jnp.asarray(te.reshape(-1, 1)),
                             jnp.asarray(w.reshape(-1)), n,
                             ray_indices=jnp.asarray(ri), n_rays=R,
                             masks=jnp.asarray(m.reshape(-1)))
    got = pt.ray_resampling(None, _t(ts.reshape(-1, 1)),
                            _t(te.reshape(-1, 1)), _t(w.reshape(-1)), n,
                            ray_indices=_t(ri), n_rays=R,
                            masks=_t(m.reshape(-1)))
    _check_resampled(got, want, n)


def test_ray_resampling_clamps_at_large_n_rays():
    # past 2^21 rays the f32 ulp of the global CDF's ray offset (0.25)
    # exceeds the first bin target: an unclamped search lands a seam
    # query in the previous ray. Rays carry parity-coded t ranges; every
    # resample must stay in its own
    n_rays = (1 << 21) + 8
    r = torch.arange(n_rays, dtype=torch.int32)
    lo = (r % 2).to(torch.float32) * 5.0
    out = pt.ray_resampling(None, lo[:, None], lo[:, None] + 1.0,
                            torch.ones(n_rays), 2, ray_indices=r,
                            n_rays=n_rays)
    got_s = out.t_starts.reshape(n_rays, 2)
    got_e = out.t_ends.reshape(n_rays, 2)
    assert (got_s >= lo[:, None] - 1e-3).all()
    assert (got_e <= lo[:, None] + 1.0 + 1e-3).all()


def _dense_distortion(w, t1, t2):
    interval = t2 - t1
    tmid = (t1 + t2) / 2
    loss_uni = (1 / 3) * (interval * w**2).sum(-1)
    ww = w[..., :, None] * w[..., None, :]
    mm = np.abs(tmid[..., :, None] - tmid[..., None, :])
    return loss_uni + (ww * mm).sum((-1, -2))


def test_loss_distortion_matches_the_dense_oracle():
    rng = np.random.RandomState(0)
    n_rays, S = 4, 16
    t = np.sort(rng.rand(n_rays, S + 1), axis=-1).astype(np.float32)
    w = rng.rand(n_rays, S).astype(np.float32)
    pvr.DENSE_BRIDGE = False
    try:
        loss = pt.loss_distortion(
            None, _t(w.reshape(-1)), _t(t[:, :-1].reshape(-1, 1)),
            _t(t[:, 1:].reshape(-1, 1)),
            ray_indices=torch.arange(n_rays, dtype=torch.int32
                                     ).repeat_interleave(S),
            n_rays=n_rays)
    finally:
        pvr.DENSE_BRIDGE = True
    np.testing.assert_allclose(loss.numpy(),
                               _dense_distortion(w, t[:, :-1], t[:, 1:]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("via", ["ray_indices", "packed_info"])
def test_loss_distortion_and_gradient_match_jax(via):
    ri, ts, te, w, m, n_rays = _ragged(5)
    info = np.asarray(jx.pack_info(jnp.asarray(ri), n_rays))
    cot = np.random.RandomState(5).rand(n_rays).astype(np.float32)

    def jfn(x):
        if via == "ray_indices":
            return jx.loss_distortion(None, x, jnp.asarray(ts[:, None]),
                                      jnp.asarray(te[:, None]),
                                      ray_indices=jnp.asarray(ri),
                                      n_rays=n_rays, masks=jnp.asarray(m))
        return jx.loss_distortion(jnp.asarray(info), x, jnp.asarray(ts),
                                  jnp.asarray(te), masks=jnp.asarray(m))

    want, vjp = jax.vjp(jfn, jnp.asarray(w))
    x = _t(w).requires_grad_()
    if via == "ray_indices":
        got = pt.loss_distortion(None, x, _t(ts[:, None]), _t(te[:, None]),
                                 ray_indices=_t(ri), n_rays=n_rays,
                                 masks=_t(m))
    else:
        got = pt.loss_distortion(_t(info), x, _t(ts), _t(te), masks=_t(m))
    (got * _t(cot)).sum().backward()
    assert got.shape == (n_rays,)
    tol = dict(rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]), **tol)
    assert (x.grad.numpy()[~m] == 0).all()


def test_star_import_covers_the_jax_names():
    ns = {}
    exec("from nerfacc_tpu_torch import *", ns)
    missing = [n for n in jx.__all__ if n not in ns]
    assert not missing and len(jx.__all__) == 47
    assert pt.__version__ == jx.__version__ == "0.1.0"
    assert set(pt.__all__) >= set(jx.__all__)


def test_unpack_to_ray_indices_warns():
    info = torch.tensor([[0, 2], [2, 1]], dtype=torch.int32)
    with pytest.warns(DeprecationWarning, match="unpack_info"):
        got = pt.unpack_to_ray_indices(info, 3)
    assert got.tolist() == [0, 0, 1]


def test_port_modules_import_no_jax():
    # every module of the package, the flat API's among them
    code = (
        "import pkgutil, importlib, sys\n"
        "import nerfacc_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'nerfacc_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert {'nerfacc_tpu_torch.scan', 'nerfacc_tpu_torch.pack', "
        "'nerfacc_tpu_torch.version'} <= set(names), names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nerfacc_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
