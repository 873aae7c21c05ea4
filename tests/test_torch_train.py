"""The port's training step vs the JAX package's, piece by piece and whole.

Inputs come from numpy seeds and the same flax parameters go to both
packages. JAX runs its Pallas kernels in interpret mode; the port's
wrappers run their plain twins on the CPU.

Tolerances, with their reasons:
- ``trunc_exp``, the dense weights and Adam: f32 rounding (rtol 1e-5 or
  tighter).
- Field gradients: the heads' gradients (and every gradient of the
  ``use_kernel=False`` field) are bf16 values rounded once from f32 sums,
  and measured bit-equal to JAX's: rtol 1e-6, atol 1e-6 of the largest
  |gradient|. The CP tables' gradients on the kernel path carry K4's bf16
  rounding of ``d``, which XLA's CPU compiler skips in interpret mode
  (see test_torch_cp_backward.py); measured within 2.2e-3 of the largest
  |gradient|. Held to the JAX package's own bound for that kernel
  (rtol 5e-2, atol 4e-3 at |dT| ~ 1), with the atol scaled to the
  table's largest |gradient|.
- ``update_grid``: occupancies within rtol 1e-5; the binary masks equal
  except at cells within f32 rounding of the threshold (counted).
- The whole step: the loss within rtol 1e-5 (measured 6e-8),
  ``n_samples`` within 2 (visibility flips at ``early_stop_eps``, as in
  test_torch_render.py; measured 0), gradients as the field's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerfacc_tpu as jx
import nerfacc_tpu.grid as jax_grid
from nerfacc_tpu.models import TensoCPRadianceField as JaxTensoCP
from nerfacc_tpu.models import trunc_exp as jax_trunc_exp
from nerfacc_tpu.utils import render_rays as jax_render_rays
from nerfacc_tpu.vol_rendering import (
    render_weight_from_density_dense as jax_weights_dense,
)
from nerfacc_tpu_torch import (
    compact_mse,
    every_n_step,
    render_rays,
    render_weight_from_density_dense,
    train_step,
    update_grid,
)
from nerfacc_tpu_torch.convert import grid_from_arrays, tensocp_from_flax
from nerfacc_tpu_torch.grid import _update_grid_at
from nerfacc_tpu_torch.models import TensoCPRadianceField, trunc_exp

torch.set_num_threads(1)

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
LEVELS = ((16, 8), (32, 16))
N_RAYS = 64
STEP = 1e-2
KW = dict(
    scene_aabb=AABB,
    render_step_size=STEP,
    max_samples_per_ray=512,
    samples_budget=N_RAYS * 24,
    coarse_stride=8,
    probe_dilation=1,
    probe_groups=16,
    compact_rays_fraction=0.75,
    use_pallas=True,
)


def _fields(use_kernel=True, density_bias=3.0, seed=1):
    kw = dict(aabb=AABB, levels=LEVELS, use_kernel=use_kernel,
              density_bias=density_bias)
    jfield = JaxTensoCP(**kw)
    x0 = jnp.zeros((8, 3))
    params = jfield.init(jax.random.PRNGKey(seed), x0, x0)
    tfield = TensoCPRadianceField(device="cpu", **kw)
    tensocp_from_flax(jax.tree_util.tree_map(np.asarray, params), tfield)
    return jfield, params, tfield


@pytest.fixture(scope="module")
def scene():
    """Both packages' field (same flax parameters, kernel path) and grid."""
    rng = np.random.RandomState(0)
    binary = np.zeros((32, 32, 32), bool)
    binary[6:26, 6:26, 6:26] = rng.rand(20, 20, 20) < 0.5
    occs = (rng.rand(32 ** 3) * 0.02).astype(np.float32)
    jgrid = jx.with_binary(jx.create_grid(jnp.asarray(AABB), resolution=32),
                           jnp.asarray(binary))
    jgrid = jgrid.replace(occs=jnp.asarray(occs))
    tgrid = grid_from_arrays(AABB, binary, occs, device="cpu")
    return (*_fields(), jgrid, tgrid)


def _grads_as_torch(grads, tfield):
    """A flax gradient tree, as {torch parameter name: numpy array}."""
    holder = TensoCPRadianceField(
        aabb=AABB, levels=LEVELS, use_kernel=tfield.cp_levels[0].use_kernel,
        device="cpu",
    )
    tensocp_from_flax(jax.tree_util.tree_map(np.asarray, grads), holder)
    return {n: p.detach().numpy() for n, p in holder.named_parameters()}


def _assert_field_grads(tfield, want):
    for name, p in tfield.named_parameters():
        assert p.grad is not None, name
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name
        k4 = tfield.cp_levels[0].use_kernel and name.startswith("cp_levels")
        rtol, atol = (5e-2, 4e-3 * scale) if k4 else (1e-6, 1e-6 * scale)
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def _camera_rays(n, seed):
    """Rays from outside the box aimed near its centre; some miss it."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 0.8
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    px = rng.rand(n, 3)
    return o.astype(np.float32), d.astype(np.float32), px.astype(np.float32)


def test_trunc_exp_gradient_matches_jax():
    x = np.asarray([-5.0, 14.9, 15.0, 20.0, 29.9, 30.0, 35.0], np.float32)
    w = np.linspace(0.5, 2.0, x.size).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_trunc_exp(v) * w))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    out = trunc_exp(xt)
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6)
    # the gradient is clamped at 15, the value at 30
    assert float(xt.grad[3]) == pytest.approx(w[3] * np.exp(15.0), rel=1e-6)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_trunc_exp(jnp.asarray(x))),
                               rtol=1e-6)


def test_dense_weights_gradient_matches_jax():
    rng = np.random.RandomState(2)
    R, K = 16, 24
    t_starts = np.sort(rng.rand(R, K) * 3, axis=1).astype(np.float32)
    t_ends = (t_starts + rng.rand(R, K) * 0.05).astype(np.float32)
    sigmas = (rng.rand(R, K) * 20).astype(np.float32)
    masks = rng.rand(R, K) < 0.8
    g = rng.randn(R, K).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, b, s: jax_weights_dense(a, b, s, masks=jnp.asarray(masks)),
        *map(jnp.asarray, (t_starts, t_ends, sigmas)),
    )
    want = vjp(jnp.asarray(g))
    ts_t, te_t, sg_t = (torch.as_tensor(a).requires_grad_()
                        for a in (t_starts, t_ends, sigmas))
    w = render_weight_from_density_dense(ts_t, te_t, sg_t,
                                         masks=torch.as_tensor(masks))
    w.backward(torch.as_tensor(g))
    np.testing.assert_allclose(sg_t.grad.numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-6)
    # the deltas (so t_starts and t_ends) get a zero gradient
    for got, exp in ((ts_t, want[0]), (te_t, want[1])):
        np.testing.assert_array_equal(np.asarray(exp), 0.0)
        np.testing.assert_array_equal(got.grad.numpy(), 0.0)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_field_gradients_match_jax(use_kernel):
    jfield, params, tfield = _fields(use_kernel, density_bias=1.0, seed=3)
    rng = np.random.RandomState(5)
    x = (rng.rand(200, 3) * 2.2 - 1.1).astype(np.float32)
    d = rng.randn(200, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    w_rgb = rng.randn(200, 3).astype(np.float32)
    w_sig = rng.randn(200, 1).astype(np.float32)

    def loss_j(p):
        rgb, sig = jfield.apply(p, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(rgb * w_rgb) + jnp.sum(sig * w_sig)

    want = _grads_as_torch(jax.grad(loss_j)(params), tfield)
    rgb, sig = tfield(torch.as_tensor(x), torch.as_tensor(d))
    (torch.sum(rgb * torch.as_tensor(w_rgb))
     + torch.sum(sig * torch.as_tensor(w_sig))).backward()
    _assert_field_grads(tfield, want)
    # the heads' weight gradients are bf16 values, as XLA's bf16 dot gives
    wgrad = tfield.mlp_head.layers[0].weight.grad
    assert torch.equal(wgrad, wgrad.to(torch.bfloat16).float())


@pytest.mark.parametrize("step", [0, 1000])
def test_update_grid_matches_jax(scene, step):
    *_, jgrid, tgrid = scene
    # density ~ exp(-1) * 0.01 per cell: near the adaptive threshold
    jfield, params, tfield = _fields(density_bias=-1.0, seed=6)
    key = jax.random.PRNGKey(7)

    def occ_j(x):
        return jfield.apply(params, x, method=jfield.query_density) * STEP

    def occ_t(x):
        return tfield.query_density(x) * STEP

    want = jx.update_grid(jgrid, key, step, occ_j, occ_thre=1e-2,
                          ema_decay=0.95)
    # the cells and jitter JAX draws from this key, fed to the port
    k_sel, k_jit = jax.random.split(key)
    n = jgrid.num_cells
    indices = (jnp.arange(n) if step < 256
               else jax_grid._sample_cells(jgrid, k_sel, n // 4))
    jitter = jax.random.uniform(k_jit, (indices.shape[0], 3))
    got = _update_grid_at(tgrid, torch.as_tensor(np.array(indices)),
                          torch.as_tensor(np.array(jitter)), occ_t,
                          occ_thre=1e-2, ema_decay=0.95, adaptive_thre=True)
    occs_j = np.asarray(want.occs)
    np.testing.assert_allclose(got.occs.numpy(), occs_j, rtol=1e-5,
                               atol=1e-9)
    thre = min(float(np.mean(occs_j)), 1e-2)
    flips = got.binary.numpy().reshape(-1) != np.asarray(want.binary).reshape(-1)
    assert np.all(np.abs(occs_j[flips] - thre) <= 1e-6 * thre), flips.sum()
    assert flips.sum() <= 2
    # the dilated tables follow the new mask
    assert torch.equal(got.dilated[1],
                       grid_from_arrays(AABB, got.binary.numpy(),
                                        device="cpu").dilated[1])
    assert 0 < int(got.binary.sum()) < got.num_cells


def test_update_grid_public_entry_and_every_n_step(scene):
    *_, tfield, _, tgrid = scene

    def occ_t(x):
        return tfield.query_density(x) * STEP

    gen = torch.Generator().manual_seed(3)
    for step in (0, 1000):
        new = update_grid(tgrid, gen, step, occ_t)
        assert new.occs.shape == tgrid.occs.shape
        assert bool(torch.isfinite(new.occs).all())
        # sampled: every selected cell decays once, then takes the max
        assert bool((new.occs >= tgrid.occs * 0.95 - 1e-9).all())
        assert new.occs.requires_grad is False
    assert every_n_step(tgrid, gen, 17, occ_t) is tgrid
    assert every_n_step(tgrid, gen, 32, occ_t) is not tgrid


def test_adam_matches_optax():
    rng = np.random.RandomState(8)
    p0 = {"a": rng.randn(5, 4).astype(np.float32),
          "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 10 ** -i
              for k, v in p0.items()} for i in range(3)]
    opt = optax.adam(5e-4)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(pj)
    pt = {k: torch.nn.Parameter(torch.as_tensor(v)) for k, v in p0.items()}
    topt = torch.optim.Adam(pt.values(), lr=5e-4)
    for g in grads:
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, p in pt.items():
            p.grad = torch.as_tensor(g[k])
        topt.step()
        for k in p0:
            np.testing.assert_allclose(pt[k].detach().numpy(),
                                       np.asarray(pj[k]), rtol=1e-6,
                                       atol=1e-7)


def test_compact_render_matches_jax(scene):
    jfield, params, tfield, jgrid, tgrid = scene
    o, d, px = _camera_rays(N_RAYS, seed=9)
    kw = dict(KW, return_compact=True, return_extras=True)
    cj, oj, dj, nj, sj = jax_render_rays(
        params, jfield, jnp.asarray(o), jnp.asarray(d), grid=jgrid,
        render_bkgd=jnp.ones(3), aux=jnp.asarray(px), **kw)
    with torch.no_grad():
        ct, ot, dt, nt, st = render_rays(
            tfield, torch.as_tensor(o), torch.as_tensor(d), grid=tgrid,
            render_bkgd=torch.ones(3), aux=torch.as_tensor(px), **kw)
    assert ct.shape == (48, 3)  # the compacted rays
    np.testing.assert_array_equal(st["ray_indices"].numpy(),
                                  np.asarray(sj["ray_indices"]))
    assert st["ray_indices"].dtype == torch.int32
    assert np.asarray(sj["ray_indices"]).dtype == np.int32
    np.testing.assert_array_equal(st["ray_ok"].numpy(),
                                  np.asarray(sj["ray_ok"]))
    np.testing.assert_array_equal(st["aux"].numpy(), np.asarray(sj["aux"]))
    assert abs(int(nt) - int(nj)) <= 2
    for a, b in ((ct, cj), (ot, oj), (dt, dj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    assert set(st["extras"]) == set(sj["extras"])
    assert int(st["extras"]["field_budget_dropped"]) == 0
    # without ray compaction the selection is every ray
    kw.pop("compact_rays_fraction")
    with torch.no_grad():
        *_, st = render_rays(tfield, torch.as_tensor(o), torch.as_tensor(d),
                             grid=tgrid, aux=torch.as_tensor(px), **kw)
    assert torch.equal(st["ray_indices"],
                       torch.arange(N_RAYS, dtype=torch.int32))
    assert bool(st["ray_ok"].all()) and st["aux"] is not None
    # the full-batch extras carry the dropped count too
    with torch.no_grad():
        extras = render_rays(tfield, torch.as_tensor(o), torch.as_tensor(d),
                             grid=tgrid, return_extras=True, **KW)[4]
    assert int(extras["field_budget_dropped"]) == 0


def test_compact_mse_is_the_full_batch_mse(scene):
    *_, tfield, _, tgrid = scene
    o, d, px = (torch.as_tensor(a) for a in _camera_rays(N_RAYS, seed=10))
    with torch.no_grad():
        colors, *_, sel = render_rays(
            tfield, o, d, grid=tgrid, render_bkgd=torch.ones(3), aux=px,
            return_compact=True, **KW)
        full = render_rays(tfield, o, d, grid=tgrid,
                           render_bkgd=torch.ones(3), **KW)[0]
    torch.testing.assert_close(compact_mse(colors, sel, px),
                               torch.mean((full - px) ** 2), rtol=1e-5,
                               atol=1e-7)


def test_train_step_matches_jax(scene):
    # the slice as a whole: bench.py's step from the same parameters
    jfield, params, tfield, jgrid, tgrid = scene
    o, d, px = _camera_rays(N_RAYS, seed=11)

    def loss_fn(p):
        colors, _, _, n, sel = jax_render_rays(
            p, jfield, jnp.asarray(o), jnp.asarray(d), grid=jgrid,
            render_bkgd=jnp.ones(3), aux=jnp.asarray(px),
            return_compact=True, **KW)
        p_h, okm = sel["aux"], sel["ray_ok"][:, None]
        sh = jnp.sum(jnp.where(okm, (colors - p_h) ** 2, 0.0))
        sbg = jnp.sum((1.0 - px) ** 2) - jnp.sum(
            jnp.where(okm, (1.0 - p_h) ** 2, 0.0))
        return (sh + sbg) / px.size, n

    (loss_j, n_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    field = TensoCPRadianceField(aabb=AABB, levels=LEVELS, use_kernel=True,
                                 density_bias=3.0, device="cpu")
    field.load_state_dict(tfield.state_dict())
    opt = torch.optim.Adam(field.parameters(), lr=5e-4)
    before = {n: p.detach().clone() for n, p in field.named_parameters()}
    loss_t, n_t = train_step(field, opt, tgrid, *map(torch.as_tensor, (o, d, px)),
                             **KW)
    assert loss_t.requires_grad is False
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert abs(int(n_t) - int(n_j)) <= 2 and int(n_t) > 200
    _assert_field_grads(field, _grads_as_torch(grads_j, field))
    # one Adam step moved every parameter by at most lr (first step)
    for name, p in field.named_parameters():
        step = (p.detach() - before[name]).abs().max()
        assert 0 < float(step) <= 5e-4 * (1 + 1e-5), name
