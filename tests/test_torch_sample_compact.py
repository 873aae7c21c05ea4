"""The port's live-sample compaction and the hash-NGP training step vs the
JAX package's.

Inputs come from numpy seeds and the same flax parameters go to both
packages. JAX runs its Pallas kernels (march selection, hash-table
scatter) in interpret mode; the port's wrappers run their plain twins on
the CPU.

Tolerances, with their reasons:
- the compaction plan is integer work (and one f32 quota taken in the
  same order): bit-equal.
- ``expand_compact`` moves values without arithmetic: equal.
- renders: the field agrees to f32 rounding (test_torch_hash.py), so the
  live and dropped counts are equal and colors agree within 1e-5.
  Opacities and depths (t <= 5) are held to 1e-4 as in
  test_torch_render.py: a one-ulp difference in a sample position (XLA
  may contract ``o + t * d``) times the level resolution times the scaled
  density logit moves a sample's density by ~1e-5 relative, and they sum
  over a ray (measured up to 1.5e-5).
- the whole step: loss within 1e-5 relative; each gradient within 1e-4 of
  its largest |entry| (f32 sums in another order through the heads and the
  table scatter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu as jx
from nerfacc_tpu.models import NGPRadianceField as JaxNGP
from nerfacc_tpu.ops.sample_compact import (
    compact_live_slots as jax_compact_live_slots,
)
from nerfacc_tpu.ops.sample_compact import expand_compact as jax_expand_compact
from nerfacc_tpu.utils import render_rays as jax_render_rays
from nerfacc_tpu_torch import render_rays, train_step
from nerfacc_tpu_torch.convert import (
    grid_from_arrays,
    ngp_from_flax,
    ngp_table_from_flax,
)
from nerfacc_tpu_torch.models import NGPRadianceField
from nerfacc_tpu_torch.ops import compact_live_slots, expand_compact

torch.set_num_threads(1)

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
N_RAYS = 64
FIELD_KW = dict(aabb=AABB, n_levels=4, log2_hashmap_size=13)
KW = dict(
    scene_aabb=AABB,
    render_step_size=1e-2,
    max_samples_per_ray=512,
    samples_budget=N_RAYS * 24,
    coarse_stride=8,
    probe_dilation=1,
    probe_groups=16,
    compact_rays_fraction=0.75,
    use_pallas=True,
)


def _masks(case):
    rng = np.random.RandomState(3)
    masks = rng.rand(40, 24) < 0.4
    masks[5] = False  # a ray without a live slot
    masks[7] = True
    if case == "floor":
        # three crowded rays and five with a single live slot, whose
        # proportional quota floors to 0: the one-per-ray floor lifts it
        masks[:] = False
        masks[0:3] = True
        masks[3:8, 3] = True
    elif case == "backstop":
        # so many single-slot rays that the floor overshoots the budget
        # and the global rank backstop trims the last rays
        masks[:] = False
        masks[0] = True
        masks[1:30, 3] = True
    return masks


@pytest.mark.parametrize("case,budget", [
    ("under", 600), ("exact", None), ("over", 150), ("floor", 60),
    ("backstop", 20), ("beyond", 5000),
])
def test_compact_live_slots_matches_jax(case, budget):
    masks = _masks(case)
    if budget is None:
        budget = int(masks.sum())
    want = jax_compact_live_slots(jnp.asarray(masks), budget)
    got = compact_live_slots(torch.as_tensor(masks), budget)
    pos, ok, rank, keep, dropped = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[1].numpy(), ok)
    np.testing.assert_array_equal(got[0].numpy(), pos)
    np.testing.assert_array_equal(got[3].numpy(), keep)
    np.testing.assert_array_equal(got[2].numpy()[keep.reshape(-1)],
                                  rank[keep.reshape(-1)])
    assert int(got[4]) == int(dropped)
    live = int(masks.sum())
    assert int(got[3].sum()) + int(got[4]) == live
    if case in ("under", "exact", "beyond"):
        assert int(got[4]) == 0 and np.array_equal(got[3].numpy(), masks)
    else:
        assert int(got[4]) > 0 and int(got[3].sum()) <= budget
        # every ray with a live slot keeps its first one, unless the
        # backstop cut it
        has = masks.any(1)
        if case == "backstop":
            assert int(got[3].sum()) == budget
            assert got[3].numpy().any(1).sum() < has.sum()
        else:
            assert np.array_equal(got[3].numpy().any(1), has)
    # pos inverts rank on the kept slots
    flat_keep = got[3].reshape(-1)
    assert torch.equal(got[0][got[2][flat_keep]],
                       torch.nonzero(flat_keep)[:, 0])


def test_expand_compact_forward_and_gradient_match_jax():
    masks = _masks("over")
    budget = 150
    rng = np.random.RandomState(4)
    vals = rng.randn(budget, 4).astype(np.float32)
    g = rng.randn(masks.size, 4).astype(np.float32)
    pj = jax_compact_live_slots(jnp.asarray(masks), budget)
    pos, ok, rank, keep, _ = pj
    want, vjp = jax.vjp(
        lambda v: jax_expand_compact(v, rank, keep.reshape(-1), pos, ok),
        jnp.asarray(vals))
    (want_g,) = vjp(jnp.asarray(g))
    pt = compact_live_slots(torch.as_tensor(masks), budget)
    vt = torch.as_tensor(vals).requires_grad_()
    out = expand_compact(vt, pt[2], pt[3].reshape(-1), pt[0], pt[1])
    out.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(want_g))
    # dead and dropped slots are exactly zero, unused entries take no
    # gradient
    dead = ~pt[3].reshape(-1)
    assert bool((out.detach()[dead] == 0).all())
    assert bool((vt.grad[~pt[1]] == 0).all())


@pytest.fixture(scope="module")
def scene():
    """Both packages' NGP field (same flax parameters: a table of order 2
    and the density logit's weights scaled by 8, so that densities reach
    the early-stop cull while the hidden activations stay of order 1) and
    a 32^3 grid."""
    rng = np.random.RandomState(0)
    binary = np.zeros((32, 32, 32), bool)
    binary[6:26, 6:26, 6:26] = rng.rand(20, 20, 20) < 0.5
    jgrid = jx.with_binary(jx.create_grid(jnp.asarray(AABB), resolution=32),
                           jnp.asarray(binary))
    tgrid = grid_from_arrays(AABB, binary, device="cpu")
    fields = {}
    for pallas_grad in (False, True):
        jfield = JaxNGP(pallas_grad=pallas_grad, **FIELD_KW)
        x0 = jnp.zeros((8, 3))
        params = jfield.init(jax.random.PRNGKey(1), x0, x0)
        params = jax.tree_util.tree_map(np.asarray, params)
        params["params"]["encoder"]["table"] = (
            rng.randn(params["params"]["encoder"]["table"].shape[0]) * 2.0
        ).astype(np.float32)
        kernel = np.array(params["params"]["mlp_base"]["Dense_1"]["kernel"])
        kernel[:, 0] *= 8.0
        params["params"]["mlp_base"]["Dense_1"]["kernel"] = kernel
        tfield = NGPRadianceField(pallas_grad=pallas_grad, device="cpu",
                                  **FIELD_KW)
        ngp_from_flax(params, tfield)
        fields[pallas_grad] = (jfield, params, tfield)
    return fields, jgrid, tgrid


def _camera_rays(n, seed):
    """Rays from outside the box aimed near its centre; some miss it."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 0.8
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    px = rng.rand(n, 3)
    return o.astype(np.float32), d.astype(np.float32), px.astype(np.float32)


@pytest.mark.parametrize("stages,budget", [
    ("single", 800), ("single", 250), ("two", 800), ("two", 250),
])
def test_render_with_field_budget_matches_jax(scene, stages, budget):
    fields, jgrid, tgrid = scene
    jfield, params, tfield = fields[False]
    o, d, _ = _camera_rays(N_RAYS, seed=5)
    kw = dict(KW, field_samples_budget=budget, return_extras=True)
    if stages == "two":
        kw["visible_samples_budget"] = N_RAYS * 12
    cj, oj, dj, nj, ej = jax_render_rays(
        params, jfield, jnp.asarray(o), jnp.asarray(d), grid=jgrid,
        render_bkgd=jnp.ones(3), **kw)
    with torch.no_grad():
        ct, ot, dt, nt, et = render_rays(
            tfield, torch.as_tensor(o), torch.as_tensor(d), grid=tgrid,
            render_bkgd=torch.ones(3), **kw)
    assert int(nt) == int(nj) and int(nt) > 100
    assert (int(et["field_budget_dropped"])
            == int(ej["field_budget_dropped"]))
    np.testing.assert_array_equal(et["masks"].numpy(),
                                  np.asarray(ej["masks"]))
    for a, b, atol in ((ct, cj, 1e-5), (ot, oj, 1e-4), (dt, dj, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)
    # 800 covers the live count, 250 does not (the stage-2 pass of the
    # two-stage render sees fewer live slots than its budget)
    if budget == 800:
        assert int(et["field_budget_dropped"]) == 0
    elif stages == "single":
        assert int(et["field_budget_dropped"]) > 0
    assert float(ot.max()) > 0.99


def test_field_budget_render_equals_the_dense_render(scene):
    # a budget above the live count changes nothing but the work
    fields, _, tgrid = scene
    tfield = fields[False][2]
    o, d, _ = (torch.as_tensor(a) for a in _camera_rays(N_RAYS, seed=6))
    with torch.no_grad():
        dense = render_rays(tfield, o, d, grid=tgrid,
                            render_bkgd=torch.ones(3), **KW)
        compact = render_rays(tfield, o, d, grid=tgrid,
                              render_bkgd=torch.ones(3),
                              field_samples_budget=800, **KW)
    assert int(dense[3]) == int(compact[3])
    for a, b in zip(dense[:3], compact[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pallas_grad", [True, False])
def test_ngp_train_step_matches_jax(scene, pallas_grad):
    # the slice as a whole: bench.py's step (--model ngp, field budget
    # half the sample budget) from the same parameters
    fields, jgrid, tgrid = scene
    jfield, params, tfield = fields[pallas_grad]
    o, d, px = _camera_rays(N_RAYS, seed=7)
    kw = dict(KW, field_samples_budget=int(KW["samples_budget"] * 0.5))

    def loss_fn(p):
        colors, _, _, n, sel = jax_render_rays(
            p, jfield, jnp.asarray(o), jnp.asarray(d), grid=jgrid,
            render_bkgd=jnp.ones(3), aux=jnp.asarray(px),
            return_compact=True, **kw)
        p_h, okm = sel["aux"], sel["ray_ok"][:, None]
        sh = jnp.sum(jnp.where(okm, (colors - p_h) ** 2, 0.0))
        sbg = jnp.sum((1.0 - px) ** 2) - jnp.sum(
            jnp.where(okm, (1.0 - p_h) ** 2, 0.0))
        return (sh + sbg) / px.size, n

    (loss_j, n_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    grads_j = jax.tree_util.tree_map(np.asarray, grads_j)["params"]
    want = {"encoder.table": ngp_table_from_flax(
        grads_j["encoder"]["table"], 4, 2)}
    for head, n in (("mlp_base", 2), ("mlp_head", 3)):
        for j in range(n):
            want[f"{head}.layers.{j}.weight"] = (
                grads_j[head][f"Dense_{j}"]["kernel"].T)

    field = NGPRadianceField(pallas_grad=pallas_grad, device="cpu",
                             **FIELD_KW)
    field.load_state_dict(tfield.state_dict())
    opt = torch.optim.Adam(field.parameters(), lr=5e-4)
    before = {n: p.detach().clone() for n, p in field.named_parameters()}
    loss_t, n_t = train_step(field, opt, tgrid,
                             *map(torch.as_tensor, (o, d, px)), **kw)
    assert loss_t.requires_grad is False
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert int(n_t) == int(n_j) and int(n_t) > 200
    assert set(want) == {n for n, _ in field.named_parameters()}
    for name, p in field.named_parameters():
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    # one Adam step moved the heads by at most lr, and the table only
    # where a sample touched it
    for name, p in field.named_parameters():
        step = (p.detach() - before[name]).abs()
        assert 0 < float(step.max()) <= 5e-4 + 1e-6, name
    moved = (field.encoder.table.detach() != before["encoder.table"])
    assert 0 < int(moved.sum()) < moved.numel()
