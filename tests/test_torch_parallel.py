"""The port's data parallelism (``nerfacc_tpu_torch.parallel``) in a world
of two gloo processes on the CPU, against the JAX package's
``nerfacc_tpu.parallel`` on a 2-device mesh of the virtual CPU devices and
against the port's own single process: the twins of the fast tests of
``tests/test_parallel.py``, and the data-parallel step as a whole.

One world runs every case (``torch_parallel_workers.parallel_suite``,
spawned by ``launch_world`` with a deadline of its own); the JAX package's
results and the port's single-process runs are computed here. Inputs come
from numpy seeds; the port's weights are the flax parameters, carried by
``nerfacc_tpu_torch.convert``.

Tolerances, with their reasons:
- sharded render vs the JAX package's single-device render: the JAX
  test's own bounds, rtol 1e-4 / atol 1e-5; vs the port's single process:
  every ray runs the same program, rtol 1e-5 / atol 1e-6.
- the identical-data control: every shard sums the same terms in the same
  order, so the world's mean is the single process's up to the mean's
  rounding: loss rtol 1e-6, gradients rtol 1e-5 / atol 1e-7 (the JAX
  test's).
- ``update_grid_distributed`` on the JAX package's draws: the occupancies
  within rtol 1e-5 (measured equal), ``binary`` equal (the occupancy
  functions are 0, 1 or 5e-3, never near a threshold); the merge is the
  elementwise max of the ranks' own updates, bit for bit.
- the step as a whole vs the JAX package's ``shard_map`` step (compiled
  without excess precision: see ``_jax_slice``): colours rtol 1e-5 / atol
  1e-6, loss rtol 1e-5,
  gradients within relative L2 5e-3 per leaf (the JAX package's envelope
  for the order of a split sum); vs the same step compiled as XLA
  compiles it by default: the same bounds but colours atol 1e-4 (its
  fused bf16 intermediates kept in f32 move the colours by 6.55e-5).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

try:
    from jax.sharding import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

import nerfacc_tpu as jx
import nerfacc_tpu.grid as jax_grid
from nerfacc_tpu.models import TensoCPRadianceField as JaxTensoCP
from nerfacc_tpu.models import VanillaNeRFRadianceField as JaxVanilla
from nerfacc_tpu.parallel import make_mesh as jax_make_mesh
from nerfacc_tpu.parallel import update_grid_distributed as jax_ugd
from nerfacc_tpu.utils import render_rays as jax_render_rays
from nerfacc_tpu_torch import create_grid
from nerfacc_tpu_torch.convert import grid_from_arrays

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import dryrun_multichip_torch as dry  # noqa: E402
import torch_parallel_workers as w  # noqa: E402
from nerfacc_tpu_torch.parallel import (  # noqa: E402
    data_parallel,
    make_mesh,
    psum_grads,
    shard_batch,
    update_grid_distributed,
)
from nerfacc_tpu_torch.parallel.multihost import launch_world  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
BOX = w.BOX
RENDER_KW = dict(scene_aabb=BOX, render_step_size=5e-2,
                 max_samples_per_ray=64)
FUSED_KW = dict(RENDER_KW, coarse_stride=8, probe_groups=8,
                visible_samples_budget=None)
# the slice: the TensoCP field at small levels, the kernel path's march
# (JAX: the Pallas kernels in interpret mode; the port: their twins)
AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
LEVELS = ((16, 8), (32, 16))
SLICE_K = 24
SLICE_KW = dict(scene_aabb=AABB, render_step_size=1e-2,
                max_samples_per_ray=512, coarse_stride=8, probe_dilation=1,
                probe_groups=16, use_pallas=True)


def _rays(n, seed, pixels=False):
    """test_parallel.py's rays: origins in [-1, 1]^3, unit directions."""
    rng = np.random.RandomState(seed)
    o = (rng.rand(n, 3) * 2 - 1).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if pixels:
        return o, d, rng.rand(n, 3).astype(np.float32)
    return o, d


def _camera_rays(n, seed):
    """Rays from outside the box aimed near its centre; some miss it."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 0.8
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    px = rng.rand(n, 3)
    return o.astype(np.float32), d.astype(np.float32), px.astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def vanilla_params():
    field = JaxVanilla(net_depth=2, net_width=32)
    params = field.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                        jnp.zeros((4, 3)))
    return field, params


@pytest.fixture(scope="module")
def slice_scene():
    """The TensoCP field (flax parameters), the grid of
    test_torch_train.py and the rays of the slice's step."""
    jfield = JaxTensoCP(aabb=AABB, levels=LEVELS, density_bias=3.0)
    params = jfield.init(jax.random.PRNGKey(1), jnp.zeros((8, 3)),
                         jnp.zeros((8, 3)))
    rng = np.random.RandomState(0)
    binary = np.zeros((32, 32, 32), bool)
    binary[6:26, 6:26, 6:26] = rng.rand(20, 20, 20) < 0.5
    occs = (rng.rand(32 ** 3) * 0.02).astype(np.float32)
    jgrid = jx.with_binary(jx.create_grid(jnp.asarray(AABB), resolution=32),
                           jnp.asarray(binary)).replace(occs=jnp.asarray(occs))
    return jfield, params, (binary, occs), jgrid, _camera_rays(64, seed=11)


def _grid_draws(key, n_dev=WORLD):
    """The cells and jitter each device of the JAX package's
    update_grid_distributed draws past warm-up (fold_in, then
    update_grid's split), on an empty 8^3 grid of the unit box."""
    grid0 = jx.create_grid(jnp.asarray([0, 0, 0, 1, 1, 1]), resolution=8)
    n = grid0.num_cells
    draws = []
    for i in range(n_dev):
        k_sel, k_jit = jax.random.split(jax.random.fold_in(key, i))
        idx = jax_grid._sample_cells(grid0, k_sel, n // 4)
        jit = jax.random.uniform(k_jit, (idx.shape[0], 3))
        draws.append((np.asarray(idx), np.asarray(jit)))
    return draws


@pytest.fixture(scope="module")
def world(vanilla_params, slice_scene):
    """Every case in one spawned world of two gloo processes."""
    _, params = vanilla_params
    p_np = _np_tree(params)
    _, sparams, grid_arrays, _, srays = slice_scene
    cases = {
        "render": ("render", dict(params=p_np, rays=_rays(64, 0),
                                  kw=RENDER_KW, k_slots=64)),
        "fused": ("render", dict(params=p_np, rays=_rays(64, 7),
                                 kw=dict(FUSED_KW, use_pallas=True),
                                 k_slots=32)),
        "control": ("control", dict(params=p_np,
                                    rays=_rays(32, 5, pixels=True),
                                    kw=RENDER_KW)),
        "wrapper": ("wrapper", {}),
        "ball": ("grid", dict(draws=_grid_draws(jax.random.PRNGKey(0)),
                              occ="ball", occ_thre=1e-2,
                              adaptive_thre=True)),
        "fog": ("grid", dict(draws=_grid_draws(jax.random.PRNGKey(3)),
                             occ="fog", occ_thre=1e-2, adaptive_thre=False)),
        "slice": ("slice", dict(params=_np_tree(sparams), levels=LEVELS,
                                grid_arrays=grid_arrays, rays=srays,
                                kw=dict(SLICE_KW, compact_rays_fraction=None),
                                k_slots=SLICE_K)),
    }
    return launch_world(w.parallel_suite, WORLD, (cases,), timeout=240)


def _port_single_render(params, rays, kw, k_slots):
    field = w.vanilla(_np_tree(params))
    grid = create_grid(BOX, resolution=16, occupied=True, device="cpu")
    with torch.no_grad():
        return [t.numpy() for t in w.render_local(
            field, grid, *(torch.as_tensor(a) for a in rays), k_slots, **kw)]


def _jax_single_render(vanilla_params, rays, kw, k_slots):
    field, params = vanilla_params
    grid = jx.create_grid(jnp.asarray(BOX), resolution=16, occupied=True)
    o, d = (jnp.asarray(a) for a in rays)
    colors, opacities, depths, _ = jax.jit(
        lambda p, o, d: jax_render_rays(
            p, field, o, d, grid=grid, render_bkgd=jnp.ones(3),
            samples_budget=o.shape[0] * k_slots, **kw))(params, o, d)
    return [np.asarray(a) for a in (colors, opacities, depths)]


@pytest.mark.parametrize("case", ["render", "fused"])
def test_sharded_render_matches_single_device(world, vanilla_params, case):
    # "fused": the march kernels' twins on each shard (K5 / K6 on the
    # card) against the JAX package's unfused single-device render
    rays = _rays(64, 0 if case == "render" else 7)
    kw, k = ((RENDER_KW, 64) if case == "render"
             else (dict(FUSED_KW, use_pallas=False), 32))
    want = _jax_single_render(vanilla_params, rays, kw, k)
    port_kw = kw if case == "render" else dict(FUSED_KW, use_pallas=True)
    mine = _port_single_render(vanilla_params[1], rays, port_kw, k)
    for rank in range(WORLD):
        for got, ref, single in zip(world[rank][case], want, mine):
            assert got.shape == ref.shape and got.shape[0] == 64
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-6)
    assert float(world[0][case][1].max()) > 0.1  # rays hit the field


def test_sharded_grads_identical_data_control(world, vanilla_params):
    field, params = vanilla_params
    o, d, px = _rays(32, 5, pixels=True)
    grid = create_grid(BOX, resolution=16, occupied=True, device="cpu")
    want_loss, want = w.mse_grads(w.vanilla(_np_tree(params)), grid,
                                  *(torch.as_tensor(a) for a in (o, d, px)),
                                  RENDER_KW)
    jgrid = jx.create_grid(jnp.asarray(BOX), resolution=16, occupied=True)

    def jax_loss(p):
        colors, _, _, _ = jax_render_rays(
            p, field, jnp.asarray(o), jnp.asarray(d), grid=jgrid,
            render_bkgd=jnp.ones(3), samples_budget=32 * 64, **RENDER_KW)
        return jnp.mean((colors - px) ** 2)

    np.testing.assert_allclose(float(want_loss), float(jax_loss(params)),
                               rtol=1e-5)
    for rank in range(WORLD):
        loss, grads = world[rank]["control"]
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
        assert set(grads) == set(want)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("occ", ["ball", "fog"])
def test_update_grid_distributed_matches_jax(world, occ):
    # the JAX package's update_grid_distributed on a 2-device mesh, and the
    # port's merge of the same per-device draws
    fn = {"ball": lambda x: jnp.where(
        jnp.linalg.norm(x - 0.5, axis=-1, keepdims=True) < 0.3, 1.0, 0.0),
        "fog": lambda x: jnp.full(x.shape[:-1] + (1,), 5e-3)}[occ]
    kw = dict(occ_thre=1e-2, adaptive_thre=occ == "ball")
    key = jax.random.PRNGKey(0 if occ == "ball" else 3)
    mesh = jax_make_mesh(jax.devices()[:WORLD])
    grid0 = jx.create_grid(jnp.asarray([0, 0, 0, 1, 1, 1]), resolution=8)
    rep = NamedSharding(mesh, P())
    want = jax.jit(shard_map(
        lambda g, k: jax_ugd(g, k, step=10**9, occ_eval_fn=fn, **kw),
        mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_rep=False,
    ))(jax.device_put(grid0, rep), jax.device_put(key, rep))
    for rank in range(WORLD):
        got = world[rank][occ]["jax_draws"]
        np.testing.assert_allclose(got["occs"], np.asarray(want.occs),
                                   rtol=1e-5, atol=0)
        np.testing.assert_array_equal(got["binary"],
                                      np.asarray(want.binary))
        # the dilated tables follow the merged mask
        np.testing.assert_array_equal(
            got["dilated"], grid_from_arrays(
                [0, 0, 0, 1, 1, 1], got["binary"], device="cpu"
            ).dilated[1].numpy())
    if occ == "fog":
        # the fixed threshold 1e-2 above the fog: nothing is occupied,
        # where the adaptive rule would mark every updated cell
        assert int(want.binary.sum()) == 0
        adaptive = jx.update_grid(grid0, key, step=10**9, occ_eval_fn=fn,
                                  occ_thre=1e-2, adaptive_thre=True)
        assert int(adaptive.binary.sum()) > 0


@pytest.mark.parametrize("occ", ["ball", "fog"])
def test_update_grid_distributed_merges_more_cells(world, occ):
    # the port's own draws: the merge is the elementwise max of the ranks'
    # own updates, holds at least the cells of any one of them, and keeps
    # the threshold rule
    merged = world[0][occ]["merged"]
    owns = [world[r][occ]["own"] for r in range(WORLD)]
    for rank in range(WORLD):
        np.testing.assert_array_equal(world[rank][occ]["merged"]["occs"],
                                      merged["occs"])
    np.testing.assert_array_equal(
        merged["occs"], np.maximum(*(o["occs"] for o in owns)))
    single = world[0][occ]["single"]
    assert (merged["occs"] >= single["occs"]).all()
    assert int(merged["binary"].sum()) >= int(single["binary"].sum())
    if occ == "ball":
        updated = [int((o["occs"] > 0).sum()) for o in owns]
        assert int((merged["occs"] > 0).sum()) > max(updated)
        assert int(merged["binary"].sum()) > 0
    else:
        assert int(merged["binary"].sum()) == 0


def test_data_parallel_wrapper(world):
    x = np.arange(16, dtype=np.float32)
    for rank in range(WORLD):
        total, doubled, refused = world[rank]["wrapper"]
        np.testing.assert_allclose(float(total), float((x * 2.0).sum()))
        np.testing.assert_allclose(doubled, x * 2.0)
        # a length the world does not divide, as JAX's device_put
        assert "does not split into 2 equal shards" in refused


def test_world_of_one_without_a_process_group():
    # no process group: a world of one, where every collective is the
    # identity, as the JAX functions run on one device
    mesh = make_mesh(device="cpu")
    assert mesh.shape == (1,) and mesh.axis_index("data") == 0
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(shard_batch(x, mesh), x)
    fn = data_parallel(lambda a: (psum_grads(a.sum()), a * 2), mesh,
                       batched_args=(0,), n_out=2, replicated_out=(0,))
    total, doubled = fn(x)
    assert float(total) == 15.0 and torch.equal(doubled, x * 2)
    grid = create_grid([0, 0, 0, 1, 1, 1], resolution=8, device="cpu")
    merged = update_grid_distributed(grid, 0, 10**9, w.ball, mesh=mesh)
    assert int(merged.binary.sum()) > 0
    with pytest.raises(ValueError, match="equal shards"):
        shard_batch(torch.zeros(()), mesh)
    with pytest.raises(ValueError, match="no mesh"):
        psum_grads(torch.ones(2))


def _jax_slice(slice_scene, sharded: bool, excess_precision: bool = False):
    """The JAX package's step (the dry run's render_loss) on the whole
    batch, or under shard_map over 2 devices with pmean'd loss and
    gradients; returns (loss, colours, gradients as the port's names).
    ``excess_precision``: compiled as XLA compiles it by default."""
    jfield, params, _, jgrid, (o, d, px) = slice_scene
    kw = dict(SLICE_KW, compact_rays_fraction=None)

    def render_loss(p, grid, o, d, px):
        colors, _, _, _, sel = jax_render_rays(
            p, jfield, o, d, grid=grid, render_bkgd=jnp.ones(3), aux=px,
            return_compact=True, samples_budget=SLICE_K * o.shape[0], **kw)
        ph, okm = sel["aux"], sel["ray_ok"][:, None]
        sh = jnp.sum(jnp.where(okm, (colors - ph) ** 2, 0.0))
        sbg = jnp.sum((1.0 - px) ** 2) - jnp.sum(
            jnp.where(okm, (1.0 - ph) ** 2, 0.0))
        return (sh + sbg) / px.size, colors

    def step(p, grid, o, d, px):
        (loss, colors), grads = jax.value_and_grad(
            render_loss, has_aux=True)(p, grid, o, d, px)
        if sharded:
            loss = jax.lax.pmean(loss, axis_name="data")
            grads = jax.lax.pmean(grads, axis_name="data")
        return loss, colors, grads

    args = (params, jgrid, *(jnp.asarray(a) for a in (o, d, px)))
    if sharded:
        mesh = jax_make_mesh(jax.devices()[:WORLD])
        rep, sh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
        args = ([jax.device_put(a, rep) for a in args[:2]]
                + [jax.device_put(a, sh) for a in args[2:]])
        fn = shard_map(step, mesh=mesh,
                       in_specs=(P(), P(), P("data"), P("data"), P("data")),
                       out_specs=(P(), P("data"), P()), check_rep=False)
    else:
        fn = step
    # compiled without excess precision: by default XLA may keep a fused
    # bf16 intermediate in f32, which moves this batch's colours by up to
    # 6.6e-5 from the JAX package's op-by-op run; the port rounds where the
    # program says, as that run does (within 2.4e-7 of it, and of this)
    options = ({} if excess_precision
               else {"xla_allow_excess_precision": False})
    loss, colors, grads = jax.jit(fn).lower(*args).compile(
        compiler_options=options)(*args)
    holder = w.tensocp(_np_tree(grads), LEVELS)
    return float(loss), np.asarray(colors), {
        k: p.detach().numpy() for k, p in holder.named_parameters()}


def _hold(got, want, color_rtol=1e-5, color_atol=1e-6, loss_rtol=1e-5,
          grad_rel=5e-3):
    loss, colors, grads = got
    np.testing.assert_allclose(loss, want[0], rtol=loss_rtol)
    np.testing.assert_allclose(colors, want[1], rtol=color_rtol,
                               atol=color_atol)
    assert set(grads) == set(want[2])
    for k, g in grads.items():
        ref = want[2][k]
        assert np.linalg.norm(ref) > 0, k
        rel = np.linalg.norm(g - ref) / np.linalg.norm(ref)
        assert rel <= grad_rel, f"{k}: relative L2 {rel:.2e}"


def test_data_parallel_step_matches_jax_shard_map(world, slice_scene):
    # the slice as a whole: the world-of-two step (each rank its 32 rays
    # at K = 24) against the JAX package's step under shard_map on a
    # 2-device mesh, and against one process on the whole batch
    want = _jax_slice(slice_scene, sharded=True)
    shipped = _jax_slice(slice_scene, sharded=True, excess_precision=True)
    for rank in range(WORLD):
        r = world[rank]["slice"]
        assert r["colors"].shape == (64, 3)
        _hold((r["loss"], r["colors"], r["grads"]), want)
        # the JAX step as XLA compiles it by default: colours measured
        # 6.55e-5 apart (max abs), held to 1e-4
        _hold((r["loss"], r["colors"], r["grads"]), shipped, color_rtol=0,
              color_atol=1e-4)
    # one process, whole batch: the port's and the JAX package's
    _, params, grid_arrays, _, rays = slice_scene
    field = w.tensocp(_np_tree(params), LEVELS)
    grid = grid_from_arrays(AABB, *grid_arrays, device="cpu")
    single = dry.single_loss_grads(
        field, grid, *(torch.as_tensor(a) for a in rays),
        dict(SLICE_KW, compact_rays_fraction=None,
             samples_budget=64 * SLICE_K))
    single = (float(single[0]), single[1].numpy(),
              {k: g.numpy() for k, g in single[2].items()})
    _hold(single, _jax_slice(slice_scene, sharded=False))
    r = world[0]["slice"]
    _hold((r["loss"], r["colors"], r["grads"]), single)


def test_data_parallel_step_runs_the_full_cadence(world):
    # the grid update, the step and Adam: a finite loss, live samples, an
    # occupied grid, and parameters still equal on both ranks
    r0, r1 = (world[r]["slice"] for r in range(WORLD))
    assert np.isfinite(r0["step_loss"]) and r0["step_loss"] == r1["step_loss"]
    assert r0["live"] == r1["live"] > 0
    assert 0 < r0["occupied"] == r1["occupied"]
    for k, p in r0["params"].items():
        np.testing.assert_array_equal(p, r1["params"][k], err_msg=k)
