"""The port's multi-host helpers (``nerfacc_tpu_torch.parallel``:
``init_distributed``, ``make_host_mesh``, ``shard_host_batch``,
``psum_hierarchical``) in four gloo processes on the CPU laid out as 2
hosts x 2 chips (``LOCAL_WORLD_SIZE`` 2, as torchrun sets it), against the
single-process JAX reference of ``tests/test_multihost.py``: the summed
squared error of the vanilla field's render over the global batch (the two
JAX processes' rays, rank-ordered) and its gradient's squared norm.

Tolerances: the loss and the gradient norm within rtol 1e-5 of the JAX
reference (f32 sums in another order); every process holds the same
reduced values, and the hierarchical all-reduce equals one world
all-reduce of integers exactly.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import nerfacc_tpu as jx
from nerfacc_tpu.models import VanillaNeRFRadianceField as JaxVanilla
from nerfacc_tpu.utils import render_rays as jax_render_rays

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_parallel_workers as w  # noqa: E402
from nerfacc_tpu_torch.parallel import init_distributed  # noqa: E402
from nerfacc_tpu_torch.parallel.multihost import launch_world  # noqa: E402

HOSTS, PER_HOST = 2, 2
BOX = [-1.5] * 3 + [1.5] * 3


def _global_batch():
    parts = [w.local_batch(0, 32), w.local_batch(1, 32)]
    return [np.concatenate([p[i] for p in parts]) for i in range(3)]


def _jax_reference(params, field, rays):
    """test_multihost.py's single-process reference: the sum over 8-ray
    shards (budget 8 x 64) of the squared error; with its gradient."""
    grid = jx.create_grid(jnp.asarray(BOX), resolution=8, occupied=True)
    o, d, px = (jnp.asarray(a) for a in rays)

    def total(p):
        loss = 0.0
        for s in range(0, o.shape[0], 8):
            colors, _, _, _ = jax_render_rays(
                p, field, o[s:s + 8], d[s:s + 8], grid=grid,
                render_bkgd=jnp.ones(3), scene_aabb=jnp.asarray(BOX),
                render_step_size=5e-2, max_samples_per_ray=64,
                samples_budget=8 * 64)
            loss = loss + jnp.sum((colors - px[s:s + 8]) ** 2)
        return loss

    loss, grads = jax.jit(jax.value_and_grad(total))(params)
    gnorm = jax.tree_util.tree_reduce(lambda a, x: a + jnp.sum(x * x),
                                      grads, 0.0)
    return float(loss), float(gnorm)


def test_two_hosts_by_two_chips_match_single_process():
    field = JaxVanilla(net_depth=2, net_width=32)
    params = field.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                        jnp.zeros((4, 3)))
    rays = _global_batch()
    results = launch_world(
        w.multihost_rank, HOSTS * PER_HOST,
        (jax.tree_util.tree_map(np.asarray, params), rays), timeout=180,
        env={"LOCAL_WORLD_SIZE": PER_HOST})
    ref_loss, ref_gnorm = _jax_reference(params, field, rays)
    for rank, r in enumerate(results):
        assert r["again"] is True
        assert r["shape"] == (HOSTS, PER_HOST)
        assert r["coords"] == (rank // PER_HOST, rank % PER_HOST)
        assert r["axes"] == ("host", "chip")
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=1e-5)
        np.testing.assert_allclose(r["gnorm"], ref_gnorm, rtol=1e-5)
        # every process holds the reduced values
        assert r["loss"] == results[0]["loss"]
        for k, g in r["grads"].items():
            np.testing.assert_array_equal(g, results[0]["grads"][k])
        want = sum(np.arange(4.0) + q for q in range(HOSTS * PER_HOST))
        np.testing.assert_array_equal(r["hier"], want)
        np.testing.assert_array_equal(r["flat"], want)
        # local batches of unequal length are refused on every process
        assert "differ" in r["refused"]


def test_init_distributed_without_an_environment(monkeypatch):
    # no torchrun environment and no arguments: a single process
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert "RANK" not in os.environ
    import torch.distributed as dist

    assert not dist.is_initialized()
