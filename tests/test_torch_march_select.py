"""nerfacc_tpu_torch.ops.march_select vs the JAX package's Pallas kernels.

The port's wrappers run their plain twins for CPU tensors; JAX runs the
Pallas kernels in interpret mode. Masks must be bit-equal and t within
rtol 1e-5 / atol 1e-6 (the JAX package's own kernel-vs-XLA bounds: f32
rounding, FMA contraction and cumsum order move t by ~1e-7).

The CUDA kernels cannot run here, so their index algebra is held through
its PyTorch statement in the same module (``select_slots_by_search``: the
per-slot binary search over chunks of the running counts;
``reselect_by_scatter``: rank -> output slot, empty slots -> source slot
K - 1, widths from the neighbours' starts) against the JAX kernels and the
plain twins: masks, positions and gathered t bit-equal, sums within the
bounds above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.ops.march_select import (
    fused_reselect as jax_fused_reselect,
    fused_select_grouped as jax_fused_select_grouped,
)
from nerfacc_tpu_torch.ops.march_select import (
    fused_reselect,
    fused_reselect_plain,
    fused_select_grouped,
    fused_select_grouped_plain,
    reselect_by_scatter,
    select_slots_by_search,
)
from nerfacc_tpu_torch.ray_marching import _lattice_t, select_slots_grouped

torch.set_num_threads(1)


def _assert_quads(got, want):
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def _select_fixture(R, G, C, live_frac, seed):
    rng = np.random.RandomState(seed)
    live = rng.randint(0, C + 1, size=(R, G)) * (rng.rand(R, G) < live_frac)
    gsize = rng.randint(1, C + 1, size=(R, 1))
    live = np.minimum(live, gsize).astype(np.int32)
    t_min = (rng.rand(R) * 0.5 + 0.05).astype(np.float32)
    return live, gsize.astype(np.int32), t_min


def _select_both(live, gsize, t_min, **kw):
    want = jax_fused_select_grouped(
        jnp.asarray(live), jnp.asarray(gsize), jnp.asarray(t_min), **kw
    )
    got = fused_select_grouped(
        torch.as_tensor(live), torch.as_tensor(gsize),
        torch.as_tensor(t_min), **kw
    )
    return got, want


@pytest.mark.parametrize("cone", [0.0, 0.004])
def test_select_grouped_matches_jax_kernel(cone):
    live, gsize, t_min = _select_fixture(300, 32, 16, 0.4, seed=4)
    got, want = _select_both(live, gsize, t_min, k_slots=24, step_size=5e-3,
                             cone_angle=cone, dt_max=1e10)
    _assert_quads(got, want)


def test_select_grouped_ragged_rays():
    # R = 1300 is not a multiple of any block size; the JAX kernel pads
    live, gsize, t_min = _select_fixture(1300, 16, 8, 0.5, seed=8)
    t_min = (t_min - 0.05) * 2.0
    got, want = _select_both(live, gsize, t_min, k_slots=8, step_size=1e-2)
    assert got[0].shape == (1300, 8) and got[3].dtype == torch.bool
    _assert_quads(got, want)


def test_select_grouped_decimates_over_full_rays():
    # every group full: count > K, so slots spread with stride ceil(count/K)
    R, G, C = 40, 8, 8
    live = np.full((R, G), C, np.int32)
    gsize = np.full((R, 1), C, np.int32)
    t_min = np.linspace(0.1, 1.0, R).astype(np.float32)
    got, want = _select_both(live, gsize, t_min, k_slots=10, step_size=1e-2,
                             cone_angle=0.004)
    _assert_quads(got, want)
    assert bool(got[3].all())


def _reselect_fixture(R, K, frac, seed):
    rng = np.random.RandomState(seed)
    masks = rng.rand(R, K) < frac
    ts = np.sort(rng.rand(R, K), axis=1).astype(np.float32)
    dt = (rng.rand(R, K) * 0.01 + 1e-3).astype(np.float32)
    return masks, ts, (ts + dt).astype(np.float32), dt


@pytest.mark.parametrize("R,K,K2,frac", [(200, 48, 16, 0.3), (77, 64, 32, 0.9)])
def test_reselect_matches_jax_kernel(R, K, K2, frac):
    masks, ts, te, dt = _reselect_fixture(R, K, frac, seed=6)
    want = jax_fused_reselect(*map(jnp.asarray, (masks, ts, te, dt)), k2=K2)
    got = fused_reselect(*map(torch.as_tensor, (masks, ts, te, dt)), k2=K2)
    _assert_quads(got, want)


def test_wrappers_on_cpu_are_the_plain_twins():
    live, gsize, t_min = _select_fixture(50, 16, 8, 0.5, seed=1)
    args = tuple(map(torch.as_tensor, (live, gsize, t_min)))
    kw = dict(k_slots=12, step_size=1e-2, cone_angle=0.004)
    n_sel, n_re = fused_select_grouped.launches, fused_reselect.launches
    for a, b in zip(fused_select_grouped(*args, **kw),
                    fused_select_grouped_plain(*args, **kw)):
        assert torch.equal(a, b)
    r_args = tuple(map(torch.as_tensor, _reselect_fixture(50, 16, 0.5, 2)))
    for a, b in zip(fused_reselect(*r_args, k2=8),
                    fused_reselect_plain(*r_args, k2=8)):
        assert torch.equal(a, b)
    assert fused_select_grouped.launches == n_sel
    assert fused_reselect.launches == n_re


def _spread(total, G, cap, rng):
    """``total`` live candidates over G groups, at most ``cap`` in each."""
    assert total <= G * cap
    row = np.zeros(G, np.int64)
    for _ in range(total):
        row[rng.choice(np.flatnonzero(row < cap))] += 1
    return row


def _select_cases(G, K, C=16, seed=3):
    """Random rays, then: an all-dead ray, an all-live ray (count > K), a
    ray with count == K exactly (stride 1, every slot live) and one with
    count == 2 K (stride 2) where the groups can hold it."""
    live, gsize, t_min = _select_fixture(60, G, C, 0.4, seed=seed)
    rng = np.random.RandomState(seed + 1)
    live[0] = 0
    gsize[1], live[1] = C, C
    for row, total in ((2, K), (3, 2 * K)):
        gsize[row] = C
        live[row] = _spread(min(total, G * C), G, C, rng)
    assert live[1].sum() > K and live[2].sum() == min(K, G * C)
    return live, gsize, t_min


def _quad_from_slots(pos, ok, scale, t_min, step, cone):
    def lat(k):
        return _lattice_t(t_min[:, None], k.to(torch.float32), step, cone)

    ts = lat(pos)
    return ts, lat(pos.to(torch.float32) + 1.0), lat(pos + scale) - ts, ok


@pytest.mark.parametrize("K", [8, 24, 48, 64, 80])
@pytest.mark.parametrize("G", [16, 32, 64])
def test_select_by_search_matches_jax_kernel_and_twin(G, K):
    live, gsize, t_min = _select_cases(G, K)
    # the cone lattice where t stays small: at 1,024 lattice points its t
    # values pass 30, and the two packages' exp differ there by more than
    # the bound on t, which is no matter of the selection
    cone = 0.004 if G == 32 else 0.0
    tl, tg, tt = map(torch.as_tensor, (live, gsize, t_min))
    pos, ok, scale = select_slots_by_search(tl, tg, K)
    want = select_slots_grouped(tl, tg, K)
    for a, b in zip((pos, ok, scale), want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    count = live.sum(axis=1)
    stride = np.maximum(-(-count // K), 1)
    np.testing.assert_array_equal(ok.sum(dim=1).numpy(), -(-count // stride))
    assert not bool(ok[0].any()) and count[1] > K
    assert bool(ok[2].all()) == (count[2] == K)
    jax_quad = jax_fused_select_grouped(
        jnp.asarray(live), jnp.asarray(gsize), jnp.asarray(t_min),
        k_slots=K, step_size=5e-3, cone_angle=cone)
    _assert_quads(_quad_from_slots(pos, ok, scale, tt, 5e-3, cone), jax_quad)


@pytest.mark.parametrize("chunk", [1, 5, 16, 32, 63])
def test_select_by_search_settles_each_slot_in_one_chunk(chunk):
    # rows longer than a chunk: the carried count, the slot's chunk, the
    # clamp to the last group and the count before the chunk's first group
    live, gsize, t_min = _select_cases(64, 48, seed=5)
    tl, tg = torch.as_tensor(live), torch.as_tensor(gsize)
    got = select_slots_by_search(tl, tg, 48, chunk=chunk)
    for a, b in zip(got, select_slots_grouped(tl, tg, 48)):
        assert torch.equal(a, b)
    # one group only: the clamp lands on group 0 with nothing before it
    one = select_slots_by_search(tl[:, :1], tg, 8, chunk=chunk)
    for a, b in zip(one, select_slots_grouped(tl[:, :1], tg, 8)):
        assert torch.equal(a, b)


def _reselect_cases(K, K2, seed=7):
    """Random rays, then: an all-dead ray, an all-live ray (count = K), a
    ray with count == K2 * stride exactly, one live slot only (the last),
    and a ray with count == K2 + 1 (stride 2 leaves empty slots)."""
    masks, ts, te, dt = _reselect_fixture(40, K, 0.5, seed=seed)
    rng = np.random.RandomState(seed + 1)
    masks[0] = False
    masks[1] = True
    exact = 2 * K2 if 2 * K2 <= K else K2
    for row, total in ((2, exact), (4, min(K2 + 1, K))):
        masks[row] = False
        masks[row, rng.choice(K, total, replace=False)] = True
    masks[3] = False
    masks[3, K - 1] = True
    return masks, ts, te, dt


@pytest.mark.parametrize("K,K2", [
    (K, K2) for K in (8, 24, 48, 64, 80) for K2 in (8, 24, 32) if K2 <= K])
def test_reselect_by_scatter_matches_jax_kernel_and_twin(K, K2):
    arrays = _reselect_cases(K, K2)
    tensors = tuple(map(torch.as_tensor, arrays))
    got = reselect_by_scatter(*tensors, k2=K2)
    twin = fused_reselect_plain(*tensors, k2=K2)
    # the mask and the gathered t are exact; only the width sums round
    assert torch.equal(got[3], twin[3])
    assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])
    np.testing.assert_allclose(got[2].numpy(), twin[2].numpy(), rtol=1e-5,
                               atol=1e-6)
    count = arrays[0].sum(axis=1)
    stride = np.maximum(-(-count // K2), 1)
    np.testing.assert_array_equal(got[3].sum(dim=1).numpy(),
                                  -(-count // stride))
    assert not bool(got[3][0].any()) and count[1] == K
    assert bool(got[3][2].all()) and int(got[3][3].sum()) == 1
    assert bool((got[2][~got[3]] == 0).all())
    _assert_quads(got, jax_fused_reselect(*map(jnp.asarray, arrays), k2=K2))


@pytest.mark.parametrize("tile", [1, 3, 8, 31])
def test_reselect_by_scatter_assembles_tile_by_tile(tile):
    # more output slots than a tile holds: the extra start past the tile's
    # last slot, and K no multiple of the 32 source slots read at once
    for K, K2 in ((80, 32), (45, 45), (33, 7)):
        tensors = tuple(map(torch.as_tensor, _reselect_cases(K, K2, seed=9)))
        got = reselect_by_scatter(*tensors, k2=K2, tile=tile)
        twin = fused_reselect_plain(*tensors, k2=K2)
        for a, b in zip((got[0], got[1], got[3]),
                        (twin[0], twin[1], twin[3])):
            assert torch.equal(a, b)
        np.testing.assert_allclose(got[2].numpy(), twin[2].numpy(),
                                   rtol=1e-5, atol=1e-6)
