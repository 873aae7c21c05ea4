"""nerfacc_tpu_torch.ops.march_select vs the JAX package's Pallas kernels.

The port's wrappers run their plain twins for CPU tensors; JAX runs the
Pallas kernels in interpret mode. Masks must be bit-equal and t within
rtol 1e-5 / atol 1e-6 (the JAX package's own kernel-vs-XLA bounds: f32
rounding, FMA contraction and cumsum order move t by ~1e-7).
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
)

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
