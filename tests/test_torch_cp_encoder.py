"""nerfacc_tpu_torch.ops.cp_encoder vs the JAX package's Pallas CP kernel.

Inputs come from numpy seeds and go to both packages. JAX runs its Pallas
kernel in interpret mode on the CPU; the port's wrapper runs its plain
twin for CPU tensors. Tolerance: rtol 1e-3 / atol 1e-5, the JAX package's
own kernel-vs-XLA bound for this level (both sides sum the same two exact
bf16 products in f32, so the values agree far inside it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.ops import cp_level_features as jax_cp_level_features
from nerfacc_tpu_torch.ops import cp_encoder
from nerfacc_tpu_torch.ops.cp_encoder import (
    cp_level_features,
    cp_level_features_plain,
)

torch.set_num_threads(1)


def _fixture(B=300, G=33, R=8, seed=0):
    rng = np.random.RandomState(seed)
    xu = rng.rand(B, 3).astype(np.float32)
    ts = [(rng.randn(G, R) * 0.2).astype(np.float32) for _ in range(3)]
    return xu, ts


def _both(xu, ts):
    want = np.asarray(jax_cp_level_features(jnp.asarray(xu),
                                            *map(jnp.asarray, ts)))
    got = cp_level_features(torch.as_tensor(xu),
                            *map(torch.as_tensor, ts)).numpy()
    return got, want


@pytest.mark.parametrize("B,seed", [(300, 0), (1500, 3)])
def test_cp_features_match_jax_kernel(B, seed):
    xu, ts = _fixture(B=B, seed=seed)
    got, want = _both(xu, ts)
    assert got.shape == (B, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_cp_features_at_grid_ends():
    # u == 0 (first node) and u == G - 1 (last node: a single tap), mixed
    # across axes, plus coordinates one f32 step inside each end
    xu, ts = _fixture(B=64, seed=1)
    xu[:16] = 0.0
    xu[16:32] = 1.0
    xu[32:48, 0], xu[32:48, 1], xu[32:48, 2] = 0.0, 1.0, 0.5
    xu[48:56] = np.nextafter(np.float32(1.0), np.float32(0.0))
    xu[56:64] = np.nextafter(np.float32(0.0), np.float32(1.0))
    got, want = _both(xu, ts)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    # at u == G - 1 the feature is the bf16-rounded last table row
    last = [torch.as_tensor(t[-1]).to(torch.bfloat16).float() for t in ts]
    np.testing.assert_array_equal(got[16], (last[0] * last[1] * last[2]).numpy())


def test_cp_wrapper_refuses_gradients():
    xu, ts = _fixture(B=16)
    tables = [torch.as_tensor(t).requires_grad_() for t in ts]
    with pytest.raises(NotImplementedError):
        cp_level_features(torch.as_tensor(xu), *tables)
    with torch.no_grad():
        assert cp_level_features(torch.as_tensor(xu), *tables).shape == (16, 8)


def test_cp_wrapper_on_cpu_is_the_plain_twin():
    xu, ts = _fixture(B=50, seed=2)
    before = cp_level_features.launches
    args = (torch.as_tensor(xu), *map(torch.as_tensor, ts))
    assert torch.equal(cp_level_features(*args), cp_level_features_plain(*args))
    assert cp_level_features.launches == before


def test_hat_basis_rows_have_two_bf16_taps():
    u = torch.as_tensor(np.random.RandomState(4).rand(200).astype(np.float32))
    basis = cp_encoder.hat_basis_bf16(u, 17).float()
    assert int((basis > 0).sum(dim=1).max()) <= 2
    np.testing.assert_allclose(basis.sum(dim=1).numpy(), 1.0, atol=1e-2)
