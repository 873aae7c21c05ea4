"""The CP encoder's training half (K2, K3, K4) in the port vs the JAX
package's Pallas kernels, which run in interpret mode on the CPU. The
port's wrappers run their plain twins for CPU tensors.

Measured agreement (B = 1500, G = 33, R = 8):
- K2: features and bf16 residuals bit-equal.
- K3: table gradients within 6e-8 absolute of |dT| <= 1.23: f32
  summation order. Held to rtol 1e-5 / atol 1e-6.
- K4: within 1.3e-3 absolute of |dT| <= 0.58. The kernel rounds
  ``d = bf16(g) * bf16(u_b u_c)`` to bf16, as its bf16 MXU operand is on
  the TPU and as the twin does; XLA's CPU compiler keeps that product in
  f32 in interpret mode (with that one rounding left out the twin agrees
  to 9e-8). Held to the JAX package's own kernel-vs-XLA bound for this
  kernel (``tests/test_pallas_ops.py``: rtol 5e-2, atol 4e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.ops import cp_encoder as jax_cp
from nerfacc_tpu_torch.ops import (
    cp_level_features,
    cp_level_features_plain,
    cp_level_features_res,
    cp_level_features_res_fwd,
    cp_level_features_res_plain,
    cp_level_grads,
    cp_level_grads_plain,
    cp_level_grads_res,
    cp_level_grads_res_plain,
)

torch.set_num_threads(1)

K3_TOL = dict(rtol=1e-5, atol=1e-6)
K4_TOL = dict(rtol=5e-2, atol=4e-3)


def _fixture(B=1500, G=33, R=8, seed=0):
    """B not a multiple of the Pallas block (1024); samples at u == 0 and
    u == G - 1 on every axis and mixed across axes."""
    rng = np.random.RandomState(seed)
    xu = rng.rand(B, 3).astype(np.float32)
    xu[:16] = 0.0
    xu[16:32] = 1.0
    xu[32:48, 0], xu[32:48, 1], xu[32:48, 2] = 1.0, 0.0, 0.5
    ts = [(rng.randn(G, R) * 0.2).astype(np.float32) for _ in range(3)]
    g = rng.randn(B, R).astype(np.float32)
    return xu, ts, g


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_res_forward_matches_jax_kernel():
    xu, ts, _ = _fixture()
    feats_j, us_j = jax_cp._cp_fwd_res_impl(jnp.asarray(xu), *map(jnp.asarray, ts))
    feats_t, us_t = cp_level_features_res_plain(*_torch(xu, *ts))
    np.testing.assert_array_equal(feats_t.numpy(), np.asarray(feats_j))
    for u_t, u_j in zip(us_t, us_j):
        assert u_t.dtype == torch.bfloat16 and u_t.shape == (1500, 8)
        # the JAX residuals keep the kernel's padded rows
        np.testing.assert_array_equal(
            u_t.float().numpy(), np.asarray(u_j[:1500]).astype(np.float32)
        )
    # the residual is bf16 of K1's f32 axis feature, and the features are K1's
    assert torch.equal(feats_t, cp_level_features_plain(*_torch(xu, *ts)))


def test_k3_twin_matches_jax_backward_kernel():
    xu, ts, g = _fixture(seed=1)
    want = jax_cp._cp_bwd(
        (jnp.asarray(xu), *map(jnp.asarray, ts)), jnp.asarray(g)
    )
    got = cp_level_grads_plain(*_torch(xu, *ts, g))
    np.testing.assert_array_equal(np.asarray(want[0]), 0.0)  # xu: zeros
    for d_t, d_j in zip(got, want[1:]):
        assert d_t.shape == (33, 8)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **K3_TOL)


@pytest.mark.parametrize("B,G,R", [
    (1500, 33, 8),
    (1500, 33, 48),  # R neither below 32 nor a multiple of it
    (1237, 40, 32),  # a prime B: no block or chunk size divides it
])
def test_k4_twin_matches_jax_backward_kernel(B, G, R):
    xu, ts, g = _fixture(B=B, G=G, R=R, seed=2)
    _, res = jax_cp._cp_fwd_res(jnp.asarray(xu), *map(jnp.asarray, ts))
    want = jax_cp._cp_bwd_res(res, jnp.asarray(g))
    _, us = cp_level_features_res_plain(*_torch(xu, *ts))
    got = cp_level_grads_res_plain(*_torch(xu, g), *us, G)
    for d_t, d_j in zip(got, want[1:]):
        assert d_t.shape == (G, R)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **K4_TOL)


@pytest.mark.parametrize("res", [False, True])
def test_autograd_matches_jax_grad(res):
    # the ops' table gradients vs jax.grad of the same loss
    xu, ts, _ = _fixture(seed=3)
    w = np.random.RandomState(4).randn(8).astype(np.float32)
    jax_op = jax_cp.cp_level_features_res if res else jax_cp.cp_level_features
    op = cp_level_features_res if res else cp_level_features

    def loss_j(t0, t1, t2):
        return jnp.sum(jax_op(jnp.asarray(xu), t0, t1, t2) * w)

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, ts))
    tables = [t.requires_grad_() for t in _torch(*ts)]
    xu_t = torch.as_tensor(xu).requires_grad_()
    (op(xu_t, *tables) * torch.as_tensor(w)).sum().backward()
    assert xu_t.grad is None  # no gradient flows to the coordinates
    for table, d_j in zip(tables, want):
        np.testing.assert_allclose(table.grad.numpy(), np.asarray(d_j),
                                   **(K4_TOL if res else K3_TOL))


def test_res_op_without_gradients_runs_k1_and_saves_nothing():
    xu, ts, _ = _fixture(B=64, seed=5)
    tables = [t.requires_grad_() for t in _torch(*ts)]
    with torch.no_grad():
        out = cp_level_features_res(torch.as_tensor(xu), *tables)
    assert out.grad_fn is None
    assert torch.equal(out, cp_level_features_plain(torch.as_tensor(xu), *tables))
    frozen = _torch(*ts)  # no table asks for a gradient
    assert cp_level_features_res(torch.as_tensor(xu), *frozen).grad_fn is None
    out = cp_level_features_res(torch.as_tensor(xu), *tables)
    assert out.grad_fn is not None


def test_cpu_wrappers_are_the_twins_and_count_nothing():
    xu, ts, g = _fixture(B=100, seed=6)
    xu, t0, t1, t2, g = _torch(xu, *ts, g)
    counters = (cp_level_features, cp_level_features_res, cp_level_grads,
                cp_level_grads_res)
    before = [fn.launches for fn in counters]
    feats, us = cp_level_features_res_fwd(xu, t0, t1, t2)
    want_feats, want_us = cp_level_features_res_plain(xu, t0, t1, t2)
    assert torch.equal(feats, want_feats)
    assert all(torch.equal(a, b) for a, b in zip(us, want_us))
    for a, b in zip(cp_level_grads(xu, t0, t1, t2, g),
                    cp_level_grads_plain(xu, t0, t1, t2, g)):
        assert torch.equal(a, b)
    for a, b in zip(cp_level_grads_res(xu, g, *us, 33),
                    cp_level_grads_res_plain(xu, g, *us, 33)):
        assert torch.equal(a, b)
    assert [fn.launches for fn in counters] == before
