"""The port's TensoCP field vs the JAX package's, from the same flax
parameters loaded through ``nerfacc_tpu_torch.convert``.

Both sides round the heads' inputs and weights to bf16, accumulate in f32
and round each layer's output to bf16 (XLA's CPU bf16 dot rounds once, as
the port does). Measured agreement is to f32 rounding (sigma ~1e-7
relative), so rgb and sigma are held to rtol 1e-4 / atol 1e-5: f32
summation order passes, a different bf16 rounding rule (~1e-3) fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models import TensoCPRadianceField as JaxTensoCP
from nerfacc_tpu.models import contract_to_unisphere as jax_unisphere
from nerfacc_tpu.models import trunc_exp as jax_trunc_exp
from nerfacc_tpu.models.ngp import spherical_harmonics_deg4 as jax_sh
from nerfacc_tpu_torch.convert import tensocp_from_flax
from nerfacc_tpu_torch.models import (
    TensoCPRadianceField,
    contract_to_unisphere,
    spherical_harmonics_deg4,
    trunc_exp,
)

torch.set_num_threads(1)

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
LEVELS = ((16, 8), (32, 16))


def _inputs(n=256, seed=4):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, 3) * 2.2 - 1.1).astype(np.float32)  # some outside
    x[:8] = np.asarray(AABB[3:], np.float32)  # on the box corner
    d = rng.randn(n, 3)
    return x, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _pair(use_kernel, **kw):
    x, d = _inputs()
    jfield = JaxTensoCP(aabb=AABB, levels=LEVELS, use_kernel=use_kernel, **kw)
    params = jfield.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(d))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tfield = TensoCPRadianceField(aabb=AABB, levels=LEVELS,
                                  use_kernel=use_kernel, **kw)
    tensocp_from_flax(params_np, tfield)
    return jfield, params, tfield, x, d


@pytest.mark.parametrize("use_kernel", [True, False])
def test_tensocp_matches_jax(use_kernel):
    jfield, params, tfield, x, d = _pair(use_kernel, density_bias=1.0)
    rgb_j, sig_j = jfield.apply(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        rgb_t, sig_t = tfield(torch.as_tensor(x), torch.as_tensor(d))
        sig_q = tfield.query_density(torch.as_tensor(x))
    assert rgb_t.dtype == torch.float32 and sig_t.shape == (256, 1)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(sig_q, sig_t)
    # the selector zeroes density outside the open unit cube
    outside = np.any((x <= -1.0) | (x >= 1.0), axis=-1)
    assert outside.sum() > 20
    assert bool((sig_t[torch.as_tensor(outside)] == 0).all())
    assert bool((sig_t[torch.as_tensor(~outside)] > 0).all())


def test_cp_level_paths_differ_only_by_feature_rounding():
    # use_kernel=False keeps bf16 features, the kernel path f32 ones
    _, _, tk, x, _ = _pair(True)
    tx = TensoCPRadianceField(aabb=AABB, levels=LEVELS, use_kernel=False)
    tx.load_state_dict(tk.state_dict())
    xu = torch.as_tensor(np.clip((x + 1.0) / 2.0, 0.0, 1.0))
    with torch.no_grad():
        fk = tk.cp_levels[1](xu)
        fx = tx.cp_levels[1](xu)
    assert fk.dtype == torch.float32 and fx.dtype == torch.bfloat16
    torch.testing.assert_close(fx.float(), fk, rtol=2e-2, atol=1e-4)


def test_converter_transposes_and_checks_names():
    _, params, tfield, _, _ = _pair(True)
    tree = jax.tree_util.tree_map(np.asarray, params)["params"]
    np.testing.assert_array_equal(
        tfield.mlp_head.layers[2].weight.detach().numpy(),
        tree["mlp_head"]["Dense_2"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        tfield.cp_levels[1].axis2.detach().numpy(), tree["level1"]["axis2"]
    )
    del tree["mlp_base"]["Dense_1"]
    with pytest.raises(KeyError):
        tensocp_from_flax(tree, tfield)


def test_field_helpers_match_jax():
    rng = np.random.RandomState(9)
    x = np.concatenate([rng.randn(100).astype(np.float32) * 10,
                        np.asarray([29.9, 30.0, 35.0, 1e4], np.float32)])
    np.testing.assert_allclose(trunc_exp(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_trunc_exp(jnp.asarray(x))),
                               rtol=1e-6)
    assert float(trunc_exp(torch.tensor(1e4))) == pytest.approx(np.exp(30.0),
                                                                rel=1e-6)
    d = rng.randn(64, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        spherical_harmonics_deg4(torch.as_tensor(d)).numpy(),
        np.asarray(jax_sh(jnp.asarray(d))), rtol=1e-5, atol=1e-6,
    )
    p = (rng.randn(64, 3) * 3).astype(np.float32)
    aabb = np.asarray(AABB, np.float32)
    np.testing.assert_allclose(
        contract_to_unisphere(torch.as_tensor(p), torch.as_tensor(aabb)).numpy(),
        np.asarray(jax_unisphere(jnp.asarray(p), jnp.asarray(aabb))),
        rtol=1e-5, atol=1e-6,
    )


def test_unbounded_field_matches_jax():
    jfield, params, tfield, x, d = _pair(True, unbounded=True)
    x = x * 3.0
    rgb_j, sig_j = jfield.apply(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        rgb_t, sig_t = tfield(torch.as_tensor(x), torch.as_tensor(d))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-4,
                               atol=1e-5)
