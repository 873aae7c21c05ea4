"""The port's sinusoidal encoder and MLP fields against the JAX package's.

Both packages run on the CPU with the same flax parameters, carried into
the port by ``convert.vanilla_from_flax`` / ``dnerf_from_flax``, on points
from numpy seeds inside the procedural scene's box ([-1.5, 1.5]^3, where
the encoder's top degree reaches arguments of ~770). Tolerances, with
their reasons:
- the encoder: the same f32 products and adds (the cosine half is
  ``sin(xb + pi / 2)`` on both sides) and two libraries' ``sin``: atol
  1e-6;
- the fields' outputs: f32 GEMMs summed in another order, through 8 + 2
  layers of width 256: rtol 1e-5 / atol 1e-6;
- parameter gradients: the same sums backwards: relative L2 1e-4 per
  parameter;
- the init: the bounds are exact, so every weight lies inside them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models import encoders as jax_encoders
from nerfacc_tpu.models import mlp as jax_mlp
from nerfacc_tpu_torch.convert import dnerf_from_flax, vanilla_from_flax
from nerfacc_tpu_torch.models import (
    MLP,
    DNeRFRadianceField,
    NerfMLP,
    SinusoidalEncoder,
    VanillaNeRFRadianceField,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 300  # points per field test
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
GRAD_L2 = 1e-4


def _points(n, seed, dim=3, lo=-1.5, hi=1.5):
    rng = np.random.RandomState(seed)
    return (lo + (hi - lo) * rng.rand(n, dim)).astype(np.float32)


def _dirs(n, seed):
    d = np.random.RandomState(seed).randn(n, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want, rtol=OUT_RTOL, atol=OUT_ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flax_grad_state(grads) -> dict:
    """A flax gradient tree by the port's parameter names."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if k == "kernel":
                out[prefix + "weight"] = np.asarray(v).T
            elif k == "bias":
                out[prefix + "bias"] = np.asarray(v)
            else:
                name = f"layers.{k[6:]}" if k.startswith("Dense_") else k
                walk(v, f"{prefix}{name}.")

    walk(grads.get("params", grads), "")
    return out


def _check_grads(module, jax_grads):
    want = _flax_grad_state(jax_grads)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        assert g is not None, name
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err < GRAD_L2, f"{name}: relative L2 {err:.2e}"


@pytest.mark.parametrize("identity", [True, False])
@pytest.mark.parametrize("degrees", [(0, 10), (0, 4), (0, 0), (2, 5)])
def test_sinusoidal_encoder_matches_jax(degrees, identity):
    lo, hi = degrees
    x = _points(500, 1)
    jenc = jax_encoders.SinusoidalEncoder(3, lo, hi, identity)
    want = jenc.apply({}, jnp.asarray(x))
    enc = SinusoidalEncoder(3, lo, hi, identity)
    got = enc(torch.as_tensor(x))
    assert enc.latent_dim == jenc.latent_dim
    assert tuple(got.shape) == want.shape
    if hi > lo:
        assert got.shape[-1] == enc.latent_dim
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0,
                               atol=1e-6)
    assert not any(True for _ in enc.parameters())


@pytest.mark.parametrize("kw", [
    dict(output_dim=3, net_depth=4, net_width=64, skip_layer=2),
    dict(output_dim=5, net_depth=3, net_width=32, skip_layer=None),
    dict(net_depth=8, net_width=256, skip_layer=4, output_enabled=False),
])
def test_mlp_matches_jax(kw):
    x = _points(N, 2, dim=36)
    jm = jax_mlp.MLP(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    m = MLP(36, generator=torch.Generator().manual_seed(0), **kw)
    vanilla_from_flax(_np_tree(params), m)
    want = jm.apply(params, jnp.asarray(x))
    got = m(torch.as_tensor(x))
    assert got.shape[-1] == m.out_dim == want.shape[-1]
    _close(got, want)


def test_nerf_mlp_matches_jax():
    x, c = _points(N, 3, dim=63), _points(N, 4, dim=27)
    jm = jax_mlp.NerfMLP()
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(c))
    m = NerfMLP(63, 27, generator=torch.Generator().manual_seed(1))
    vanilla_from_flax(_np_tree(params), m)
    rgb_j, sigma_j = jm.apply(params, jnp.asarray(x), jnp.asarray(c))
    rgb, sigma = m(torch.as_tensor(x), torch.as_tensor(c))
    _close(rgb, rgb_j)
    _close(sigma, sigma_j)
    _close(m.query_density(torch.as_tensor(x)),
           jm.apply(params, jnp.asarray(x), method=jm.query_density))
    # one condition per ray, broadcast over its samples
    x3 = x.reshape(30, 10, 63)
    c1 = c[:30]
    rgb_j, _ = jm.apply(params, jnp.asarray(x3), jnp.asarray(c1))
    rgb, _ = m(torch.as_tensor(x3), torch.as_tensor(c1))
    _close(rgb, rgb_j)


@pytest.fixture(scope="module")
def vanilla():
    jf = jax_mlp.VanillaNeRFRadianceField()
    x0 = jnp.zeros((8, 3))
    params = jf.init(jax.random.PRNGKey(2), x0, x0)
    tf = VanillaNeRFRadianceField(generator=torch.Generator().manual_seed(2),
                                  device=CPU)
    vanilla_from_flax(_np_tree(params), tf)
    return jf, params, tf


@pytest.fixture(scope="module")
def dnerf():
    jf = jax_mlp.DNeRFRadianceField()
    params = jf.init(jax.random.PRNGKey(3), jnp.zeros((8, 3)),
                     jnp.zeros((8, 1)), jnp.zeros((8, 3)))
    tf = DNeRFRadianceField(generator=torch.Generator().manual_seed(3),
                            device=CPU)
    dnerf_from_flax(_np_tree(params), tf)
    return jf, params, tf


def test_vanilla_field_matches_jax(vanilla):
    jf, params, tf = vanilla
    x, d = _points(N, 5), _dirs(N, 6)
    rgb_j, sigma_j = jf.apply(params, jnp.asarray(x), jnp.asarray(d))
    rgb, sigma = tf(torch.as_tensor(x), torch.as_tensor(d))
    assert rgb.shape == (N, 3) and sigma.shape == (N, 1)
    _close(rgb, rgb_j)
    _close(sigma, sigma_j)
    assert float(sigma.detach().max()) > 0.0  # the relu leaves density
    _close(tf.query_density(torch.as_tensor(x)),
           jf.apply(params, jnp.asarray(x), method=jf.query_density))
    _close(tf.query_opacity(torch.as_tensor(x), 5e-3),
           jf.apply(params, jnp.asarray(x), 5e-3, method=jf.query_opacity))


def test_vanilla_field_gradients_match_jax(vanilla):
    jf, params, tf = vanilla
    x, d = _points(N, 7), _dirs(N, 8)
    rng = np.random.RandomState(9)
    wr = rng.randn(N, 3).astype(np.float32)
    ws = rng.randn(N, 1).astype(np.float32)

    def loss_j(p):
        rgb, sigma = jf.apply(p, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(rgb * wr) + jnp.sum(sigma * ws)

    grads = jax.grad(loss_j)(params)
    tf.zero_grad(set_to_none=True)
    rgb, sigma = tf(torch.as_tensor(x), torch.as_tensor(d))
    (torch.sum(rgb * torch.as_tensor(wr))
     + torch.sum(sigma * torch.as_tensor(ws))).backward()
    _check_grads(tf, grads)


def test_dnerf_field_matches_jax(dnerf):
    jf, params, tf = dnerf
    x, d = _points(N, 10), _dirs(N, 11)
    t = _points(N, 12, dim=1, lo=0.0, hi=1.0)
    args_j = (jnp.asarray(x), jnp.asarray(t))
    args_t = (torch.as_tensor(x), torch.as_tensor(t))
    rgb_j, sigma_j = jf.apply(params, *args_j, jnp.asarray(d))
    rgb, sigma = tf(*args_t, torch.as_tensor(d))
    _close(rgb, rgb_j)
    _close(sigma, sigma_j)
    _close(tf.query_density(*args_t),
           jf.apply(params, *args_j, method=jf.query_density))
    disp = tf.warp_displacement(*args_t)
    _close(disp, jf.apply(params, *args_j, method=jf.warp_displacement),
           atol=1e-7)
    # the warp starts near the identity: its output layer is ~1e-4
    assert 0.0 < float(disp.detach().abs().max()) < 0.05


def test_dnerf_query_opacity_replays_the_time_draw(dnerf):
    jf, params, tf = dnerf
    x = _points(N, 13)
    times = np.linspace(0.0, 1.0, 7, dtype=np.float32)[:, None]
    gen = torch.Generator().manual_seed(4)
    replay = torch.Generator().manual_seed(4)
    got = tf.query_opacity(torch.as_tensor(x), torch.as_tensor(times), 5e-3,
                           gen)
    idxs = torch.randint(0, 7, (N,), generator=replay).numpy()
    assert len(set(idxs.tolist())) > 1
    want = jf.apply(params, jnp.asarray(x), jnp.asarray(times[idxs]),
                    method=jf.query_density) * 5e-3
    _close(got, want)


@pytest.mark.parametrize("head", ["zero", "init"])
def test_dnerf_field_gradients_match_jax(dnerf, head):
    """``zero``: the warp's output layer zeroed in both packages, so the
    warped points are the inputs bit for bit, and every parameter's
    gradient of rgb, sigma and the displacement is held. ``init``: the
    drawn head; the warped points then differ between the packages in the
    last bit (the warp's GEMMs sum in another order), which can flip a
    trunk relu and move the trunk's gradients by ~1e-3 relative, so the
    warp's gradients are held on the displacement alone (the forward is
    held in ``test_dnerf_field_matches_jax``)."""
    jf, params, tf = dnerf
    params = _np_tree(params)
    if head == "zero":
        last = f"Dense_{len(tf.warp.layers) - 1}"
        params["params"]["warp"][last] = jax.tree_util.tree_map(
            np.zeros_like, params["params"]["warp"][last])
        tf = DNeRFRadianceField(device=CPU)
        dnerf_from_flax(params, tf)
    x, d = _points(N, 14), _dirs(N, 15)
    t = _points(N, 16, dim=1, lo=0.0, hi=1.0)
    rng = np.random.RandomState(17)
    wr, ww = rng.randn(N, 3).astype(np.float32), rng.randn(N, 3)
    ws = rng.randn(N, 1).astype(np.float32)
    ww = ww.astype(np.float32)
    full = head == "zero"

    def loss_j(p):
        args = (jnp.asarray(x), jnp.asarray(t))
        loss = jnp.sum(jf.apply(p, *args, method=jf.warp_displacement) * ww)
        if full:
            rgb, sigma = jf.apply(p, *args, jnp.asarray(d))
            loss = loss + jnp.sum(rgb * wr) + jnp.sum(sigma * ws)
        return loss

    grads = jax.grad(loss_j)(params)
    tf.zero_grad(set_to_none=True)
    xt, tt = torch.as_tensor(x), torch.as_tensor(t)
    loss = torch.sum(tf.warp_displacement(xt, tt) * torch.as_tensor(ww))
    if full:
        rgb, sigma = tf(xt, tt, torch.as_tensor(d))
        loss = (loss + torch.sum(rgb * torch.as_tensor(wr))
                + torch.sum(sigma * torch.as_tensor(ws)))
    loss.backward()
    if full:
        _check_grads(tf, grads)
    else:
        _check_grads(tf.warp, grads["params"]["warp"])


def test_init_statistics():
    f = DNeRFRadianceField(generator=torch.Generator().manual_seed(5),
                           device=CPU)
    state = f.state_dict()
    for name, w in state.items():
        if name.endswith("bias"):
            assert bool((w == 0).all()), name
            continue
        d_out, d_in = w.shape
        if name == f"warp.layers.{len(f.warp.layers) - 1}.weight":
            # flax uniform(scale=1e-4): [0, 1e-4), not symmetric
            assert float(w.min()) >= 0.0 and float(w.max()) < 1e-4
            assert float(w.mean()) == pytest.approx(5e-5, rel=0.2)
            continue
        bound = np.sqrt(6.0 / (d_in + d_out))
        assert float(w.abs().max()) <= bound, name
        if w.numel() >= 4096:
            # uniform in +-bound: the variance is bound^2 / 3
            assert float(w.var()) == pytest.approx(bound**2 / 3, rel=0.1)
    # the skip: layer 5 of the trunk reads 256 + 63 inputs, the rgb layer
    # 256 + 27
    assert state["nerf.mlp.base.layers.5.weight"].shape == (256, 319)
    assert state["nerf.mlp.rgb_layer.layers.0.weight"].shape == (128, 283)
    assert state["warp.layers.3.weight"].shape == (64, 100)
    # a seed gives the same weights; another seed others
    again = DNeRFRadianceField(generator=torch.Generator().manual_seed(5),
                               device=CPU).state_dict()
    other = VanillaNeRFRadianceField(
        generator=torch.Generator().manual_seed(6), device=CPU).state_dict()
    assert all(torch.equal(state[k], again[k]) for k in state)
    assert not torch.equal(state["nerf.mlp.base.layers.0.weight"],
                           other["mlp.base.layers.0.weight"])


def test_converter_refuses_a_tree_of_another_shape(vanilla):
    _, params, _ = vanilla
    small = VanillaNeRFRadianceField(net_width=128, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        vanilla_from_flax(_np_tree(params), small)
    with pytest.raises(ValueError, match="names differ"):
        dnerf_from_flax(_np_tree(params),
                        DNeRFRadianceField(device=CPU))


def test_fields_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a CUDA device")
    with pytest.raises((AssertionError, RuntimeError)):
        VanillaNeRFRadianceField()
    with pytest.raises((AssertionError, RuntimeError)):
        DNeRFRadianceField()
