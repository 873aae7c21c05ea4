"""The port's flat packed rendering (the flat half of
``nerfacc_tpu_torch/vol_rendering.py``) against the JAX package's and
against ``tests/reference_oracle.py`` (numpy transliterations of the
reference's serial CUDA loops, in float64), on the same numpy-seeded
inputs.

Tolerances, with their reasons:
- against JAX, values: rtol 1e-5 / atol 1e-6. Both sum the same f32
  terms by a segmented reset-operator scan, in another tree order (XLA's
  associative scan, the port's Hillis-Steele steps). Gradients: the JAX
  package's own bound against the serial oracle, rtol 1e-4 / atol 1e-5.
  Its reverse suffix sum is a ray's total less its inclusive prefix,
  which leaves a residue of up to one f32 rounding of the total where the
  exact suffix is 0 (2e-6 here, after the division by 1 - alpha); the
  port's reverse scan subtracts nothing.
- against the serial oracle: the JAX package's own bounds
  (``tests/test_reference_oracle.py``), transmittance rtol 1e-5 / atol
  1e-5, its gradient rtol 1e-4 / atol 1e-5; the weights and the render the
  same as the transmittance, their gradients rtol 2e-4 / atol 2e-5.
- the goldens of the reference's ``tests/test_rendering.py``: atol 1e-4
  (four printed digits).
- bridged (dense twins) against the segmented path forced by
  ``DENSE_BRIDGE = False``: rtol 1e-5 / atol 1e-6 on values and
  gradients (row cumsums against segmented scans of the same terms).
- masks and visibility: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu as jx
import nerfacc_tpu_torch as pt
import nerfacc_tpu_torch.vol_rendering as pvr
from tests import reference_oracle as oracle

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _t(a):
    return torch.as_tensor(np.array(a))


def _packed(seed=2, n_rays=32, max_count=40, masked=True):
    """An irregular packed set: counts 0..max_count per ray, sorted t."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, max_count, n_rays)
    counts[3] = 0
    ri = np.repeat(np.arange(n_rays), counts).astype(np.int32)
    n = ri.shape[0]
    ts = np.sort(rng.rand(n).astype(np.float32))
    te = (ts + rng.rand(n).astype(np.float32) * 0.02 + 0.005).astype(
        np.float32)
    sig = (rng.rand(n) * 30).astype(np.float32)
    rgb = rng.rand(n, 3).astype(np.float32)
    m = rng.rand(n) < 0.85 if masked else np.ones(n, bool)
    info = oracle.pack_info(ri, n_rays).astype(np.int32)
    return dict(ri=ri, n_rays=n_rays, ts=ts, te=te, sig=sig, rgb=rgb, m=m,
                info=info, counts=counts)


def _kw(p, via, lib):
    if lib == "jax":
        if via == "ray_indices":
            return dict(ray_indices=jnp.asarray(p["ri"]), n_rays=p["n_rays"])
        return dict(packed_info=jnp.asarray(p["info"]))
    if via == "ray_indices":
        return dict(ray_indices=_t(p["ri"]), n_rays=p["n_rays"])
    return dict(packed_info=_t(p["info"]))


def _jax_value_and_vjp(fn, x, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return out, vjp(jnp.asarray(cot))[0]


def _torch_value_and_grad(fn, x, cot):
    xt = _t(x).requires_grad_()
    out = fn(xt)
    (out * _t(cot)).sum().backward()
    return out, xt.grad


OPS = ["trans_density", "trans_alpha", "weight_density", "weight_alpha"]


def _op(lib, name, p, via, masked):
    """fn(x) of the named flat op over this packed set, x = sigmas (N, 1)
    or alphas (N, 1)."""
    mod = jx if lib == "jax" else pt
    arr = jnp.asarray if lib == "jax" else _t
    ts, te = arr(p["ts"][:, None]), arr(p["te"][:, None])
    kw = dict(_kw(p, via, lib), masks=arr(p["m"]) if masked else None)
    if name == "trans_density":
        return lambda x: mod.render_transmittance_from_density(ts, te, x, **kw)
    if name == "weight_density":
        return lambda x: mod.render_weight_from_density(ts, te, x, **kw)
    if name == "trans_alpha":
        return lambda x: mod.render_transmittance_from_alpha(x, **kw)
    return lambda x: mod.render_weight_from_alpha(x, **kw)


def _op_input(name, p):
    if name.endswith("alpha"):
        return (1.0 - np.exp(-p["sig"] * (p["te"] - p["ts"])))[:, None].astype(
            np.float32)
    return p["sig"][:, None]


@pytest.mark.parametrize("name", OPS)
@pytest.mark.parametrize("via", ["ray_indices", "packed_info"])
@pytest.mark.parametrize("masked", [False, True])
def test_flat_op_and_gradient_match_jax(name, via, masked):
    p = _packed()
    x = _op_input(name, p)
    cot = np.random.RandomState(9).rand(*x.shape).astype(np.float32)
    want, want_g = _jax_value_and_vjp(_op("jax", name, p, via, masked), x, cot)
    got, got_g = _torch_value_and_grad(_op("torch", name, p, via, masked), x,
                                       cot)
    assert got.shape == x.shape
    _close(got, want)
    _close(got_g, want_g, **GRAD_TOL)


def test_transmittance_fwd_bwd_vs_oracle_serial():
    p = _packed(masked=False)
    g = np.random.RandomState(3).rand(p["ri"].shape[0]).astype(np.float32)
    trans, d_sig = _torch_value_and_grad(
        _op("torch", "trans_density", p, "ray_indices", False),
        p["sig"][:, None], g[:, None])
    f64 = [p[k].astype(np.float64) for k in ("ts", "te", "sig")]
    trans_o = oracle.transmittance_from_sigma(p["info"], *f64)
    d_sig_o = oracle.grad_sigmas_from_transmittance(
        p["info"], f64[0], f64[1], trans_o, g.astype(np.float64))
    _close(trans[:, 0], trans_o, rtol=1e-5, atol=1e-5)
    _close(d_sig[:, 0], d_sig_o, rtol=1e-4, atol=1e-5)


def test_weights_fwd_bwd_vs_oracle_serial():
    p = _packed(masked=False)
    g = np.random.RandomState(4).rand(p["ri"].shape[0]).astype(np.float32)
    w, d_sig = _torch_value_and_grad(
        _op("torch", "weight_density", p, "packed_info", False),
        p["sig"][:, None], g[:, None])
    f64 = [p[k].astype(np.float64) for k in ("ts", "te", "sig")]
    w_o = oracle.weights_from_sigma(p["info"], *f64)
    d_sig_o = oracle.grad_sigmas_from_weights(p["info"], *f64, w_o,
                                              g.astype(np.float64))
    _close(w[:, 0], w_o, rtol=1e-5, atol=1e-5)
    _close(d_sig[:, 0], d_sig_o, rtol=2e-4, atol=2e-5)


def test_rendering_and_its_gradient_vs_oracle_and_jax():
    # the render of an irregular packed set on a white background, and
    # the gradient of a colour loss in the densities and colours
    p = _packed(masked=False)
    n = p["ri"].shape[0]
    bkgd = np.ones(3, np.float32)
    g_col = np.random.RandomState(6).rand(p["n_rays"], 3).astype(np.float32)
    sig = _t(p["sig"][:, None]).requires_grad_()
    rgb = _t(p["rgb"]).requires_grad_()
    colors, opac, depths = pt.rendering(
        _t(p["ts"][:, None]), _t(p["te"][:, None]), _t(p["ri"]), p["n_rays"],
        rgb_sigma_fn=lambda ts, te, ri: (rgb, sig), render_bkgd=_t(bkgd))
    (colors * _t(g_col)).sum().backward()

    f64 = {k: p[k].astype(np.float64) for k in ("ts", "te", "sig", "rgb")}
    c_o, o_o, d_o, w_o = oracle.rendering_forward(
        p["info"], p["ri"], f64["ts"], f64["te"], f64["sig"], f64["rgb"],
        p["n_rays"], render_bkgd=bkgd.astype(np.float64))
    dsig_o, drgb_o = oracle.rendering_backward(
        p["info"], p["ri"], f64["ts"], f64["te"], f64["sig"], f64["rgb"],
        w_o, g_col.astype(np.float64), p["n_rays"],
        render_bkgd=bkgd.astype(np.float64))
    for got, want in ((colors, c_o), (opac, o_o), (depths, d_o)):
        _close(got, want, rtol=1e-5, atol=1e-5)
    _close(sig.grad[:, 0], dsig_o, rtol=2e-4, atol=2e-5)
    _close(rgb.grad, drgb_o, rtol=2e-4, atol=2e-5)

    def jloss(s, c):
        out = jx.rendering(
            jnp.asarray(p["ts"][:, None]), jnp.asarray(p["te"][:, None]),
            jnp.asarray(p["ri"]), p["n_rays"],
            rgb_sigma_fn=lambda ts, te, ri: (c, s),
            render_bkgd=jnp.asarray(bkgd))
        return (out[0] * jnp.asarray(g_col)).sum(), out

    (_, jout), (js, jc) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(p["sig"][:, None]), jnp.asarray(p["rgb"]))
    for got, want in zip((colors, opac, depths), jout):
        _close(got, want)
    _close(sig.grad, js, **GRAD_TOL)
    _close(rgb.grad, jc, **GRAD_TOL)
    assert colors.shape == (p["n_rays"], 3) and n > 0


def test_grads_golden():
    # the reference's tests/test_rendering.py:136-214
    ri = torch.tensor([0, 2, 2, 2, 2], dtype=torch.int32)
    info = torch.tensor([[0, 1], [1, 0], [1, 4]], dtype=torch.int32)
    sigmas = torch.tensor([[0.4], [0.8], [0.1], [0.8], [0.1]])
    ts = torch.as_tensor(np.random.RandomState(3).rand(5, 1).astype(
        np.float32))
    te = ts + 1.0
    w_ref = [[0.3297], [0.5507], [0.0428], [0.2239], [0.0174]]
    g_ref = [[0.6703], [0.1653], [0.1653], [0.1653], [0.1653]]
    fns = [
        lambda s, kw: pt.render_transmittance_from_density(ts, te, s, **kw)
        * (1.0 - torch.exp(-s * (te - ts))),
        lambda s, kw: pt.render_weight_from_density(ts, te, s, **kw),
        lambda s, kw: pt.render_weight_from_alpha(
            1.0 - torch.exp(-s * (te - ts)), **kw),
    ]
    for fn in fns:
        for kw in (dict(ray_indices=ri, n_rays=3), dict(packed_info=info)):
            s = sigmas.clone().requires_grad_()
            w = fn(s, kw)
            w.sum().backward()
            _close(w, w_ref, atol=1e-4, rtol=0)
            _close(s.grad, g_ref, atol=1e-4, rtol=0)


def test_masked_entries_are_inert():
    seg = torch.tensor([0, 0, 1, 1, 1, 2, 2, 2], dtype=torch.int32)
    masks = torch.tensor([1, 1, 1, 0, 1, 1, 1, 0], dtype=torch.bool)
    rng = np.random.RandomState(5)
    sigmas = _t(rng.rand(8, 1).astype(np.float32)).requires_grad_()
    ts = _t(rng.rand(8, 1).astype(np.float32))
    te = ts + 0.5
    kw = dict(ray_indices=seg, n_rays=3, masks=masks)
    w1 = pt.render_weight_from_density(ts, te, sigmas, **kw)
    w1.sum().backward()
    w2 = pt.render_weight_from_density(
        ts, te, torch.where(masks[:, None], sigmas.detach(),
                            torch.tensor(77.0)), **kw)
    assert torch.equal(w1.detach(), w2)
    assert (w1[~masks] == 0).all() and (sigmas.grad[~masks] == 0).all()
    a = 1.0 - torch.exp(-sigmas.detach())
    vis = pt.render_visibility(a, **kw)
    assert not vis[~masks].any()
    acc = pt.accumulate_along_rays(w1.detach()[:, 0], seg, values=None,
                                   n_rays=3, masks=masks)
    want = torch.zeros(3).index_add(0, seg.long(),
                                    torch.where(masks, w1.detach()[:, 0], 0.0))
    _close(acc[:, 0], want.numpy(), rtol=0, atol=0)


def test_rendering_rgb_alpha_fn_matches_sigma_fn():
    rng = np.random.RandomState(0)
    n_rays, n = 3, 12
    ri = torch.tensor([0, 0, 0, 0, 0, 1, 1, 2, 2, 2, 2, 2], dtype=torch.int32)
    ts = _t(np.sort(rng.rand(n)).reshape(-1, 1).astype(np.float32))
    te = ts + 0.05
    sigmas = _t((rng.rand(n, 1) * 5).astype(np.float32))
    rgbs = _t(rng.rand(n, 3).astype(np.float32))
    out1 = pt.rendering(ts, te, ri, n_rays,
                        rgb_sigma_fn=lambda a, b, r: (rgbs, sigmas),
                        render_bkgd=torch.ones(3))
    out2 = pt.rendering(
        ts, te, ri, n_rays,
        rgb_alpha_fn=lambda a, b, r: (rgbs, 1.0 - torch.exp(-sigmas * (b - a))),
        render_bkgd=torch.ones(3))
    for a, b in zip(out1, out2):
        _close(a, b.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        pt.rendering(ts, te, ri, n_rays)


def test_saturated_alpha_keeps_its_weight():
    # an alpha of exactly 1 keeps its own weight T_i and hides what lies
    # behind it (the JAX package's tests/test_dense_path.py:427)
    alphas = torch.tensor([0.3, 1.0, 0.5, 0.2])
    ri = torch.zeros(4, dtype=torch.int32)
    for bridge in (True, False):
        pvr.DENSE_BRIDGE = bridge
        try:
            w = pt.render_weight_from_alpha(alphas, ray_indices=ri, n_rays=1)
            t = pt.render_transmittance_from_alpha(alphas, ray_indices=ri,
                                                   n_rays=1)
            vis = pt.render_visibility(alphas, ray_indices=ri, n_rays=1)
        finally:
            pvr.DENSE_BRIDGE = True
        _close(w, [0.3, 0.7, 0.0, 0.0], rtol=0, atol=1e-6)
        _close(t, [1.0, 0.7, 0.0, 0.0], rtol=0, atol=1e-6)
        assert vis.tolist() == [True, True, False, False]


@pytest.mark.parametrize("alpha_thre", [0.0, 0.3])
def test_visibility_and_accumulation_match_jax(alpha_thre):
    p = _packed(seed=8)
    a = (1.0 - np.exp(-p["sig"] * (p["te"] - p["ts"]))).astype(np.float32)
    for via in ("ray_indices", "packed_info"):
        got = pt.render_visibility(_t(a), masks=_t(p["m"]),
                                   early_stop_eps=1e-3, alpha_thre=alpha_thre,
                                   **_kw(p, via, "torch"))
        want = jx.render_visibility(jnp.asarray(a), masks=jnp.asarray(p["m"]),
                                    early_stop_eps=1e-3,
                                    alpha_thre=alpha_thre,
                                    **_kw(p, via, "jax"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for values in (None, p["rgb"]):
        got = pt.accumulate_along_rays(
            _t(a), _t(p["ri"]), None if values is None else _t(values),
            n_rays=p["n_rays"], masks=_t(p["m"]))
        want = jx.accumulate_along_rays(
            jnp.asarray(a), jnp.asarray(p["ri"]),
            None if values is None else jnp.asarray(values),
            n_rays=p["n_rays"], masks=jnp.asarray(p["m"]))
        _close(got, want)


def _dense_fixture(R=6, K=8, seed=0):
    rng = np.random.RandomState(seed)
    ts = np.sort(rng.rand(R, K), axis=1).astype(np.float32)
    te = (ts + rng.rand(R, K) * 0.1 + 0.01).astype(np.float32)
    sig = (rng.rand(R, K) * 3).astype(np.float32)
    m = rng.rand(R, K) < 0.7
    idx = np.repeat(np.arange(R, dtype=np.int32), K)
    info = np.stack([np.arange(R, dtype=np.int32) * K,
                     np.full((R,), K, np.int32)], axis=-1)
    return ts, te, sig, m, idx, info


def test_bridge_detection_positive_and_negative():
    ts, te, sig, m, idx, info = _dense_fixture()
    R, K = sig.shape
    N = R * K
    det = pvr._detect_dense_layout
    assert det(_t(idx), None, N, R) == (K, R)
    assert det(None, _t(info), N, R) == (K, R)
    assert det(None, torch.tensor([[0, 3], [3, 5]]), 8, None) is None
    bad = idx.copy()
    bad[3] = 5
    assert det(_t(bad), None, N, R) is None
    assert det(_t(idx[:-1]), None, N - 1, R) is None
    assert det(_t(idx), None, N, None) is None  # n_rays unknown
    pvr.DENSE_BRIDGE = False
    try:
        assert det(_t(idx), None, N, R) is None
    finally:
        pvr.DENSE_BRIDGE = True


@pytest.mark.parametrize("via", ["ray_indices", "packed_info"])
def test_bridged_results_and_gradients_match_segmented(via):
    ts, te, sig, m, idx, info = _dense_fixture()
    R, K = sig.shape
    kw = (dict(ray_indices=_t(idx), n_rays=R) if via == "ray_indices"
          else dict(packed_info=_t(info)))
    flat = [_t(a.reshape(-1, 1)) for a in (ts, te)]
    mk = _t(m.reshape(-1))
    alphas = 1.0 - np.exp(-sig * (te - ts))
    cot = np.random.RandomState(1).rand(R * K, 1).astype(np.float32)

    def run(bridge):
        pvr.DENSE_BRIDGE = bridge
        try:
            outs = []
            for name in OPS:
                x = (alphas if name.endswith("alpha") else sig).reshape(-1, 1)
                fn = {
                    "trans_density": lambda s: pt.render_transmittance_from_density(
                        *flat, s, masks=mk, **kw),
                    "weight_density": lambda s: pt.render_weight_from_density(
                        *flat, s, masks=mk, **kw),
                    "trans_alpha": lambda a: pt.render_transmittance_from_alpha(
                        a, masks=mk, **kw),
                    "weight_alpha": lambda a: pt.render_weight_from_alpha(
                        a, masks=mk, **kw),
                }[name]
                outs.extend(_torch_value_and_grad(fn, x.astype(np.float32),
                                                  cot))
            outs.append(pt.render_visibility(_t(alphas.reshape(-1)), masks=mk,
                                             **kw))
            w = outs[2].detach()[:, 0]
            outs.append(pt.loss_distortion(
                kw.get("packed_info"), w, *flat,
                ray_indices=kw.get("ray_indices"), n_rays=kw.get("n_rays"),
                masks=mk))
            if via == "ray_indices":
                outs.append(pt.accumulate_along_rays(
                    w, _t(idx), _t(np.stack([ts, te, sig], -1).reshape(-1, 3)),
                    n_rays=R, masks=mk))
            return outs
        finally:
            pvr.DENSE_BRIDGE = True

    for a, b in zip(run(True), run(False)):
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
        else:
            _close(a, b.detach().numpy())


def test_rendering_bridged_matches_segmented():
    ts, te, sig, m, idx, info = _dense_fixture(R=5, K=12, seed=3)
    rgb = np.random.RandomState(3).rand(5 * 12, 3).astype(np.float32)
    outs = []
    for bridge in (True, False):
        pvr.DENSE_BRIDGE = bridge
        try:
            s = _t(sig.reshape(-1, 1)).requires_grad_()
            c = _t(rgb).requires_grad_()
            out = pt.rendering(
                _t(ts.reshape(-1, 1)), _t(te.reshape(-1, 1)), _t(idx), 5,
                rgb_sigma_fn=lambda a, b, r: (c, s),
                render_bkgd=torch.ones(3), masks=_t(m.reshape(-1)))
            sum(o.sum() for o in out).backward()
            outs.append((*out, s.grad, c.grad))
        finally:
            pvr.DENSE_BRIDGE = True
    for a, b in zip(*outs):
        _close(a, b.detach().numpy())
