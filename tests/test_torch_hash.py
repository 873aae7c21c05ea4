"""The port's hash encoder, its table-gradient scatter and the NGP field vs
the JAX package's.

Inputs come from numpy seeds and the same flax parameters go to both
packages (``convert.ngp_from_flax``). JAX runs its Pallas scatter kernel in
interpret mode; the port's wrappers run their plain twins on the CPU. All
at small size: 4 levels over tables of 2^10 to 2^13 entries, which hold
both densely indexed and hashed levels.

Tolerances, with their reasons:
- corner indices are integers: bit-equal. Corner weights are products of
  three f32 fractions: within 1e-6 absolute (XLA may contract ``x * res -
  floor``).
- encoder outputs sum 8 f32 products per level in another order: within
  1e-6 of the largest |output| (tables of order 1).
- ``hash_grad_scatter`` and the table gradients sum f32 terms in another
  order: the JAX package's own bounds for its kernel against XLA
  (rtol 1e-5 / atol 1e-5, and rtol 1e-4 / atol 1e-6); the multi-level
  table gradient within 1e-5 of the largest |gradient|.
- field outputs pass two or three small f32 MLPs: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu.ops.hash_gather as jax_hash_gather
from nerfacc_tpu.models import HashEncoder as JaxHashEncoder
from nerfacc_tpu.models import NGPRadianceField as JaxNGP
from nerfacc_tpu.models.hash_encoding import (
    _level_resolutions as jax_level_resolutions,
)
from nerfacc_tpu_torch.convert import (
    ngp_from_flax,
    ngp_table_from_flax,
    ngp_table_to_flax,
)
from nerfacc_tpu_torch.models import (
    HashEncoder,
    NGPRadianceField,
    hash_grid_indices,
)
from nerfacc_tpu_torch.models.hash_encoding import _level_resolutions
from nerfacc_tpu_torch.ops import (
    hash_encode,
    hash_encode_lookup,
    hash_encode_plain,
    hash_grad_scatter,
    hash_grad_scatter_levels,
    hash_grad_scatter_levels_plain,
    hash_grad_scatter_plain,
    table_gather,
    table_gather_plain,
)

torch.set_num_threads(1)

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
# 4 levels at resolutions 4, 5, 8, 12 over 2^10 entries: the first three
# are dense ((res + 1)^3 <= 1024), the last is hashed
SMALL = dict(n_levels=4, log2_hashmap_size=10, base_resolution=4)
# resolutions 16 .. 101 over 2^12 entries: every level hashed, with
# coordinates whose hash products pass 2^32
HASHED = dict(n_levels=6, log2_hashmap_size=12, base_resolution=16)


def _points(n, res_list, seed):
    """Points in [0, 1]^3 with the corners 0 and 1, points on cell faces
    of every level, and points one f32 step inside 1."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3).astype(np.float32)
    x[0], x[1], x[2] = 0.0, 1.0, (0.0, 1.0, 0.5)
    x[3] = np.nextafter(np.float32(1.0), np.float32(0.0))
    row = 4
    for res in res_list:
        for k in (1, res // 2, res - 1, res):
            x[row] = rng.rand(3)
            x[row, rng.randint(3)] = np.float32(k) / np.float32(res)
            row += 1
    assert row <= n
    return x


def _jax_indices(monkeypatch, x, n_features=2, **kw):
    """The (flat_idx, corner_w) that the JAX encoder hands to its lookup."""
    seen = {}

    def capture(table, flat_idx, cw, T, *args):
        seen["idx"], seen["w"] = np.asarray(flat_idx), np.asarray(cw)
        L = flat_idx.shape[1] // 8
        return jnp.zeros((flat_idx.shape[0], n_features * L), jnp.float32)

    monkeypatch.setattr(jax_hash_gather, "hash_encode_lookup", capture)
    enc = JaxHashEncoder(n_features=n_features, **kw)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    enc.apply(params, jnp.asarray(x))
    return seen["idx"], seen["w"]


def _encoders(n_features, table_fn, seed=0, pallas_grad=False, **kw):
    """Both packages' encoder over the same table: ``table_fn(rng, size)``
    gives the flat feature-major values."""
    jenc = JaxHashEncoder(n_features=n_features, pallas_grad=pallas_grad,
                          **kw)
    params = jenc.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)))
    size = params["params"]["table"].shape[0]
    table = table_fn(np.random.RandomState(seed), size).astype(np.float32)
    params = {"params": {"table": jnp.asarray(table)}}
    tenc = HashEncoder(n_features=n_features, pallas_grad=pallas_grad,
                       device="cpu", **kw)
    with torch.no_grad():
        tenc.table.copy_(torch.as_tensor(np.ascontiguousarray(
            ngp_table_from_flax(table, tenc.n_levels, n_features))))
    return jenc, params, tenc


def _randn(rng, size):
    return rng.randn(size)


@pytest.mark.parametrize("args", [
    (16, 16, 1.4472692012786865), (4, 4, 1.4472692012786865), (8, 16, 2.0),
])
def test_level_resolutions_match_jax(args):
    np.testing.assert_array_equal(_level_resolutions(*args),
                                  jax_level_resolutions(*args))
    assert _level_resolutions(*args).dtype == np.int64


def test_full_size_levels_are_dense_then_hashed():
    # the reference field: levels 0-4 dense, 5-15 hashed, never built here
    res = _level_resolutions(16, 16, 1.4472692012786865)
    assert res[0] == 16 and res[-1] == 4095  # float64 floor of 4095.99..
    np.testing.assert_array_equal((res + 1) ** 3 <= 1 << 19,
                                  [True] * 5 + [False] * 11)


@pytest.mark.parametrize("kw", [SMALL, HASHED], ids=["dense+hashed", "hashed"])
def test_indices_and_weights_match_jax(monkeypatch, kw):
    res = _level_resolutions(kw["n_levels"], kw["base_resolution"],
                             1.4472692012786865)
    x = _points(203, list(res), seed=1)
    want_idx, want_w = _jax_indices(monkeypatch, x, **kw)
    T = 1 << kw["log2_hashmap_size"]
    dense = (res + 1) ** 3 <= T
    got_idx, got_w = hash_grid_indices(
        torch.as_tensor(x), torch.as_tensor(res), torch.as_tensor(dense), T)
    assert got_idx.dtype == torch.int32 and got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=1e-6)
    # every index stays inside its level's slice of the table
    levels = np.repeat(np.arange(kw["n_levels"]), 8)[None, :]
    assert np.all(got_idx.numpy() // T == levels)
    # at x == 1 the upper corner clips onto the lower one; its weight stays
    w1 = got_w[1].reshape(-1, 8)
    np.testing.assert_allclose(w1.sum(1).numpy(), 1.0, atol=1e-6)
    if kw is SMALL:
        assert dense.tolist() == [True, True, True, False]


@pytest.mark.parametrize("n_features", [2, 4, 1])
def test_encoder_output_matches_jax(n_features):
    jenc, params, tenc = _encoders(n_features, _randn, **SMALL)
    x = _points(203, [4, 5, 8, 12], seed=2)
    want = np.asarray(jenc.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tenc(torch.as_tensor(x)).numpy()
    assert got.shape == (203, 4 * n_features) == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_encoder_reads_the_table_rounded_to_bf16():
    # values whose low mantissa bits bf16 drops: 1 + k * 2^-12
    def table_fn(rng, size):
        return 1.0 + rng.randint(1, 4096, size) * 2.0 ** -12

    jenc, params, tenc = _encoders(2, table_fn, **SMALL)
    x = _points(203, [4, 5, 8, 12], seed=3)
    want = np.asarray(jenc.apply(params, jnp.asarray(x)))
    xt = torch.as_tensor(x)
    with torch.no_grad():
        got = tenc(xt).numpy()
        idx, w = hash_grid_indices(xt, tenc._res, tenc._dense, tenc.n_entries)
        f32_read = hash_encode_lookup(tenc.table, idx, w, tenc.n_entries,
                                      packed_gather=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert np.abs(f32_read - want).max() > 1e-4
    # the generic-F path reads f32: F = 1 over the same kind of table
    jenc1, params1, tenc1 = _encoders(1, table_fn, **SMALL)
    want1 = np.asarray(jenc1.apply(params1, jnp.asarray(x)))
    with torch.no_grad():
        got1 = tenc1(xt).numpy()
    np.testing.assert_allclose(got1, want1, rtol=0,
                               atol=1e-6 * np.abs(want1).max())
    t1 = tenc1.table.detach()
    assert not torch.equal(t1, t1.to(torch.bfloat16).float())


def test_hash_grad_scatter_plain_matches_jax_kernel():
    rng = np.random.RandomState(7)
    T, B = 512, 3000
    idx = rng.randint(0, T, B).astype(np.int32)
    idx[::17] = -1  # padding rows are skipped
    v = rng.randn(B, 2).astype(np.float32)
    want = np.asarray(jax_hash_gather.hash_grad_scatter(
        jnp.asarray(idx), jnp.asarray(v), T))
    got = hash_grad_scatter_plain(torch.as_tensor(idx), torch.as_tensor(v), T)
    assert got.shape == (T, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a CPU tensor takes the twin through the wrapper and launches nothing
    before = hash_grad_scatter.launches
    out = torch.ones((T, 2))
    same = hash_grad_scatter(torch.as_tensor(idx), torch.as_tensor(v), T,
                             out=out)
    assert same is out and hash_grad_scatter.launches == before
    np.testing.assert_allclose(out.numpy() - 1.0, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        hash_grad_scatter(torch.as_tensor(idx), torch.as_tensor(v[:, :1]), T)


def _levels_case(seed, n=203, n_features=2):
    """(flat_idx, corner_w, g, T, L) of the SMALL encoder at ``n`` points
    (no multiple of 8), as numpy."""
    L, T = SMALL["n_levels"], 1 << SMALL["log2_hashmap_size"]
    res = _level_resolutions(L, SMALL["base_resolution"],
                             1.4472692012786865)
    rng = np.random.RandomState(seed)
    x = _points(n, list(res), seed=seed)
    idx, w = hash_grid_indices(
        torch.as_tensor(x), torch.as_tensor(res),
        torch.as_tensor((res + 1) ** 3 <= T), T)
    g = rng.randn(n, n_features * L).astype(np.float32)
    return idx.numpy().copy(), w.numpy().copy(), g, T, L


@pytest.mark.parametrize("pallas_scatter", [True, False])
def test_multi_level_table_gradient_twin_matches_jax(pallas_scatter):
    # the JAX package's whole backward (Pallas scatter in interpret mode, or
    # XLA's per-level scatter-adds) against the port's multi-level twin
    idx, w, g, T, L = _levels_case(seed=21)
    rng = np.random.RandomState(22)
    dead = rng.rand(*idx.shape) < 0.1
    idx[dead] = -1
    if not pallas_scatter:
        # XLA's scatter wraps -1 round to the level's last entry: give the
        # dead corners no weight, so that both add nothing
        w[dead] = 0.0
    want, _, _ = jax_hash_gather._lookup_bwd(
        T, pallas_scatter, True,
        (jnp.asarray(idx), jnp.asarray(w), (2 * L * T,)), jnp.asarray(g))
    want = ngp_table_from_flax(np.asarray(want), L, 2)
    got = hash_grad_scatter_levels_plain(
        torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(g),
        torch.zeros((L, T, 2)))
    assert got.shape == (L, T, 2) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    # a CPU tensor takes the twin through the wrapper and launches nothing
    before = hash_grad_scatter_levels.launches
    out = torch.ones((L, T, 2))
    same = hash_grad_scatter_levels(
        torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(g), out)
    assert same is out and hash_grad_scatter_levels.launches == before
    np.testing.assert_allclose(out.numpy() - 1.0, want, rtol=0,
                               atol=1e-5 * scale)


def test_multi_level_twin_skips_indices_outside_their_level():
    idx, w, g, T, L = _levels_case(seed=23)
    base = hash_grad_scatter_levels_plain(
        torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(g),
        torch.zeros((L, T, 2)))
    # level 1's corners of some samples point into level 0, level 2 and
    # past the table: none of them may add anything
    moved = idx.copy()
    moved[::5, 8:16] -= T
    moved[1::5, 8:16] += T
    moved[2::5, 8:16] = L * T + 3
    keep = np.ones(idx.shape[0], bool)
    keep[::5] = keep[1::5] = keep[2::5] = False
    w_kept = w.copy()
    w_kept[~keep, 8:16] = 0.0
    want = hash_grad_scatter_levels_plain(
        torch.as_tensor(idx), torch.as_tensor(w_kept), torch.as_tensor(g),
        torch.zeros((L, T, 2)))
    got = hash_grad_scatter_levels_plain(
        torch.as_tensor(moved), torch.as_tensor(w), torch.as_tensor(g),
        torch.zeros((L, T, 2)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not np.array_equal(got.numpy(), base.numpy())
    for bad in (
        lambda: hash_grad_scatter_levels(
            torch.as_tensor(idx), torch.as_tensor(w),
            torch.as_tensor(g[:, :-1]), torch.zeros((L, T, 2))),
        lambda: hash_grad_scatter_levels(
            torch.as_tensor(idx[:, :-8]), torch.as_tensor(w),
            torch.as_tensor(g), torch.zeros((L, T, 2))),
        lambda: hash_grad_scatter_levels(
            torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(g),
            torch.zeros((L * T, 2))),
    ):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("n_features", [2, 4])
def test_lookup_backward_equals_the_per_level_loop(n_features):
    # the op's backward (pallas_scatter on where F = 2 allows it) against
    # the loop it replaced: one hash_grad_scatter or index_add_ per level
    idx, w, g, T, L = _levels_case(seed=24, n_features=n_features)
    F = n_features
    idx, w, g = (torch.as_tensor(a) for a in (idx, w, g))
    table = torch.zeros((L, T, F), requires_grad=True)
    hash_encode_lookup(table, idx, w, T, pallas_scatter=F == 2).backward(g)
    gl = g.reshape(-1, F, L).permute(0, 2, 1)
    want = torch.zeros((L, T, F))
    for level in range(L):
        sl = slice(level * 8, level * 8 + 8)
        idx_l = (idx[:, sl] - level * T).reshape(-1)
        v = (w[:, sl, None] * gl[:, level, None, :]).reshape(-1, F)
        if F == 2:
            hash_grad_scatter(idx_l, v, T, out=want[level])
        else:
            want[level].index_add_(0, idx_l.long(), v)
    # the same f32 terms in the same order
    np.testing.assert_array_equal(table.grad.numpy(), want.numpy())
    assert float(want.abs().max()) > 0.1


@pytest.mark.parametrize("pallas_grad", [False, True])
def test_table_gradient_matches_jax(pallas_grad):
    # 203 samples: no multiple of 8 or 64
    jenc, params, tenc = _encoders(2, _randn, pallas_grad=pallas_grad,
                                   **SMALL)
    rng = np.random.RandomState(8)
    x = rng.rand(203, 3).astype(np.float32)
    g = rng.randn(203, 8).astype(np.float32)
    want = jax.grad(
        lambda p: jnp.sum(jenc.apply(p, jnp.asarray(x)) * g))(params)
    want = np.asarray(want["params"]["table"])
    (tenc(torch.as_tensor(x)) * torch.as_tensor(g)).sum().backward()
    got = ngp_table_to_flax(tenc.table.grad.numpy())
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # the layout conversion is a bijection
    np.testing.assert_array_equal(
        ngp_table_from_flax(got, 4, 2), tenc.table.grad.numpy())


def test_f4_table_gradient_matches_jax():
    # F = 4 takes the index_add_ backward, as in the JAX package
    jenc, params, tenc = _encoders(4, _randn, **SMALL)
    rng = np.random.RandomState(9)
    x = rng.rand(203, 3).astype(np.float32)
    g = rng.randn(203, 16).astype(np.float32)
    want = jax.grad(
        lambda p: jnp.sum(jenc.apply(p, jnp.asarray(x)) * g))(params)
    (tenc(torch.as_tensor(x)) * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(
        ngp_table_to_flax(tenc.table.grad.numpy()),
        np.asarray(want["params"]["table"]), rtol=1e-4, atol=1e-6)


def test_encoder_options():
    # every option of the JAX encoder is ported: gather_mode "per_level"
    # constructs and computes; what neither package supports raises
    # the kernel adds feature pairs: F = 4 cannot take it
    with pytest.raises(ValueError, match="n_features == 2"):
        HashEncoder(n_features=4, pallas_grad=True, device="cpu", **SMALL)
    with pytest.raises(ValueError, match="gather_mode"):
        HashEncoder(gather_mode="per_row", device="cpu", **SMALL)
    x = torch.rand(5, 3)
    per_level = HashEncoder(gather_mode="per_level", device="cpu", **SMALL)
    out = per_level(x)
    assert per_level.gather_mode == "per_level"
    assert out.shape == (5, 8) and bool(torch.isfinite(out).all())
    enc = HashEncoder(n_features=4, device="cpu", **SMALL)
    idx, w = hash_grid_indices(x, enc._res, enc._dense, enc.n_entries)
    with pytest.raises(ValueError, match="n_features == 2"):
        hash_encode_lookup(enc.table, idx, w, enc.n_entries,
                           pallas_scatter=True)
    with pytest.raises(ValueError):
        hash_encode_lookup(enc.table, idx, w, enc.n_entries * 2)


@pytest.mark.parametrize("n_features,pallas_grad",
                         [(2, False), (2, True), (4, False)])
def test_per_level_gather_equals_packed(n_features, pallas_grad):
    # the twin of tests/test_models.py's per-level test, held tighter: the
    # per-level encoder reads the packed gather's bf16 values in its
    # layout, so the output and the table gradient are bit-equal
    x = torch.as_tensor(_points(64, [4, 5, 8, 12], seed=3))
    g = torch.as_tensor(
        np.random.RandomState(9).randn(64, 4 * n_features).astype(np.float32))
    out, grads = {}, {}
    for mode in ("packed", "per_level"):
        enc = HashEncoder(n_features=n_features, pallas_grad=pallas_grad,
                          gather_mode=mode, device="cpu",
                          generator=torch.Generator().manual_seed(1), **SMALL)
        out[mode] = enc(x)
        (out[mode] * g).sum().backward()
        grads[mode] = enc.table.grad
    assert torch.equal(out["per_level"], out["packed"])
    assert torch.equal(grads["per_level"], grads["packed"])
    assert float(grads["packed"].abs().max()) > 0


@pytest.mark.parametrize("pallas_grad", [False, True])
def test_per_level_encoder_matches_jax(pallas_grad):
    # the JAX package's gather_mode="per_level", forward and table
    # gradient, at the bounds of the packed encoder's tests above
    jenc, params, tenc = _encoders(2, _randn, pallas_grad=pallas_grad,
                                   gather_mode="per_level", **SMALL)
    x = _points(203, [4, 5, 8, 12], seed=2)
    g = np.random.RandomState(8).randn(203, 8).astype(np.float32)
    want = np.asarray(jenc.apply(params, jnp.asarray(x)))
    got = tenc(torch.as_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    want_g = jax.grad(
        lambda p: jnp.sum(jenc.apply(p, jnp.asarray(x)) * g))(params)
    want_g = np.asarray(want_g["params"]["table"])
    (got * torch.as_tensor(g)).sum().backward()
    assert np.abs(want_g).max() > 0.1
    np.testing.assert_allclose(ngp_table_to_flax(tenc.table.grad.numpy()),
                               want_g, rtol=1e-4, atol=1e-6)


def _ngp_pair(unbounded, seed=4, **kw):
    # 2^13 entries under the field's base resolution 16: level 0 dense
    # (17^3 = 4913), levels 1-3 hashed
    kw = dict(aabb=AABB, unbounded=unbounded, n_levels=4,
              log2_hashmap_size=13, **kw)
    jfield = JaxNGP(**kw)
    x0 = jnp.zeros((8, 3))
    params = jfield.init(jax.random.PRNGKey(seed), x0, x0)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(seed)
    # a table of order 1, so that the encoder moves the outputs
    params["params"]["encoder"]["table"] = rng.randn(
        params["params"]["encoder"]["table"].shape[0]).astype(np.float32)
    tfield = NGPRadianceField(device="cpu", **kw)
    ngp_from_flax(params, tfield)
    return jfield, params, tfield


@pytest.mark.parametrize("unbounded", [False, True])
def test_ngp_field_matches_jax(unbounded):
    jfield, params, tfield = _ngp_pair(unbounded)
    rng = np.random.RandomState(5)
    x = (rng.rand(300, 3) * 2.6 - 1.3).astype(np.float32)
    d = rng.randn(300, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rgb_j, sig_j = jfield.apply(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        rgb_t, sig_t = tfield(torch.as_tensor(x), torch.as_tensor(d))
        dens_t = tfield.query_density(torch.as_tensor(x))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(dens_t, sig_t) and sig_t.shape == (300, 1)
    outside = np.any(np.abs(x) >= 1.0, axis=-1)
    assert outside.sum() > 50
    if unbounded:
        assert bool((sig_t > 0).all())
    else:
        assert bool((sig_t[torch.as_tensor(outside)] == 0).all())
    assert float(rgb_t.std()) > 1e-2  # the encoder drives the colors


@pytest.mark.parametrize("unbounded", [False, True])
def test_ngp_query_opacity_matches_jax(unbounded):
    jfield, params, tfield = _ngp_pair(unbounded)
    rng = np.random.RandomState(6)
    x = (rng.rand(300, 3) * 2.6 - 1.3).astype(np.float32)
    step = 5e-3
    want = jfield.apply(params, jnp.asarray(x), step,
                        method=jfield.query_opacity)
    with torch.no_grad():
        got = tfield.query_opacity(torch.as_tensor(x), step)
        dens = tfield.query_density(torch.as_tensor(x))
    assert got.shape == (300, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * step)
    assert torch.equal(got, dens * step) and float(got.max()) > 0


def test_ngp_from_flax_refuses_a_mismatch():
    _, params, tfield = _ngp_pair(False)
    wrong = NGPRadianceField(aabb=AABB, n_levels=4, log2_hashmap_size=12,
                             device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ngp_from_flax(params, wrong)
    tree = {k: v for k, v in params["params"].items() if k != "mlp_head"}
    with pytest.raises(KeyError):
        ngp_from_flax({"params": tree}, tfield)
    with pytest.raises(ValueError, match="flat"):
        ngp_table_from_flax(np.zeros(10, np.float32), 4, 2)


def test_seed_gives_the_same_weights_on_every_device():
    a, b = (NGPRadianceField(aabb=AABB, n_levels=2, log2_hashmap_size=8,
                             generator=torch.Generator().manual_seed(3),
                             device="cpu") for _ in range(2))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    t = a.encoder.table
    assert t.shape == (2, 256, 2) and float(t.detach().abs().max()) <= 1e-4


def _level_args(kw):
    """(res, dense, T) of an encoder configuration, as CPU tensors."""
    res = _level_resolutions(kw["n_levels"], kw["base_resolution"],
                             1.4472692012786865)
    T = 1 << kw["log2_hashmap_size"]
    return torch.as_tensor(res), torch.as_tensor((res + 1) ** 3 <= T), T


@pytest.mark.parametrize("n_features,pallas_scatter,packed_gather", [
    (1, False, False), (2, False, True), (2, True, True), (4, False, True),
    (8, False, False),
])
def test_fused_op_on_the_cpu_is_the_twin(n_features, pallas_scatter,
                                         packed_gather):
    # on CPU tensors hash_encode is hash_grid_indices + hash_encode_lookup:
    # the same forward and the same table gradient, bit for bit; the dense
    # and the hashed levels, points at 0, 1 and outside [0, 1]
    res, dense, T = _level_args(SMALL)
    L, F = res.shape[0], n_features
    x = _points(203, [4, 5, 8, 12], seed=11)
    x[-8:] = np.random.RandomState(12).uniform(-0.5, 1.5, (8, 3))
    x = torch.as_tensor(x)
    g = torch.as_tensor(
        np.random.RandomState(13).randn(203, F * L).astype(np.float32))
    rng = np.random.RandomState(14)
    start = torch.as_tensor(rng.randn(L, T, F).astype(np.float32))
    outs, grads = [], []
    for fn in ("op", "twin"):
        table = start.clone().requires_grad_()
        if fn == "op":
            out = hash_encode(x, table, res, dense, T, pallas_scatter,
                              packed_gather)
        else:
            idx, w = hash_grid_indices(x, res, dense, T)
            out = hash_encode_lookup(table, idx, w, T, pallas_scatter,
                                     packed_gather)
        (out * g).sum().backward()
        outs.append(out.detach())
        grads.append(table.grad)
    assert outs[0].shape == (203, F * L)
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
    assert float(grads[0].abs().max()) > 0.1
    assert torch.equal(
        hash_encode_plain(x, start, res, dense, T, pallas_scatter,
                          packed_gather), outs[1])


def test_fused_op_refuses_what_it_does_not_take():
    res, dense, T = _level_args(SMALL)
    L = res.shape[0]
    table = torch.zeros((L, T, 2))
    x = torch.rand(16, 3)
    for bad in (
        lambda: hash_encode(x.double(), table, res, dense, T),  # not f32
        lambda: hash_encode(x[:, :2], table, res, dense, T),  # not (N, 3)
        lambda: hash_encode(x.reshape(-1), table, res, dense, T),
        lambda: hash_encode(x, torch.zeros((L, 1000, 2)), res, dense,
                            1000),  # T not a power of two
        lambda: hash_encode(x, table, res, dense, T // 2),  # T != n_entries
        lambda: hash_encode(x, table[:L - 1], res, dense, T),  # L vs res
        lambda: hash_encode(x, table, res[:L - 1], dense[:L - 1], T),
        lambda: hash_encode(x, table, res, dense[:L - 1], T),
        lambda: hash_encode(x, table.reshape(L * T, 2), res, dense, T),
        lambda: hash_encode(x, torch.zeros((L, T, 4)), res, dense, T,
                            pallas_scatter=True),  # K7 adds pairs
    ):
        with pytest.raises(ValueError):
            bad()


def test_table_gather_twin_on_cpu():
    rng = np.random.RandomState(6)
    table = torch.as_tensor(rng.randint(0, 2 ** 31, 4096).astype(np.int32))
    idx = torch.as_tensor(rng.randint(0, 4096, 1000).astype(np.int32))
    before = table_gather.launches
    got = table_gather(idx, table)
    assert table_gather.launches == before
    assert got.dtype == torch.int32
    assert torch.equal(got, table_gather_plain(idx, table))
    np.testing.assert_array_equal(got.numpy(), table.numpy()[idx.numpy()])
