"""The port's packed <-> dense conversions (``nerfacc_tpu_torch/pack.py``)
against the JAX package's, on the same numpy-seeded inputs.

Integer outputs (``packed_info``, ray indices, masks, validity) are
bit-equal, on contiguous, gapped and empty-ray layouts and past the
capacity. Packed data are copies: bit-equal. The gradient of
``unpack_data`` is a gather-back of the cotangent: bit-equal too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu as jx
from nerfacc_tpu_torch import (
    pack_data,
    pack_info,
    unpack_data,
    unpack_info,
    unpack_info_to_mask,
)

torch.set_num_threads(1)


def _eq(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _ray_indices(seed, n_rays=17, n=200):
    rng = np.random.RandomState(seed)
    ri = np.sort(rng.randint(0, n_rays, size=n))
    ri[(ri == 0) | (ri == 4) | (ri == n_rays - 1)] = 5  # empty rays
    return np.sort(ri).astype(np.int32)


def test_pack_info_unpack_info_roundtrip():
    # the reference's golden (tests/test_pack.py)
    ri = torch.tensor([0, 0, 0, 2, 2, 4], dtype=torch.int32)
    info = pack_info(ri, n_rays=5)
    assert info.dtype == torch.int32
    _eq(info, [[0, 3], [3, 0], [3, 2], [5, 0], [5, 1]])
    _eq(unpack_info(info, n_samples=6), ri.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_pack_info_matches_jax(seed, masked):
    ri = _ray_indices(seed)
    m = np.random.RandomState(seed).rand(ri.shape[0]) < 0.6 if masked else None
    got = pack_info(torch.as_tensor(ri), 17,
                    masks=None if m is None else torch.as_tensor(m))
    want = jx.pack_info(jnp.asarray(ri), 17,
                        masks=None if m is None else jnp.asarray(m))
    _eq(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tail", [0, 9])
def test_unpack_info_matches_jax(seed, tail):
    # gapped and empty rays (the last one among them), and a padding tail
    # past the last live ray's samples, which takes that ray's index
    ri = _ray_indices(seed)
    info = jx.pack_info(jnp.asarray(ri), 17)
    n = ri.shape[0] + tail
    got = unpack_info(torch.as_tensor(np.array(info)), n)
    assert got.dtype == torch.int32
    _eq(got, jx.unpack_info(info, n))
    _eq(got[:ri.shape[0]], ri)
    assert (got[ri.shape[0]:] == int(ri[-1])).all()


def test_unpack_info_tail_takes_the_last_ray():
    # a live last ray: the padding tail gets index n_rays - 1
    info = torch.tensor([[0, 2], [2, 0], [2, 3]], dtype=torch.int32)
    _eq(unpack_info(info, 8), [0, 0, 2, 2, 2, 2, 2, 2])


def test_unpack_info_gapped_and_shared_starts():
    # a gapped layout (rays start past their predecessor's end), empty
    # rays sharing a start with a live one (the largest id wins), and a
    # start beyond the buffer
    info = np.array([[0, 2], [2, 0], [2, 0], [2, 3], [7, 1], [8, 0],
                     [8, 2], [12, 0], [30, 4]], np.int32)
    got = unpack_info(torch.as_tensor(info), 12)
    want = jx.unpack_info(jnp.asarray(info), 12)
    _eq(got, want)
    _eq(got, [0, 0, 3, 3, 3, 3, 3, 4, 6, 6, 6, 6])


def test_unpack_info_to_mask_matches_jax():
    info = np.array([[0, 2], [2, 0], [2, 3], [5, 4]], np.int32)
    got = unpack_info_to_mask(torch.as_tensor(info), 4)
    _eq(got, jx.unpack_info_to_mask(jnp.asarray(info), 4))
    _eq(got, [[1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 1, 0], [1, 1, 1, 1]])


@pytest.mark.parametrize("capacity", [None, 9, 20, 40])
def test_pack_data_matches_jax(capacity):
    # capacity 9 and 20 cut the live tail as jnp.nonzero(size=) does; 40
    # pads with zero rows
    rng = np.random.RandomState(0)
    data = rng.rand(10, 3, 4).astype(np.float32)
    mask = rng.rand(10, 3) > 0.5
    mask[2] = False  # an empty ray
    got = pack_data(torch.as_tensor(data), torch.as_tensor(mask), capacity)
    want = jx.pack_data(jnp.asarray(data), jnp.asarray(mask), capacity)
    for g, w in zip(got, want):
        _eq(g, w)
    n_live = int(mask.sum())
    cap = capacity or data.shape[0] * 3
    assert int(got[2].sum()) == min(n_live, cap)
    assert (got[0][~got[2]] == 0).all()
    _eq(got[1][:, 1], mask.sum(-1).astype(np.int32))  # the dropped count


def test_pack_data_roundtrip():
    rng = np.random.RandomState(0)
    data = torch.as_tensor(rng.rand(10, 3, 4).astype(np.float32))
    mask = torch.as_tensor(rng.rand(10, 3) > 0.5)
    packed, info, valid = pack_data(data, mask)
    dense = unpack_data(info, packed, n_samples=3)
    for r in range(10):
        kept = data[r][mask[r]]
        _eq(dense[r, :len(kept)], kept.numpy())
        assert (dense[r, len(kept):] == 0).all()
    assert int(valid.sum()) == int(mask.sum())


@pytest.mark.parametrize("n_samples", [2, 3, 5])
def test_unpack_data_and_its_gradient_match_jax(n_samples):
    info = np.array([[0, 2], [2, 0], [2, 3], [5, 1]], np.int32)
    rng = np.random.RandomState(n_samples)
    data = rng.rand(7, 2).astype(np.float32)
    cot = rng.rand(4, n_samples, 2).astype(np.float32)
    d = torch.as_tensor(data).requires_grad_()
    got = unpack_data(torch.as_tensor(info), d, n_samples)
    (got * torch.as_tensor(cot)).sum().backward()
    want, vjp = jax.vjp(
        lambda x: jx.unpack_data(jnp.asarray(info), x, n_samples),
        jnp.asarray(data))
    _eq(got, want)
    _eq(d.grad, vjp(jnp.asarray(cot))[0])


def test_unpack_data_gradient_is_the_mask():
    # the reference's check: d(sum unpack(data)) / d data = 1 on live rows
    info = torch.tensor([[0, 2], [2, 1]], dtype=torch.int32)
    data = torch.tensor([[1.0], [2.0], [3.0]], requires_grad=True)
    unpack_data(info, data, n_samples=3).sum().backward()
    _eq(data.grad, np.ones((3, 1), np.float32))


def test_pack_data_gradient_matches_jax():
    rng = np.random.RandomState(4)
    data = rng.rand(6, 4, 3).astype(np.float32)
    mask = rng.rand(6, 4) > 0.4
    cot = rng.rand(12, 3).astype(np.float32)
    d = torch.as_tensor(data).requires_grad_()
    packed, _, _ = pack_data(d, torch.as_tensor(mask), 12)
    (packed * torch.as_tensor(cot)).sum().backward()
    _, vjp = jax.vjp(lambda x: jx.pack_data(x, jnp.asarray(mask), 12)[0],
                     jnp.asarray(data))
    _eq(d.grad, vjp(jnp.asarray(cot))[0])
