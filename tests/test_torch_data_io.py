"""The port's native ray-batch assembler (``nerfacc_tpu_torch/data_io.py``
over ``nerfacc_tpu_torch/csrc/raygen.cpp``): twins of
``tests/test_data_io.py``, then the port's library against the JAX
package's.

Tolerances: the native rays against the port's ``generate_rays``: origins
rtol 1e-5 / atol 1e-6 and directions rtol 1e-4 / atol 1e-5, the JAX
test's bounds (the C code and PyTorch order the f32 products apart, and
``-march=native`` may fuse them). Against the JAX package's library: bit
for bit, since both build the same code with the same flags on the same
machine.
"""

import numpy as np
import pytest
import torch

from nerfacc_tpu import data_io as jax_data_io
from nerfacc_tpu_torch import data_io
from nerfacc_tpu_torch.datasets.rays import generate_rays, look_at_poses

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def native():
    """The port's library; the tests skip where g++ cannot build it."""
    if data_io.lib() is None:
        pytest.skip("no g++ to build the native assembler")
    return data_io


def _batch_inputs(c=4, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.rand(3, 8, 10, c).astype(np.float32)
    poses = look_at_poses(3, radius=2.0, device=CPU).numpy()
    intrin = np.array([10.0, 11.0, 5.0, 4.0], np.float32)
    bkgd = np.array([0.2, 0.5, 1.0], np.float32)
    return images, poses, intrin, bkgd


def test_rays_for_pose_matches_generate_rays(native):
    h, w = 12, 16
    poses = look_at_poses(3, radius=2.0, device=CPU)
    K = np.array([20.0, 20.0, w / 2, h / 2], np.float32)
    o_n, d_n = native.rays_for_pose(h, w, poses[1].numpy(), K, opengl=True)

    y, x = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    Km = torch.tensor([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]])
    rays = generate_rays(x.reshape(-1), y.reshape(-1), poses[1], Km)
    np.testing.assert_allclose(o_n, rays.origins.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(d_n, rays.viewdirs.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_sample_ray_batch_composites_and_normalizes(native):
    rng = np.random.RandomState(0)
    images = rng.rand(2, 8, 8, 4).astype(np.float32)
    poses = look_at_poses(2, radius=2.0, device=CPU).numpy()
    K = np.array([10.0, 10.0, 4.0, 4.0], np.float32)
    bkgd = np.array([1.0, 1.0, 1.0], np.float32)
    o, d, px = native.sample_ray_batch(images, poses, K, bkgd, seed=7,
                                       num_rays=64)
    assert o.shape == (64, 3) and d.shape == (64, 3) and px.shape == (64, 3)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-5)
    # pixels are convex combinations of image rgb and bkgd: in [0, 1]
    assert (px >= 0).all() and (px <= 1.0 + 1e-6).all()
    # deterministic per seed
    _, _, px2 = native.sample_ray_batch(images, poses, K, bkgd, seed=7,
                                        num_rays=64)
    np.testing.assert_array_equal(px, px2)
    o3, _, _ = native.sample_ray_batch(images, poses, K, bkgd, seed=8,
                                       num_rays=64)
    assert not np.array_equal(o, o3)


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("opengl", [True, False])
def test_library_is_bit_equal_to_the_jax_library(native, c, opengl):
    if jax_data_io.lib() is None:
        pytest.skip("the JAX package's native assembler did not build")
    images, poses, intrin, bkgd = _batch_inputs(c)
    got = native.sample_ray_batch(images, poses, intrin, bkgd, seed=123,
                                  num_rays=777, opengl=opengl)
    want = jax_data_io.sample_ray_batch(images, poses, intrin, bkgd,
                                        seed=123, num_rays=777,
                                        opengl=opengl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = native.rays_for_pose(8, 10, poses[2], intrin, opengl=opengl)
    want = jax_data_io.rays_for_pose(8, 10, poses[2], intrin, opengl=opengl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_into_the_callers_buffers(native):
    images, poses, intrin, bkgd = _batch_inputs()
    want = native.sample_ray_batch(images, poses, intrin, bkgd, seed=5,
                                   num_rays=100)
    # numpy views of one tensor, as the loaders pass page-locked ones
    buf = torch.full((3, 100, 3), float("nan"))
    out = tuple(buf.numpy())
    got = native.sample_ray_batch(images, poses, intrin, bkgd, seed=5,
                                  num_rays=100, out=out)
    assert all(g is o for g, o in zip(got, out))
    for i in range(3):
        np.testing.assert_array_equal(buf[i].numpy(), want[i])
    with pytest.raises(ValueError, match="out origins"):
        native.sample_ray_batch(images, poses, intrin, bkgd, seed=5,
                                num_rays=99, out=out)
    with pytest.raises(ValueError, match="poses must have shape"):
        native.sample_ray_batch(images, poses[:2], intrin, bkgd, seed=5,
                                num_rays=100)


def test_library_is_named_by_its_source(native):
    path = native.library_path()
    assert path.exists() and path.parent.name == "nerfacc_tpu_torch"
    assert path.parent.parent.name == "build"
