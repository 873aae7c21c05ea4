"""The port's COLMAP reader (``nerfacc_tpu_torch/datasets/colmap.py``):
twins of ``tests/test_colmap.py`` on synthetic ``cameras.bin`` /
``images.bin`` (https://colmap.github.io/format.html) and the ``.txt``
fallback, then the port's reader against the JAX package's on the same
files. Both parse the same bytes with the same numpy code: cameras,
quaternions, translations and rotations equal bit for bit.
"""

import numpy as np
import pytest

from nerfacc_tpu.datasets.colmap import SceneManager as JaxSceneManager
from nerfacc_tpu_torch.datasets.colmap import SceneManager
from nerfacc_tpu_torch.datasets.fixtures import (
    write_cameras_bin,
    write_images_bin,
)

Q45 = np.array([0.9238795, 0.0, 0.3826834, 0.0])  # 45 deg about y


def _write_bin(d):
    write_cameras_bin(
        d / "cameras.bin",
        [(1, 1, 640, 480, [500.0, 510.0, 320.0, 240.0]),  # PINHOLE
         (2, 0, 320, 240, [300.0, 160.0, 120.0])],  # SIMPLE_PINHOLE
    )
    write_images_bin(
        d / "images.bin",
        [(7, Q45, np.array([0.5, -1.0, 2.0]), 1, "frame_0001.png", 3),
         (9, np.array([0.5, 0.5, -0.5, 0.5]), np.array([1.0, 2.0, 3.0]), 2,
          "frame_0002.png", 0)],
    )


def _write_txt(d):
    (d / "cameras.txt").write_text(
        "# comment\n1 SIMPLE_PINHOLE 320 240 300.0 160.0 120.0\n"
    )
    (d / "images.txt").write_text(
        "# comment\n"
        "2 1 0 0 0 0.1 0.2 0.3 1 img.png\n"
        "1.0 2.0 -1\n"
    )


def _load(cls, d):
    mgr = cls(str(d))
    mgr.load_cameras()
    mgr.load_images()
    return mgr


def test_colmap_bin_roundtrip(tmp_path):
    _write_bin(tmp_path)
    mgr = _load(SceneManager, tmp_path)
    cam = mgr.cameras[1]
    assert cam.model == "PINHOLE" and (cam.width, cam.height) == (640, 480)
    K = cam.K
    assert K[0, 0] == 500.0 and K[1, 1] == 510.0 and K[0, 2] == 320.0

    img = mgr.images[7]
    assert img.name == "frame_0001.png" and img.camera_id == 1
    np.testing.assert_allclose(img.tvec, [0.5, -1.0, 2.0])
    R = img.R()
    # a proper rotation reproducing the quaternion
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-7)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-7)
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    want = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    np.testing.assert_allclose(R, want, atol=1e-6)


def test_colmap_txt_fallback(tmp_path):
    _write_txt(tmp_path)
    mgr = _load(SceneManager, tmp_path)
    cam = mgr.cameras[1]
    assert cam.K[0, 0] == 300.0 and cam.K[1, 1] == 300.0  # SIMPLE_PINHOLE
    img = mgr.images[2]
    np.testing.assert_allclose(img.qvec, [1, 0, 0, 0])
    np.testing.assert_allclose(img.R(), np.eye(3), atol=1e-12)


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_reader_agrees_with_jax(tmp_path, fmt):
    (_write_bin if fmt == "bin" else _write_txt)(tmp_path)
    port, jax_mgr = _load(SceneManager, tmp_path), _load(JaxSceneManager,
                                                          tmp_path)
    assert port.cameras.keys() == jax_mgr.cameras.keys()
    for k, cam in port.cameras.items():
        want = jax_mgr.cameras[k]
        assert (cam.model, cam.width, cam.height) == (want.model, want.width,
                                                      want.height)
        np.testing.assert_array_equal(cam.params, want.params)
        np.testing.assert_array_equal(cam.K, want.K)
    assert port.images.keys() == jax_mgr.images.keys()
    for k, img in port.images.items():
        want = jax_mgr.images[k]
        assert (img.name, img.camera_id) == (want.name, want.camera_id)
        for got, exp in ((img.qvec, want.qvec), (img.tvec, want.tvec),
                         (img.R(), want.R())):
            np.testing.assert_array_equal(got, exp)
