"""MipNeRF-360 dataset loader (COLMAP scenes, unbounded), the port's twin
of :mod:`nerfacc_tpu.datasets.nerf_360_v2`.

Pinhole cameras from ``sparse/0`` (:mod:`.colmap`), ``K[:2] /= factor``;
the images of ``images_{factor}/`` (``images/`` at factor 1) paired with
the COLMAP names through the sorted file names of ``images/``; every pose
recentred and rescaled into the unit box before the split (every 8th
image to test), so that train and test share one world frame; OpenCV
rays (+z forward, +y down) through pixel centres; no background (zeros).
``sample_batch`` assembles on the host with numpy from
``numpy.random.RandomState(seed)``, as the JAX loader does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .colmap import SceneManager
from .image_io import imread
from .rays import Rays

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)  # roi for the contraction


def _load_colmap(root_fp: str, subject_id: str, split: str, factor: int = 1):
    """A split's RGB(A) images in [0, 1], normalised (n, 3, 4) poses and the
    scaled intrinsics, all numpy."""
    if factor not in (1, 2, 4, 8):
        raise ValueError(f"factor {factor}: one of 1, 2, 4, 8")
    data_dir = Path(root_fp) / subject_id
    manager = SceneManager(str(data_dir / "sparse" / "0"))
    manager.load_cameras()
    manager.load_images()

    cam = next(iter(manager.cameras.values()))
    if cam.model not in ("SIMPLE_PINHOLE", "PINHOLE"):
        raise ValueError(f"camera model {cam.model}: only the pinhole "
                         "models are supported")
    K = cam.K
    K[:2, :] /= factor

    names, c2ws = [], []
    for im in manager.images.values():
        w2c = np.concatenate(
            [np.concatenate([im.R(), im.tvec.reshape(3, 1)], axis=1),
             [[0, 0, 0, 1]]], axis=0)
        c2ws.append(np.linalg.inv(w2c))
        names.append(im.name)
    order = np.argsort(names)
    c2ws = np.stack(c2ws)[order]
    names = [names[i] for i in order]

    suffix = f"_{factor}" if factor > 1 else ""
    colmap_dir = data_dir / "images"
    image_dir = data_dir / ("images" + suffix)
    colmap_files = sorted(p.name for p in colmap_dir.iterdir())
    image_files = sorted(p.name for p in image_dir.iterdir())
    mapping = dict(zip(colmap_files, image_files))
    images = np.stack(
        [imread(image_dir / mapping[n]) for n in names]
    ).astype(np.float32) / 255.0

    # normalise over all poses before the split: train and test must share
    # one world frame
    c2ws = _normalize_poses(c2ws[:, :3, :4].astype(np.float32))
    idx = np.arange(len(images))
    sel = idx[idx % 8 == 0] if split == "test" else idx[idx % 8 != 0]
    return images[sel], c2ws[sel], K


def _normalize_poses(c2ws: np.ndarray):
    """Recentre and rescale so that the cameras fit in the unit box."""
    center = c2ws[:, :, 3].mean(axis=0)
    scale = 1.0 / max(np.abs(c2ws[:, :, 3] - center).max(), 1e-6)
    out = c2ws.copy()
    out[:, :, 3] = (c2ws[:, :, 3] - center) * scale
    return out


class SubjectLoader:
    """Random-pixel ray batches over a 360 scene, on ``device`` (None: the
    CUDA device)."""

    SPLITS = ["train", "test"]
    SUBJECT_IDS = [
        "garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump",
    ]
    OPENGL_CAMERA = False  # COLMAP/OpenCV: +z forward, y down

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str = "train",
        color_bkgd_aug: str = "random",
        factor: int = 4,
        seed: int = 0,
        device=None,
    ):
        images, c2ws, K = _load_colmap(root_fp, subject_id, split, factor)
        dev = self.device = (torch.device("cuda") if device is None
                             else torch.device(device))
        # host-side copies for the batch assembly
        self._images_np = np.ascontiguousarray(images[..., :3], np.float32)
        self._poses_np = np.ascontiguousarray(c2ws, np.float32)
        self.images = torch.as_tensor(self._images_np, device=dev)
        self.train_poses = torch.as_tensor(self._poses_np, device=dev)
        self.test_poses = self.train_poses
        self.test_images = self.images
        self.K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        self.height, self.width = images.shape[1:3]
        self.training = split == "train"
        self.color_bkgd_aug = color_bkgd_aug
        self.aabb = torch.tensor(AABB, dtype=torch.float32, device=dev)
        self._rng = np.random.RandomState(seed)
        self.bkgd = torch.zeros(3, dtype=torch.float32, device=dev)

    def _rays(self, x, y, poses) -> Rays:
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        x = x.to(torch.float32)
        y = y.to(torch.float32)
        dirs = torch.stack(
            [(x + 0.5 - cx) / fx, (y + 0.5 - cy) / fy, torch.ones_like(x)],
            dim=-1)
        d = torch.einsum("...ij,...j->...i", poses[..., :3, :3], dirs)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = torch.broadcast_to(poses[..., :3, 3], d.shape)
        return Rays(origins=o, viewdirs=d)

    def rays_for_view(self, pose: torch.Tensor) -> Rays:
        """The rays through every pixel of one view, row-major."""
        y, x = torch.meshgrid(
            torch.arange(self.height, device=self.device),
            torch.arange(self.width, device=self.device), indexing="ij")
        return self._rays(x.reshape(-1), y.reshape(-1), pose)

    def sample_batch(self, num_rays: int):
        """Random pixels across all images -> (rays, pixels)."""
        n, h, w = self._images_np.shape[:3]
        img_idx = self._rng.randint(0, n, (num_rays,))
        ys = self._rng.randint(0, h, (num_rays,))
        xs = self._rng.randint(0, w, (num_rays,))
        pixels = self._images_np[img_idx, ys, xs]
        img_idx, ys, xs, pixels = (torch.as_tensor(a, device=self.device)
                                   for a in (img_idx, ys, xs, pixels))
        return self._rays(xs, ys, self.train_poses[img_idx]), pixels
