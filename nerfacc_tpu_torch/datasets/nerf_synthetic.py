"""NeRF-Synthetic (blender) dataset loader, the port's twin of
:mod:`nerfacc_tpu.datasets.nerf_synthetic`.

Blender convention: ``transforms_{split}.json`` with ``camera_angle_x``
and per-frame ``transform_matrix`` (OpenGL camera-to-world); RGBA PNGs
(read by :mod:`.image_io`); NEAR/FAR = 2.0/6.0; white, black or random
background augmentation in training; random-pixel ray batches across all
images. The images and poses stay in host memory for the batch assembly
and are on ``device`` (None: the CUDA device) for the trainers, with the
attributes of :class:`~.procedural.ProceduralScene` (``images``,
``test_images``, ``train_poses``, ``test_poses``, ``K``, ``aabb``,
``bkgd``, ``height``, ``width``, ``_rng``), so that the trainers take
either.

``sample_batch`` draws from ``numpy.random.RandomState(seed)`` in the JAX
loader's order, so that one seed gives both packages the same batch:
where the native assembler (:mod:`nerfacc_tpu_torch.data_io`) builds, the
background first and then the assembler's seed; otherwise images, rows
and columns, then the background. A native batch is written into a
page-locked buffer and reaches the card in one asynchronous copy;
PyTorch's caching host allocator hands that buffer out again only once
the copy has finished.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .. import data_io
from .image_io import imread
from .rays import Rays, generate_rays

NEAR, FAR = 2.0, 6.0
AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def _read_split(root: Path, subject_id: str, split: str, factor: int = 1):
    """A split's RGBA images in [0, 1] (n, h, w, 4) float32, its (n, 3, 4)
    camera-to-world poses, per-frame times (0 where a frame has none) and
    the intrinsics, all numpy."""
    meta = json.loads(
        (root / subject_id / f"transforms_{split}.json").read_text())
    images, poses, times = [], [], []
    for frame in meta["frames"]:
        rgba = imread(root / subject_id / (frame["file_path"] + ".png"))
        if factor > 1:
            rgba = rgba[::factor, ::factor]
        images.append(rgba)
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
        times.append(float(frame.get("time", 0.0)))
    images = np.stack(images).astype(np.float32) / 255.0
    poses = np.stack(poses)[:, :3, :4]
    h, w = images.shape[1:3]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.asarray(
        [[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]], np.float32
    )
    return images, poses, np.asarray(times, np.float32), K


def _load_split(root: Path, subject_id: str, split: str, factor: int = 1):
    """A split's images, poses and intrinsics (numpy)."""
    images, poses, _, K = _read_split(root, subject_id, split, factor)
    return images, poses, K


class SubjectLoader:
    """Random-pixel ray batches over a blender subject."""

    SPLITS = ["train", "val", "trainval", "test"]

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str = "train",
        color_bkgd_aug: str = "white",  # white | black | random
        factor: int = 1,
        seed: int = 0,
        device=None,
    ):
        if split not in self.SPLITS:
            raise ValueError(f"split {split!r}: one of {self.SPLITS}")
        root = Path(root_fp)
        if split == "trainval":
            i1, p1, K = _load_split(root, subject_id, "train", factor)
            i2, p2, _ = _load_split(root, subject_id, "val", factor)
            images = np.concatenate([i1, i2])
            poses = np.concatenate([p1, p2])
        else:
            images, poses, K = _load_split(root, subject_id, split, factor)
        self._setup(images, poses, K, split, color_bkgd_aug, seed, device)

    def _setup(self, images, poses, K, split, color_bkgd_aug, seed,
               device) -> None:
        """The attributes from a split's numpy images, poses and
        intrinsics."""
        dev = self.device = (torch.device("cuda") if device is None
                             else torch.device(device))
        # host-side copies for the batch assembly
        self._images_np = np.ascontiguousarray(images, np.float32)
        self._poses_np = np.ascontiguousarray(poses, np.float32)
        self._intrin_np = np.asarray(
            [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
        self.images = torch.as_tensor(self._images_np, device=dev)
        self.train_poses = torch.as_tensor(self._poses_np, device=dev)
        self.test_poses = self.train_poses
        self.K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        # composited on white, as the evaluation renders them
        rgb, a = images[..., :3], images[..., 3:]
        self.test_images = torch.as_tensor(rgb * a + (1 - a), device=dev)
        self.height, self.width = images.shape[1:3]
        self.color_bkgd_aug = color_bkgd_aug
        self.training = split in ("train", "trainval")
        self.aabb = torch.tensor(AABB, dtype=torch.float32, device=dev)
        self.near, self.far = NEAR, FAR
        self._rng = np.random.RandomState(seed)
        self._white = torch.ones(3, dtype=torch.float32, device=dev)
        self._black = torch.zeros(3, dtype=torch.float32, device=dev)
        self.bkgd = self._white

    def _bkgd(self):
        """This step's background: (host float32 (3,), tensor on the
        device); a random one is drawn from ``_rng``."""
        if not self.training or self.color_bkgd_aug == "white":
            return np.ones(3, np.float32), self._white
        if self.color_bkgd_aug == "black":
            return np.zeros(3, np.float32), self._black
        host = self._rng.rand(3).astype(np.float32)
        return host, torch.as_tensor(host, device=self.device)

    def rays_for_view(self, pose: torch.Tensor) -> Rays:
        """The rays through every pixel of one view, row-major."""
        y, x = torch.meshgrid(
            torch.arange(self.height, device=self.device),
            torch.arange(self.width, device=self.device), indexing="ij")
        return generate_rays(x.reshape(-1), y.reshape(-1), pose, self.K)

    def _draw_pixels(self, num_rays: int):
        """Random (image, row, column) indices, the JAX loader's draws."""
        n, h, w = self._images_np.shape[:3]
        img_idx = self._rng.randint(0, n, (num_rays,))
        ys = self._rng.randint(0, h, (num_rays,))
        xs = self._rng.randint(0, w, (num_rays,))
        return img_idx, ys, xs

    def _device(self, *arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def sample_batch(self, num_rays: int):
        """Random pixels across all images -> (rays, rgb pixels composited
        on this step's augmentation background), on the device."""
        if data_io.lib() is not None:
            host_bkgd, self.bkgd = self._bkgd()
            # origins, dirs and pixels: page-locked when bound for the card
            buf = torch.empty((3, num_rays, 3), dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            data_io.sample_ray_batch(
                self._images_np, self._poses_np, self._intrin_np, host_bkgd,
                seed=int(self._rng.randint(0, 2**31)), num_rays=num_rays,
                opengl=True, out=tuple(buf.numpy()))
            batch = buf.to(self.device, non_blocking=True)
            return Rays(batch[0], batch[1]), batch[2]
        img_idx, ys, xs = self._draw_pixels(num_rays)
        rgba = self._images_np[img_idx, ys, xs]
        host_bkgd, self.bkgd = self._bkgd()
        pixels = rgba[:, :3] * rgba[:, 3:] + host_bkgd * (1 - rgba[:, 3:])
        img_idx, ys, xs, pixels = self._device(img_idx, ys, xs, pixels)
        rays = generate_rays(xs, ys, self.train_poses[img_idx], self.K)
        return rays, pixels
