"""D-NeRF synthetic dataset loader (time-conditioned scenes), the port's
twin of :mod:`nerfacc_tpu.datasets.dnerf_synthetic`: the blender format
plus a per-frame ``time`` in [0, 1], which conditions the deformation
field. ``sample_batch`` always assembles on the host with numpy, as the
JAX loader does, and returns ``(rays, pixels, t)`` with ``t`` (n, 1) each
ray's frame time.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .nerf_synthetic import SubjectLoader as _Base
from .nerf_synthetic import _read_split
from .rays import generate_rays


class SubjectLoader(_Base):
    """The blender loader plus per-frame ``timestamps``."""

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str = "train",
        color_bkgd_aug: str = "white",
        factor: int = 1,
        seed: int = 0,
        device=None,
    ):
        images, poses, times, K = _read_split(Path(root_fp), subject_id,
                                              split, factor)
        self._setup(images, poses, K, split, color_bkgd_aug, seed, device)
        self._times_np = times
        self.timestamps = torch.as_tensor(times, device=self.device)

    def sample_batch(self, num_rays: int):
        """Random pixels across all images -> (rays, pixels, t)."""
        img_idx, ys, xs = self._draw_pixels(num_rays)
        rgba = self._images_np[img_idx, ys, xs]
        host_bkgd, self.bkgd = self._bkgd()
        pixels = rgba[:, :3] * rgba[:, 3:] + host_bkgd * (1 - rgba[:, 3:])
        t = self._times_np[img_idx][:, None]
        img_idx, ys, xs, pixels, t = self._device(img_idx, ys, xs, pixels, t)
        rays = generate_rays(xs, ys, self.train_poses[img_idx], self.K)
        return rays, pixels, t
