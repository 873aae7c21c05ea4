"""Minimal pure-python COLMAP sparse-reconstruction reader (the port's
copy of :mod:`nerfacc_tpu.datasets.colmap`, numpy only).

A self-contained parser for ``cameras.bin`` / ``images.bin`` (and their
``.txt`` fallbacks) in place of the reference's ``pycolmap`` submodule.
Only what the 360 loader needs: intrinsics and world-to-camera poses.

Binary format: https://colmap.github.io/format.html
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np

# COLMAP camera model ids -> (name, n_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),  # f, cx, cy
    1: ("PINHOLE", 4),  # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        if self.model == "SIMPLE_PINHOLE":
            f, cx, cy = self.params[:3]
            fx = fy = f
        else:
            fx, fy, cx, cy = self.params[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class Image:
    image_id: int
    qvec: np.ndarray  # (4,) w, x, y, z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str

    def R(self) -> np.ndarray:
        """Rotation matrix (world-to-camera) from the quaternion."""
        w, x, y, z = self.qvec
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            np.float64,
        )


def _read(fh, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_bin(path: Path) -> Dict[int, Camera]:
    cams: Dict[int, Camera] = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(fh, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{n_params}d"))
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_bin(path: Path) -> Dict[int, Image]:
    images: Dict[int, Image] = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            image_id = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<4d"))
            tvec = np.array(_read(fh, "<3d"))
            (camera_id,) = _read(fh, "<i")
            name = b""
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(fh, "<Q")
            fh.read(24 * n_pts)  # skip 2D points (x, y, point3D_id)
            images[image_id] = Image(
                image_id, qvec, tvec, int(camera_id), name.decode()
            )
    return images


def read_cameras_txt(path: Path) -> Dict[int, Camera]:
    cams: Dict[int, Camera] = {}
    for line in path.read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
        params = np.array([float(p) for p in parts[4:]])
        cams[cam_id] = Camera(cam_id, model, w, h, params)
    return cams


def read_images_txt(path: Path) -> Dict[int, Image]:
    images: Dict[int, Image] = {}
    lines = [
        l for l in path.read_text().splitlines() if l and not l.startswith("#")
    ]
    for meta in lines[::2]:  # every other line is the 2D-point list
        p = meta.split()
        images[int(p[0])] = Image(
            int(p[0]),
            np.array([float(x) for x in p[1:5]]),
            np.array([float(x) for x in p[5:8]]),
            int(p[8]),
            p[9],
        )
    return images


class SceneManager:
    """pycolmap.SceneManager-shaped facade over the parsers."""

    def __init__(self, colmap_dir: str):
        self.dir = Path(colmap_dir)
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, Image] = {}

    def load_cameras(self):
        if (self.dir / "cameras.bin").exists():
            self.cameras = read_cameras_bin(self.dir / "cameras.bin")
        else:
            self.cameras = read_cameras_txt(self.dir / "cameras.txt")

    def load_images(self):
        if (self.dir / "images.bin").exists():
            self.images = read_images_bin(self.dir / "images.bin")
        else:
            self.images = read_images_txt(self.dir / "images.txt")
