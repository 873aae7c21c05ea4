"""On-disk dataset fixtures in the reference's real formats, the port's
twin of :mod:`nerfacc_tpu.datasets.fixtures`.

No published dataset ships with the repository, so the loaders are proven
on the analytic procedural scene rendered to disk in the formats they
parse: blender ``transforms_{split}.json`` with RGBA PNGs (the same plus a
per-frame ``time`` for D-NeRF) and a COLMAP ``sparse/0`` binary model
with ``images/`` for 360_v2. The views are rendered on ``device`` (None:
the CUDA device) through :mod:`.procedural`'s ``render_gt*``, 65,536 rays
at a time, and written through :mod:`.image_io`.

The oracle validates itself: the images come from the same analytic field
the loaders' rays can be re-rendered through, so a sign or convention
error anywhere in the loader chain shows as an image mismatch.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from .image_io import imwrite
from .procedural import render_gt, render_gt_dynamic, render_gt_env
from .rays import generate_rays, look_at_poses

CHUNK = 65536


def _device(device) -> torch.device:
    return torch.device("cuda") if device is None else torch.device(device)


def _render_chunks(render, origins, viewdirs, times=None,
                   chunk=CHUNK) -> torch.Tensor:
    """``render(o, d[, t])`` over ``chunk`` rays at a time."""
    out = []
    for s in range(0, origins.shape[0], chunk):
        args = (origins[s:s + chunk], viewdirs[s:s + chunk])
        if times is not None:
            args += (times[s:s + chunk],)
        out.append(render(*args))
    return torch.cat(out)


def _quantize(img01: torch.Tensor) -> np.ndarray:
    """[0, 1] colours as the 8-bit values a PNG stores (round half up)."""
    return (img01 * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def _rgba_views(poses, K, height, width, times=None, chunk=CHUNK):
    """Straight-alpha RGBA views of the analytic field, quantised to uint8
    (n, h, w, 4) on the host.

    Foreground colour and opacity come from two composites of the exact
    volumetric render, on black and on white:
    ``alpha = 1 - (c_white - c_black)`` (mean over the channels) and
    ``fg = c_black / alpha``."""
    dev = poses.device
    y, x = torch.meshgrid(torch.arange(height, device=dev),
                          torch.arange(width, device=dev), indexing="ij")
    black = torch.zeros(3, device=dev)
    white = torch.ones(3, device=dev)
    out = []
    for i in range(poses.shape[0]):
        rays = generate_rays(x.reshape(-1), y.reshape(-1), poses[i], K)
        if times is None:
            c_black, c_white = (
                _render_chunks(lambda o, d, b=b: render_gt(o, d, b),
                               rays.origins, rays.viewdirs, chunk=chunk)
                for b in (black, white))
        else:
            t = torch.full((height * width, 1), float(times[i]), device=dev)
            c_black, c_white = (
                _render_chunks(
                    lambda o, d, tt, b=b: render_gt_dynamic(o, d, b, tt),
                    rays.origins, rays.viewdirs, t, chunk=chunk)
                for b in (black, white))
        alpha = torch.clamp(1.0 - (c_white - c_black).mean(-1, keepdim=True),
                            0.0, 1.0)
        fg = torch.where(alpha > 1e-4, c_black / torch.clamp(alpha, min=1e-4),
                         torch.zeros_like(c_black))
        rgba = torch.cat([torch.clamp(fg, 0.0, 1.0), alpha], dim=-1)
        out.append(_quantize(rgba.reshape(height, width, 4)))
    return np.stack(out)


def write_blender_fixture(
    root,
    subject_id: str = "procedural",
    n_train: int = 12,
    n_val: int = 2,
    n_test: int = 4,
    width: int = 64,
    height: int = 64,
    dynamic: bool = False,
    camera_radius: float = 3.5,
    hemisphere: bool = False,
    device=None,
) -> Path:
    """Write a blender-format dataset of the procedural scene.

    Layout: ``{root}/{subject_id}/transforms_{train,val,test}.json`` with
    ``camera_angle_x`` and per-frame OpenGL ``transform_matrix`` (4x4) and
    ``./{split}/r_{i}`` file paths; RGBA PNGs. With ``dynamic=True`` each
    frame carries a ``time`` and is rendered through the time-shifted field
    (the D-NeRF format); with ``hemisphere=True`` each split's views are
    drawn over the upper hemisphere, as NeRF-Synthetic's are. The camera
    radius 3.5 keeps all content beyond the loaders' NEAR = 2.0.
    """
    dev = _device(device)
    subj = Path(root) / subject_id
    fov_x = np.deg2rad(45.0)
    focal = 0.5 * width / np.tan(0.5 * fov_x)
    K = torch.tensor(
        [[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]],
        dtype=torch.float32, device=dev)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    elev = {"train": 25.0, "val": 35.0, "test": 32.0}
    hemi_seed = {"train": 100, "val": 200, "test": 300}
    for split, n in counts.items():
        if n == 0:
            continue
        if hemisphere:
            poses = look_at_poses(n, radius=camera_radius,
                                  hemisphere_seed=hemi_seed[split],
                                  device=dev)
        else:
            poses = look_at_poses(n, radius=camera_radius,
                                  elevation_deg=elev[split], device=dev)
        times = None
        if dynamic:
            times = np.linspace(0.0, 1.0, n) if n > 1 else np.asarray([0.0])
        rgba = _rgba_views(poses, K, height, width, times=times)
        img_dir = subj / split
        img_dir.mkdir(parents=True, exist_ok=True)
        frames = []
        for i, pose in enumerate(poses.cpu().numpy()):
            imwrite(img_dir / f"r_{i}.png", rgba[i])
            mat = np.eye(4, dtype=np.float64)
            mat[:3, :4] = pose
            frame = {"file_path": f"./{split}/r_{i}",
                     "transform_matrix": mat.tolist()}
            if dynamic:
                frame["time"] = float(times[i])
            frames.append(frame)
        meta = {"camera_angle_x": float(fov_x), "frames": frames}
        (subj / f"transforms_{split}.json").write_text(json.dumps(meta))
    return subj


# ---------------------------------------------------------------------------
# COLMAP (360_v2) fixture
# ---------------------------------------------------------------------------


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            w = (R[2, 1] - R[1, 2]) / s
            x = 0.25 * s
            y = (R[0, 1] + R[1, 0]) / s
            z = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            w = (R[0, 2] - R[2, 0]) / s
            x = (R[0, 1] + R[1, 0]) / s
            y = 0.25 * s
            z = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            w = (R[1, 0] - R[0, 1]) / s
            x = (R[0, 2] + R[2, 0]) / s
            y = (R[1, 2] + R[2, 1]) / s
            z = 0.25 * s
    q = np.asarray([w, x, y, z])
    return q / np.linalg.norm(q)


def opencv_circle_poses(n_views: int, radius: float,
                        elevation_deg: float = 25.0) -> np.ndarray:
    """(n, 3, 4) float32 camera-to-world poses on a circle looking at the
    origin in the OpenCV convention (+z forward, +y down) used by COLMAP."""
    phis = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    theta = np.deg2rad(elevation_deg)
    poses = []
    for phi in phis:
        eye = radius * np.array(
            [np.cos(phi) * np.cos(theta), np.sin(phi) * np.cos(theta),
             np.sin(theta)]
        )
        forward = -eye / np.linalg.norm(eye)  # +z: towards the origin
        up_world = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up_world)
        right = right / np.linalg.norm(right)
        down = np.cross(forward, right)  # +y: image down
        R = np.stack([right, down, forward], axis=-1)
        poses.append(np.concatenate([R, eye[:, None]], axis=-1))
    return np.stack(poses).astype(np.float32)


def write_cameras_bin(path: Path, cams):
    """COLMAP cameras.bin (https://colmap.github.io/format.html)."""
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(cams)))
        for cam_id, model_id, w, h, params in cams:
            fh.write(struct.pack("<iiQQ", cam_id, model_id, w, h))
            fh.write(struct.pack(f"<{len(params)}d", *params))


def write_images_bin(path: Path, images):
    """COLMAP images.bin: (image_id, qvec, tvec, camera_id, name, n_pts)."""
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for image_id, qvec, tvec, camera_id, name, n_pts in images:
            fh.write(struct.pack("<i", image_id))
            fh.write(struct.pack("<4d", *qvec))
            fh.write(struct.pack("<3d", *tvec))
            fh.write(struct.pack("<i", camera_id))
            fh.write(name.encode() + b"\x00")
            fh.write(struct.pack("<Q", n_pts))
            fh.write(b"\x00" * (24 * n_pts))


def normalize_poses(c2ws: np.ndarray) -> np.ndarray:
    """The 360 loader's pose normalisation (recentre and rescale into the
    unit box), imported from the loader so that a fixture's oracle can
    never drift from the frame the loader emits rays in."""
    from .nerf_360_v2 import _normalize_poses

    return _normalize_poses(c2ws)


def write_colmap_fixture(
    root,
    subject_id: str = "procedural360",
    n_images: int = 16,
    width: int = 64,
    height: int = 64,
    camera_radius: float = 3.2,
    device=None,
) -> Path:
    """Write a 360_v2-format COLMAP dataset of the procedural scene.

    Layout: ``{root}/{subject_id}/sparse/0/{cameras,images}.bin`` and
    ``{root}/{subject_id}/images/*.png`` (factor 1). The images are the
    field over the directional environment (``render_gt_env``) along the
    raw (un-normalised) OpenCV camera rays.

    For an oracle: the loader recentres and rescales the pose origins into
    the unit box (:func:`normalize_poses`; directions are unchanged), so
    map its origins back to the raw frame first, ``o_raw = o_loaded /
    scale + center`` with the constants :func:`normalize_poses` derives
    from the raw poses.
    """
    dev = _device(device)
    subj = Path(root) / subject_id
    sparse = subj / "sparse" / "0"
    img_dir = subj / "images"
    sparse.mkdir(parents=True, exist_ok=True)
    img_dir.mkdir(parents=True, exist_ok=True)

    focal = 0.5 * width / np.tan(0.5 * np.deg2rad(45.0))
    write_cameras_bin(
        sparse / "cameras.bin",
        [(1, 1, width, height,
          [float(focal), float(focal), width / 2.0, height / 2.0])],
    )

    c2ws = opencv_circle_poses(n_images, radius=camera_radius)
    entries = []
    y, x = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    for i in range(n_images):
        c2w4 = np.concatenate(
            [c2ws[i], np.asarray([[0.0, 0.0, 0.0, 1.0]])], axis=0
        )
        w2c = np.linalg.inv(c2w4)
        name = f"img_{i:04d}.png"
        entries.append((i + 1, _rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], 1,
                        name, 0))
        # OpenCV rays through pixel centres (the loader's convention)
        dirs = np.stack(
            [
                (x.reshape(-1) + 0.5 - width / 2.0) / focal,
                (y.reshape(-1) + 0.5 - height / 2.0) / focal,
                np.ones(height * width),
            ],
            axis=-1,
        )
        d = dirs @ c2ws[i][:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = torch.as_tensor(c2ws[i][:3, 3], device=dev).expand(d.shape)
        img = _render_chunks(
            render_gt_env, o,
            torch.as_tensor(d, dtype=torch.float32, device=dev))
        imwrite(img_dir / name,
                _quantize(torch.clamp(img, 0.0, 1.0).reshape(height, width,
                                                              3)))
    write_images_bin(sparse / "images.bin", entries)
    return subj
