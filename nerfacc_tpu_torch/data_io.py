"""ctypes bridge to the native host ray-batch assembler
(``csrc/raygen.cpp``), the port's twin of :mod:`nerfacc_tpu.data_io`.

``g++`` builds the shared library at first use into
``build/nerfacc_tpu_torch/`` (beside the CUDA library of
:mod:`nerfacc_tpu_torch._build`), named by a hash of the source, the
flags and the host CPU, with the JAX package's flags: ``-O3
-march=native -fopenmp``, then without OpenMP and ``-march`` if that
fails. With no compiler at all
:func:`lib` is ``None`` and the loaders take their numpy path, as the JAX
loaders do, so that both packages draw the same batches. The module uses
numpy only: the loaders turn its buffers into tensors. A caller may pass
its own output buffers (``out``), such as numpy views of one page-locked
tensor, so that a batch reaches the card in one asynchronous copy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "csrc" / "raygen.cpp"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
# the retry where OpenMP or -march=native is refused
PORTABLE_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (Linux), which
    ``-march=native`` compiles for: a library built on one machine is never
    loaded on another."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def library_path() -> Path:
    """The shared library for the current source on this host's CPU (not
    built yet)."""
    h = hashlib.sha1(" ".join(FLAGS).encode() + SRC.read_bytes()
                     + _host_cpu())
    return BUILD_DIR / f"raygen_{h.hexdigest()[:12]}.so"


def _compile(so: Path) -> bool:
    """Build ``so``, written under a temporary name and moved into place so
    that processes building at once never load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        for flags in (FLAGS, PORTABLE_FLAGS):
            try:
                subprocess.run(["g++", *flags, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True)
            except (OSError, subprocess.CalledProcessError):
                continue
            os.replace(tmp, so)
            return True
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    so = library_path()
    if not so.exists() and not _compile(so):
        return None
    lib = ctypes.CDLL(str(so))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.sample_ray_batch.argtypes = [
        f32p, i64, i64, i64, i64, f32p, f32p, ctypes.c_int, f32p,
        ctypes.c_uint64, i64, f32p, f32p, f32p,
    ]
    lib.sample_ray_batch.restype = None
    lib.rays_for_pose.argtypes = [i64, i64, f32p, f32p, ctypes.c_int, f32p,
                                  f32p]
    lib.rays_for_pose.restype = None
    return lib


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; ``None`` where no
    compiler builds it."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _load()
    return _LIB


def _require() -> ctypes.CDLL:
    handle = lib()
    if handle is None:
        raise RuntimeError("native raygen unavailable: g++ could not build "
                           f"{SRC}")
    return handle


def _f32(a, shape, name) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.shape != shape:
        raise ValueError(f"{name} must have shape {shape}, got {a.shape}")
    return a


def _outputs(out, n: int) -> tuple:
    """Three (n, 3) float32 output arrays: ``out``'s, checked, or new."""
    if out is None:
        return tuple(np.empty((n, 3), np.float32) for _ in range(3))
    if len(out) != 3:
        raise ValueError("out must hold origins, dirs and pixels")
    for name, a in zip(("origins", "dirs", "pixels"), out):
        if (a.dtype != np.float32 or a.shape != (n, 3)
                or not a.flags.c_contiguous or not a.flags.writeable):
            raise ValueError(f"out {name} must be a writable C-contiguous "
                             f"({n}, 3) float32 array, got {a.dtype} "
                             f"{a.shape}")
    return tuple(out)


def sample_ray_batch(
    images: np.ndarray,  # (n, h, w, c) float32, c in {3, 4}
    poses: np.ndarray,  # (n, 3, 4) float32
    intrin: np.ndarray,  # (4,) fx, fy, cx, cy
    bkgd: np.ndarray,  # (3,)
    seed: int,
    num_rays: int,
    opengl: bool = True,
    out=None,
):
    """Native random-pixel batch; returns (origins, dirs, pixels) float32
    (num_rays, 3), written into ``out`` where it is given."""
    L = _require()
    images = np.ascontiguousarray(images, np.float32)
    if images.ndim != 4 or images.shape[-1] not in (3, 4):
        raise ValueError(f"images must be (n, h, w, 3 | 4), got "
                         f"{images.shape}")
    n, h, w, c = images.shape
    poses = _f32(poses, (n, 3, 4), "poses")
    intrin = _f32(intrin, (4,), "intrin")
    bkgd = _f32(bkgd, (3,), "bkgd")
    origins, dirs, pixels = _outputs(out, num_rays)
    L.sample_ray_batch(
        images, n, h, w, c, poses, intrin, int(opengl), bkgd,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), num_rays,
        origins, dirs, pixels,
    )
    return origins, dirs, pixels


def rays_for_pose(
    h: int, w: int, pose: np.ndarray, intrin: np.ndarray, opengl: bool = True
):
    """Rays through every pixel of one view, row-major: (origins, dirs)
    float32 (h * w, 3)."""
    L = _require()
    origins = np.empty((h * w, 3), np.float32)
    dirs = np.empty((h * w, 3), np.float32)
    L.rays_for_pose(h, w, _f32(pose, (3, 4), "pose"),
                    _f32(intrin, (4,), "intrin"), int(opengl), origins, dirs)
    return origins, dirs
