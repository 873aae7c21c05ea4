"""Builds the package's CUDA kernels and loads them with ``ctypes``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, for ``sm_90a`` (Hopper), at first use. The library lands in
``build/nerfacc_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. A missing ``nvcc`` or a failed build raises with the
compiler's output: no kernel quietly falls back to anything.

The kernels keep their float arithmetic in the order of their plain
PyTorch twins: no ``--use_fast_math``, and ``-fmad=false`` so that the
compiler does not contract a multiply and an add that PyTorch rounds
apart.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "nerfacc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: every one returns the cudaError_t of its launch
_SIGNATURES = {
    # xu, t0, t1, t2, out, B, G, R, stream
    "nerfacc_cp_level_features": (_P,) * 5 + (_I,) * 3 + (_P,),
    # live, group_size, t_min, ts, te, dt, ok, R, G, K,
    # step, cone, dt_max, step / cone, log1p(cone), stream
    "nerfacc_select_grouped": (_P,) * 7 + (_I,) * 3 + (_F,) * 5 + (_P,),
    # masks, ts, te, dt, ts2, te2, dt2, ok2, R, K, K2, stream
    "nerfacc_reselect": (_P,) * 8 + (_I,) * 3 + (_P,),
}

# where the CUDA toolkit installs nvcc when it is not on PATH
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

_lib = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(NVCC_FALLBACK):
        nvcc = NVCC_FALLBACK
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of nerfacc_tpu_torch are "
            "built from source at first use and need the CUDA toolkit"
        )
    return nvcc


def library_path() -> Path:
    """The shared library for the current sources (not built yet)."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnerfacc_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the
    library's path. The compiler's report (registers, spills) is kept
    beside it as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.nerfacc_error_string.argtypes = [ctypes.c_int]
        handle.nerfacc_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib().nerfacc_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err}: {msg}")


def cuda_ptr(kernel: str, name: str, t, dtype, shape, device) -> int:
    """Device pointer of an argument, after checking that the kernel takes
    it: a contiguous CUDA tensor of ``dtype`` and ``shape`` on ``device``.
    """
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{kernel}: {name} must have shape {tuple(shape)}, "
            f"got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    return t.data_ptr()
