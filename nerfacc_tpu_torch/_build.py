"""Builds the package's CUDA kernels, loads them with ``ctypes`` and
launches them.

``nvcc`` compiles every ``csrc/*.cu`` (one compiler process per source,
all started together) and links them into one shared library with a plain
C interface, for ``sm_90a`` (Hopper), at first use. The library lands in
``build/nerfacc_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. A missing ``nvcc`` or a failed build raises with the
compiler's output: no kernel quietly falls back to anything.

:func:`launch` is the one way a wrapper reaches its kernel. A wrapper call
is mostly host time for the short kernels, so the launch keeps that small:
the C function is looked up once per symbol, the stream is taken as a raw
handle (no ``torch.cuda.Stream`` object is built), and the device guard is
entered only when the tensors' device is not the current one. The guard
stays in Python rather than in the C entry points: PyTorch's guard also
switches PyTorch's own notion of the current device and stream, which a
bare ``cudaSetDevice`` in the library would leave behind, and the common
case (one card, or the tensors' card already current) then costs one
comparison.

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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "nerfacc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: every one returns the cudaError_t of its launch
_SIGNATURES = {
    # xu, t0, t1, t2, out, B, G, R, slice width (0: the tables read from
    # device memory), stream
    "nerfacc_cp_level_features": (_P,) * 5 + (_I,) * 4 + (_P,),
    # xu, t0, t1, t2, out, u0, u1, u2, B, G, R, slice width, stream
    "nerfacc_cp_level_features_res": (_P,) * 8 + (_I,) * 4 + (_P,),
    # xu, t0, t1, t2, g, d0, d1, d2, B, G, R, slice width (0: the
    # global-atomic kernel), staged (the tables in shared memory too), stream
    "nerfacc_cp_level_grads": (_P,) * 8 + (_I,) * 5 + (_P,),
    # xu, g, u0, u1, u2, d0, d1, d2, B, G, R, slice width (0: the
    # global-atomic kernel), stream
    "nerfacc_cp_level_grads_res": (_P,) * 8 + (_I,) * 4 + (_P,),
    # live, group_size, t_min, ts, te, dt, ok, R, G, K,
    # step, cone, dt_max, step / cone, log1p(cone), stream
    "nerfacc_select_grouped": (_P,) * 7 + (_I,) * 3 + (_F,) * 5 + (_P,),
    # masks, ts, te, dt, ts2, te2, dt2, ok2, R, K, K2, stream
    "nerfacc_reselect": (_P,) * 8 + (_I,) * 3 + (_P,),
    # rays_o, rays_d, t_min, t_max, roi, table, ts, te, dt, ok, R, S, K,
    # the resolution (3), step, cone, dt_max, step / cone, log1p(cone),
    # stream
    "nerfacc_march_dense": (_P,) * 10 + (_I,) * 6 + (_F,) * 5 + (_P,),
    # idx, v, out, B, T, stream
    "nerfacc_hash_grad_scatter": (_P,) * 3 + (_L, _I, _P),
    # flat_idx, corner_w, g, d_table, N, L, T, levels per group, run
    # length, stream
    "nerfacc_hash_grad_scatter_levels": (_P,) * 4 + (_I,) * 5 + (_P,),
    # idx, table, out, N, T, stream
    "nerfacc_table_gather": (_P,) * 3 + (_L, _I, _P),
    # x, table, res, dense, out, idx, w (idx and w null: no gradient's
    # inputs), N, L, T, F, round to bf16, stream
    "nerfacc_hash_encode": (_P,) * 7 + (_L,) + (_I,) * 4 + (_P,),
}

# where the CUDA toolkit installs nvcc when it is not on PATH
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

_lib = None
_functions: dict = {}  # symbol -> its C function, filled by launch()


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and their headers
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
    nvcc = _nvcc()
    stem = f"{out.name}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [out.with_name(f"{stem}.{src.stem}.o") for src in sources]
    tmp = out.with_name(f"{stem}.tmp")
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objects)])
    report, failed = "", None
    try:
        for cmd, proc in zip(cmds, procs):
            report += proc.communicate()[0]
            failed = failed or (proc.returncode and (cmd, proc.returncode))
        if not failed:
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            report += link.stdout + link.stderr
            failed = link.returncode and (cmds[-1], link.returncode)
        if failed:
            raise RuntimeError(
                f"nvcc failed with exit code {failed[1]}:\n"
                f"{' '.join(failed[0])}\n{report}"
            )
        out.with_name(out.name + ".log").write_text(report)
        os.replace(tmp, out)
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
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


def launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Call the C entry point ``symbol`` with ``args`` and, last, the raw
    handle of PyTorch's current stream on ``device``; raise if the launch
    returns a CUDA error. ``kernel`` names the wrapper in the error. The
    device guard is entered only when ``device`` is not the current one.
    """
    fn = _functions.get(symbol)
    if fn is None:
        fn = _functions[symbol] = getattr(lib(), symbol)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        check(err, kernel)


def cuda_ptr(kernel: str, name: str, t, dtype, shape, device) -> int:
    """Device pointer of an argument, after checking that the kernel takes
    it: a contiguous CUDA tensor of ``dtype`` and ``shape`` on ``device``.
    """
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{kernel}: {name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:  # a torch.Size is a tuple
        raise ValueError(
            f"{kernel}: {name} must have shape {tuple(shape)}, "
            f"got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    return t.data_ptr()
