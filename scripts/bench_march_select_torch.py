#!/usr/bin/env python3
"""The march kernels of nerfacc_tpu_torch (K5 ``fused_select_grouped``, K6
``fused_reselect``; a warp per ray) timed beside their first design (a
thread per ray), on one NVIDIA GPU (Hopper).

    python3 scripts/bench_march_select_torch.py [--sass_dir DIR]

It prints, after the card's name and power limit:

1. the SASS instruction counts of the package's two march kernels
   (``cuobjdump -sass``; the listings go to ``--sass_dir``, default
   ``build/sass``); their registers are in the build log;
2. per shape (the render's 12,288 rays x 32 groups x 64 slots and 64 -> 32
   slots, the training step's 48 slots, 64 groups, the evaluation's 48 ->
   24, a K above 64, an R that 4 does not divide): the package's kernel
   checked against the first kernel (K5: every output bit-equal; K6: the
   mask and the gathered t bit-equal, the widths within rtol 1e-5 / atol
   1e-6), then both timed in turns (first, package, package, first)
   through the bare C entry points: ten calls back to back between one
   pair of CUDA events, median of 20 windows, and twenty calls replayed
   from a CUDA graph, the card's time alone (a bare ctypes call of 12-16
   arguments costs the host about what these kernels cost the card, so
   the back-to-back window is partly the host's); the package's kernel
   also through its wrapper;
3. what bounds the package's kernels: the same two windows at 8 rays (a
   launch's own time on the card) and at 8 x 12,288 rays (the card
   filled several times over: the time per 12,288 rays is then the rate
   the kernel sustains, not one wave's latency);
4. the package's source built with 1, 2, 4, 8 and 16 warps (rays) per
   block, and K6 compiled to fit 1, 4, 5, 6 or 8 blocks on an SM (a cap
   on its registers).

The first kernels live in ``scripts/csrc/march_select_first.cu`` and are
measurements only. No CPU mode.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the timers, the shapes, the bounds)
from bench_k1_k7_variants_torch import sass_counts  # noqa: E402

FIRST = ROOT / "scripts" / "csrc" / "march_select_first.cu"
BUILD_DIR = ROOT / "build" / "march_select_variants"
WARPS = (1, 2, 4, 8, 16)
# blocks of 8 warps that K6 is compiled to fit on an SM: no cap on its
# registers, then at most 64 (as shipped), 51, 40 and 32 a thread
MIN_BLOCKS = (1, 4, 5, 6, 8)
# (R, G, K, cone)
SELECT_SHAPES = (
    (cs.R_SLICE, 32, 64, 0.0), (cs.R_SLICE, 32, 64, 0.004),
    (cs.R_SLICE, 32, 48, 0.0), (cs.R_SLICE, 64, 64, 0.0),
    (cs.R_SLICE + 1, 32, 64, 0.0),
)
# (R, K, K2)
RESELECT_SHAPES = (
    (cs.R_SLICE, 64, 32), (cs.R_SLICE, 48, 24), (cs.R_SLICE, 80, 32),
    (cs.R_SLICE + 1, 64, 32),
)


def build_variants() -> dict:
    """The first kernels and the package's source at each block size, one
    nvcc each, all started together; ``{label: CDLL}``."""
    from nerfacc_tpu_torch import _build

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    package = _build.CSRC / "march_select.cu"
    jobs = {"first": (FIRST, [])}
    for w in WARPS:
        jobs[f"warps{w}"] = (package, [f"-DMARCH_WARPS_PER_BLOCK={w}"])
    for b in MIN_BLOCKS:
        jobs[f"blocks{b}"] = (package, [f"-DMARCH_RESELECT_MIN_BLOCKS={b}"])
    procs = {}
    for label, (src, defines) in jobs.items():
        lib = BUILD_DIR / f"lib{label}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o",
               str(lib), str(src)]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        prefix = "first" if label == "first" else "nerfacc"
        for name in ("select_grouped", "reselect"):
            fn = getattr(handle, f"{prefix}_{name}")
            fn.argtypes = list(_build._SIGNATURES[f"nerfacc_{name}"])
            fn.restype = ctypes.c_int
            setattr(handle, name, fn)
        libs[label] = handle
    return libs


def _stream():
    return torch._C._cuda_getCurrentRawStream(0)


def _call(fn, *args):
    err = fn(*args, _stream())
    if err:
        raise RuntimeError(f"CUDA error {err}")


def select_inputs(dev, R, G, K, seed=0):
    rng = np.random.RandomState(seed)
    C = 16
    gsize = rng.randint(1, C + 1, size=(R, 1))
    live = rng.randint(0, C + 1, size=(R, G)) * (rng.rand(R, G) < 0.4)
    live = torch.as_tensor(np.minimum(live, gsize), dtype=torch.int32,
                           device=dev)
    gsize = torch.as_tensor(gsize, dtype=torch.int32, device=dev)
    t_min = torch.as_tensor(rng.rand(R).astype(np.float32) * 2.0 + 0.05,
                            device=dev)
    return live, gsize, t_min


def reselect_inputs(dev, R, K, seed=1):
    rng = np.random.RandomState(seed)
    masks = torch.as_tensor(rng.rand(R, K) < 0.5, device=dev)
    ts = torch.as_tensor(
        np.sort(rng.rand(R, K), axis=1).astype(np.float32) * 3.0, device=dev)
    dt = torch.as_tensor(
        (rng.rand(R, K) * 0.01 + 1e-3).astype(np.float32), device=dev)
    return masks, ts, ts + dt, dt


def _quad(dev, R, K):
    outs = [torch.empty((R, K), dtype=torch.float32, device=dev)
            for _ in range(3)]
    return outs + [torch.empty((R, K), dtype=torch.bool, device=dev)]


def select_runner(lib, dev, R, G, K, cone):
    """(function that launches the library's K5 once, its outputs)."""
    import math

    live, gsize, t_min = select_inputs(dev, R, G, K)
    outs = _quad(dev, R, K)
    args = (live.data_ptr(), gsize.data_ptr(), t_min.data_ptr(),
            *(o.data_ptr() for o in outs), R, G, K, 5e-3, cone, 1e10,
            5e-3 / cone if cone > 0 else 0.0, math.log1p(cone))
    keep = (live, gsize, t_min)
    return (lambda: _call(lib.select_grouped, *args)), outs, keep


def reselect_runner(lib, dev, R, K, K2):
    ins = reselect_inputs(dev, R, K)
    outs = _quad(dev, R, K2)
    args = (*(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs),
            R, K, K2)
    return (lambda: _call(lib.reselect, *args)), outs, ins


def _b2b(fn) -> float:
    return cs.median_ms(fn, iters=20, calls=10)




def _in_turns(first, package):
    """ms per call in turns (first, package, package, first), each as
    (back to back, from a graph); and the speedup from the graph times."""
    runs = [(_b2b(fn), cs.graph_ms(fn))
            for fn in (first, package, package, first)]
    text = " ".join(f"{name} {b:.4f} / {g:.4f}" for name, (b, g) in zip(
        ("first", "package", "package", "first"), runs))
    speedup = min(runs[0][1], runs[3][1]) / max(runs[1][1], runs[2][1])
    return text, speedup


def compare(libs, dev) -> None:
    from nerfacc_tpu_torch.ops import fused_reselect, fused_select_grouped

    for R, G, K, cone in SELECT_SHAPES:
        f_run, f_out, ins = select_runner(libs["first"], dev, R, G, K, cone)
        p_run, p_out, _ = select_runner(libs["warps8"], dev, R, G, K, cone)
        f_run(), p_run()
        torch.cuda.synchronize()
        for name, a, b in zip(("ts", "te", "dt", "ok"), p_out, f_out):
            cs._check_equal(f"K5 {name} package vs first", a, b)
        text, speedup = _in_turns(f_run, p_run)
        kw = dict(k_slots=K, step_size=5e-3, cone_angle=cone)
        wrapped = cs.median_ms(lambda: fused_select_grouped(*ins, **kw))
        b = cs.bound(R * (4 * G + 8) + R * K * 13, 10 * R * K)
        print(f"K5 R={R} G={G} K={K} cone={cone}: bit-equal to the first "
              f"kernel; ms per call, ten back to back / twenty from a CUDA "
              f"graph: {text} ({speedup:.1f}x by the graph); one wrapper "
              f"call {wrapped:.4f} ms; bound {b['bound_ms']:.4f} ms",
              flush=True)
    for R, K, K2 in RESELECT_SHAPES:
        f_run, f_out, ins = reselect_runner(libs["first"], dev, R, K, K2)
        p_run, p_out, _ = reselect_runner(libs["warps8"], dev, R, K, K2)
        f_run(), p_run()
        torch.cuda.synchronize()
        for name, a, b in zip(("ts", "te"), p_out, f_out):
            cs._check_equal(f"K6 {name} package vs first", a, b)
        cs._check_equal("K6 ok package vs first", p_out[3], f_out[3])
        err = cs._check_close("K6 dt package vs first", p_out[2], f_out[2],
                              cs.T_RTOL, cs.T_ATOL)
        text, speedup = _in_turns(f_run, p_run)
        wrapped = cs.median_ms(lambda: fused_reselect(*ins, k2=K2))
        b = cs.bound(R * 13 * (K + K2), R * K)
        print(f"K6 R={R} K={K} k2={K2}: mask and gathered t bit-equal to the "
              f"first kernel, widths max abs diff {err:.3e}; ms per call, "
              f"ten back to back / twenty from a CUDA graph: {text} "
              f"({speedup:.1f}x by the graph); one wrapper call "
              f"{wrapped:.4f} ms; bound {b['bound_ms']:.4f} ms", flush=True)


def what_bounds(libs, dev) -> None:
    lib = libs["warps8"]
    R0 = cs.R_SLICE
    for label, make in (
        ("K5 G=32 K=64", lambda R: select_runner(lib, dev, R, 32, 64, 0.0)),
        ("K6 K=64 k2=32", lambda R: reselect_runner(lib, dev, R, 64, 32)),
    ):
        cells = []
        for R in (8, R0, 8 * R0):
            run, _, keep = make(R)
            ms = cs.graph_ms(run)
            cells.append(f"R={R}: {_b2b(run):.4f} / {ms:.4f} ms"
                         + (f" = {ms * R0 / R:.4f} per {R0} rays"
                            if R > R0 else ""))
            del keep
        print(f"{label}, ms per call, ten back to back / twenty from a CUDA "
              "graph: " + "  ".join(cells), flush=True)


def block_sizes(libs, dev) -> None:
    for label, make in (
        ("K5 G=32 K=64", lambda lib: select_runner(
            lib, dev, cs.R_SLICE, 32, 64, 0.0)),
        ("K5 G=32 K=64 cone 0.004", lambda lib: select_runner(
            lib, dev, cs.R_SLICE, 32, 64, 0.004)),
        ("K6 K=64 k2=32", lambda lib: reselect_runner(
            lib, dev, cs.R_SLICE, 64, 32)),
    ):
        cells = []
        for w in WARPS:
            run, _, keep = make(libs[f"warps{w}"])
            cells.append(f"{w}: {cs.graph_ms(run):.4f}")
            del keep
        print(f"{label} R={cs.R_SLICE}, warps per block -> ms per call "
              "(twenty from a CUDA graph): " + "  ".join(cells), flush=True)


def register_caps(libs, dev) -> None:
    cells = []
    for label in (f"blocks{b}" for b in MIN_BLOCKS):
        run, _, keep = reselect_runner(libs[label], dev, cs.R_SLICE, 64, 32)
        big, _, keep_big = reselect_runner(libs[label], dev, 8 * cs.R_SLICE,
                                           64, 32)
        cells.append(f"{label[6:]}: {cs.graph_ms(run):.4f} "
                     f"({cs.graph_ms(big) / 8:.4f} per {cs.R_SLICE} rays at "
                     f"{8 * cs.R_SLICE})")
        del keep, keep_big
    print(f"K6 K=64 k2=32 R={cs.R_SLICE}, compiled for n blocks of 8 warps "
          "per SM -> ms per call (twenty from a CUDA graph): "
          + "  ".join(cells), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass_dir", type=Path,
                    default=ROOT / "build" / "sass")
    args = ap.parse_args()
    dev = cs.phase_device()
    cs.phase_build()
    sass_counts(args.sass_dir, names=("select_grouped", "reselect"))
    libs = build_variants()
    compare(libs, dev)
    what_bounds(libs, dev)
    block_sizes(libs, dev)
    register_caps(libs, dev)
    print(f"nvidia-smi: {cs.smi_line()}")


if __name__ == "__main__":
    main()
