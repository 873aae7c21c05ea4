#!/usr/bin/env python3
"""The design choices of two kernels of nerfacc_tpu_torch, measured on one
NVIDIA GPU: the hash-table gradient's one-launch entry (K7,
``hash_grad_scatter_levels``) and the CP level forward (K1 / K2).

    python3 scripts/bench_k1_k7_variants_torch.py [--sass_dir DIR]

It prints, after the card's name and power limit:

1. per kernel of the built library whose name holds ``scatter`` or
   ``features``: registers are in the build log; here the number of SASS
   instructions and how many of them are atomics, shared-memory loads,
   shuffles, global loads and stores (``cuobjdump -sass``; the listings go
   to ``--sass_dir``, default ``build/sass``);
2. K7 at the NGP step's shape (393,216 samples, 16 levels, 2^19 entries)
   on uniform random points and on ray-ordered points, for every pair of
   (levels per group of the grid) x (run length): kernel ms, median of 10
   launches between CUDA events; beside them the sixteen per-level
   launches on inputs made ready beforehand, and the per-level loop with
   the plain PyTorch glue that makes those inputs (what the backward ran
   before the one-launch entry); and the adds made per corner at each
   run length;
3. K1 and K2 at both TensoCP levels for batches from 1,024 to 786,432
   samples: the kernel that reads the tables from device memory (slice
   width 0) against the one that stages them in shared memory.

No CPU mode.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the points, the timers, the shapes)

GROUPS = (1, 2, 4, 8, 16)
RUN_LENGTHS = (8, 16, 32, 64, 128)
BATCHES = (1024, 4096, 8192, 32768, 131072, 786432)
SASS_CLASSES = (("atomics", r"\b(ATOM|RED|ATOMS|ATOMG)\b"),
                ("shared loads", r"\bLDS\b"), ("shuffles", r"\bSHFL\b"),
                ("global loads", r"\bLDG\b"), ("global stores", r"\bSTG\b"))


def sass_counts(sass_dir: Path) -> None:
    from nerfacc_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: cuobjdump not found, skipped")
        return
    out = subprocess.run([tool, "-sass", str(_build.build())],
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        print(f"sass: cuobjdump failed ({out.returncode}): {out.stderr[:200]}")
        return
    sass_dir.mkdir(parents=True, exist_ok=True)
    for chunk in out.stdout.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if "scatter" not in name and "features" not in name:
            continue
        lines = [ln for ln in chunk.splitlines()
                 if re.search(r"/\*[0-9a-f]{4}\*/", ln)]
        kinds = Counter()
        for ln in lines:
            for label, pattern in SASS_CLASSES:
                if re.search(pattern, ln):
                    kinds[label] += 1
        (sass_dir / f"{name[:120]}.sass").write_text(chunk)
        print(f"sass {name[:100]}: {len(lines)} instructions, "
              + ", ".join(f"{kinds[k]} {k}" for k, _ in SASS_CLASSES))


def scatter_variants(dev) -> None:
    from nerfacc_tpu_torch import _build
    from nerfacc_tpu_torch.models import hash_grid_indices
    from nerfacc_tpu_torch.models.hash_encoding import _level_resolutions
    from nerfacc_tpu_torch.ops import hash_grad_scatter

    rng = np.random.RandomState(cs.SEED)
    N, L, T = cs.NGP_FIELD_BUDGET, cs.NGP_LEVELS, 1 << cs.NGP_LOG2_T
    res = _level_resolutions(L, 16, 1.4472692012786865)
    dense = (res + 1) ** 3 <= T
    g = torch.as_tensor(rng.randn(N, 2 * L).astype(np.float32), device=dev)
    d_table = torch.zeros((L, T, 2), dtype=torch.float32, device=dev)
    cases = (
        ("random", torch.as_tensor(rng.rand(N, 3).astype(np.float32),
                                   device=dev)),
        ("ray-ordered", cs.ray_ordered_points(dev)),
    )
    for label, x in cases:
        flat_idx, corner_w = hash_grid_indices(
            x, torch.as_tensor(res, device=dev),
            torch.as_tensor(dense, device=dev), T)
        changed = flat_idx[1:] != flat_idx[:-1]
        rows = torch.arange(1, N, device=dev)

        def adds_per_corner(run_len):
            starts = (rows % run_len == 0)[:, None]
            return (int((changed | starts).sum()) + 8 * L) / (8 * L * N)

        print(f"K7 {label} points: adds per corner by run length: "
              + ", ".join(f"{rl}: {adds_per_corner(rl):.3f}"
                          for rl in RUN_LENGTHS))
        per_level = changed.reshape(N - 1, L, 8).float().mean(dim=(0, 2))
        print(f"K7 {label} points: share of corners whose index differs "
              "from the sample before, per level: "
              + ", ".join(f"{v:.2f}" for v in per_level.tolist()))
        ptrs = (flat_idx.data_ptr(), corner_w.data_ptr(), g.data_ptr(),
                d_table.data_ptr())
        for group in GROUPS:
            times = []
            for run_len in RUN_LENGTHS:
                times.append(cs.median_ms(lambda: _build.launch(
                    "variants", "nerfacc_hash_grad_scatter_levels", dev,
                    *ptrs, N, L, T, group, run_len), 10))
            print(f"K7 {label} points, {group:2d} levels per group, run "
                  f"lengths {RUN_LENGTHS}: "
                  + "  ".join(f"{t:.4f}" for t in times) + " ms")

        gl = g.reshape(N, 2, L).permute(0, 2, 1)

        def glue(level):
            sl = slice(level * 8, level * 8 + 8)
            return ((flat_idx[:, sl] - level * T).reshape(-1),
                    (corner_w[:, sl, None] * gl[:, level, None, :])
                    .reshape(-1, 2))

        ready = [glue(level) for level in range(L)]

        def bare():
            for level, (idx, v) in enumerate(ready):
                hash_grad_scatter(idx, v, T, out=d_table[level])

        def with_glue():
            for level in range(L):
                idx, v = glue(level)
                hash_grad_scatter(idx, v, T, out=d_table[level])

        print(f"K7 {label} points, per-level kernel x {L}: "
              f"{cs.median_ms(bare, 10):.4f} ms on ready inputs, "
              f"{cs.median_ms(with_glue, 10):.4f} ms with the glue that "
              "makes them")
        del flat_idx, corner_w, ready, changed
        torch.cuda.empty_cache()


def features_variants(dev) -> None:
    from nerfacc_tpu_torch import _build
    from nerfacc_tpu_torch.ops import cp_features_slice_width

    rng = np.random.RandomState(cs.SEED)
    xu = torch.as_tensor(rng.rand(max(BATCHES), 3).astype(np.float32),
                         device=dev)
    for G, R in ((128, 64), (512, 128)):
        tables = [torch.as_tensor(rng.randn(G, R).astype(np.float32) * 0.2,
                                  device=dev) for _ in range(3)]
        width = cp_features_slice_width(G, R, max(BATCHES))
        for B in BATCHES:
            xs = xu[:B].contiguous()
            out = torch.empty((B, R), dtype=torch.float32, device=dev)
            us = [torch.empty((B, R), dtype=torch.bfloat16, device=dev)
                  for _ in range(3)]
            base = (xs.data_ptr(), *(t.data_ptr() for t in tables),
                    out.data_ptr())
            cells = []
            for rs in (0, width):
                k1 = cs.median_ms(lambda: _build.launch(
                    "variants", "nerfacc_cp_level_features", dev, *base, B,
                    G, R, rs), 10)
                k2 = cs.median_ms(lambda: _build.launch(
                    "variants", "nerfacc_cp_level_features_res", dev, *base,
                    *(u.data_ptr() for u in us), B, G, R, rs), 10)
                cells.append(f"slice width {rs}: K1 {k1:.4f} K2 {k2:.4f} ms")
            print(f"K1/K2 G={G} R={R} B={B}: " + "  ".join(cells))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass_dir", type=Path,
                    default=ROOT / "build" / "sass")
    args = ap.parse_args()
    dev = cs.phase_device()
    cs.phase_build()
    sass_counts(args.sass_dir)
    scatter_variants(dev)
    features_variants(dev)
    print(f"nvidia-smi: {cs.smi_line()}")


if __name__ == "__main__":
    main()
