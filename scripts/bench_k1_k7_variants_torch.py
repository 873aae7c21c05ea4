#!/usr/bin/env python3
"""The design choices of three kernels of nerfacc_tpu_torch, measured on
one NVIDIA GPU: the hash-table gradient's one-launch entry (K7,
``hash_grad_scatter_levels``), the CP level forward (K1 / K2) and the CP
level gradient without residuals (K3, ``cp_level_grads``).

    python3 scripts/bench_k1_k7_variants_torch.py [--sass_dir DIR] [--parts sass,k3,k7,k1]

It prints, after the card's name and power limit:

1. per kernel of the built library whose name holds ``scatter``,
   ``features`` or ``grads``: registers are in the build log; here the
   number of SASS
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
   width 0) against the one that stages them in shared memory;
4. K3 at both TensoCP levels and 786,432 samples, on uniform random
   points and on points laid along rays, in its three layouts: the first
   kernel (global atomics, slice width 0), partial gradient tables and
   the staged bf16 tables in shared memory (the widest slice they fit:
   64 features at G=128, 16 at G=512), and partial gradient tables alone
   with the tables read through L1 / L2 (64; 32), each checked against
   the plain twin and timed in turns (first, staged, unstaged, unstaged,
   staged, first) as twenty calls replayed from a CUDA graph, through the
   C entry with the layout forced; with each layout's shared-memory
   wavefronts per warp step counted from the same points (the banks its
   rows fall on) and the bytes of table rows the unstaged layout reads;
   then the three for batches from 1,024 to 786,432 samples (where the
   shared-memory layouts start to pay).

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


def sass_counts(sass_dir: Path,
                names=("scatter", "features", "grads")) -> None:
    """SASS instruction counts of the built library's kernels whose name
    holds one of ``names``; the listings go to ``sass_dir``."""
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
        if not any(n in name for n in names):
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


def grads_layouts(G: int, R: int) -> dict:
    """K3's layouts at one level: ``{label: (slice width, staged)}``, each
    at the widest slice it fits (``cp_level_grads_slice_width``'s rule
    per layout)."""
    from nerfacc_tpu_torch.ops.cp_encoder import SHARED_BYTES_PER_BLOCK

    def widest(widths, per_feature):
        return next((w for w in widths if R % w == 0
                     and 3 * G * w * per_feature <= SHARED_BYTES_PER_BLOCK), 0)

    return {"first": (0, False), "staged": (widest((64, 32, 16), 6), True),
            "unstaged": (widest((64, 32), 4), False)}


def _chunk(B: int, slices: int, sms: int, min_samples: int = 1024) -> int:
    """The K3 kernels' samples per block (``sample_chunks`` in
    ``csrc/cp_encoder.cu``)."""
    n = min(max(sms // slices, 1), -(-B // min_samples))
    return -(-(-(-B // n)) // 32) * 32


def _wavefronts(words: torch.Tensor) -> torch.Tensor:
    """Per row of 4-byte word addresses one warp touches: the wavefronts
    shared memory takes, the most distinct words that fall on one of the
    32 banks."""
    words, _ = torch.sort(words, dim=1)
    fresh = torch.ones_like(words, dtype=torch.bool)
    fresh[:, 1:] = words[:, 1:] != words[:, :-1]
    per_bank = torch.zeros((words.shape[0], 32), dtype=torch.int64,
                           device=words.device)
    per_bank.scatter_add_(1, words % 32, fresh.long())
    return per_bank.max(dim=1).values.double()


def smem_wavefronts(x: torch.Tensor, G: int, pairs: int, chunk: int):
    """K3's shared-memory wavefronts per warp step (64 sample-features) in
    the first chunk of ``x``, for a slice of ``2 * pairs`` features: a
    step holds one sample of each of the warp's ``32 // pairs`` streams,
    and per axis and tap each of its lanes reads the staged table's 4-byte
    pair of bf16 (the staged layout) and reads and swaps the partial
    table's 8-byte pair of f32 (both layouts). Returns (staged reads,
    partial reads + swaps), summed over the six taps, averaged over the
    steps."""
    per = 32 // pairs
    n = min(chunk, x.shape[0]) // per * per
    row0 = torch.clamp(torch.floor(x[:n] * (G - 1)), 0, G - 1).long()
    # (steps, samples of a step, axes): stream s holds samples s * n / per...
    rows = row0.reshape(per, n // per, 3).permute(1, 0, 2)
    q = torch.arange(pairs, device=x.device)
    staged = partial = 0.0
    for a in range(3):
        for tap in (0, 1):
            row = rows[..., a] + tap
            row = torch.where(row < G, row, row - 1)  # the last node's own
            pair = ((a * G + row)[..., None] * pairs + q).reshape(-1, 32)
            staged = staged + _wavefronts(pair)
            partial = partial + 2 * _wavefronts(
                torch.cat([2 * pair, 2 * pair + 1], dim=1))
    return float(staged.mean()), float(partial.mean())


def _grads_call(dev, x, tables, g, width, staged):
    """A callable: zero three (G, R) gradients and launch K3's C entry
    into them at slice width ``width`` (0: the first kernel), with or
    without the tables staged in shared memory."""
    from nerfacc_tpu_torch import _build
    from nerfacc_tpu_torch.ops.cp_encoder import _zero_grads

    G, R = tables[0].shape
    B = x.shape[0]
    ptrs = (x.data_ptr(), *(t.data_ptr() for t in tables), g.data_ptr())

    def run():
        grads, grad_ptrs = _zero_grads(G, R, dev)
        _build.launch("cp_level_grads", "nerfacc_cp_level_grads", dev,
                      *ptrs, *grad_ptrs, B, G, R, width, int(staged))
        return grads

    return run


def grads_variants(dev) -> None:
    from nerfacc_tpu_torch.ops import (
        cp_level_grads_plain,
        cp_level_grads_slice_width,
        cp_level_grads_staged,
    )

    rng = np.random.RandomState(cs.SEED)
    B = cs.B_SAMPLES
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    orders = {
        "random": torch.as_tensor(rng.rand(B, 3).astype(np.float32),
                                  device=dev),
        "ray-ordered": cs.ray_ordered_points(dev, B // cs.TRAIN_RAYS),
    }
    for G, R in ((128, 64), (512, 128)):
        tables = [torch.as_tensor(rng.randn(G, R).astype(np.float32) * 0.2,
                                  device=dev) for _ in range(3)]
        g = torch.as_tensor(rng.randn(B, R).astype(np.float32), device=dev)
        layouts = grads_layouts(G, R)
        width = cp_level_grads_slice_width(G, R, B)
        package = ("staged" if cp_level_grads_staged(G, width)
                   else "unstaged")
        b = cs.bound(4 * (3 * B + 6 * G * R + B * R), 21 * B * R)
        for label, x in orders.items():
            want = cp_level_grads_plain(x, *tables, g)
            scale = max(float(w.abs().max()) for w in want)
            runs = {k: _grads_call(dev, x, tables, g, *v)
                    for k, v in layouts.items()}
            errs = {}
            for name, run in runs.items():
                got = run()
                torch.cuda.synchronize()
                errs[name] = max(float((d - w).abs().max())
                                 for d, w in zip(got, want)) / scale
                if errs[name] > cs.CP_GRAD_REL:
                    raise AssertionError(f"K3 {name} G={G} R={R} {label}: "
                                         f"error {errs[name]:.2e} x max|dT|")
            del want, got
            order = ("first", "staged", "unstaged", "unstaged", "staged",
                     "first")
            turns = [cs.graph_ms(runs[k]) for k in order]
            best = {k: min(t for o, t in zip(order, turns) if o == k)
                    for k in runs}
            counts = []
            for k in ("staged", "unstaged"):
                w = layouts[k][0]
                st, pa = smem_wavefronts(x, G, w // 2, _chunk(B, R // w, sms))
                if k == "unstaged":
                    st = 0.0  # its tables are read from L1 / L2
                counts.append(f"{k} {w} features: {st:.2f} staged + "
                              f"{pa:.2f} partial = {st + pa:.2f}")
            # the unstaged layout reads two taps x three axes of its
            # slice's features per sample and slice, 4 bytes each: R per
            # sample and tap row
            row_bytes = B * 6 * R * 4
            print(f"K3 G={G} R={R} B={B} {label} points (package: {package}"
                  f" at {width} features): in turns "
                  + " / ".join(f"{o} {t:.4f}" for o, t in zip(order, turns))
                  + " ms; first / staged "
                  f"{best['first'] / best['staged']:.2f}x, staged / "
                  f"unstaged {best['staged'] / best['unstaged']:.2f}x; bound "
                  f"{b['bound_ms']:.4f} ms = "
                  + ", ".join(f"{b['bound_ms'] / best[k]:.0%} of {k}"
                              for k in runs)
                  + "; shared-memory wavefronts per warp step (64 "
                  "sample-features): " + "; ".join(counts)
                  + f"; unstaged reads {row_bytes / 1e9:.3f} GB of table "
                  "rows; error x max|dT|: "
                  + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
        for n in BATCHES:
            xs = orders["random"][:n].contiguous()
            gs = g[:n].contiguous()
            # each layout at any batch (the package chooses by batch)
            cells = [f"{k} {cs.graph_ms(_grads_call(dev, xs, tables, gs, *v)):.4f}"
                     for k, v in layouts.items()]
            print(f"K3 G={G} R={R} B={n}: " + "  ".join(cells) + " ms")
        del tables, g
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass_dir", type=Path,
                    default=ROOT / "build" / "sass")
    ap.add_argument("--parts", default="sass,k3,k7,k1",
                    help="comma-separated parts to run (sass, k3, k7, k1)")
    args = ap.parse_args()
    parts = args.parts.split(",")
    dev = cs.phase_device()
    cs.phase_build()
    if "sass" in parts:
        sass_counts(args.sass_dir)
    if "k3" in parts:
        grads_variants(dev)
    if "k7" in parts:
        scatter_variants(dev)
    if "k1" in parts:
        features_variants(dev)
    print(f"nvidia-smi: {cs.smi_line()}")


if __name__ == "__main__":
    main()
