#!/usr/bin/env python3
"""Smoke run of nerfacc_tpu_torch's render path, TensoCP training step,
hash-NGP training step, its trainers (seven drives) and the reference's
flat packed API on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits nonzero):

1. Device: the card's name and power limit from ``nvidia-smi``. Without
   CUDA the script stops here: it never runs on the CPU.
2. Build: compiles the CUDA kernels of ``nerfacc_tpu_torch/csrc`` with
   ``nvcc`` into ``build/nerfacc_tpu_torch/`` and reports the seconds.
3. The host's cost of one wrapper call (``host us per wrapper call``:
   1,000 un-synchronised calls of ``table_gather`` at one index and of
   ``fused_reselect`` at 64 rays, host clock over the count, beside
   PyTorch's ``table[idx]``). Then kernels vs plain twins on the card, at
   the main paths' shapes: the CP encoder's forward (K1), residual
   forward (K2) and table gradients (K3, K4) at 786,432 samples for both
   TensoCP levels (K1 also at 131,072, one chunk of ``update_grid``; K3
   also on points laid along rays, against its first kernel in the same
   process, timed as one wrapper call and from a CUDA graph), and
   K4 once more at G = 1024, where its tables exceed
   a block's shared memory and it takes its global-atomic kernel; march
   selection at 12,288 rays x 32 groups x 64 slots (cone 0 and 0.004),
   re-selection at 12,288 rays x 64 -> 32 slots, both also per call over
   ten calls back to back and over twenty replayed from a CUDA graph (no
   host work between the launches) and, checked only, at 48 slots, 64
   groups, 48 -> 24 and 80 -> 32 slots, 12,289 rays, and at rows longer
   than a warp holds at once (1,100 groups, 300 -> 200 slots); the
   hash-table gradient scatter (K7) at the NGP step's 3,145,728 corners
   for each of the 16 levels (dense and hashed, every 17th index -1),
   also against a float64 ``index_add_``, and its one-launch entry for all 16 levels at 393,216
   samples, on uniform random points and on points laid along rays as the
   step feeds them; the table gather (K8) into a 2^19-word table at
   262,144 indices and at 6,291,456 (one level's corners), and at a
   length that 4 does not divide through views 4, 8 and 12 bytes off a
   16-byte boundary. Median times of both, the time of the one PyTorch
   call that computes the same function where there is one, and the
   least time the card could take (bytes over 3.35 TB/s or operations
   over 67 TFLOP/s); for K8 also both per call over ten calls back to
   back (the card's time without the host's share of a call) and the
   rate of 32-byte L2 sectors that is (every gathered word moves one).
4. The render path: four 128x128 views of the procedural scene through
   ``render_image`` with the flagship TensoCP field (random weights from a
   seed), the trained 128^3 occupancy grid, the fused march and the
   two-stage visibility cull. Outputs must be finite with opacities in
   [0, 1], every kernel of the path must have launched (and no training
   kernel), the march must match the unfused march bit for bit, the
   render must agree with the render through the plain paths, and a
   16x16 crop must agree with the same path run on the CPU.
5. The training step of ``bench.py --mode train --grid trained
   --fused_march`` with the field's kernels: one 512-ray step on the card
   against the same step on the CPU (loss and every gradient); 5 steps
   of 16,384 rays from bench.py's ray stream (finite losses and
   parameters, K2 and K4 twice and K5 once per step, step time, live
   samples, samples/s); 5 steps on a repeated batch must lower its loss;
   the plain twin of the whole step (no kernel); ``update_grid`` on the
   full 128^3 grid, warm-up and sampled paths (K1), and the card against
   the CPU on a 32^3 grid with the same cells and jitter.
6. The ``cp_level_features`` op differentiated on its own (K1, K3), and
   the per-level ``hash_grad_scatter`` op called once per level, which
   must give what the one-launch entry gives.
7. The training step of ``bench.py --model ngp --mode train --grid trained
   --fused_march --ngp_pallas_grad`` with the reference NGP field (16
   levels x 2 features x 2^19 entries) and live-sample compaction of the
   field (393,216 entries): one 512-ray step on the card against the same
   step on the CPU (2^15 entries per level; loss and every gradient); 10
   steps of 16,384 rays (finite losses and parameters, K7's one-launch
   entry and K5 once per step, the per-level K7 and the CP kernels
   never); 10 steps on a repeated batch
   must lower its loss; the same step with no kernel; one 128x128 request
   through ``render_image`` with the NGP field.
8. ``scripts/bench_hash_torch.py r5gather`` (K8 beside PyTorch's
   indexing).
9. The TensoCP trainer, ``examples/train_ngp_nerf_torch.py``, at the
   flagship drive's flags with the kernels: 1,000 steps on the procedural
   scene (GT rendered on the card), then the PSNR of 3 held-out views,
   which must reach 32.5; train seconds, live samples per second,
   ``field_budget_dropped`` and the kernels' launches over the run. Then
   each kernel of the run (K1, K2, K4, K5, K6) against its plain twin on
   the inputs the run gave it (the first call at each shape), and K5 / K6
   also on random rows at those shapes.
10. The NGP trainer, ``train_ngp_nerf_torch.py --model ngp``, at its
    drive's flags with the kernels (200 steps of 4,096 rays, 96x96 views,
    16 levels x 2 features x 2^19 entries, the field on half the sample
    budget): the PSNR of 2 held-out views must reach 20, no live sample
    may be dropped, K5, K6 and K7's one-launch entry must launch and no
    other kernel; then K5, K6 and K7 against their twins on the run's
    inputs (K7 within 1e-5 of the largest |gradient|).
11. The vanilla NeRF trainer, ``train_mlp_nerf_torch.py``, at its drive's
    flags (300 steps of 1,024 rays, 64x64 views): PSNR floor 20.
12. The D-NeRF trainer, ``train_mlp_dnerf_torch.py``, at its drive's
    flags (2,000 steps of 4,096 rays, 131,072 slots, 96x96 views of the
    moving scene, the default warp): PSNR floor 26.0. The MLP trainers
    march exactly in one stage: no kernel may launch.
13. The proposal trainer, ``train_proposal_nerf_torch.py``, at its
    ``DRIVE`` flags with ``--use_kernel`` (2,000 steps of 4,096 rays, 64 +
    32 samples, 128x128 views, 64 training views, the proposal level (64,
    32)): PSNR floor 40.0; train seconds, ``train_samples_per_s`` and the
    launches of K1, K2, K4; then each against its twin on the run's
    inputs, the proposal level's among them.
14. The same at ``DRIVE_360`` (the 360 scene, unbounded, 4,000 steps of
    4,096 rays, 96 + 48 samples, 96x96 views) on the plain paths, as the
    JAX script runs it: PSNR floor 37.0, no kernel launched; then K1, K2
    and K4 against their twins on the run's trained tables and on the
    points one batch gives each level (the proposal level (192, 32) at
    393,216 coarse midpoints). With ``--use_kernel`` the recipe collapses
    at seeds 42 and 44, and so it does with the kernels replaced by their
    plain twins: the kernel path's numerics, not the kernels (ROADMAP.md
    Queue 3). So the kernel path trains only its first
    P360_KERNEL_STEPS steps here, with no quality floor: K1, K2 and K4
    must launch and are held to their twins on the inputs those steps
    gave them, the (192, 32) level's among them.
15. The grid trainer's unbounded drive, ``train_ngp_nerf_torch.py`` at
    ``U360`` with the kernels (2,000 steps of 4,096 rays on the 360 scene,
    a 256^3 sphere-contracted grid, [0.2, 1e4] at step 1e-2 and cone
    0.004, the lattice auto-sized to 2,336 points in 146 probe groups):
    PSNR floor 25.0; K1, K2, K4, K5 and K6 against their twins on the
    run's inputs (K5 at 4,096 rays x 146 groups x 128 slots, K6 at 128 ->
    64 and on the evaluation's chunks), then the fused march against the
    unfused one on the run's grid and rays, masks bit-equal.
16. The reference's flat packed API: each of the four requests through
    ``ray_marching()`` (the grouped march, the visibility cull through
    ``make_field_fns``' ``sigma_fn``, re-selection into 24 slots per ray)
    and ``rendering()`` over ``rgb_sigma_fn``, with the kernels (K1, K5, K6
    must launch, no training kernel; each then held to its twin on the
    inputs the render gave it) and on the plain paths. The march's
    masks bit-equal to the unfused march's, before and after the cull;
    outputs finite with opacities in [0, 1]; the kernel path within
    RENDER_ATOL / DEPTH_ATOL of the plain one; a 16x16 crop on the card
    against the CPU. The segmented path at full size: one request's live
    samples repacked ragged (``pack_data``, ``unpack_info``) and composited
    through ``rendering()`` against the bridged render of the same field
    outputs, within ``flat_render_bound``; ``rendering()`` timed bridged,
    forced segmented and ragged, and the bridge check alone;
    ``loss_distortion`` and ``ray_resampling`` on the segmented path
    against their dense twins at 16,384 rays x 64 samples. Training
    through ``rendering()`` and an MSE: one 512-ray step on the card
    against the CPU, then 5 steps of 16,384 rays from bench.py's stream
    (finite losses and parameters, K1, K2, K4, K5 and K6 launched, the
    step's ms and live samples), then each of those kernels against its
    twin on the inputs the five steps gave it (K1 at 786,432 points in the
    cull, K2 / K4 at 393,216), reported as the path "flat train".
Each drive prints its PSNR per view, loop seconds, live samples and
samples/s, and the launches per kernel.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' launches (in all and per path), errors and times as
JSON, and the one before that the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
ROOT = Path(__file__).resolve().parent
AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
IMAGE = 128  # pixels per side of a request
N_VIEWS = 4
CHUNK = IMAGE * IMAGE  # one request is one chunk of 16,384 rays
# bench.py's eval configuration: 48 slots per ray before the cull, 24 after
SLICE_KW = dict(
    scene_aabb=AABB,
    render_step_size=5e-3,
    max_samples_per_ray=1024,
    coarse_stride=16,
    probe_dilation=2,
    probe_groups=32,
    compact_rays_fraction=0.75,
    exact_recheck=True,
    eval_samples_per_ray=48,
    eval_visible_samples_per_ray=24,
    visible_samples_budget=CHUNK * 24,
)
# slice shapes: 12,288 compacted rays x 64 march slots, 32 visible slots
R_SLICE, G_PROBE, K_SLOTS, K_VISIBLE = 12288, 32, 64, 32
B_SAMPLES = R_SLICE * K_SLOTS
GRID_CHUNK = 1 << 17  # samples per field call of update_grid

# Kernel vs plain twin on the card. The march kernels' integer outputs are
# exact (masks bit-equal); their t values keep the plain chain's f32
# operations, but PyTorch's scan sums in another order: 1e-5 relative.
# The CP kernel sums the same two exact products as the plain dense
# product, so it is expected bit-equal; 1e-6 absolute allows one rounding.
T_RTOL, T_ATOL = 1e-5, 1e-6
CP_ATOL = 1e-6
# Kernel render vs plain render. The plain render's CP level uses the JAX
# package's default numerics (bf16 features, where the kernel keeps f32).
# With this seed's random weights the features are small and the renders
# differ by ~2e-5; a bf16 step in a head's output moves a color by ~1e-3.
# Colors and opacities within 1e-3, depths (t ~ 1.5-4.5) within 3e-3.
RENDER_ATOL, DEPTH_ATOL = 1e-3, 3e-3
# Kernel render on the card vs the same path on the CPU: the same numerics,
# differing only in f32 summation order and the bf16 roundings it can
# flip: the same bounds.
# CP table gradients (K3, K4) vs their twins: both sum the same exact f32
# products over the batch, the kernels in atomic order, the twins in
# cuBLAS's. A sequential f32 sum of 786,432 such terms into 128 or 512 rows
# drifts ~2.5e-6 x max|dT| (a numpy simulation of that order): 1e-5 x
# max|dT| per table.
CP_GRAD_REL = 1e-5

# The training step: bench.py --mode train --grid trained --fused_march at
# full width, single-stage cull (bench.py:143-203, 276-311).
TRAIN_RAYS = 16384
TRAIN_STEPS = 5  # TensoCP steps
NGP_STEPS = 10
TRAIN_KW = dict(
    scene_aabb=AABB,
    render_step_size=5e-3,
    max_samples_per_ray=1024,
    coarse_stride=16,
    probe_dilation=2,
    probe_groups=32,
    compact_rays_fraction=0.75,
)
LR = 5e-4
CHECK_RAYS = 512  # the card-vs-CPU step
# Card vs CPU: the heads round f32 sums taken in another order to bf16,
# which can move a value by one bf16 step (2^-8 relative) and a density by
# exp of that: the loss within 1e-4 relative, each parameter's gradient
# within 1e-2 in L2 norm, grid occupancies within 5e-2 relative, and a
# binary cell may differ only within that band of the threshold.
TRAIN_LOSS_RTOL, TRAIN_GRAD_L2 = 1e-4, 1e-2
OCC_RTOL = 5e-2

# The hash-NGP step: bench.py --model ngp adds live-sample compaction of the
# field at half the sample budget (bench.py:208-212).
NGP_FIELD_BUDGET = TRAIN_RAYS * 48 // 2
NGP_LEVELS, NGP_LOG2_T = 16, 19
B_CORNERS = 8 * NGP_FIELD_BUDGET  # corners per level and step
GATHER_N = 262144  # K8: indices into one level's table
GATHER_LEVEL_N = 8 * 786432  # K8: one level's corners at 786,432 samples
# K4 at a grid size whose partial tables exceed a block's shared memory
K4_GLOBAL_SHAPE = dict(B=131072, G=1024, R=128)
# K7 vs index_add_: both sum the same f32 terms, the kernel in atomic
# order. A level's entry takes up to B / 4913 ~ 640 terms of order 1:
# 1e-5 x max|dT|, as for the CP gradients; the same against float64.
HASH_GRAD_REL = 1e-5
# Card vs CPU, NGP step: the heads are plain f32 and no bf16 rounding can
# flip; sums run in another order. Loss within 1e-5 relative, each
# gradient within 1e-3 in L2 norm.
NGP_LOSS_RTOL, NGP_GRAD_L2 = 1e-5, 1e-3
# The trainer's flagship drive (examples/train_ngp_nerf_torch.py): its
# seed and the held-out PSNR it must reach, the JAX package's regression
# line for this command (its own run reads 33.03; the port's runs read
# 33.54-34.18 over three seeds with and without kernels, PERF.md section 5).
TRAINER_SEED, TRAINER_PSNR_FLOOR = 42, 32.5
# The drives of the NGP, vanilla and D-NeRF trainers (their scripts' NGP /
# DRIVE flags, seed 42) and their floors: 20 for NGP and vanilla, the JAX
# package's regression lines (its runs read 23.41 and 22.4), and 26.0 for
# D-NeRF, 2.5 dB under the JAX package's single 28.5 as 20 sits 2.4 dB
# under vanilla's 22.4.
NGP_DRIVE_PSNR_FLOOR, MLP_PSNR_FLOOR, DNERF_PSNR_FLOOR = 20.0, 20.0, 26.0
# The unbounded drives (seed 42) and their floors: the proposal drives
# 2.5 dB under the JAX package's single runs (42.5 and 39.7), as D-NeRF's
# floor sits under its 28.5 (the 360 one on the plain paths, as the JAX
# script runs it); the grid-unbounded drive between the JAX package's
# collapse basin (12.8-15.8) and its weak seed (28.47; the others 35.52
# and 35.74).
PROPOSAL_PSNR_FLOOR, PROPOSAL360_PSNR_FLOOR, U360_PSNR_FLOOR = 40.0, 37.0, 25.0
# the 360 proposal drive's kernel path: steps trained to hold its kernels
# to their twins in training (no quality floor: ROADMAP.md Queue 3)
P360_KERNEL_STEPS = 200
# the grid-unbounded drive's lattice, auto-sized from [0.2, 1e4] at step
# 1e-2 and cone 0.004 (2,308 points plus a group of margin, in groups of
# 16)
U360_SAMPLES, U360_GROUPS = 2336, 146
# the trainer's kernels are held against their twins on the inputs the
# drive gave them: the first call at each shape, at most this many shapes
# per kernel
TRAINER_SHAPES_KEPT = 8
# the card's published peaks, for the least time a kernel could take
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs on a GPU")
    print(f"nvidia-smi: {smi_line()}")
    print(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}  count {torch.cuda.device_count()}")
    # the plain twins' f32 products run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def phase_build() -> None:
    from nerfacc_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{path.relative_to(ROOT)}")
    log = path.with_name(path.name + ".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")


def median_ms(fn, iters: int = 20, calls: int = 1) -> float:
    """Median of per-call times on the card, after a warm-up call. With
    ``calls`` above 1 each timed window holds that many calls back to
    back and is divided by the count, so the host's part of the first
    call is spread over them."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, iters: int = 20) -> float:
    """Per-call time on the card alone: ``calls`` calls of ``fn`` captured
    into one CUDA graph and replayed, so that no host work lies between
    the launches (a short kernel's wrapper costs the host more than the
    kernel costs the card). Median over ``iters`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return median_ms(graph.replay, iters) / calls


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the f32 operations over the peak rate outside the tensor cores."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def _sum_bounds(bounds) -> dict:
    """The bound of several launches timed together, named for the largest."""
    return dict(bound_ms=sum(b["bound_ms"] for b in bounds),
                bound_by=max(bounds, key=lambda b: b["bound_ms"])["bound_by"])


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _check_close(name, got, want, rtol, atol) -> float:
    err = _max_err(got, want)
    bad = (got.float() - want.float()).abs() > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} values outside rtol {rtol} / atol "
            f"{atol} (max abs err {err:.3e})"
        )
    return err


def _grads_err(label, got, want):
    """CP table gradients: the max abs error over the three tables, each
    held to CP_GRAD_REL of its twin's largest entry; and the largest such
    entry."""
    err, scale = 0.0, 0.0
    for a, (d, w) in enumerate(zip(got, want)):
        top = float(w.abs().max())
        err = max(err, _check_close(f"{label} dT{a}", d, w, 0.0,
                                    CP_GRAD_REL * top))
        scale = max(scale, top)
    return err, scale


def _check_equal(name, got, want) -> None:
    if not torch.equal(got, want):
        raise AssertionError(
            f"{name}: {int((got != want).sum())} entries differ (need equal)"
        )


def _scripts():
    """Make ``scripts/`` importable (its measurements are reused here)."""
    path = str(ROOT / "scripts")
    if path not in sys.path:
        sys.path.insert(0, path)


def print_host_cost(dev) -> None:
    """What one wrapper call costs the host (no speed check is made)."""
    _scripts()
    import bench_launch_torch

    cost = bench_launch_torch.host_cost(dev)
    print(f"host us per wrapper call: {bench_launch_torch.format_cost(cost)}")


def phase_kernels(dev: torch.device) -> list:
    from nerfacc_tpu_torch.ops import (
        cp_level_features,
        cp_level_features_plain,
    )

    rng = np.random.RandomState(SEED)
    report = []
    print_host_cost(dev)

    # K1: CP level features, both flagship levels
    xu_np = rng.rand(B_SAMPLES, 3).astype(np.float32)
    xu_np[:64] = 0.0  # u == 0 on every axis
    xu_np[64:128] = 1.0  # u == G - 1: the last node, one tap
    xu = torch.as_tensor(xu_np, device=dev)
    cp_ms = cp_plain_ms = cp_err = 0.0
    cp_bounds, cp_small = [], {}
    for g, r in ((128, 64), (512, 128)):
        tables = [
            torch.as_tensor(rng.randn(g, r).astype(np.float32) * 0.2,
                            device=dev)
            for _ in range(3)
        ]
        got = cp_level_features(xu, *tables)
        want = cp_level_features_plain(xu, *tables)
        torch.cuda.synchronize()
        err = _check_close(f"cp_level_features G={g} R={r}", got, want,
                           0.0, CP_ATOL)
        ms = median_ms(lambda: cp_level_features(xu, *tables))
        pms = median_ms(lambda: cp_level_features_plain(xu, *tables), 3)
        # reads xu and the tables, writes (B, R) f32; per output two taps
        # per axis (3 flop each) and two products
        b = bound(4 * (3 * B_SAMPLES + 3 * g * r + B_SAMPLES * r),
                  11 * B_SAMPLES * r)
        cp_bounds.append(b)
        print(f"K1 cp_level_features B={B_SAMPLES} G={g} R={r}: "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms  bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})  max_abs_err "
              f"{err:.3e}")
        cp_ms, cp_plain_ms, cp_err = cp_ms + ms, cp_plain_ms + pms, max(cp_err, err)
        # one chunk of update_grid: 131,072 samples
        xs = xu[:GRID_CHUNK].contiguous()
        _check_equal(f"cp_level_features B={GRID_CHUNK} G={g} R={r}",
                     cp_level_features(xs, *tables),
                     cp_level_features_plain(xs, *tables))
        sms = median_ms(lambda: cp_level_features(xs, *tables))
        # ten calls back to back: without the host's share of one call
        sms10 = median_ms(lambda: cp_level_features(xs, *tables), calls=10)
        sb = bound(4 * (3 * GRID_CHUNK + 3 * g * r + GRID_CHUNK * r),
                   11 * GRID_CHUNK * r)
        print(f"K1 cp_level_features B={GRID_CHUNK} G={g} R={r}: kernel "
              f"{sms:.4f} ms, ten calls back to back {sms10:.4f} ms per "
              f"call  bound {sb['bound_ms']:.4f} ms  bit-equal")
        cp_small[f"G={g} R={r}"] = dict(ms=sms, back_to_back_ms=sms10, **sb)
    report.append(dict(
        name="cp_level_features", route="cuda",
        source="nerfacc_tpu_torch/csrc/cp_encoder.cu",
        replaces="nerfacc_tpu/ops/cp_encoder.py:173",
        max_abs_err=cp_err, ms=cp_ms, plain_ms=cp_plain_ms,
        library_ms=None, **_sum_bounds(cp_bounds),
        at_grid_update_chunk={"n": GRID_CHUNK, **cp_small},
    ))
    report += check_cp_training_kernels(dev, rng, xu)

    report += check_march_kernels(dev, rng)
    report += check_hash_kernels(dev)
    return report


def _check_quad(name, got, want) -> float:
    """A march kernel's four outputs against the twin's: the mask
    bit-equal, the three t within T_RTOL / T_ATOL; the largest error."""
    _check_equal(f"{name} ok", got[3], want[3])
    return max(_check_close(f"{name} {n}", a, b, T_RTOL, T_ATOL)
               for n, a, b in zip(("ts", "te", "dt"), got[:3], want[:3]))


def _select_inputs(dev, rng, R, G, C):
    gsize = rng.randint(1, C + 1, size=(R, 1))
    live = rng.randint(0, C + 1, size=(R, G)) * (rng.rand(R, G) < 0.4)
    live = torch.as_tensor(np.minimum(live, gsize), dtype=torch.int32,
                           device=dev)
    gsize = torch.as_tensor(gsize, dtype=torch.int32, device=dev)
    t_min = torch.as_tensor(rng.rand(R).astype(np.float32) * 2.0 + 0.05,
                            device=dev)
    return live, gsize, t_min


def _reselect_inputs(dev, rng, R, K):
    masks = torch.as_tensor(rng.rand(R, K) < 0.5, device=dev)
    ts = torch.as_tensor(
        np.sort(rng.rand(R, K), axis=1).astype(np.float32) * 3.0, device=dev)
    dt = torch.as_tensor(
        (rng.rand(R, K) * 0.01 + 1e-3).astype(np.float32), device=dev)
    return masks, ts, ts + dt, dt


def check_march_kernels(dev, rng) -> list:
    """K5 and K6 against their twins: at the render's shapes (timed, one
    wrapper call between two events, ten calls back to back, which the
    host's share of a call still bounds, and twenty calls replayed from a
    CUDA graph, the card's time alone), then
    checked only at the training step's 48 slots, at 64 groups
    (``probe_groups=None``), at the evaluation's 48 -> 24 slots, at a K
    above 64, at an R that 4 does not divide, and at rows longer than the
    kernels hold at once (more than 512 groups, more than 128 output
    slots)."""
    from nerfacc_tpu_torch.ops import (
        fused_reselect,
        fused_reselect_plain,
        fused_select_grouped,
        fused_select_grouped_plain,
    )

    report = []
    # K5: grouped slot selection + lattice
    C = SLICE_KW["coarse_stride"]
    sel = {}
    for cone in (0.0, 0.004):
        args = _select_inputs(dev, rng, R_SLICE, G_PROBE, C)
        kw = dict(k_slots=K_SLOTS, step_size=5e-3, cone_angle=cone)
        got = fused_select_grouped(*args, **kw)
        want = fused_select_grouped_plain(*args, **kw)
        torch.cuda.synchronize()
        err = _check_quad(f"fused_select_grouped cone={cone}", got, want)
        ms = median_ms(lambda: fused_select_grouped(*args, **kw))
        ms10 = median_ms(lambda: fused_select_grouped(*args, **kw), calls=10)
        gms = graph_ms(lambda: fused_select_grouped(*args, **kw))
        pms = median_ms(lambda: fused_select_grouped_plain(*args, **kw))
        print(f"K5 fused_select_grouped R={R_SLICE} G={G_PROBE} K={K_SLOTS} "
              f"cone={cone}: kernel {ms:.4f} ms, ten calls back to back "
              f"{ms10:.4f} ms per call, replayed from a CUDA graph "
              f"{gms:.4f} ms per call  plain {pms:.4f} ms  "
              f"max_abs_err {err:.3e}")
        sel[cone] = dict(ms=ms, back_to_back_ms=ms10, graph_ms=gms,
                         plain_ms=pms, max_abs_err=err)
    other_err = 0.0
    for R, G, K, cone in ((R_SLICE, G_PROBE, 48, 0.004),
                          (R_SLICE, 64, K_SLOTS, 0.0),
                          (R_SLICE + 1, G_PROBE, K_SLOTS, 0.0),
                          (1001, 1100, 300, 0.0)):
        args = _select_inputs(dev, rng, R, G, C)
        kw = dict(k_slots=K, step_size=5e-3, cone_angle=cone)
        err = _check_quad(f"fused_select_grouped R={R} G={G} K={K}",
                          fused_select_grouped(*args, **kw),
                          fused_select_grouped_plain(*args, **kw))
        print(f"K5 fused_select_grouped R={R} G={G} K={K} cone={cone}: masks "
              f"bit-equal, max_abs_err {err:.3e}")
        other_err = max(other_err, err)
    # reads live (R, G) i32, the group size and t_min per ray; writes three
    # (R, K) f32 and the (R, K) bool; ~10 flop per slot (three lattice
    # points at cone 0)
    select_bound = bound(
        R_SLICE * (4 * G_PROBE + 8) + R_SLICE * K_SLOTS * 13,
        10 * R_SLICE * K_SLOTS)
    report.append(dict(
        name="fused_select_grouped", route="cuda",
        source="nerfacc_tpu_torch/csrc/march_select.cu",
        replaces="nerfacc_tpu/ops/march_select.py:136",
        **dict(sel[0.0], max_abs_err=max(
            other_err, *(v["max_abs_err"] for v in sel.values()))),
        library_ms=None, **select_bound,
    ))

    # K6: stage-2 re-selection
    args = _reselect_inputs(dev, rng, R_SLICE, K_SLOTS)
    got = fused_reselect(*args, k2=K_VISIBLE)
    want = fused_reselect_plain(*args, k2=K_VISIBLE)
    torch.cuda.synchronize()
    err = _check_quad("fused_reselect", got, want)
    ms = median_ms(lambda: fused_reselect(*args, k2=K_VISIBLE))
    ms10 = median_ms(lambda: fused_reselect(*args, k2=K_VISIBLE), calls=10)
    gms = graph_ms(lambda: fused_reselect(*args, k2=K_VISIBLE))
    pms = median_ms(lambda: fused_reselect_plain(*args, k2=K_VISIBLE))
    print(f"K6 fused_reselect R={R_SLICE} K={K_SLOTS} k2={K_VISIBLE}: "
          f"kernel {ms:.4f} ms, ten calls back to back {ms10:.4f} ms per "
          f"call, replayed from a CUDA graph {gms:.4f} ms per call  plain "
          f"{pms:.4f} ms  max_abs_err {err:.3e}")
    for R, K, K2 in ((R_SLICE, 48, 24), (R_SLICE, 80, 32),
                     (R_SLICE + 1, K_SLOTS, K_VISIBLE), (1001, 300, 200)):
        args_x = _reselect_inputs(dev, rng, R, K)
        got = fused_reselect(*args_x, k2=K2)
        want = fused_reselect_plain(*args_x, k2=K2)
        err_x = _check_quad(f"fused_reselect R={R} K={K} k2={K2}", got, want)
        # the gathered t are copies
        _check_equal(f"fused_reselect R={R} K={K} k2={K2} ts", got[0], want[0])
        _check_equal(f"fused_reselect R={R} K={K} k2={K2} te", got[1], want[1])
        print(f"K6 fused_reselect R={R} K={K} k2={K2}: masks and gathered t "
              f"bit-equal, max_abs_err {err_x:.3e}")
        err = max(err, err_x)
    report.append(dict(
        name="fused_reselect", route="cuda",
        source="nerfacc_tpu_torch/csrc/march_select.cu",
        replaces="nerfacc_tpu/ops/march_select.py:259",
        max_abs_err=err, ms=ms, back_to_back_ms=ms10, graph_ms=gms,
        plain_ms=pms,
        library_ms=None,
        # reads the (R, K) bool and three (R, K) f32; writes three (R, K2)
        # f32 and the (R, K2) bool; one add per source slot
        **bound(R_SLICE * 13 * (K_SLOTS + K_VISIBLE), R_SLICE * K_SLOTS),
    ))
    return report


def check_cp_training_kernels(dev, rng, xu) -> list:
    """K2, K3 and K4 against their twins at the training step's shapes:
    786,432 samples (with u == 0 and u == G - 1 on every axis), both
    levels, a random f32 cotangent; K3 (``check_k3``) also on points laid
    along rays and against its first kernel."""
    from nerfacc_tpu_torch.ops import (
        cp_grads_slice_width,
        cp_level_features,
        cp_level_features_res_fwd,
        cp_level_features_res_plain,
        cp_level_grads_res,
        cp_level_grads_res_plain,
    )

    acc = {k: [0.0, 0.0, 0.0] for k in ("K2", "K4")}  # ms, plain, err
    bounds = {k: [] for k in acc}
    xu_by_order = {"random": xu, "ray-ordered": ray_ordered_points(
        dev, B_SAMPLES // TRAIN_RAYS)}
    k3 = {}
    for g, r in ((128, 64), (512, 128)):
        tables = [
            torch.as_tensor(rng.randn(g, r).astype(np.float32) * 0.2,
                            device=dev)
            for _ in range(3)
        ]
        cot = torch.as_tensor(rng.randn(B_SAMPLES, r).astype(np.float32),
                              device=dev)
        shape = f"B={B_SAMPLES} G={g} R={r}"

        feats, us = cp_level_features_res_fwd(xu, *tables)
        want_feats, want_us = cp_level_features_res_plain(xu, *tables)
        torch.cuda.synchronize()
        _check_equal(f"K2 {shape} features vs K1",
                     feats, cp_level_features(xu, *tables))
        err = _check_close(f"K2 {shape} features", feats, want_feats, 0.0,
                           CP_ATOL)
        for a, (u, want) in enumerate(zip(us, want_us)):
            _check_equal(f"K2 {shape} residual {a}", u, want)
        timed = [(
            "K2", "cp_level_features_res", err,
            lambda: cp_level_features_res_fwd(xu, *tables),
            lambda: cp_level_features_res_plain(xu, *tables),
        )]

        k3[f"G={g} R={r}"] = check_k3(dev, xu_by_order, tables, cot)
        fn = lambda: cp_level_grads_res(xu, cot, *us, g)  # noqa: E731
        plain = lambda: cp_level_grads_res_plain(xu, cot, *us, g)  # noqa: E731
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err, scale = _grads_err(f"K4 {shape}", got, want)
        print(f"K4 cp_level_grads_res {shape}: max abs err {err:.3e} = "
              f"{err / scale:.2e} x max|dT| {scale:.3e}")
        timed.append(("K4", "cp_level_grads_res", err, fn, plain))
        del got, want

        for key, name, err, fn, plain in timed:
            ms = median_ms(fn)
            pms = median_ms(plain, 3)
            # K2 reads xu and the tables and writes (B, R) f32 plus three
            # (B, R) bf16; K4 reads xu, g and the three bf16 residuals.
            # ~11 flop per output (K2), ~21 per cotangent (K4: three axes x
            # (two products, two weighted adds) and roundings)
            nb = {"K2": 4 * (3 * B_SAMPLES + 3 * g * r) + 10 * B_SAMPLES * r,
                  "K4": 4 * (3 * B_SAMPLES + 3 * g * r) + 10 * B_SAMPLES * r,
                  }[key]
            b = bound(nb, (11 if key == "K2" else 21) * B_SAMPLES * r)
            bounds[key].append(b)
            route = ""
            if key == "K4":
                route = (f"  partial tables of {cp_grads_slice_width(g, r)} "
                         "features in shared memory")
            print(f"{key} {name} {shape}: kernel {ms:.4f} ms  plain "
                  f"{pms:.4f} ms  bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']})  max_abs_err {err:.3e}{route}")
            a = acc[key]
            a[0], a[1], a[2] = a[0] + ms, a[1] + pms, max(a[2], err)
        del feats, us, want_feats, want_us, timed
        torch.cuda.empty_cache()

    # K4 where its partial tables exceed shared memory: the global-atomic
    # kernel, chosen by shape (its time is not part of the K4 row)
    b, g, r = (K4_GLOBAL_SHAPE[k] for k in "BGR")
    if cp_grads_slice_width(g, r) != 0:
        raise AssertionError(f"K4 G={g} R={r} was to take the global route")
    tables = [
        torch.as_tensor(rng.randn(g, r).astype(np.float32) * 0.2, device=dev)
        for _ in range(3)
    ]
    cot = torch.as_tensor(rng.randn(b, r).astype(np.float32), device=dev)
    xs = xu[:b].contiguous()
    _, us = cp_level_features_res_fwd(xs, *tables)
    got = cp_level_grads_res(xs, cot, *us, g)
    want = cp_level_grads_res_plain(xs, cot, *us, g)
    torch.cuda.synchronize()
    err, scale = _grads_err(f"K4 global route G={g}", got, want)
    ms = median_ms(lambda: cp_level_grads_res(xs, cot, *us, g))
    print(f"K4 cp_level_grads_res B={b} G={g} R={r} (global atomics: "
          f"{3 * g * 32 * 4} bytes of tables for 32 features exceed a "
          f"block's shared memory): kernel {ms:.4f} ms  max abs err "
          f"{err:.3e} = {err / scale:.2e} x max|dT| {scale:.3e}")
    acc["K4"][2] = max(acc["K4"][2], err)
    del tables, cot, xs, us, got, want
    torch.cuda.empty_cache()

    names = {"K2": ("cp_level_features_res", 240),
             "K4": ("cp_level_grads_res", 274)}
    report = [
        dict(name=names[k][0], route="cuda",
             source="nerfacc_tpu_torch/csrc/cp_encoder.cu",
             replaces=f"nerfacc_tpu/ops/cp_encoder.py:{names[k][1]}",
             max_abs_err=acc[k][2], ms=acc[k][0], plain_ms=acc[k][1],
             library_ms=None, **_sum_bounds(bounds[k]))
        for k in ("K2", "K4")
    ]
    # K3: times of the two levels on random points, summed (one wrapper
    # call; replayed from a CUDA graph); each level and the ray-ordered
    # points beside them
    report.insert(1, dict(
        name="cp_level_grads", route="cuda",
        source="nerfacc_tpu_torch/csrc/cp_encoder.cu",
        replaces="nerfacc_tpu/ops/cp_encoder.py:198",
        max_abs_err=max(max(v["max_abs_err"],
                            v["on_ray_ordered_points"]["max_abs_err"])
                        for v in k3.values()),
        **{key: sum(v[key] for v in k3.values())
           for key in ("ms", "graph_ms", "first_kernel_ms",
                       "first_kernel_graph_ms", "plain_ms")},
        library_ms=None, **_sum_bounds([v for v in k3.values()]),
        by_level=k3,
    ))
    return report


def check_k3(dev, xu_by_order, tables, cot) -> dict:
    """K3 at one level against its twin and against the first kernel (the
    global-atomic one, launched through the C entry with slice width 0),
    on uniform random points and on points laid along rays; timed as one
    wrapper call (``ms``, as every kernel) and as twenty calls replayed
    from a CUDA graph (``graph_ms``, the card alone), the first kernel the
    same two ways in the same process."""
    from nerfacc_tpu_torch import _build
    from nerfacc_tpu_torch.ops import (
        cp_level_grads,
        cp_level_grads_plain,
        cp_level_grads_slice_width,
        cp_level_grads_staged,
    )
    from nerfacc_tpu_torch.ops.cp_encoder import _zero_grads

    g, r = tables[0].shape
    B = cot.shape[0]
    width = cp_level_grads_slice_width(g, r, B)
    staged = cp_level_grads_staged(g, width)
    if not width:
        route = "global atomics"
    elif staged:
        route = (f"slices of {width} features, tables and partial gradients "
                 "in shared memory")
    else:
        route = (f"slices of {width} features, partial gradients in shared "
                 "memory, tables through L1 / L2")
    # reads xu, the three tables and g, writes three (G, R) f32; ~21 flop
    # per cotangent (three axes x (two taps, two products) and roundings)
    b = bound(4 * (3 * B + 6 * g * r + B * r), 21 * B * r)
    rows = {}
    for label, x in xu_by_order.items():
        def first():
            grads, ptrs = _zero_grads(g, r, dev)
            _build.launch("cp_level_grads", "nerfacc_cp_level_grads", dev,
                          x.data_ptr(), *(t.data_ptr() for t in tables),
                          cot.data_ptr(), *ptrs, B, g, r, 0, 0)
            return grads

        got = cp_level_grads(x, *tables, cot)
        want = cp_level_grads_plain(x, *tables, cot)
        got_first = first()
        torch.cuda.synchronize()
        shape = f"B={B} G={g} R={r} {label} points"
        err, scale = _grads_err(f"K3 {shape}", got, want)
        ferr, _ = _grads_err(f"K3 first kernel {shape}", got_first, want)
        del got, got_first
        ms = median_ms(lambda: cp_level_grads(x, *tables, cot))
        fms = median_ms(first)
        gms = graph_ms(lambda: cp_level_grads(x, *tables, cot))
        fgms = graph_ms(first)
        pms = (median_ms(lambda: cp_level_grads_plain(x, *tables, cot), 3)
               if label == "random" else None)
        del want
        print(f"K3 cp_level_grads {shape}: kernel {ms:.4f} ms (first "
              f"kernel {fms:.4f} ms), replayed from a CUDA graph {gms:.4f} "
              f"ms per call (first kernel {fgms:.4f} ms, {fgms / gms:.2f}x)"
              + (f"  plain {pms:.4f} ms" if pms is not None else "")
              + f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
              f"{b['bound_ms'] / gms:.0%} of the graph time)  max abs err "
              f"{err:.3e} = {err / scale:.2e} x max|dT| {scale:.3e} (first "
              f"kernel {ferr / scale:.2e})  route: {route}")
        rows[label] = dict(ms=ms, graph_ms=gms, first_kernel_ms=fms,
                           first_kernel_graph_ms=fgms, plain_ms=pms,
                           max_abs_err=err, route=route)
    torch.cuda.empty_cache()
    return dict(rows["random"], **b, on_ray_ordered_points=rows["ray-ordered"])


def check_hash_kernels(dev) -> list:
    """K7 against its twin and a float64 ``index_add_`` at the NGP step's
    shape, for every level of the reference field (points uniform in the
    unit cube, so levels 0-4 are dense with few entries and 5-15 hashed
    over 2^19; every 17th index -1); then K8 (``check_table_gather``)."""
    from nerfacc_tpu_torch.models import hash_grid_indices
    from nerfacc_tpu_torch.models.hash_encoding import _level_resolutions
    from nerfacc_tpu_torch.ops import (
        hash_grad_scatter,
        hash_grad_scatter_plain,
    )

    rng = np.random.RandomState(SEED + 2)
    T = 1 << NGP_LOG2_T
    res = _level_resolutions(NGP_LEVELS, 16, 1.4472692012786865)
    dense = (res + 1) ** 3 <= T
    x = torch.as_tensor(rng.rand(NGP_FIELD_BUDGET, 3).astype(np.float32),
                        device=dev)
    flat_idx, _ = hash_grid_indices(
        x, torch.as_tensor(res, device=dev), torch.as_tensor(dense, device=dev),
        T)
    v = torch.as_tensor(rng.randn(B_CORNERS, 2).astype(np.float32),
                        device=dev)
    out = torch.empty((T, 2), dtype=torch.float32, device=dev)
    acc = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, max_abs_err=0.0)
    # reads idx (B,) i32 and v (B, 2) f32, writes the (T, 2) f32 table; two
    # adds per corner
    level_bound = bound(12 * B_CORNERS + 8 * T, 2 * B_CORNERS)
    for level in range(NGP_LEVELS):
        sl = slice(level * 8, level * 8 + 8)
        idx = (flat_idx[:, sl] - level * T).reshape(-1).contiguous()
        idx[::17] = -1
        # the library call gets the live rows only: index_add_ cannot skip,
        # and dead rows sent to one entry would collide there
        live = idx >= 0
        idx_lib, v_lib = idx[live].long(), v[live]
        got = hash_grad_scatter(idx, v, T)
        want = hash_grad_scatter_plain(idx, v, T)
        want64 = torch.zeros((T, 2), dtype=torch.float64, device=dev)
        want64.index_add_(0, idx_lib, v_lib.double())
        torch.cuda.synchronize()
        scale = float(want64.abs().max())
        tol = HASH_GRAD_REL * scale
        err = _check_close(f"K7 level {level} vs twin", got, want, 0.0, tol)
        err64 = _check_close(f"K7 level {level} vs float64", got.double(),
                             want64, 0.0, tol)
        del want64
        ms = median_ms(lambda: hash_grad_scatter(idx, v, T))
        pms = median_ms(lambda: hash_grad_scatter_plain(idx, v, T), 3)
        lms = median_ms(lambda: out.zero_().index_add_(0, idx_lib, v_lib))
        n_entries = int((res[level] + 1) ** 3) if dense[level] else T
        print(f"K7 hash_grad_scatter level {level} "
              f"({'dense' if dense[level] else 'hashed'}, res {res[level]}, "
              f"{n_entries} entries) B={B_CORNERS}: kernel {ms:.4f} ms  plain "
              f"{pms:.4f} ms  index_add_ {lms:.4f} ms  bound "
              f"{level_bound['bound_ms']:.4f} ms  max abs err {err:.3e} = "
              f"{err / scale:.2e} x max|dT| {scale:.3e} (vs float64 "
              f"{err64 / scale:.2e})")
        acc["ms"] += ms
        acc["plain_ms"] += pms
        acc["library_ms"] += lms
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
    del v, out
    torch.cuda.empty_cache()
    report = [dict(
        name="hash_grad_scatter", route="cuda",
        source="nerfacc_tpu_torch/csrc/hash_scatter.cu",
        replaces="nerfacc_tpu/ops/hash_gather.py:123",
        **acc, **_sum_bounds([level_bound] * NGP_LEVELS),
    )]
    print(f"K7 hash_grad_scatter, {NGP_LEVELS} levels: kernel "
          f"{acc['ms']:.4f} ms  plain {acc['plain_ms']:.4f} ms  index_add_ "
          f"{acc['library_ms']:.4f} ms  bound "
          f"{report[0]['bound_ms']:.4f} ms")
    del flat_idx
    report.append(check_hash_levels(dev, rng, x, res, dense, T))

    report.append(check_table_gather(dev, rng, T))
    return report


def ray_ordered_points(dev, per_ray=NGP_FIELD_BUDGET // TRAIN_RAYS):
    """TRAIN_RAYS x per_ray points (24: NGP_FIELD_BUDGET) in the order the
    training steps feed their fields: the rays of bench.py's stream in
    batch order, on each ray ``per_ray`` consecutive samples front to
    back, a march step (5e-3) apart from a random start, mapped into the
    unit cube of the scene's box and clipped. (The step's own samples have
    gaps where the grid is empty.)"""
    o, d, _ = bench_stream(dev, 1)
    rng = np.random.RandomState(SEED + 3)
    t0 = torch.as_tensor(rng.rand(TRAIN_RAYS).astype(np.float32), device=dev)
    t = t0[:, None] + TRAIN_KW["render_step_size"] * torch.arange(
        per_ray, dtype=torch.float32, device=dev)
    x = o[0][:, None, :] + t[..., None] * d[0][:, None, :]
    lo = torch.tensor(AABB[:3], device=dev)
    hi = torch.tensor(AABB[3:], device=dev)
    return ((x - lo) / (hi - lo)).clamp(0.0, 1.0).reshape(-1, 3)


def _index_add_loop(flat_idx, corner_w, g, T):
    """The table gradient through one ``index_add_`` per level on inputs
    made ready beforehand, the rows outside their level dropped (the
    library's time for what K7 computes in one launch); returns the timed
    function."""
    N, L = flat_idx.shape[0], flat_idx.shape[1] // 8
    gl = g.reshape(N, 2, L).permute(0, 2, 1)
    ready = []
    for level in range(L):
        sl = slice(level * 8, level * 8 + 8)
        idx = (flat_idx[:, sl] - level * T).reshape(-1).long()
        live = (idx >= 0) & (idx < T)  # index_add_ cannot skip the others
        v = (corner_w[:, sl, None] * gl[:, level, None, :]).reshape(-1, 2)
        ready.append((idx[live], v[live]))
    out = torch.empty((L, T, 2), dtype=torch.float32, device=g.device)

    def run():
        out.zero_()
        for level, (idx, v) in enumerate(ready):
            out[level].index_add_(0, idx, v)
        return out

    return run


def check_hash_levels(dev, rng, x_random, res, dense, T) -> dict:
    """K7's one-launch entry against its twin and a float64 ``index_add_``
    at the NGP step's shape (393,216 samples x 16 levels), on uniform
    random points, which have no runs of equal indices, and on points laid
    along rays as the step feeds them; every 17th sample's indices of one
    level are -1 and every 29th sample's cotangent is zero. The entry in
    the report is the ray-ordered case; the random one stands beside it."""
    from nerfacc_tpu_torch.models import hash_grid_indices
    from nerfacc_tpu_torch.ops import (
        hash_grad_scatter_levels,
        hash_grad_scatter_levels_plain,
    )
    from nerfacc_tpu_torch.ops.hash_gather import SCATTER_RUN_LENGTH

    N, L = NGP_FIELD_BUDGET, NGP_LEVELS
    g = torch.as_tensor(rng.randn(N, 2 * L).astype(np.float32), device=dev)
    g[5::29] = 0.0
    # reads flat_idx and corner_w (N, 8 L) and g (N, 2 L), writes the
    # (L, T, 2) table; per corner two products and two adds
    b = bound(4 * N * (16 * L + 2 * L) + 8 * L * T, 4 * 8 * L * N)
    d_table = torch.empty((L, T, 2), dtype=torch.float32, device=dev)
    rows = {}
    for label, x in (("random", x_random), ("ray-ordered",
                                            ray_ordered_points(dev))):
        flat_idx, corner_w = hash_grid_indices(
            x, torch.as_tensor(res, device=dev),
            torch.as_tensor(dense, device=dev), T)
        flat_idx[::17, 40:48] = -1  # level 5 of every 17th sample: skipped
        got = hash_grad_scatter_levels(flat_idx, corner_w, g,
                                       d_table.zero_()).clone()
        want = hash_grad_scatter_levels_plain(
            flat_idx, corner_w, g, torch.zeros_like(d_table))
        want64 = hash_grad_scatter_levels_plain(
            flat_idx, corner_w.double(), g.double(),
            torch.zeros((L, T, 2), dtype=torch.float64, device=dev))
        torch.cuda.synchronize()
        scale = float(want64.abs().max())
        tol = HASH_GRAD_REL * scale
        err = _check_close(f"K7 levels {label} vs twin", got, want, 0.0, tol)
        err64 = _check_close(f"K7 levels {label} vs float64", got.double(),
                             want64, 0.0, tol)
        del want64
        # atomic adds the kernel makes: a corner starts a new sum where
        # its index differs from the sample before or a run begins
        changed = flat_idx[1:] != flat_idx[:-1]
        starts = torch.arange(1, N, device=dev) % SCATTER_RUN_LENGTH == 0
        adds = int((changed | starts[:, None]).sum()) + 8 * L
        ms = median_ms(lambda: hash_grad_scatter_levels(
            flat_idx, corner_w, g, d_table))
        pms = median_ms(lambda: hash_grad_scatter_levels_plain(
            flat_idx, corner_w, g, d_table), 3)
        lms = median_ms(_index_add_loop(flat_idx, corner_w, g, T), 5)
        print(f"K7 hash_grad_scatter_levels {label} points N={N} L={L} "
              f"T={T}: kernel {ms:.4f} ms  plain {pms:.4f} ms  index_add_ "
              f"loop {lms:.4f} ms  bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})  {adds} adds for {8 * L * N} corners "
              f"({adds / (8 * L * N):.3f})  max abs err {err:.3e} = "
              f"{err / scale:.2e} x max|dT| {scale:.3e} (vs float64 "
              f"{err64 / scale:.2e})")
        rows[label] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                           max_abs_err=err, adds_per_corner=adds / (8 * L * N))
        del flat_idx, corner_w, got, want
        torch.cuda.empty_cache()
    return dict(
        name="hash_grad_scatter_levels", route="cuda",
        source="nerfacc_tpu_torch/csrc/hash_scatter.cu",
        replaces="nerfacc_tpu/ops/hash_gather.py:433",
        **rows["ray-ordered"], **b, on_random_points=rows["random"],
    )


def check_table_gather(dev, rng, T) -> dict:
    """K8 against ``table[idx]``, bit-equal: at the script's 262,144
    indices and at one level's 6,291,456 (both timed), and at a length
    that 4 does not divide through views 4, 8 and 12 bytes off a 16-byte
    boundary (the word-by-word kernel)."""
    from nerfacc_tpu_torch.ops import table_gather, table_gather_plain

    table = torch.as_tensor(rng.randint(0, 2 ** 31, T).astype(np.int32),
                            device=dev)
    rows = {}
    for n in (GATHER_N, GATHER_LEVEL_N):
        # three spare words for the views that start off the boundary
        store = torch.as_tensor(rng.randint(0, T, n + 3).astype(np.int32),
                                device=dev)
        idx = store[:n]
        idx_long = idx.long()
        got = table_gather(idx, table)
        torch.cuda.synchronize()
        _check_equal(f"K8 table_gather N={n}", got,
                     table_gather_plain(idx, table))
        for offset in (1, 2, 3):
            view = store[offset:offset + n - 1]  # 4 does not divide n - 1
            if view.data_ptr() % 16 != 4 * offset:
                raise AssertionError("the view was to be off the boundary")
            _check_equal(f"K8 table_gather N={n - 1} at +{4 * offset} bytes",
                         table_gather(view, table),
                         table_gather_plain(view, table))
        _check_equal(f"K8 table_gather N={n - 1}",
                     table_gather(store[:n - 1], table),
                     table_gather_plain(store[:n - 1], table))
        off = store[1:n + 1]
        ms = median_ms(lambda: table_gather(idx, table))
        wms = median_ms(lambda: table_gather(off, table))
        pms = median_ms(lambda: table_gather_plain(idx, table))
        lms = median_ms(lambda: table[idx_long])
        # ten calls back to back: the card's time without the host's share
        ms10 = median_ms(lambda: table_gather(idx, table), calls=10)
        lms10 = median_ms(lambda: table[idx_long], calls=10)
        # reads the indices and the table, writes the words; no arithmetic
        b = bound(4 * (2 * n + T), 0)
        # every gathered word moves a 32-byte sector out of L2
        sector_rate = 32 * n / (ms10 * 1e-3)
        print(f"K8 table_gather N={n} T={T}: kernel {ms:.4f} ms = "
              f"{ms * 1e6 / n:.4f} ns/idx  off the boundary (word by word) "
              f"{wms:.4f} ms  plain {pms:.4f} ms  table[idx] {lms:.4f} ms = "
              f"{lms * 1e6 / n:.4f} ns/idx  ten calls back to back: kernel "
              f"{ms10:.4f} ms ({sector_rate / 1e12:.3f} TB/s of 32-byte L2 "
              f"sectors)  table[idx] {lms10:.4f} ms per call  bound "
              f"{b['bound_ms']:.5f} ms  bit-equal, views and N={n - 1} too")
        rows[n] = dict(ms=ms, word_ms=wms, plain_ms=pms, library_ms=lms,
                       back_to_back_ms=ms10, library_back_to_back_ms=lms10,
                       sector_bytes_per_s=sector_rate, **b)
        del store, idx, idx_long, got, off
    small, level = rows[GATHER_N], rows[GATHER_LEVEL_N]
    return dict(
        name="table_gather", route="cuda",
        source="nerfacc_tpu_torch/csrc/table_gather.cu",
        replaces="scripts/bench_hash.py:379",
        max_abs_err=0.0, **small,
        at_level_size={"n": GATHER_LEVEL_N, **level},
    )


def make_requests(dev: torch.device) -> list:
    """Four 128x128 views of the procedural scene: (origins, directions)."""
    from nerfacc_tpu_torch.datasets import generate_rays, look_at_poses

    poses = look_at_poses(N_VIEWS, radius=3.2, elevation_deg=20.0,
                          device=dev)
    focal = 0.5 * IMAGE / np.tan(0.5 * np.deg2rad(45.0))
    K = torch.tensor([[focal, 0, IMAGE / 2], [0, focal, IMAGE / 2],
                      [0, 0, 1]], dtype=torch.float32, device=dev)
    y, x = torch.meshgrid(torch.arange(IMAGE, device=dev),
                          torch.arange(IMAGE, device=dev), indexing="ij")
    out = []
    for pose in poses:
        rays = generate_rays(x.reshape(-1), y.reshape(-1), pose, K)
        out.append((rays.origins.contiguous(), rays.viewdirs.contiguous()))
    return out


def make_scene(dev: torch.device, use_kernel: bool):
    from nerfacc_tpu_torch.convert import grid_from_arrays
    from nerfacc_tpu_torch.models import TensoCPRadianceField

    field = TensoCPRadianceField(
        aabb=AABB, use_kernel=use_kernel,
        generator=torch.Generator().manual_seed(SEED), device=dev,
    )
    asset = np.load(ROOT / "bench_assets" / "trained_grid.npz")
    grid = grid_from_arrays(AABB, asset["binary"], asset["occs"], device=dev)
    return field, grid


def _render(field, grid, o, d, use_pallas, chunk=CHUNK):
    from nerfacc_tpu_torch import render_image

    kw = dict(SLICE_KW, visible_samples_budget=chunk * 24)
    return render_image(
        field, o, d, grid=grid, use_pallas=use_pallas,
        render_bkgd=torch.ones(3, device=o.device), test_chunk_size=chunk,
        **kw,
    )


def _live_samples(field, grid, o, d, use_pallas) -> int:
    from nerfacc_tpu_torch import render_rays

    kw = {k: v for k, v in SLICE_KW.items() if not k.startswith("eval_")}
    with torch.no_grad():
        *_, n = render_rays(
            field, o, d, grid=grid, use_pallas=use_pallas,
            samples_budget=CHUNK * SLICE_KW["eval_samples_per_ray"], **kw,
        )
    return int(n)


def _serve(field, grid, requests, use_pallas, render=_render):
    """Render every request through ``render(field, grid, o, d,
    use_pallas)``; per-request wall time on the host clock."""
    outs, ms = [], []
    for o, d in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(render(field, grid, o, d, use_pallas))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def _check_outputs(name, colors, opacities, depths, n) -> None:
    for what, t, width in (("colors", colors, 3), ("opacities", opacities, 1),
                           ("depths", depths, 1)):
        if tuple(t.shape) != (n, width):
            raise AssertionError(f"{name} {what}: shape {tuple(t.shape)}")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} {what}: non-finite values")
    if not bool(((opacities >= 0) & (opacities <= 1 + 1e-6)).all()):
        raise AssertionError(f"{name}: opacities outside [0, 1]")


def kernel_counters() -> dict:
    """Every kernel wrapper by name: each counts its own launches."""
    from nerfacc_tpu_torch import ops

    return {name: getattr(ops, name) for name in (
        "cp_level_features", "cp_level_features_res", "cp_level_grads",
        "cp_level_grads_res", "fused_select_grouped", "fused_reselect",
        "hash_grad_scatter", "hash_grad_scatter_levels", "table_gather")}


def drive(path: str, fn, must_launch, must_not_launch=()):
    """Run ``fn`` with every launch count set to 0 just before and read
    just after; fail unless each kernel of ``must_launch`` launched and
    none of ``must_not_launch`` did. Returns ``(fn's result, counts)``."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: c.launches for name, c in counters.items()}
    print(f"launches in {path}: {counts}")
    for name in must_launch:
        if counts[name] < 1:
            raise AssertionError(f"{path}: {name} never launched")
    for name in must_not_launch:
        if counts[name]:
            raise AssertionError(f"{path}: {name} launched {counts[name]} "
                                 "times (expected none)")
    return out, counts


def phase_slice(dev: torch.device) -> dict:
    """The render path; returns its launch counts."""
    from nerfacc_tpu_torch import render_rays

    requests = make_requests(dev)
    field, grid = make_scene(dev, use_kernel=True)
    plain_field, _ = make_scene(dev, use_kernel=False)
    plain_field.load_state_dict(field.state_dict())

    # the march through the kernel vs the unfused march, before any cull
    o, d = requests[0]
    kw = {k: v for k, v in SLICE_KW.items() if not k.startswith("eval_")}
    kw.update(samples_budget=CHUNK * 48, prefilter_sigma=False,
              return_extras=True)
    with torch.no_grad():
        seg_k = render_rays(field, o, d, grid=grid, use_pallas=True, **kw)[4]
        seg_p = render_rays(field, o, d, grid=grid, use_pallas=False, **kw)[4]
    _check_equal("march masks (kernel vs unfused)", seg_k["masks"],
                 seg_p["masks"])
    for n in ("t_starts", "t_ends", "deltas"):
        _check_close(f"march {n}", seg_k[n], seg_p[n], T_RTOL, T_ATOL)
    print(f"march: masks bit-equal, {int(seg_k['masks'].sum())} live slots "
          f"of {seg_k['masks'].numel()}")

    # warm-up: every request once on both paths (the caching allocator
    # grows on first use)
    _serve(field, grid, requests, True)
    _serve(plain_field, grid, requests, False)
    # no gradient is taken: the training kernels K2-K4 must not run
    (outs, ms), launches = drive(
        f"the render of {N_VIEWS} requests",
        lambda: _serve(field, grid, requests, True),
        ("cp_level_features", "fused_select_grouped", "fused_reselect"),
        ("cp_level_features_res", "cp_level_grads", "cp_level_grads_res",
         "hash_grad_scatter", "hash_grad_scatter_levels", "table_gather"),
    )
    plain_outs, plain_ms = _serve(plain_field, grid, requests, False)

    for i, ((o, d), out, pout) in enumerate(zip(requests, outs, plain_outs)):
        _check_outputs(f"request {i}", *out, CHUNK)
        _check_outputs(f"plain request {i}", *pout, CHUNK)
        errs = [
            _check_close(f"request {i} {n} vs plain", a, b, 0.0, tol)
            for n, a, b, tol in zip(
                ("colors", "opacities", "depths"), out, pout,
                (RENDER_ATOL, RENDER_ATOL, DEPTH_ATOL))
        ]
        live = _live_samples(field, grid, o, d, True)
        plive = _live_samples(plain_field, grid, o, d, False)
        print(f"request {i}: kernels {ms[i]:.2f} ms "
              f"({CHUNK / ms[i] * 1e3:.0f} rays/s, {live} live samples)  "
              f"plain {plain_ms[i]:.2f} ms "
              f"({CHUNK / plain_ms[i] * 1e3:.0f} rays/s, {plive} live "
              f"samples)  max abs diff colors {errs[0]:.2e} opacities "
              f"{errs[1]:.2e} depths {errs[2]:.2e}  mean opacity "
              f"{float(out[1].mean()):.4f}")
    print(f"latency median: kernels {statistics.median(ms):.2f} ms  plain "
          f"{statistics.median(plain_ms):.2f} ms")

    # a 16x16 crop at the image centre, on the card vs on the CPU
    rows = torch.arange(IMAGE // 2 - 8, IMAGE // 2 + 8)
    crop = (rows[:, None] * IMAGE + rows[None]).reshape(-1)
    o, d = (t[crop.to(dev)] for t in requests[0])
    cuda_out = _render(field, grid, o, d, True, chunk=crop.numel())
    cpu = torch.device("cpu")
    cpu_field, cpu_grid = make_scene(cpu, use_kernel=True)
    cpu_out = _render(cpu_field, cpu_grid, o.cpu(), d.cpu(), True,
                      chunk=crop.numel())
    errs = [
        _check_close(f"crop {n} card vs CPU", a.cpu(), b, 0.0, tol)
        for n, a, b, tol in zip(("colors", "opacities", "depths"), cuda_out,
                                cpu_out, (RENDER_ATOL, RENDER_ATOL,
                                          DEPTH_ATOL))
    ]
    print(f"crop 16x16 card vs CPU: max abs diff colors {errs[0]:.2e} "
          f"opacities {errs[1]:.2e} depths {errs[2]:.2e}")
    return launches


def bench_stream(dev, n_batches: int):
    """bench.py's train-mode rays and pixels (RandomState(0)): origins
    uniform in [-1, 1]^3, normalised Gaussian directions, uniform pixels;
    each (n_batches, TRAIN_RAYS, 3) f32 on ``dev``."""
    r = np.random.RandomState(0)
    shape = (n_batches, TRAIN_RAYS, 3)
    o = (r.rand(*shape) * 2 - 1).astype(np.float32)
    d = r.randn(*shape).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    px = r.rand(*shape).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (o, d, px)]


def _train_kw(use_kernels: bool, n_rays: int) -> dict:
    return dict(TRAIN_KW, samples_budget=n_rays * 48, use_pallas=use_kernels)


def _rel_l2(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def check_train_card_vs_cpu(dev, step, o, d, px, label="train step") -> None:
    """One step of CHECK_RAYS rays on the card (kernels) and on the CPU
    (the same path, plain twins), from the same weights: ``step(field,
    opt, grid, o, d, px) -> (loss, live samples)``."""
    results = []
    for device in (dev, torch.device("cpu")):
        field, grid = make_scene(device, use_kernel=True)
        opt = torch.optim.Adam(field.parameters(), lr=LR)
        loss, n = step(field, opt, grid, o.to(device), d.to(device),
                       px.to(device))
        grads = {k: p.grad.cpu() for k, p in field.named_parameters()}
        results.append((float(loss), int(n), grads))
    (loss_c, n_c, g_c), (loss_h, n_h, g_h) = results
    rel = abs(loss_c - loss_h) / loss_h
    worst = max((_rel_l2(g_c[k], g_h[k]), k) for k in g_h)
    print(f"{label} card vs CPU ({CHECK_RAYS} rays): loss {loss_c:.7f} vs "
          f"{loss_h:.7f} (rel {rel:.2e}); live samples {n_c} vs {n_h}; "
          f"worst gradient rel L2 err {worst[0]:.2e} ({worst[1]})")
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{label} loss card vs CPU: rel err {rel:.2e}")
    if worst[0] > TRAIN_GRAD_L2:
        raise AssertionError(f"{label}: gradient {worst[1]} card vs CPU: rel "
                             f"L2 err {worst[0]:.2e}")
    if abs(n_c - n_h) > max(2, n_h // 1000):
        raise AssertionError(f"{label}: live samples card {n_c} vs CPU {n_h}")


def _timed_steps(field, opt, grid, batches, kw, step):
    """Train on each (o, d, px) batch through ``step(field, opt, grid, o,
    d, px, **kw)``; per step: host ms ending in a synchronize, loss, live
    samples and the kernels' launches."""
    counters = kernel_counters()
    rec = []
    for o, d, px in batches:
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, n = step(field, opt, grid, o, d, px, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec.append((ms, float(loss), int(n), {
            k: c.launches - before[k] for k, c in counters.items()}))
    return rec


def _check_finite_params(name, field) -> None:
    for k, p in field.named_parameters():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{name}: parameter {k} is not finite")


def phase_train(dev) -> dict:
    """The training step at full width, its plain twin, and the grid
    update; returns the launch counts of each path."""
    from nerfacc_tpu_torch import train_step

    paths = {}
    o, d, px = bench_stream(dev, TRAIN_STEPS + 1)
    check_train_card_vs_cpu(
        dev, lambda *a: train_step(*a, **_train_kw(True, CHECK_RAYS)),
        o[0, :CHECK_RAYS], d[0, :CHECK_RAYS], px[0, :CHECK_RAYS])

    field, grid = make_scene(dev, use_kernel=True)
    opt = torch.optim.Adam(field.parameters(), lr=LR)
    kw = _train_kw(True, TRAIN_RAYS)
    batch = [(o[i], d[i], px[i]) for i in range(TRAIN_STEPS + 1)]
    _timed_steps(field, opt, grid, batch[:1], kw, train_step)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    rec, paths["train"] = drive(
        f"{TRAIN_STEPS} training steps",
        lambda: _timed_steps(field, opt, grid, batch[1:], kw, train_step),
        ("cp_level_features_res", "cp_level_grads_res",
         "fused_select_grouped"),
        ("cp_level_features", "cp_level_grads", "fused_reselect",
         "hash_grad_scatter", "hash_grad_scatter_levels", "table_gather"),
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {"cp_level_features_res": 2, "cp_level_grads_res": 2,
                "fused_select_grouped": 1}
    for i, (ms, loss, n, counts) in enumerate(rec):
        if not np.isfinite(loss):
            raise AssertionError(f"train step {i}: loss {loss}")
        for k, want in per_step.items():
            if counts[k] != want:
                raise AssertionError(f"train step {i}: {k} launched "
                                     f"{counts[k]} times, expected {want}")
    _check_finite_params("training", field)
    ms = [r[0] for r in rec]
    live = [r[2] for r in rec]
    print(f"train steps (kernels, {TRAIN_RAYS} rays): losses "
          f"{[round(r[1], 6) for r in rec]}")
    print(f"train step (kernels): median {statistics.median(ms):.3f} ms "
          f"(min {min(ms):.3f}, max {max(ms):.3f}); live samples per step "
          f"median {statistics.median(live)}; "
          f"{sum(live) / sum(ms) * 1e3:.0f} samples/s; peak memory "
          f"{peak_gb:.2f} GB")

    # a repeated batch: the loss after TRAIN_STEPS steps is below step 0's
    losses = [r[1] for r in _timed_steps(
        field, opt, grid, batch[:1] * (TRAIN_STEPS + 1), kw, train_step)]
    print(f"repeated batch: loss {losses[0]:.7f} -> {losses[-1]:.7f} after "
          f"{TRAIN_STEPS} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on a repeated batch")

    # the plain twin of the whole step: no kernel at all
    pfield, _ = make_scene(dev, use_kernel=False)
    popt = torch.optim.Adam(pfield.parameters(), lr=LR)
    pkw = _train_kw(False, TRAIN_RAYS)
    _timed_steps(pfield, popt, grid, batch[:1], pkw, train_step)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    prec, _ = drive("plain training steps",
                    lambda: _timed_steps(pfield, popt, grid, batch[1:4], pkw,
                                         train_step),
                    (), tuple(kernel_counters()))
    _check_finite_params("plain training", pfield)
    pms = [r[0] for r in prec]
    print(f"train step (plain): median {statistics.median(pms):.3f} ms over "
          f"{len(pms)} steps; live samples {[r[2] for r in prec]}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    paths.update(phase_grid_update(dev, field, grid))
    return paths


def phase_grid_update(dev, field, grid) -> dict:
    """update_grid on the trained-grid state, warm-up path (every cell) and
    sampled path (1/4 uniform + 1/4 occupied); then the card against the
    CPU on a 32^3 grid with the same cells and jitter."""
    from nerfacc_tpu_torch import update_grid
    from nerfacc_tpu_torch.convert import grid_from_arrays
    from nerfacc_tpu_torch.grid import _update_grid_at

    step_size = TRAIN_KW["render_step_size"]

    def occ_fn(model):
        return lambda x: model.query_density(x) * step_size

    paths = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, step in (("warm-up", 0), ("sampled", 10**9)):
        t0 = time.perf_counter()
        new, counts = drive(
            f"update_grid ({name})",
            lambda: update_grid(grid, gen, step, occ_fn(field), occ_thre=1e-2,
                                ema_decay=0.95),
            ("cp_level_features",),
            tuple(k for k in kernel_counters() if k != "cp_level_features"),
        )
        ms = (time.perf_counter() - t0) * 1e3
        paths[f"update_grid {name}"] = counts
        if not bool(torch.isfinite(new.occs).all()):
            raise AssertionError(f"update_grid ({name}): non-finite occs")
        print(f"update_grid ({name}, {grid.num_cells} cells): occupied "
              f"{float(new.binary.float().mean()):.4f} (before "
              f"{float(grid.binary.float().mean()):.4f}); K1 launches "
              f"{counts['cp_level_features']}; {ms:.1f} ms")

    # 32^3: the trained grid max-pooled 4x4x4, the same cells and jitter
    asset = np.load(ROOT / "bench_assets" / "trained_grid.npz")
    binary = asset["binary"].reshape(32, 4, 32, 4, 32, 4).any(axis=(1, 3, 5))
    occs = asset["occs"].reshape(32, 4, 32, 4, 32, 4).max(axis=(1, 3, 5))
    cpu_field, _ = make_scene(torch.device("cpu"), use_kernel=True)
    cpu_field.load_state_dict(field.state_dict())
    rng = np.random.RandomState(SEED)
    n = binary.size
    occupied = np.flatnonzero(binary)
    for name, idx in (
        ("warm-up", np.arange(n)),
        ("sampled", np.concatenate([rng.randint(0, n, n // 4),
                                    rng.choice(occupied, n // 4)])),
    ):
        jitter = rng.rand(idx.size, 3).astype(np.float32)
        out = []
        for device, model in ((dev, field), (torch.device("cpu"), cpu_field)):
            g32 = grid_from_arrays(AABB, binary, occs, device=device)
            out.append(_update_grid_at(
                g32, torch.as_tensor(idx, device=device),
                torch.as_tensor(jitter, device=device), occ_fn(model),
                occ_thre=1e-2, ema_decay=0.95, adaptive_thre=True))
        card, cpu = out
        occ_c, occ_h = card.occs.cpu(), cpu.occs
        rel = float(((occ_c - occ_h).abs() / occ_h.abs().clamp(min=1e-30))
                    .max())
        thre = min(float(occ_h.mean()), 1e-2)
        flips = (card.binary.cpu() != cpu.binary).reshape(-1)
        near = (occ_h - thre).abs() <= OCC_RTOL * thre
        print(f"update_grid 32^3 ({name}) card vs CPU: occs max rel err "
              f"{rel:.2e}; binary differs at {int(flips.sum())} of {n} "
              f"cells ({int((flips & near).sum())} within {OCC_RTOL} of the "
              f"threshold {thre:.3e})")
        if rel > OCC_RTOL or bool((flips & ~near).any()):
            raise AssertionError(f"update_grid 32^3 ({name}): card vs CPU")
    return paths


def make_ngp_scene(dev, pallas_grad: bool, log2_hashmap_size=NGP_LOG2_T):
    """The reference NGP field (16 levels x 2 features, heads 64 wide, SH
    degree 4; random weights from the seed) and the trained grid."""
    from nerfacc_tpu_torch.convert import grid_from_arrays
    from nerfacc_tpu_torch.models import NGPRadianceField

    field = NGPRadianceField(
        aabb=AABB, n_levels=NGP_LEVELS, log2_hashmap_size=log2_hashmap_size,
        pallas_grad=pallas_grad,
        generator=torch.Generator().manual_seed(SEED), device=dev,
    )
    asset = np.load(ROOT / "bench_assets" / "trained_grid.npz")
    grid = grid_from_arrays(AABB, asset["binary"], asset["occs"], device=dev)
    return field, grid


def _ngp_kw(use_kernels: bool, n_rays: int) -> dict:
    return dict(_train_kw(use_kernels, n_rays),
                field_samples_budget=n_rays * 48 // 2)


def check_ngp_card_vs_cpu(dev, o, d, px) -> None:
    """One NGP step of CHECK_RAYS rays on the card (K5, K7) and on the CPU
    (the same path, plain twins), from the same weights; 2^15 entries per
    level keep the CPU side small."""
    from nerfacc_tpu_torch import train_step

    results = []
    for device in (dev, torch.device("cpu")):
        field, grid = make_ngp_scene(device, True, log2_hashmap_size=15)
        opt = torch.optim.Adam(field.parameters(), lr=LR)
        loss, n = train_step(field, opt, grid, o.to(device), d.to(device),
                             px.to(device), **_ngp_kw(True, CHECK_RAYS))
        grads = {k: p.grad.cpu() for k, p in field.named_parameters()}
        results.append((float(loss), int(n), grads))
    (loss_c, n_c, g_c), (loss_h, n_h, g_h) = results
    rel = abs(loss_c - loss_h) / loss_h
    worst = max((_rel_l2(g_c[k], g_h[k]), k) for k in g_h)
    table = _rel_l2(g_c["encoder.table"], g_h["encoder.table"])
    print(f"NGP step card vs CPU ({CHECK_RAYS} rays): loss {loss_c:.7f} vs "
          f"{loss_h:.7f} (rel {rel:.2e}); live samples {n_c} vs {n_h}; "
          f"worst gradient rel L2 err {worst[0]:.2e} ({worst[1]}); table "
          f"gradient rel L2 err {table:.2e}")
    if rel > NGP_LOSS_RTOL:
        raise AssertionError(f"NGP loss card vs CPU: rel err {rel:.2e}")
    if worst[0] > NGP_GRAD_L2:
        raise AssertionError(f"NGP gradient {worst[1]} card vs CPU: rel L2 "
                             f"err {worst[0]:.2e}")
    if n_c != n_h:
        raise AssertionError(f"live samples card {n_c} vs CPU {n_h}")


def phase_ngp(dev) -> dict:
    """The hash-NGP training step at full width, its twin without kernels
    and one NGP render request; returns the launch counts of each path."""
    from nerfacc_tpu_torch import render_rays, train_step

    paths = {}
    o, d, px = bench_stream(dev, NGP_STEPS + 1)
    check_ngp_card_vs_cpu(dev, o[0, :CHECK_RAYS], d[0, :CHECK_RAYS],
                          px[0, :CHECK_RAYS])

    field, grid = make_ngp_scene(dev, pallas_grad=True)
    n_table = field.encoder.table.numel()
    print(f"NGP field: table {tuple(field.encoder.table.shape)} = {n_table} "
          f"floats ({n_table * 4 / 1e6:.1f} MB), "
          f"{sum(p.numel() for p in field.parameters()) - n_table} head "
          "weights")
    opt = torch.optim.Adam(field.parameters(), lr=LR)
    kw = _ngp_kw(True, TRAIN_RAYS)
    batch = [(o[i], d[i], px[i]) for i in range(NGP_STEPS + 1)]
    _timed_steps(field, opt, grid, batch[:1], kw, train_step)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    # the table gradient is one launch: the per-level kernel must not run
    others = ("cp_level_features", "cp_level_features_res", "cp_level_grads",
              "cp_level_grads_res", "fused_reselect", "hash_grad_scatter",
              "table_gather")
    rec, paths["ngp train"] = drive(
        f"{NGP_STEPS} NGP training steps",
        lambda: _timed_steps(field, opt, grid, batch[1:], kw, train_step),
        ("hash_grad_scatter_levels", "fused_select_grouped"), others,
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {"hash_grad_scatter_levels": 1, "fused_select_grouped": 1}
    for i, (ms, loss, n, counts) in enumerate(rec):
        if not np.isfinite(loss):
            raise AssertionError(f"NGP step {i}: loss {loss}")
        for k, want in per_step.items():
            if counts[k] != want:
                raise AssertionError(f"NGP step {i}: {k} launched "
                                     f"{counts[k]} times, expected {want}")
    _check_finite_params("NGP training", field)
    ms = [r[0] for r in rec]
    live = [r[2] for r in rec]
    with torch.no_grad():
        *_, sel = render_rays(
            field, *batch[1][:2], grid=grid, aux=batch[1][2],
            return_compact=True, return_extras=True, **kw)
    dropped = int(sel["extras"]["field_budget_dropped"])
    print(f"NGP steps (kernels, {TRAIN_RAYS} rays): losses "
          f"{[round(r[1], 6) for r in rec]}")
    print(f"NGP step (kernels): median {statistics.median(ms):.3f} ms "
          f"(min {min(ms):.3f}, max {max(ms):.3f}); live samples per step "
          f"median {statistics.median(live)} of a field budget "
          f"{NGP_FIELD_BUDGET}, field_budget_dropped {dropped}; "
          f"{sum(live) / sum(ms) * 1e3:.0f} samples/s; peak memory "
          f"{peak_gb:.2f} GB")

    # a repeated batch: the loss after NGP_STEPS steps is below step 0's
    losses = [r[1] for r in _timed_steps(
        field, opt, grid, batch[:1] * (NGP_STEPS + 1), kw, train_step)]
    print(f"NGP repeated batch: loss {losses[0]:.7f} -> {losses[-1]:.7f} "
          f"after {NGP_STEPS} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError("the NGP loss did not fall on a repeated batch")

    # one 128x128 request through render_image with the trained-on field
    request = make_requests(dev)[0]
    (colors, opacities, depths), paths["ngp render"] = drive(
        "one NGP render request",
        lambda: _render(field, grid, *request, True),
        ("fused_select_grouped", "fused_reselect"),
        tuple(k for k in kernel_counters()
              if k not in ("fused_select_grouped", "fused_reselect")),
    )
    _check_outputs("NGP request", colors, opacities, depths, CHUNK)
    print(f"NGP request: mean opacity {float(opacities.mean()):.4f}, "
          "outputs finite, opacities in [0, 1]")
    del field, opt

    # the same step with no kernel: index_add_ table gradient, unfused march
    pfield, _ = make_ngp_scene(dev, pallas_grad=False)
    popt = torch.optim.Adam(pfield.parameters(), lr=LR)
    pkw = _ngp_kw(False, TRAIN_RAYS)
    _timed_steps(pfield, popt, grid, batch[:1], pkw, train_step)  # warm-up
    prec, _ = drive("plain NGP training steps",
                    lambda: _timed_steps(pfield, popt, grid, batch[1:4], pkw,
                                         train_step),
                    (), tuple(kernel_counters()))
    _check_finite_params("plain NGP training", pfield)
    pms = [r[0] for r in prec]
    print(f"NGP step (plain): median {statistics.median(pms):.3f} ms over "
          f"{len(pms)} steps; live samples {[r[2] for r in prec]}")
    return paths


def phase_gather_script(dev) -> dict:
    """``scripts/bench_hash_torch.py r5gather``: K8 on its script path."""
    _scripts()
    import bench_hash_torch

    _, counts = drive(
        "bench_hash_torch r5gather",
        lambda: bench_hash_torch.r5gather(device=dev),
        ("table_gather",),
        tuple(k for k in kernel_counters() if k != "table_gather"),
    )
    return {"r5gather": counts}


def phase_op_backward(dev) -> dict:
    """The ``cp_level_features`` op differentiated at the slice's level-1
    shape: K1 forward, K3 backward (the model's training step takes the
    residual op, K2 and K4, instead)."""
    from nerfacc_tpu_torch.ops import cp_level_features

    rng = np.random.RandomState(SEED + 1)
    xu = torch.as_tensor(rng.rand(B_SAMPLES, 3).astype(np.float32),
                         device=dev)
    tables = [torch.as_tensor(rng.randn(512, 128).astype(np.float32) * 0.2,
                              device=dev).requires_grad_()
              for _ in range(3)]
    cot = torch.as_tensor(rng.randn(B_SAMPLES, 128).astype(np.float32),
                          device=dev)
    _, counts = drive(
        "the cp_level_features op's backward",
        lambda: cp_level_features(xu, *tables).backward(cot),
        ("cp_level_features", "cp_level_grads"),
        ("cp_level_features_res", "cp_level_grads_res", "hash_grad_scatter",
         "hash_grad_scatter_levels"),
    )
    if not all(bool(torch.isfinite(t.grad).all()) for t in tables):
        raise AssertionError("cp_level_features backward: non-finite grads")
    return {"cp_level_features op backward": counts}


def phase_level_scatter(dev) -> dict:
    """The per-level ``hash_grad_scatter`` op on its own, as the JAX
    package's ``_bwd_pallas`` calls its kernel: once per level into that
    level's slice of a zeroed gradient, at the NGP step's shape on
    ray-ordered points. The sixteen calls must give what the one-launch
    entry gives (f32 sums in another order)."""
    from nerfacc_tpu_torch.models import hash_grid_indices
    from nerfacc_tpu_torch.models.hash_encoding import _level_resolutions
    from nerfacc_tpu_torch.ops import (
        hash_grad_scatter,
        hash_grad_scatter_levels,
    )

    rng = np.random.RandomState(SEED + 4)
    N, L, T = NGP_FIELD_BUDGET, NGP_LEVELS, 1 << NGP_LOG2_T
    res = _level_resolutions(L, 16, 1.4472692012786865)
    flat_idx, corner_w = hash_grid_indices(
        ray_ordered_points(dev), torch.as_tensor(res, device=dev),
        torch.as_tensor((res + 1) ** 3 <= T, device=dev), T)
    g = torch.as_tensor(rng.randn(N, 2 * L).astype(np.float32), device=dev)

    def per_level():
        d_table = torch.zeros((L, T, 2), dtype=torch.float32, device=dev)
        for level in range(L):
            sl = slice(level * 8, level * 8 + 8)
            pair = torch.stack([g[:, level], g[:, L + level]], dim=-1)
            hash_grad_scatter(
                (flat_idx[:, sl] - level * T).reshape(-1),
                (corner_w[:, sl, None] * pair[:, None, :]).reshape(-1, 2),
                T, out=d_table[level])
        return d_table

    got, counts = drive(
        "the per-level hash_grad_scatter op", per_level,
        ("hash_grad_scatter",),
        tuple(k for k in kernel_counters() if k != "hash_grad_scatter"),
    )
    want = hash_grad_scatter_levels(flat_idx, corner_w, g,
                                    torch.zeros_like(got))
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = _check_close("per-level K7 vs the one-launch entry", got, want, 0.0,
                       HASH_GRAD_REL * scale)
    print(f"per-level hash_grad_scatter x {L} vs hash_grad_scatter_levels: "
          f"max abs diff {err:.3e} = {err / scale:.2e} x max|dT| "
          f"{scale:.3e}")
    return {"hash_grad_scatter op per level": counts}


class InputRecorder:
    """Stands in for a kernel wrapper in the module that calls it while a
    path runs: passes every call on, and keeps a copy of the arguments of
    the first call at each new shape (at most TRAINER_SHAPES_KEPT), so that
    the kernel can be held against its twin afterwards on the very inputs
    the path gave it. A wrapper's body adds to the count of the name it is
    bound to in its module, which is this object while it stands in:
    ``launches`` reads and writes the wrapper's own count."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.wrapped = getattr(module, attr)
        self.calls = {}

    @property
    def launches(self) -> int:
        return self.wrapped.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.wrapped.launches = n

    def __call__(self, *args, **kw):
        key = tuple(tuple(a.shape) if torch.is_tensor(a) else a
                    for a in args) + tuple(sorted(kw.items()))
        if key not in self.calls and len(self.calls) < TRAINER_SHAPES_KEPT:
            self.calls[key] = (tuple(a.detach().clone() if torch.is_tensor(a)
                                     else a for a in args), dict(kw))
        return self.wrapped(*args, **kw)


def _trainer_kernels():
    """The trainers' kernels: counter name -> (module, the name the path
    calls in it, the plain twin, how the two outputs are compared)."""
    from nerfacc_tpu_torch.ops import cp_encoder as cpe
    from nerfacc_tpu_torch.ops import hash_gather as hg
    from nerfacc_tpu_torch.ops import march_select as msel

    def k2_err(name, got, want):
        for a, (u, w) in enumerate(zip(got[1], want[1])):
            _check_equal(f"{name} residual {a}", u, w)
        return _check_close(f"{name} features", got[0], want[0], 0.0,
                            CP_ATOL)

    def k7_plain(flat_idx, corner_w, g, d_table):
        # the kernel adds into the recorded (zero) table; the twin gets its
        # own
        return hg.hash_grad_scatter_levels_plain(flat_idx, corner_w, g,
                                                 torch.zeros_like(d_table))

    def k7_err(name, got, want):
        scale = float(want.abs().max())
        err = _check_close(name, got, want, 0.0, HASH_GRAD_REL * scale)
        print(f"{name}: {err / scale:.2e} x max|dT| {scale:.3e}")
        return err

    return {
        # K1 through the function both CP ops call without a gradient
        "cp_level_features": (
            cpe, "_features", cpe.cp_level_features_plain,
            lambda n, got, want: _check_close(n, got, want, 0.0, CP_ATOL)),
        "cp_level_features_res": (
            cpe, "cp_level_features_res_fwd", cpe.cp_level_features_res_plain,
            k2_err),
        "cp_level_grads_res": (
            cpe, "cp_level_grads_res", cpe.cp_level_grads_res_plain,
            lambda n, got, want: _grads_err(n, got, want)[0]),
        "fused_select_grouped": (
            msel, "fused_select_grouped", msel.fused_select_grouped_plain,
            _check_quad),
        "fused_reselect": (
            msel, "fused_reselect", msel.fused_reselect_plain, _check_quad),
        # K7 through the name the hash lookup's backward calls
        "hash_grad_scatter_levels": (
            hg, "hash_grad_scatter_levels", k7_plain, k7_err),
    }


@contextlib.contextmanager
def recording(names):
    """An InputRecorder in place of each named kernel's wrapper (a name of
    ``_trainer_kernels``) while the block runs; yields them by name."""
    kernels = _trainer_kernels()
    recorders = {name: InputRecorder(*kernels[name][:2]) for name in names}
    for rec in recorders.values():
        setattr(rec.module, rec.attr, rec)
    try:
        yield recorders
    finally:
        for rec in recorders.values():
            setattr(rec.module, rec.attr, rec.wrapped)


def _shape_label(args, kw) -> str:
    dims = ["x".join(map(str, a.shape)) if torch.is_tensor(a) else str(a)
            for a in args]
    return " ".join(dims + [f"{k}={v}" for k, v in kw.items()
                            if k in ("k_slots", "k2")])


def check_trainer_inputs(dev, recorders, path="trainer") -> dict:
    """Each kernel of a trainer's path against its plain twin, with the
    tolerances of phase 3, on the inputs the drive gave it (the first call
    at each shape: the grid update's and the stage-1 passes' K1, the
    step's K2 / K4 / K7, the march's K5 / K6, the evaluation's). K5 and K6
    also on random rows at the drive's shapes (rows fuller than the
    trained scene's, so that every row is decimated). Returns, per kernel,
    the shapes and their errors."""
    kernels = _trainer_kernels()
    rng = np.random.RandomState(SEED + 9)
    found = {}
    for name, rec in recorders.items():
        _, _, plain, compare = kernels[name]
        rows = []
        for args, kw in rec.calls.values():
            label = f"{name} {_shape_label(args, kw)}"
            err = compare(f"{path} {label}", rec.wrapped(*args, **kw),
                          plain(*args, **kw))
            rows.append(dict(path=path, shape=_shape_label(args, kw),
                             max_abs_err=err))
            print(f"{path} inputs: {label}: max_abs_err {err:.3e}")
            if name == "fused_select_grouped":
                R, G = args[0].shape
                x = _select_inputs(dev, rng, R, G, int(args[1].max()))
            elif name == "fused_reselect":
                x = _reselect_inputs(dev, rng, *args[0].shape)
            else:
                continue
            err = compare(f"{path} shape, random rows: {label}",
                          rec.wrapped(*x, **kw), plain(*x, **kw))
            rows.append(dict(path=path,
                             shape=_shape_label(x, kw) + " random rows",
                             max_abs_err=err))
            print(f"{path} shape, random rows: {label}: max_abs_err "
                  f"{err:.3e}")
        if not rows:
            raise AssertionError(f"{path}: no input of {name} was kept")
        found[name] = rows
    return found


# counter name -> the kernel's tag in the drives' lines
KERNEL_TAGS = {
    "cp_level_features": "K1", "cp_level_features_res": "K2",
    "cp_level_grads": "K3", "cp_level_grads_res": "K4",
    "fused_select_grouped": "K5", "fused_reselect": "K6",
    "hash_grad_scatter": "K7 per level", "hash_grad_scatter_levels": "K7",
    "table_gather": "K8",
}


def load_example(script: str):
    """``examples/<script>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        script, ROOT / "examples" / f"{script}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_drive(dev, path: str, trainer, argv, floor: float,
              must_launch=()) -> tuple:
    """A trainer script's ``main`` on ``argv``, with every launch count
    set to 0 just before and read just after: each kernel of
    ``must_launch`` must launch and no other; the held-out PSNR must reach
    ``floor`` and the field budget drop nothing. Then each kernel of
    ``must_launch`` against its twin on the inputs the run gave it.
    Returns the run's launch counts, those checks and the run's
    ``Trainer``."""
    with recording(must_launch) as recorders:
        out, counts = drive(
            path, lambda: trainer.main(list(argv)), must_launch,
            [k for k in kernel_counters() if k not in must_launch])
    t = out.pop("trainer")
    launched = ", ".join(f"{KERNEL_TAGS[k]} {n}" for k, n in counts.items()
                         if n) or "none"
    print(f"{path}: PSNR {out['psnr']:.4f} per view "
          f"{[round(p, 4) for p in out['psnrs']]} (floor {floor}); "
          f"training loop {out['loop_s']:.3f} s for {out['steps']} steps, "
          f"train_time_s {out['train_time_s']:.3f}; {out['samples']} live "
          f"samples = {out['samples'] / out['loop_s']:.0f} samples/s "
          f"({out['samples'] / out['steps']:.0f} per step"
          + (f"; train_samples_per_s {out['train_samples_per_s']:.0f}"
             if "train_samples_per_s" in out else "")
          + f"); field_budget_dropped {out['field_budget_dropped']}; "
          f"launches {launched}")
    if not out["psnr"] >= floor:
        raise AssertionError(f"{path}: PSNR {out['psnr']:.4f} below the "
                             f"floor {floor}")
    if out["field_budget_dropped"]:
        raise AssertionError(f"{path}: the field budget dropped samples")
    return counts, check_trainer_inputs(dev, recorders, path), t


def check_proposal_levels(dev, t, path: str) -> dict:
    """After a proposal drive on the plain paths: K1, K2 and K4 against
    their twins at the drive's shapes, on the run's own trained tables and
    on the points one training batch gives each CP level (the proposal
    level at the coarse interval midpoints, the main field's two levels at
    the resampled ones), with a random cotangent for K4. The tolerances
    of phase 3. Returns, per kernel, the shapes and their errors."""
    from nerfacc_tpu_torch.ops import cp_encoder as cpe

    kernels = _trainer_kernels()
    seen = {}
    for name, field in (("proposal", t.proposal), ("field", t.field)):
        for i, lvl in enumerate(field.cp_levels):
            def record(x, lvl=lvl, key=f"{name} level {i}", fwd=lvl.forward):
                seen.setdefault(key, (lvl, x.detach().clone()))
                return fwd(x)
            lvl.forward = record
    try:
        rays, _ = t.scene.sample_batch(t.args.num_rays)
        with torch.no_grad():
            t.forward(rays.origins, rays.viewdirs,
                      t.jitter(rays.origins.shape[0]))
    finally:
        for field in (t.proposal, t.field):
            for lvl in field.cp_levels:
                del lvl.forward
    rng = torch.Generator(device=dev).manual_seed(SEED + 14)
    found = {}
    for key, (lvl, xu) in seen.items():
        tables = tuple(a.detach() for a in lvl.tables())
        G, R = tables[0].shape
        g = torch.randn((xu.shape[0], R), generator=rng, device=dev)
        _, us = cpe.cp_level_features_res_fwd(xu, *tables)
        checks = (
            ("cp_level_features", (xu, *tables)),
            ("cp_level_features_res", (xu, *tables)),
            ("cp_level_grads_res", (xu, g, *us, G)),
        )
        for name, args in checks:
            module, attr, plain, compare = kernels[name]
            label = f"{path} {key}: {name} {_shape_label(args, {})}"
            err = compare(label, getattr(module, attr)(*args), plain(*args))
            found.setdefault(name, []).append(dict(
                path=path, shape=f"{key} {_shape_label(args, {})}",
                max_abs_err=err))
            print(f"{label}: max_abs_err {err:.3e}")
    return found


def check_unbounded_march(dev, t) -> None:
    """Phase 15 after its drive, on the run's own grid, field and rays:
    the auto-sized lattice, then the fused march (K5) and re-selection
    (K6) against the unfused op chain on a training batch (4,096 rays x
    146 groups x 128 slots, then 128 -> 64) and on one evaluation chunk
    (``coarse_stride=1``, 2,048 rays, 128 -> 64): the march's masks
    (before the cull) and the culled masks bit-equal, t within rtol 1e-5,
    colours within 1e-5."""
    from nerfacc_tpu_torch import render_rays

    args = t.args
    print(f"grid-unbounded trainer: max_samples_per_ray "
          f"{args.max_samples_per_ray} (expect {U360_SAMPLES}), probe_groups "
          f"{args.probe_groups} (expect {U360_GROUPS})")
    if (args.max_samples_per_ray, args.probe_groups) != (U360_SAMPLES,
                                                         U360_GROUPS):
        raise AssertionError("grid-unbounded trainer: the lattice was not "
                             "auto-sized as the JAX trainer sizes it")
    rays, _ = t.scene.sample_batch(args.num_rays)
    view = t.scene.rays_for_view(t.scene.test_poses[0])
    chunk = args.test_chunk_size
    cases = (
        ("train batch", rays.origins, rays.viewdirs, t.render_kwargs),
        ("evaluation chunk", view.origins[:chunk], view.viewdirs[:chunk],
         dict(t.render_kwargs, coarse_stride=1, samples_budget=chunk * 128,
              visible_samples_budget=chunk * 64)),
    )
    for label, o, d, kw in cases:
        for prefilter in (False, True):
            with torch.no_grad():
                fused, plain = (render_rays(
                    t.field, o, d, grid=t.grid, render_bkgd=None,
                    return_extras=True,
                    **dict(kw, use_pallas=up, prefilter_sigma=prefilter))
                    for up in (True, False))
            ef, ep = fused[4], plain[4]
            name = (f"grid-unbounded {label}, "
                    + ("after the cull" if prefilter else "the march"))
            _check_equal(f"{name} masks", ef["masks"], ep["masks"])
            for n in ("t_starts", "t_ends", "deltas"):
                _check_close(f"{name} {n}", ef[n], ep[n], 1e-5, 0.0)
            err = _check_close(f"{name} colours", fused[0], plain[0], 0.0,
                               1e-4)
            live = ef["t_starts"][ef["masks"]]
            print(f"{name}: masks bit-equal {tuple(ef['masks'].shape)}, "
                  f"{int(ef['masks'].sum())} live, t up to "
                  f"{float(live.max()) if live.numel() else 0.0:.1f}, "
                  f"colours max_abs_err {err:.3e}")


def phase_trainers(dev) -> tuple:
    """The trainers' drives, each through its script's ``main`` (seed
    TRAINER_SEED): phase 9, the TensoCP trainer's flagship drive with the
    kernels (K1, K2, K4, K5, K6); phase 10, the NGP drive with the kernels
    (K5, K6, K7's one-launch entry); phase 11, the vanilla drive; phase 12,
    the D-NeRF drive (the MLP trainers march exactly and in one stage, so
    they launch no kernel); phase 13, the proposal trainer's drive with the
    kernels (K1, K2, K4); phase 14, its 360 drive on the plain paths, then
    K1, K2 and K4 on the run's tables and points, then the first
    P360_KERNEL_STEPS steps of the drive with the kernels; phase 15, the grid
    trainer's unbounded drive with the kernels (K1, K2, K4, K5, K6), then
    its march on its own grid and rays. Returns the launch counts per path
    and the kernels' checks on the drives' inputs, merged per kernel."""
    seed = ("--seed", str(TRAINER_SEED))
    cp_kernels = ("cp_level_features", "cp_level_features_res",
                  "cp_level_grads_res")
    drives = (
        ("trainer", "train_ngp_nerf_torch",
         lambda m: [*m.FLAGSHIP, *m.KERNELS, *seed], TRAINER_PSNR_FLOOR,
         ("cp_level_features", "cp_level_features_res",
          "cp_level_grads_res", "fused_select_grouped", "fused_reselect")),
        ("NGP trainer", "train_ngp_nerf_torch",
         lambda m: [*m.NGP, *m.KERNELS, *seed], NGP_DRIVE_PSNR_FLOOR,
         ("fused_select_grouped", "fused_reselect",
          "hash_grad_scatter_levels")),
        ("vanilla trainer", "train_mlp_nerf_torch",
         lambda m: [*m.DRIVE, *seed], MLP_PSNR_FLOOR, ()),
        ("D-NeRF trainer", "train_mlp_dnerf_torch",
         lambda m: [*m.DRIVE, *seed], DNERF_PSNR_FLOOR, ()),
        ("proposal trainer", "train_proposal_nerf_torch",
         lambda m: [*m.DRIVE, *m.KERNELS, *seed], PROPOSAL_PSNR_FLOOR,
         cp_kernels),
        # the plain paths, as the JAX script runs it: the kernel path's
        # numerics collapse this recipe at seeds 42 and 44, the kernels'
        # twins too (ROADMAP.md Queue 3); its levels' kernels are held to
        # their twins on the run's tables and points after the drive, and
        # in training on the kernel path's first steps
        ("proposal 360 trainer", "train_proposal_nerf_torch",
         lambda m: [*m.DRIVE_360, *seed], PROPOSAL360_PSNR_FLOOR, ()),
        ("proposal 360 trainer, kernel path", "train_proposal_nerf_torch",
         lambda m: [*m.DRIVE_360, *m.KERNELS, *seed, "--max_steps",
                    str(P360_KERNEL_STEPS)], 0.0, cp_kernels),
        ("grid-unbounded trainer", "train_ngp_nerf_torch",
         lambda m: [*m.U360, *m.KERNELS, *seed], U360_PSNR_FLOOR,
         (*cp_kernels, "fused_select_grouped", "fused_reselect")),
    )
    paths, inputs = {}, {}
    for path, script, flags, floor, kernels in drives:
        module = load_example(script)
        paths[path], found, t = run_drive(dev, path, module, flags(module),
                                          floor, kernels)
        for name, rows in found.items():
            inputs.setdefault(name, []).extend(rows)
        if path == "grid-unbounded trainer":
            check_unbounded_march(dev, t)
        if path == "proposal 360 trainer":
            for name, rows in check_proposal_levels(dev, t, path).items():
                inputs.setdefault(name, []).extend(rows)
        del t
        torch.cuda.empty_cache()
    return paths, inputs


# Phase 16: the reference's flat packed API, ray_marching() -> rendering()
# over make_field_fns' closures, at the request's width
FLAT_MARCH_KW = dict(scene_aabb=AABB, render_step_size=5e-3,
                     max_samples_per_ray=1024, coarse_stride=16,
                     probe_dilation=2, probe_groups=32)
FLAT_RAYS, FLAT_SAMPLES = CHUNK, 64  # loss_distortion / ray_resampling
FLAT_RESAMPLES = 32
F32_U = 2.0 ** -24  # f32 unit roundoff


def _flat_kw(n_rays: int, visible: bool = True) -> dict:
    """The request's march: 48 slots per ray, 24 after the cull."""
    kw = dict(FLAT_MARCH_KW, samples_budget=n_rays * 48)
    if visible:
        kw["visible_samples_budget"] = n_rays * 24
    return kw


def _flat_request(field, grid, o, d, use_pallas):
    """One request through the reference's two calls; returns the render
    and the packed samples."""
    from nerfacc_tpu_torch import make_field_fns, ray_marching, rendering

    sigma_fn, rgb_sigma_fn = make_field_fns(field, o, d)
    with torch.no_grad():
        s = ray_marching(o, d, grid=grid, sigma_fn=sigma_fn,
                         use_pallas=use_pallas, **_flat_kw(o.shape[0]))
        out = rendering(s.t_starts, s.t_ends, s.ray_indices, o.shape[0],
                        rgb_sigma_fn=rgb_sigma_fn,
                        render_bkgd=torch.ones(3, device=o.device),
                        masks=s.masks)
    return out, s


def flat_render_bound(k_slots: int, n_samples: int, t_max: float):
    """How far two renders of the same samples may differ when one
    composites a dense (R, K) view (row cumsums, row sums) and the other
    the flat buffer (segmented scans, segment sums): the same terms,
    summed in another order. With u the f32 unit roundoff and L =
    ceil(log2 n_samples): the exclusive sum of sigma delta >= 0 is off by
    at most (K - 1) u acc along a row and L u acc along the scan's tree,
    so T = exp(-acc) differs by at most (K + L) u T acc + 4 u <= (K + L) u
    / e + 4 u (x e^-x <= 1 / e; exp within 2 ulp on each side); a weight
    T alpha (alpha computed alike) by that plus 2 u. A sum of K weights
    times values in [0, 1] then differs by K times that plus 2 K u (each
    side's order of sums); colors add the opacity's error through the
    background; depths scale by t_max. Returns (colors, opacities,
    depths)."""
    L = int(np.ceil(np.log2(n_samples)))
    per_weight = (k_slots + L) * F32_U / np.e + 6 * F32_U
    opac = k_slots * per_weight + 2 * k_slots * F32_U
    return 2 * opac + 2 * F32_U, opac, t_max * opac


def _repack_ragged(s, rgbs, sigmas, n_rays):
    """A request's live samples packed ragged: ``pack_data`` on the march's
    mask, then ``unpack_info``. Returns (t_starts, t_ends, rgbs, sigmas,
    ray_indices, valid) of the packed buffer."""
    from nerfacc_tpu_torch import pack_data, unpack_info

    k = s.masks.numel() // n_rays
    data = torch.cat([s.t_starts, s.t_ends, rgbs, sigmas.reshape(-1, 1)],
                     dim=1).reshape(n_rays, k, 6)
    packed, info, valid = pack_data(data, s.masks.reshape(n_rays, k))
    ri = unpack_info(info, packed.shape[0])
    return (packed[:, 0:1], packed[:, 1:2], packed[:, 2:5], packed[:, 5:6],
            ri, valid)


def check_flat_segmented(field, grid, o, d) -> dict:
    """The segmented path at full size: one request's live samples repacked
    ragged and composited through ``rendering()`` (no bridge) against the
    bridged render of the march's own buffer, the field's outputs computed
    once and given to both. Then ``rendering()`` timed bridged and forced
    segmented on the same buffer, and the bridge check alone."""
    import nerfacc_tpu_torch.vol_rendering as pvr
    from nerfacc_tpu_torch import make_field_fns, rendering

    n = o.shape[0]
    (_, s) = _flat_request(field, grid, o, d, True)
    _, rgb_sigma_fn = make_field_fns(field, o, d)
    with torch.no_grad():
        rgbs, sigmas = rgb_sigma_fn(s.t_starts, s.t_ends, s.ray_indices)
    bkgd = torch.ones(3, device=o.device)

    def render(ts, te, ri, rgb, sig, masks):
        return rendering(ts, te, ri, n, rgb_sigma_fn=lambda *a: (rgb, sig),
                         render_bkgd=bkgd, masks=masks)

    bridged = render(s.t_starts, s.t_ends, s.ray_indices, rgbs, sigmas,
                     s.masks)
    ts, te, rg, sg, ri, valid = _repack_ragged(s, rgbs, sigmas, n)
    n_samples = ts.shape[0]
    if pvr._detect_dense_layout(ri, None, n_samples, n) is not None:
        raise AssertionError("the ragged repack was taken for dense")
    ragged = render(ts, te, ri, rg, sg, valid)
    t_max = float((s.t_ends[s.masks]).max())
    k = n_samples // n
    bounds = flat_render_bound(k, n_samples, t_max)
    errs = [_check_close(f"ragged segmented render {name} vs bridged", a, b,
                         0.0, tol)
            for name, a, b, tol in zip(("colors", "opacities", "depths"),
                                       ragged, bridged, bounds)]
    print(f"flat segmented (ragged repack, {int(valid.sum())} live of "
          f"{n_samples}) vs bridged: max abs diff colors {errs[0]:.3e} "
          f"opacities {errs[1]:.3e} depths {errs[2]:.3e} (bounds "
          f"{bounds[0]:.3e} / {bounds[1]:.3e} / {bounds[2]:.3e}, K={k}, "
          f"t_max={t_max:.3f})")

    def segmented():
        pvr.DENSE_BRIDGE = False
        try:
            render(s.t_starts, s.t_ends, s.ray_indices, rgbs, sigmas, s.masks)
        finally:
            pvr.DENSE_BRIDGE = True

    times = dict(
        bridged=median_ms(lambda: render(s.t_starts, s.t_ends, s.ray_indices,
                                         rgbs, sigmas, s.masks)),
        segmented=median_ms(segmented),
        ragged=median_ms(lambda: render(ts, te, ri, rg, sg, valid)),
        bridge_check=median_ms(lambda: pvr._detect_dense_layout(
            s.ray_indices, None, n_samples, n)),
    )
    print(f"rendering() at {n} rays x {k} slots, the field's outputs given "
          f"(ms, median of 20): bridged {times['bridged']:.4f}  forced "
          f"segmented {times['segmented']:.4f}  ragged repack "
          f"{times['ragged']:.4f}  the bridge check alone "
          f"{times['bridge_check']:.4f}  [{smi_line()}]")
    return times


def _flat_random_rays(dev, n_rays, k, seed):
    """(t_starts, t_ends, weights, masks) of (n_rays, k), rendering-like:
    sorted contiguous intervals, weights summing to ~0.5 per ray, 30%
    zero, 80% live."""
    rng = np.random.RandomState(seed)
    edges = np.cumsum(rng.rand(n_rays, k + 1) * 0.1, axis=1)
    w = rng.rand(n_rays, k) / k
    w[rng.rand(n_rays, k) < 0.3] = 0.0
    m = rng.rand(n_rays, k) < 0.8
    m[::97] = False  # rays with no live sample
    return [torch.as_tensor(a, device=dev) for a in (
        edges[:, :-1].astype(np.float32), edges[:, 1:].astype(np.float32),
        w.astype(np.float32), m)]


def check_flat_distortion_and_resampling(dev) -> None:
    """``loss_distortion`` and ``ray_resampling`` on the segmented path
    (the bridge off) against their dense twins at FLAT_RAYS x
    FLAT_SAMPLES."""
    import nerfacc_tpu_torch.vol_rendering as pvr
    from nerfacc_tpu_torch import (
        loss_distortion,
        loss_distortion_dense,
        ray_resampling,
        ray_resampling_dense,
    )
    from nerfacc_tpu_torch.cdf import resampling_targets, weight_cdf

    R, K = FLAT_RAYS, FLAT_SAMPLES
    ts, te, w, m = _flat_random_rays(dev, R, K, seed=16)
    ri = torch.arange(R, dtype=torch.int32, device=dev).repeat_interleave(K)
    flat = [x.reshape(-1) for x in (w, ts, te, m)]
    pvr.DENSE_BRIDGE = False
    try:
        loss = loss_distortion(None, flat[0], flat[1], flat[2],
                               ray_indices=ri, n_rays=R, masks=flat[3])
        res = ray_resampling(None, flat[1], flat[2], flat[0], FLAT_RESAMPLES,
                             ray_indices=ri, n_rays=R, masks=flat[3])
    finally:
        pvr.DENSE_BRIDGE = True
    want = loss_distortion_dense(w, ts, te, masks=m)
    # the same terms summed in another order (see flat_render_bound): the
    # prefix sums A, B off by (K + L) u W and (K + L) u W M per sample
    # (W the ray's weight sum, M its largest midpoint), so w (m A - B)
    # summed over the ray by (4 (K + L) + 8) u W^2 M, each side's final
    # sums by 2 K u W^2 M more, and the uniform term by 2 K u D W^2 / 3
    # (D the widest interval)
    L = int(np.ceil(np.log2(R * K)))
    wl = torch.where(m, w, torch.zeros_like(w))
    W = wl.sum(1)
    M = ((ts + te) / 2).max(1).values
    D = (te - ts).max(1).values
    tol = F32_U * W * W * ((4 * (K + L) + 8 + 4 * K) * M + 2 * K * D / 3)
    err = (loss - want).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"flat loss_distortion vs dense: "
                             f"{int((err > tol).sum())} rays outside the "
                             f"bound (max abs err {float(err.max()):.3e})")
    print(f"flat loss_distortion ({R} rays x {K}) vs dense: max abs diff "
          f"{float(err.max()):.3e} (largest bound {float(tol.max()):.3e}, "
          f"largest share of its bound "
          f"{float((err / torch.clamp(tol, min=1e-30)).max()):.3f})")

    s2, e2, mk2 = ray_resampling_dense(ts, te, w, FLAT_RESAMPLES, masks=m)
    _check_equal("flat ray_resampling masks vs dense", res.masks,
                 mk2.reshape(-1))
    # the flat path searches the global f32 CDF r + cdf, which resolves a
    # target only to the f32 spacing at r (2^-10 at 16,384 rays): a bin may
    # take the neighbouring interval where its target lies within two such
    # spacings (and the two CDFs' last-bit differences) of a CDF value.
    # Elsewhere t agrees within the tests' bound, rtol 1e-4 / atol 1e-5
    got_s = res.t_starts.reshape(R, FLAT_RESAMPLES)
    got_e = res.t_ends.reshape(R, FLAT_RESAMPLES)
    off = ~(torch.isclose(got_s, s2, rtol=1e-4, atol=1e-5)
            & torch.isclose(got_e, e2, rtol=1e-4, atol=1e-5)) & mk2
    cdf = weight_cdf(w, m)
    u = resampling_targets(FLAT_RESAMPLES, dev)
    spacing = torch.as_tensor(
        np.spacing(np.arange(1, R + 1, dtype=np.float32)), device=dev)
    near = (cdf[:, :, None] - u[None, None, :]).abs().amin(1)  # (R, n + 1)
    seam = near <= (2 * spacing + 1e-5)[:, None]
    # bin b's interval bounds come from targets b and b + 1
    excused = seam[:, :-1] | seam[:, 1:]
    if bool((off & ~excused).any()):
        raise AssertionError(f"flat ray_resampling vs dense: "
                             f"{int((off & ~excused).sum())} bins differ "
                             "away from a CDF seam")
    print(f"flat ray_resampling ({R} rays x {K} -> {FLAT_RESAMPLES}) vs "
          f"dense: masks bit-equal, {int(off.sum())} of {int(mk2.sum())} "
          f"live bins differ, all at a CDF seam of the global f32 CDF "
          f"({int(excused.sum())} bins lie at one)")


def flat_train_step(field, opt, grid, o, d, px):
    """One training step through the reference's user path: the culled
    march, ``rendering()`` and the MSE on a white background, Adam."""
    from nerfacc_tpu_torch import make_field_fns, ray_marching, rendering

    opt.zero_grad(set_to_none=True)
    sigma_fn, rgb_sigma_fn = make_field_fns(field, o, d)
    s = ray_marching(o, d, grid=grid, sigma_fn=sigma_fn,
                     use_pallas=True, **_flat_kw(o.shape[0]))
    colors, _, _ = rendering(s.t_starts, s.t_ends, s.ray_indices, o.shape[0],
                             rgb_sigma_fn=rgb_sigma_fn,
                             render_bkgd=torch.ones(3, device=o.device),
                             masks=s.masks)
    loss = torch.mean((colors - px) ** 2)
    loss.backward()
    opt.step()
    return loss.detach(), s.masks.sum()


def phase_flat(dev) -> dict:
    """Phase 16: the flat packed API. Returns the launch counts of the flat
    render of the requests and of the flat training steps, and each
    kernel's checks against its twin on the inputs those two paths gave
    it."""
    from nerfacc_tpu_torch import make_field_fns, ray_marching

    t_phase = time.perf_counter()
    paths = {}
    requests = make_requests(dev)
    field, grid = make_scene(dev, use_kernel=True)
    plain_field, _ = make_scene(dev, use_kernel=False)
    plain_field.load_state_dict(field.state_dict())

    # the march through the kernels vs the unfused march, before and after
    # the cull (the same field on both)
    o, d = requests[0]
    with torch.no_grad():
        for cull in (False, True):
            kw = _flat_kw(CHUNK, visible=cull)
            if cull:
                kw["sigma_fn"] = make_field_fns(field, o, d)[0]
            a = ray_marching(o, d, grid=grid, use_pallas=True, **kw)
            b = ray_marching(o, d, grid=grid, use_pallas=False, **kw)
            what = "after the cull" if cull else "before the cull"
            _check_equal(f"flat march masks {what}", a.masks, b.masks)
            _check_equal(f"flat march ray_indices {what}", a.ray_indices,
                         b.ray_indices)
            for n, x, y in (("t_starts", a.t_starts, b.t_starts),
                            ("t_ends", a.t_ends, b.t_ends)):
                _check_close(f"flat march {n} {what}", x, y, T_RTOL, T_ATOL)
            print(f"flat march {what}: masks bit-equal, {int(a.masks.sum())} "
                  f"live of {a.masks.numel()}")

    _serve(field, grid, requests, True, _flat_request)  # warm-up
    _serve(plain_field, grid, requests, False, _flat_request)
    render_kernels = ("cp_level_features", "fused_select_grouped",
                      "fused_reselect")
    with recording(render_kernels) as recorders:
        (outs, ms), paths["flat render"] = drive(
            f"the flat render of {N_VIEWS} requests",
            lambda: _serve(field, grid, requests, True, _flat_request),
            render_kernels,
            ("cp_level_features_res", "cp_level_grads", "cp_level_grads_res",
             "hash_grad_scatter", "hash_grad_scatter_levels",
             "table_gather"),
        )
    inputs = check_trainer_inputs(dev, recorders, "flat render")
    plain_outs, plain_ms = _serve(plain_field, grid, requests, False,
                                  _flat_request)
    for i, ((out, s), (pout, _)) in enumerate(zip(outs, plain_outs)):
        _check_outputs(f"flat request {i}", *out, CHUNK)
        _check_outputs(f"flat plain request {i}", *pout, CHUNK)
        errs = [_check_close(f"flat request {i} {n} vs plain", a, b, 0.0, tol)
                for n, a, b, tol in zip(("colors", "opacities", "depths"),
                                        out, pout,
                                        (RENDER_ATOL, RENDER_ATOL,
                                         DEPTH_ATOL))]
        print(f"flat request {i}: kernels {ms[i]:.2f} ms plain "
              f"{plain_ms[i]:.2f} ms, {int(s.masks.sum())} live samples of "
              f"{s.masks.numel()}; max abs diff colors {errs[0]:.2e} "
              f"opacities {errs[1]:.2e} depths {errs[2]:.2e}  mean opacity "
              f"{float(out[1].mean()):.4f}")
    print(f"flat request latency median: kernels {statistics.median(ms):.2f} "
          f"ms  plain {statistics.median(plain_ms):.2f} ms  [{smi_line()}]")

    # a 16x16 crop at the image centre, on the card vs on the CPU
    rows = torch.arange(IMAGE // 2 - 8, IMAGE // 2 + 8)
    crop = (rows[:, None] * IMAGE + rows[None]).reshape(-1).to(dev)
    o, d = (t[crop] for t in requests[0])
    cuda_out, _ = _flat_request(field, grid, o, d, True)
    cpu_field, cpu_grid = make_scene(torch.device("cpu"), use_kernel=True)
    cpu_out, _ = _flat_request(cpu_field, cpu_grid, o.cpu(), d.cpu(), True)
    errs = [_check_close(f"flat crop {n} card vs CPU", a.cpu(), b, 0.0, tol)
            for n, a, b, tol in zip(("colors", "opacities", "depths"),
                                    cuda_out, cpu_out,
                                    (RENDER_ATOL, RENDER_ATOL, DEPTH_ATOL))]
    print(f"flat crop 16x16 card vs CPU: max abs diff colors {errs[0]:.2e} "
          f"opacities {errs[1]:.2e} depths {errs[2]:.2e}")

    check_flat_segmented(field, grid, *requests[0])
    check_flat_distortion_and_resampling(dev)

    # training through rendering(): one CHECK_RAYS step on the card and on
    # the CPU, then TRAIN_STEPS steps of TRAIN_RAYS from bench.py's stream,
    # each kernel then held to its twin on the inputs those steps gave it
    bo, bd, bpx = bench_stream(dev, TRAIN_STEPS + 1)
    check_train_card_vs_cpu(dev, flat_train_step, bo[0, :CHECK_RAYS],
                            bd[0, :CHECK_RAYS], bpx[0, :CHECK_RAYS],
                            label="flat train step")
    opt = torch.optim.Adam(field.parameters(), lr=LR)
    batches = [(bo[i], bd[i], bpx[i]) for i in range(TRAIN_STEPS + 1)]
    _timed_steps(field, opt, grid, batches[:1], {}, flat_train_step)
    train_kernels = ("cp_level_features_res", "cp_level_grads_res",
                     "fused_select_grouped", "fused_reselect",
                     "cp_level_features")
    with recording(train_kernels) as recorders:
        rec, paths["flat train"] = drive(
            f"{TRAIN_STEPS} flat training steps",
            lambda: _timed_steps(field, opt, grid, batches[1:], {},
                                 flat_train_step),
            train_kernels,
            ("cp_level_grads", "hash_grad_scatter",
             "hash_grad_scatter_levels", "table_gather"),
        )
    for name, rows in check_trainer_inputs(dev, recorders,
                                           "flat train").items():
        inputs.setdefault(name, []).extend(rows)
    if not all(np.isfinite(r[1]) for r in rec):
        raise AssertionError(f"flat train losses {[r[1] for r in rec]}")
    _check_finite_params("flat training", field)
    step_ms = [r[0] for r in rec]
    print(f"flat train steps ({TRAIN_RAYS} rays): losses "
          f"{[round(r[1], 6) for r in rec]}; step median "
          f"{statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}); live samples per step {[r[2] for r in rec]}"
          f"  [{smi_line()}]")
    print(f"phase 16 (the flat packed API): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths, inputs


def main() -> None:
    dev = phase_device()
    phase_build()
    report = phase_kernels(dev)
    paths = {"render": phase_slice(dev)}
    paths.update(phase_train(dev))
    paths.update(phase_op_backward(dev))
    paths.update(phase_level_scatter(dev))
    paths.update(phase_ngp(dev))
    paths.update(phase_gather_script(dev))
    trainer_counts, trainer_inputs = phase_trainers(dev)
    paths.update(trainer_counts)
    flat_counts, flat_inputs = phase_flat(dev)
    paths.update(flat_counts)
    for name, rows in flat_inputs.items():
        trainer_inputs.setdefault(name, []).extend(rows)
    for entry in report:
        if entry["name"] in trainer_inputs:
            rows = trainer_inputs[entry["name"]]
            entry["at_trainer_inputs"] = rows
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       *(r["max_abs_err"] for r in rows))
        by_path = {p: c[entry["name"]] for p, c in paths.items()
                   if c[entry["name"]]}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} never launched")
    print(f"nvidia-smi: {smi_line()}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.exit(0)
