#!/usr/bin/env python3
"""Smoke run of nerfacc_tpu_torch's render path, TensoCP training step and
hash-NGP training step on one NVIDIA GPU.

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
   TensoCP levels (K1 also at 131,072, one chunk of ``update_grid``), and
   K4 once more at G = 1024, where its tables exceed
   a block's shared memory and it takes its global-atomic kernel; march
   selection at 12,288 rays x 32 groups x 64 slots (cone 0 and 0.004),
   re-selection at 12,288 rays x 64 -> 32 slots; the hash-table gradient
   scatter (K7) at the NGP step's 3,145,728 corners for each of the 16
   levels (dense and hashed, every 17th index -1), also against a float64
   ``index_add_``, and its one-launch entry for all 16 levels at 393,216
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

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' launches (in all and per path), errors and times as
JSON, and the one before that the card's name and power limit.
"""

from __future__ import annotations

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
        fused_reselect,
        fused_reselect_plain,
        fused_select_grouped,
        fused_select_grouped_plain,
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

    # K5: grouped slot selection + lattice
    C = SLICE_KW["coarse_stride"]
    sel = {}
    for cone in (0.0, 0.004):
        gsize = rng.randint(1, C + 1, size=(R_SLICE, 1))
        live = rng.randint(0, C + 1, size=(R_SLICE, G_PROBE)) * (
            rng.rand(R_SLICE, G_PROBE) < 0.4)
        live = torch.as_tensor(np.minimum(live, gsize), dtype=torch.int32,
                               device=dev)
        gsize = torch.as_tensor(gsize, dtype=torch.int32, device=dev)
        t_min = torch.as_tensor(rng.rand(R_SLICE).astype(np.float32) * 2.0
                                + 0.05, device=dev)
        kw = dict(k_slots=K_SLOTS, step_size=5e-3, cone_angle=cone)
        got = fused_select_grouped(live, gsize, t_min, **kw)
        want = fused_select_grouped_plain(live, gsize, t_min, **kw)
        torch.cuda.synchronize()
        _check_equal(f"fused_select_grouped cone={cone} ok", got[3], want[3])
        err = max(
            _check_close(f"fused_select_grouped cone={cone} {n}", a, b,
                         T_RTOL, T_ATOL)
            for n, a, b in zip(("ts", "te", "dt"), got[:3], want[:3])
        )
        ms = median_ms(lambda: fused_select_grouped(live, gsize, t_min, **kw))
        pms = median_ms(
            lambda: fused_select_grouped_plain(live, gsize, t_min, **kw))
        print(f"K5 fused_select_grouped R={R_SLICE} G={G_PROBE} K={K_SLOTS} "
              f"cone={cone}: kernel {ms:.4f} ms  plain {pms:.4f} ms  "
              f"max_abs_err {err:.3e}")
        sel[cone] = (ms, pms, err)
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
        max_abs_err=max(v[2] for v in sel.values()),
        ms=sel[0.0][0], plain_ms=sel[0.0][1], library_ms=None,
        **select_bound,
    ))

    # K6: stage-2 re-selection
    masks = torch.as_tensor(rng.rand(R_SLICE, K_SLOTS) < 0.5, device=dev)
    ts = torch.as_tensor(
        np.sort(rng.rand(R_SLICE, K_SLOTS), axis=1).astype(np.float32) * 3.0,
        device=dev)
    dt = torch.as_tensor(
        (rng.rand(R_SLICE, K_SLOTS) * 0.01 + 1e-3).astype(np.float32),
        device=dev)
    te = ts + dt
    got = fused_reselect(masks, ts, te, dt, k2=K_VISIBLE)
    want = fused_reselect_plain(masks, ts, te, dt, k2=K_VISIBLE)
    torch.cuda.synchronize()
    _check_equal("fused_reselect ok", got[3], want[3])
    err = max(
        _check_close(f"fused_reselect {n}", a, b, T_RTOL, T_ATOL)
        for n, a, b in zip(("ts", "te", "dt"), got[:3], want[:3])
    )
    ms = median_ms(lambda: fused_reselect(masks, ts, te, dt, k2=K_VISIBLE))
    pms = median_ms(
        lambda: fused_reselect_plain(masks, ts, te, dt, k2=K_VISIBLE))
    print(f"K6 fused_reselect R={R_SLICE} K={K_SLOTS} k2={K_VISIBLE}: "
          f"kernel {ms:.4f} ms  plain {pms:.4f} ms  max_abs_err {err:.3e}")
    report.append(dict(
        name="fused_reselect", route="cuda",
        source="nerfacc_tpu_torch/csrc/march_select.cu",
        replaces="nerfacc_tpu/ops/march_select.py:259",
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
        # reads the (R, K) bool and three (R, K) f32; writes three (R, K2)
        # f32 and the (R, K2) bool; one add per source slot
        **bound(R_SLICE * 13 * (K_SLOTS + K_VISIBLE), R_SLICE * K_SLOTS),
    ))
    report += check_hash_kernels(dev)
    return report


def check_cp_training_kernels(dev, rng, xu) -> list:
    """K2, K3 and K4 against their twins at the training step's shapes:
    786,432 samples (with u == 0 and u == G - 1 on every axis), both
    levels, a random f32 cotangent."""
    from nerfacc_tpu_torch.ops import (
        cp_grads_slice_width,
        cp_level_features,
        cp_level_features_res_fwd,
        cp_level_features_res_plain,
        cp_level_grads,
        cp_level_grads_plain,
        cp_level_grads_res,
        cp_level_grads_res_plain,
    )

    def grads_err(label, got, want):
        """Max abs error over the three tables, each held to CP_GRAD_REL
        of its twin's largest entry; and the largest such entry."""
        err, scale = 0.0, 0.0
        for a, (d, w) in enumerate(zip(got, want)):
            top = float(w.abs().max())
            err = max(err, _check_close(f"{label} dT{a}", d, w, 0.0,
                                        CP_GRAD_REL * top))
            scale = max(scale, top)
        return err, scale

    acc = {k: [0.0, 0.0, 0.0] for k in ("K2", "K3", "K4")}  # ms, plain, err
    bounds = {k: [] for k in acc}
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

        for key, name, fn, plain in (
            ("K3", "cp_level_grads",
             lambda: cp_level_grads(xu, *tables, cot),
             lambda: cp_level_grads_plain(xu, *tables, cot)),
            ("K4", "cp_level_grads_res",
             lambda: cp_level_grads_res(xu, cot, *us, g),
             lambda: cp_level_grads_res_plain(xu, cot, *us, g)),
        ):
            got, want = fn(), plain()
            torch.cuda.synchronize()
            err, scale = grads_err(f"{key} {shape}", got, want)
            print(f"{key} {name} {shape}: max abs err {err:.3e} = "
                  f"{err / scale:.2e} x max|dT| {scale:.3e}")
            timed.append((key, name, err, fn, plain))
            del got, want

        for key, name, err, fn, plain in timed:
            ms = median_ms(fn)
            pms = median_ms(plain, 3)
            # K2 reads xu and the tables and writes (B, R) f32 plus three
            # (B, R) bf16; K3 reads xu, the tables and g and writes three
            # (G, R) f32; K4 reads xu, g and the three bf16 residuals.
            # ~11 flop per output (K2), ~21 per cotangent (K3, K4: three
            # axes x (two products, two weighted adds) and roundings)
            nb = {"K2": 4 * (3 * B_SAMPLES + 3 * g * r) + 10 * B_SAMPLES * r,
                  "K3": 4 * (3 * B_SAMPLES + 6 * g * r + B_SAMPLES * r),
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
    err, scale = grads_err(f"K4 global route G={g}", got, want)
    ms = median_ms(lambda: cp_level_grads_res(xs, cot, *us, g))
    print(f"K4 cp_level_grads_res B={b} G={g} R={r} (global atomics: "
          f"{3 * g * 32 * 4} bytes of tables for 32 features exceed a "
          f"block's shared memory): kernel {ms:.4f} ms  max abs err "
          f"{err:.3e} = {err / scale:.2e} x max|dT| {scale:.3e}")
    acc["K4"][2] = max(acc["K4"][2], err)
    del tables, cot, xs, us, got, want
    torch.cuda.empty_cache()

    names = {"K2": ("cp_level_features_res", 240),
             "K3": ("cp_level_grads", 198), "K4": ("cp_level_grads_res", 274)}
    return [
        dict(name=names[k][0], route="cuda",
             source="nerfacc_tpu_torch/csrc/cp_encoder.cu",
             replaces=f"nerfacc_tpu/ops/cp_encoder.py:{names[k][1]}",
             max_abs_err=acc[k][2], ms=acc[k][0], plain_ms=acc[k][1],
             library_ms=None, **_sum_bounds(bounds[k]))
        for k in ("K2", "K3", "K4")
    ]


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


def ray_ordered_points(dev) -> torch.Tensor:
    """NGP_FIELD_BUDGET points in the order the NGP step feeds its
    encoder: the rays of bench.py's stream in batch order, on each ray 24
    consecutive samples front to back, a march step (5e-3) apart from a
    random start, mapped into the unit cube of the scene's box and
    clipped. (The step's own samples have gaps where the grid is empty.)"""
    o, d, _ = bench_stream(dev, 1)
    per_ray = NGP_FIELD_BUDGET // TRAIN_RAYS
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


def _serve(field, grid, requests, use_pallas):
    """Render every request; per-request wall time on the host clock."""
    outs, ms = [], []
    for o, d in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(_render(field, grid, o, d, use_pallas))
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


def check_train_card_vs_cpu(dev, o, d, px) -> None:
    """One step of CHECK_RAYS rays on the card (kernels) and on the CPU
    (the same path, plain twins), from the same weights."""
    from nerfacc_tpu_torch import train_step

    results = []
    for device in (dev, torch.device("cpu")):
        field, grid = make_scene(device, use_kernel=True)
        opt = torch.optim.Adam(field.parameters(), lr=LR)
        loss, n = train_step(field, opt, grid, o.to(device), d.to(device),
                             px.to(device), **_train_kw(True, CHECK_RAYS))
        grads = {k: p.grad.cpu() for k, p in field.named_parameters()}
        results.append((float(loss), int(n), grads))
    (loss_c, n_c, g_c), (loss_h, n_h, g_h) = results
    rel = abs(loss_c - loss_h) / loss_h
    worst = max((_rel_l2(g_c[k], g_h[k]), k) for k in g_h)
    print(f"train step card vs CPU ({CHECK_RAYS} rays): loss {loss_c:.7f} vs "
          f"{loss_h:.7f} (rel {rel:.2e}); live samples {n_c} vs {n_h}; "
          f"worst gradient rel L2 err {worst[0]:.2e} ({worst[1]})")
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"train loss card vs CPU: rel err {rel:.2e}")
    if worst[0] > TRAIN_GRAD_L2:
        raise AssertionError(f"gradient {worst[1]} card vs CPU: rel L2 err "
                             f"{worst[0]:.2e}")
    if abs(n_c - n_h) > max(2, n_h // 1000):
        raise AssertionError(f"live samples card {n_c} vs CPU {n_h}")


def _timed_steps(field, opt, grid, batches, kw):
    """Train on each (o, d, px) batch; per step: host ms ending in a
    synchronize, loss, live samples and the kernels' launches."""
    from nerfacc_tpu_torch import train_step

    counters = kernel_counters()
    rec = []
    for o, d, px in batches:
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, n = train_step(field, opt, grid, o, d, px, **kw)
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
    paths = {}
    o, d, px = bench_stream(dev, TRAIN_STEPS + 1)
    check_train_card_vs_cpu(dev, o[0, :CHECK_RAYS], d[0, :CHECK_RAYS],
                            px[0, :CHECK_RAYS])

    field, grid = make_scene(dev, use_kernel=True)
    opt = torch.optim.Adam(field.parameters(), lr=LR)
    kw = _train_kw(True, TRAIN_RAYS)
    batch = [(o[i], d[i], px[i]) for i in range(TRAIN_STEPS + 1)]
    _timed_steps(field, opt, grid, batch[:1], kw)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    rec, paths["train"] = drive(
        f"{TRAIN_STEPS} training steps",
        lambda: _timed_steps(field, opt, grid, batch[1:], kw),
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
        field, opt, grid, batch[:1] * (TRAIN_STEPS + 1), kw)]
    print(f"repeated batch: loss {losses[0]:.7f} -> {losses[-1]:.7f} after "
          f"{TRAIN_STEPS} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on a repeated batch")

    # the plain twin of the whole step: no kernel at all
    pfield, _ = make_scene(dev, use_kernel=False)
    popt = torch.optim.Adam(pfield.parameters(), lr=LR)
    pkw = _train_kw(False, TRAIN_RAYS)
    _timed_steps(pfield, popt, grid, batch[:1], pkw)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    prec, _ = drive("plain training steps",
                    lambda: _timed_steps(pfield, popt, grid, batch[1:4], pkw),
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
    from nerfacc_tpu_torch import render_rays

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
    _timed_steps(field, opt, grid, batch[:1], kw)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    # the table gradient is one launch: the per-level kernel must not run
    others = ("cp_level_features", "cp_level_features_res", "cp_level_grads",
              "cp_level_grads_res", "fused_reselect", "hash_grad_scatter",
              "table_gather")
    rec, paths["ngp train"] = drive(
        f"{NGP_STEPS} NGP training steps",
        lambda: _timed_steps(field, opt, grid, batch[1:], kw),
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
        field, opt, grid, batch[:1] * (NGP_STEPS + 1), kw)]
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
    _timed_steps(pfield, popt, grid, batch[:1], pkw)  # warm-up
    prec, _ = drive("plain NGP training steps",
                    lambda: _timed_steps(pfield, popt, grid, batch[1:4], pkw),
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
    for entry in report:
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
