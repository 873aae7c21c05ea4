#!/usr/bin/env python3
"""Smoke run of nerfacc_tpu_torch's forward render path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits nonzero):

1. Device: the card's name and power limit from ``nvidia-smi``. Without
   CUDA the script stops here: it never runs on the CPU.
2. Build: compiles the CUDA kernels of ``nerfacc_tpu_torch/csrc`` with
   ``nvcc`` into ``build/nerfacc_tpu_torch/`` and reports the seconds.
3. Kernels vs plain twins on the card, at the render path's shapes:
   the CP encoder at 786,432 samples for both TensoCP levels, march
   selection at 12,288 rays x 32 groups x 64 slots (cone 0 and 0.004),
   re-selection at 12,288 rays x 64 -> 32 slots. Median times of both.
4. The render path: four 128x128 views of the procedural scene through
   ``render_image`` with the flagship TensoCP field (random weights from a
   seed), the trained 128^3 occupancy grid, the fused march and the
   two-stage visibility cull. Outputs must be finite with opacities in
   [0, 1], every kernel must have launched, the march must match the
   unfused march bit for bit, the render must agree with the render
   through the plain paths, and a 16x16 crop must agree with the same
   path run on the CPU.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' launches, errors and times as JSON.
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


def median_ms(fn, iters: int = 20) -> float:
    """Median of per-call times on the card, after a warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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

    # K1: CP level features, both flagship levels
    xu_np = rng.rand(B_SAMPLES, 3).astype(np.float32)
    xu_np[:64] = 0.0  # u == 0 on every axis
    xu_np[64:128] = 1.0  # u == G - 1: the last node, one tap
    xu = torch.as_tensor(xu_np, device=dev)
    cp_ms = cp_plain_ms = cp_err = 0.0
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
        pms = median_ms(lambda: cp_level_features_plain(xu, *tables), 5)
        print(f"K1 cp_level_features B={B_SAMPLES} G={g} R={r}: "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms  max_abs_err {err:.3e}")
        cp_ms, cp_plain_ms, cp_err = cp_ms + ms, cp_plain_ms + pms, max(cp_err, err)
    report.append(dict(
        name="cp_level_features", route="cuda",
        source="nerfacc_tpu_torch/csrc/cp_encoder.cu",
        replaces="nerfacc_tpu/ops/cp_encoder.py:173",
        max_abs_err=cp_err, ms=cp_ms, plain_ms=cp_plain_ms,
    ))

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
    report.append(dict(
        name="fused_select_grouped", route="cuda",
        source="nerfacc_tpu_torch/csrc/march_select.cu",
        replaces="nerfacc_tpu/ops/march_select.py:136",
        max_abs_err=max(v[2] for v in sel.values()),
        ms=sel[0.0][0], plain_ms=sel[0.0][1],
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
        max_abs_err=err, ms=ms, plain_ms=pms,
    ))
    return report


def make_requests(dev: torch.device) -> list:
    """Four 128x128 views of the procedural scene: (origins, directions)."""
    from nerfacc_tpu_torch.datasets import generate_rays, look_at_poses

    poses = look_at_poses(N_VIEWS, radius=3.2, elevation_deg=20.0)
    focal = 0.5 * IMAGE / np.tan(0.5 * np.deg2rad(45.0))
    K = torch.tensor([[focal, 0, IMAGE / 2], [0, focal, IMAGE / 2],
                      [0, 0, 1]], dtype=torch.float32)
    y, x = torch.meshgrid(torch.arange(IMAGE), torch.arange(IMAGE),
                          indexing="ij")
    out = []
    for pose in poses:
        rays = generate_rays(x.reshape(-1), y.reshape(-1), pose, K)
        out.append((rays.origins.contiguous().to(dev),
                    rays.viewdirs.contiguous().to(dev)))
    return out


def make_scene(dev: torch.device, use_kernel: bool):
    from nerfacc_tpu_torch.convert import grid_from_arrays
    from nerfacc_tpu_torch.models import TensoCPRadianceField

    field = TensoCPRadianceField(
        aabb=AABB, use_kernel=use_kernel,
        generator=torch.Generator().manual_seed(SEED),
    ).to(dev)
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


def phase_slice(dev: torch.device, report: list) -> None:
    from nerfacc_tpu_torch import render_rays
    from nerfacc_tpu_torch.ops import (
        cp_level_features,
        fused_reselect,
        fused_select_grouped,
    )

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
    kernels = (cp_level_features, fused_select_grouped, fused_reselect)
    for fn in kernels:
        fn.launches = 0
    outs, ms = _serve(field, grid, requests, True)
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"launches in the render of {N_VIEWS} requests: {launches}")
    for entry in report:
        entry["launches"] = launches[entry["name"]]
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} never launched")
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


def main() -> None:
    dev = phase_device()
    phase_build()
    report = phase_kernels(dev)
    phase_slice(dev, report)
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
