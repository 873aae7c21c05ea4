#!/usr/bin/env python3
"""Where the time of nerfacc_tpu_torch's training steps goes, on one
NVIDIA GPU.

    python3 scripts/profile_step_torch.py [--model ngp|tensocp|both|render]
        [--steps N] [--trace_dir DIR] [--scatter_run_length N]

The steps are ``chip_smoke.py``'s, 16,384 rays and Adam: the reference NGP
field at full width with live-sample compaction of the field, and the
flagship TensoCP field. For the kernel configuration (NGP:
``pallas_grad=True, use_pallas=True``; TensoCP: ``use_kernel=True,
use_pallas=True``) and the plain one of each model asked for (default:
both) it prints:

1. the step's host-clock time over ``--steps`` steps (median, min, max);
2. from a ``torch.profiler`` trace of 5 steps with the host's operations:
   device-busy and idle time per step (the idle time inflated by the
   host's recording), kernel launches and host-to-device copies per step,
   each ``nerfacc.*`` span's device, self and idle ms per step (the
   benchmark's attribution, ``port_bench/harness/spans.py``), device ms
   per step by kernel name (the 25 largest, then every hand-written
   kernel of the package below them), and the per-level hash-table
   scatter's ms per level where it ran;
3. for NGP, the step's layers on their own, timed with CUDA events at the
   shapes (393,216 compacted samples): the index arithmetic, the table
   gather and blend, the table gradient with the scatter kernel and with
   ``index_add_`` (on uniform random points and on points laid along
   rays, as the step feeds them), the heads forward and backward, and
   Adam over the table.

``--model render`` profiles chip_smoke's four 128x128 render requests
with the TensoCP field instead (kernel configuration; per request).
``--scatter_run_length`` sets, for this run, how many consecutive samples
a thread of the hash-table scatter sums before it adds
(``ops.hash_gather.SCATTER_RUN_LENGTH``), to compare lengths inside the
step.

The card's name and power limit come first. The chrome traces go to
``<trace_dir>/<model>_step_<config>.json`` (default ``build/profiles``).
No CPU mode.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the scene, the ray stream, the timers)
from port_bench.harness.spans import stage_table  # noqa: E402

PROFILED_STEPS = 5


def _trace_summary(path: Path, n_steps: int, unit: str = "step") -> None:
    """Sums of the chrome trace's device events, per step (or request),
    and the device and idle time of each of the program's spans."""
    events = json.loads(path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        rec = by_name[e["name"]]
        rec[0] += e["dur"]
        rec[1] += 1
    kernels = sum(1 for e in dev if e["cat"] == "kernel")
    h2d = sum(1 for e in dev if e["cat"] == "gpu_memcpy"
              and "HtoD" in e["name"])
    # each device operation goes to the nerfacc.* span open at its launch,
    # each idle gap to the span whose launch ended it (the benchmark's rule)
    table = stage_table(events, n_steps)
    print(f"  profiled {n_steps} {unit}s: device busy "
          f"{table['device_ms']:.3f} ms and idle {table['idle_ms']:.3f} ms "
          f"per {unit}, idle inflated by the host's recording (the card "
          f"waits while the profiler records each host operation); "
          f"{kernels / n_steps:.0f} kernel launches and {h2d / n_steps:.1f} "
          f"host-to-device copies per {unit}")
    print(f"  by the program's spans, per {unit}: device ms (children "
          f"included), self ms, idle ms (inflated as above), kernels")
    for name, r in sorted(table["stages"].items(),
                          key=lambda kv: -kv[1]["device_ms"]):
        print(f"    {r['device_ms']:8.3f} {r['self_ms']:8.3f} "
              f"{r['idle_ms']:8.3f} {r['launches']:7.1f}  {name}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the 25 longest, then any hand-written kernel of the package below them
    own = re.compile(r"^(void )?\(anonymous namespace\)::")
    shown = ranked[:25] + [kv for kv in ranked[25:] if own.match(kv[0])]
    for name, (dur, count) in shown:
        print(f"    {dur / n_steps / 1e3:8.3f} ms/{unit}  "
              f"{count / n_steps:6.1f} x  {name[:110]}")
    # the per-level kernel only (the one-launch entry is one line above)
    scatter = sorted((e for e in dev
                      if "hash_grad_scatter_kernel" in e["name"]),
                     key=lambda e: e["ts"])
    if scatter:
        per_level = defaultdict(list)
        for i, e in enumerate(scatter):
            per_level[i % cs.NGP_LEVELS].append(e["dur"] / 1e3)
        print("  hash_grad_scatter ms per level (median over the steps): "
              + ", ".join(f"{statistics.median(per_level[lv]):.4f}"
                          for lv in range(cs.NGP_LEVELS)))


def profile_config(dev, model: str, name: str, kernels: bool, batch,
                   n_steps: int, trace_dir: Path) -> None:
    from nerfacc_tpu_torch import train_step as step

    if model == "ngp":
        field, grid = cs.make_ngp_scene(dev, pallas_grad=kernels)
        kw = cs._ngp_kw(kernels, cs.TRAIN_RAYS)
    else:
        field, grid = cs.make_scene(dev, use_kernel=kernels)
        kw = cs._train_kw(kernels, cs.TRAIN_RAYS)
    opt = torch.optim.Adam(field.parameters(), lr=cs.LR)
    cs._timed_steps(field, opt, grid, batch[:3], kw, step)  # warm-up
    rec = cs._timed_steps(
        field, opt, grid, [batch[i % len(batch)] for i in range(n_steps)], kw,
        step)
    ms = [r[0] for r in rec]
    live = [r[2] for r in rec]
    print(f"{model} {name}: step median {statistics.median(ms):.3f} ms (min "
          f"{min(ms):.3f}, max {max(ms):.3f}) over {n_steps} steps; live "
          f"samples median {statistics.median(live)}")
    trace_dir.mkdir(parents=True, exist_ok=True)
    trace = trace_dir / f"{model}_step_{name}.json"
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        cs._timed_steps(field, opt, grid, batch[:PROFILED_STEPS], kw, step)
    prof.export_chrome_trace(str(trace))
    _trace_summary(trace, PROFILED_STEPS)


def profile_render(dev, trace_dir: Path) -> None:
    """chip_smoke's render requests, kernel configuration."""
    field, grid = cs.make_scene(dev, use_kernel=True)
    requests = cs.make_requests(dev)
    cs._serve(field, grid, requests, True)  # warm-up
    _, ms = cs._serve(field, grid, requests, True)
    print(f"render kernels: request median {statistics.median(ms):.3f} ms "
          f"(min {min(ms):.3f}, max {max(ms):.3f}) over {len(ms)} requests")
    trace_dir.mkdir(parents=True, exist_ok=True)
    trace = trace_dir / "render_requests_kernels.json"
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        cs._serve(field, grid, requests, True)
    prof.export_chrome_trace(str(trace))
    _trace_summary(trace, len(requests), "request")


def layer_times(dev) -> None:
    """The NGP step's layers on their own at the step's shapes."""
    from nerfacc_tpu_torch.models import (
        hash_grid_indices,
        spherical_harmonics_deg4,
    )
    from nerfacc_tpu_torch.ops import hash_encode_lookup

    rng = np.random.RandomState(0)
    n = cs.NGP_FIELD_BUDGET
    field, _ = cs.make_ngp_scene(dev, pallas_grad=True)
    enc = field.encoder
    x = torch.as_tensor(rng.rand(n, 3).astype(np.float32), device=dev)
    d = torch.nn.functional.normalize(
        torch.as_tensor(rng.randn(n, 3).astype(np.float32), device=dev),
        dim=-1)
    g = torch.as_tensor(
        rng.randn(n, enc.latent_dim).astype(np.float32), device=dev)
    idx, w = hash_grid_indices(x, enc._res, enc._dense, enc.n_entries)
    print(f"layers at {n} samples (CUDA events, median of 10):")
    print(f"  index arithmetic (hash_grid_indices): "
          f"{cs.median_ms(lambda: hash_grid_indices(x, enc._res, enc._dense, enc.n_entries), 10):.3f} ms")
    with torch.no_grad():
        ms = cs.median_ms(lambda: hash_encode_lookup(
            enc.table, idx, w, enc.n_entries), 10)
    print(f"  table gather and blend (lookup forward): {ms:.3f} ms")
    ray_idx, ray_w = hash_grid_indices(
        cs.ray_ordered_points(dev), enc._res, enc._dense, enc.n_entries)
    with torch.no_grad():
        ray_ms = cs.median_ms(lambda: hash_encode_lookup(
            enc.table, ray_idx, ray_w, enc.n_entries), 10)
    for points, (pi, pw, fwd) in (("uniform random points", (idx, w, ms)),
                                  ("ray-ordered points",
                                   (ray_idx, ray_w, ray_ms))):
        for label, scatter in (("scatter kernel", True),
                               ("index_add_", False)):
            def fwd_bwd():
                enc.table.grad = None
                hash_encode_lookup(enc.table, pi, pw, enc.n_entries,
                                   scatter).backward(g)
            total = cs.median_ms(fwd_bwd, 10)
            print(f"  lookup forward + table gradient ({label}, {points}): "
                  f"{total:.3f} ms (gradient alone {total - fwd:.3f} ms)")
    del ray_idx, ray_w
    feats = torch.as_tensor(
        rng.randn(n, enc.latent_dim).astype(np.float32) * 1e-4, device=dev)
    heads = [p for k, p in field.named_parameters() if k != "encoder.table"]

    def heads_fwd_bwd():
        for p in heads:
            p.grad = None
        h = field.mlp_base(feats)
        sh = torch.cat([spherical_harmonics_deg4(d), h[..., 1:]], dim=-1)
        (torch.sigmoid(field.mlp_head(sh)).sum() + h[..., :1].sum()).backward()

    print(f"  heads forward + backward (f32, with the SH encoding): "
          f"{cs.median_ms(heads_fwd_bwd, 10):.3f} ms")
    table = torch.nn.Parameter(torch.zeros_like(enc.table))
    table.grad = torch.full_like(table, 1e-3)
    opt = torch.optim.Adam([table], lr=cs.LR)
    print(f"  Adam over the {table.numel()}-float table: "
          f"{cs.median_ms(opt.step, 10):.3f} ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("ngp", "tensocp", "both", "render"),
                    default="both")
    ap.add_argument("--scatter_run_length", type=int, default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace_dir", type=Path,
                    default=ROOT / "build" / "profiles")
    args = ap.parse_args()
    dev = cs.phase_device()
    t0 = time.perf_counter()
    cs.phase_build()
    print(f"build and load: {time.perf_counter() - t0:.1f} s")
    if args.scatter_run_length is not None:
        from nerfacc_tpu_torch.ops import hash_gather

        hash_gather.SCATTER_RUN_LENGTH = args.scatter_run_length
        print(f"scatter run length: {args.scatter_run_length}")
    if args.model == "render":
        profile_render(dev, args.trace_dir)
    o, d, px = cs.bench_stream(dev, 8)
    batch = [(o[i], d[i], px[i]) for i in range(8)]
    for model in ("tensocp", "ngp"):
        if args.model not in (model, "both"):
            continue
        for name, kernels in (("kernels", True), ("plain", False)):
            profile_config(dev, model, name, kernels, batch, args.steps,
                           args.trace_dir)
        if model == "ngp":
            layer_times(dev)
    print(f"nvidia-smi: {cs.smi_line()}")


if __name__ == "__main__":
    main()
