#!/usr/bin/env python3
"""The TensoCP trainer's flagship drive on one NVIDIA GPU, with and
without the CUDA kernels and over several seeds, in one process.

    python3 scripts/train_drive_torch.py [--seeds 42,43,44]
        [--modes kernels,plain] [--max_steps 1000] [--out FILE]
        [--profile] [--trace_dir DIR]

Each run calls ``examples/train_ngp_nerf_torch.py``'s ``main`` with the
flagship flags (``FLAGSHIP``; ``kernels`` adds ``--use_kernel
--fused_march``) and the seed, and prints one line: the held-out PSNR per
view and their mean, the training loop's seconds (host clock ending in a
synchronize), the whole run's (``train_time_s``: evaluation included, as
the JAX trainer reports it), the live samples summed over the steps and
per second of the loop, ``field_budget_dropped``, and the launches of the
CP and march kernels over the run. The card's name and power limit come
first and last; ``--out`` keeps every run as JSON.

``--profile`` then looks inside the step, for each mode: a trainer at the
flagship flags (seed 42) takes 300 steps with its grid updates (past the
warm-up), then 20 steps timed on the host clock (each ending in a
synchronize), one sampled grid update timed the same way, and a
``torch.profiler`` trace of 5 steps summed as ``profile_step_torch.py``
sums its traces (device-busy and wall ms per step, launches, device ms by
kernel); the traces go to ``--trace_dir`` (default ``build/profiles``).
No CPU mode.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402  (the card's line, the counters)

KERNELS = ("cp_level_features", "cp_level_features_res", "cp_level_grads",
           "cp_level_grads_res", "fused_select_grouped", "fused_reselect")


def load_trainer():
    """``examples/train_ngp_nerf_torch.py`` as a module."""
    path = ROOT / "examples" / "train_ngp_nerf_torch.py"
    spec = importlib.util.spec_from_file_location("train_ngp_nerf_torch",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def drive(trainer, seed: int, kernels: bool, max_steps=None) -> dict:
    """One run of the trainer's main at the flagship flags; its numbers
    and the kernels' launches."""
    argv = list(trainer.FLAGSHIP) + ["--seed", str(seed)]
    if max_steps is not None:
        argv += ["--max_steps", str(max_steps)]
    if kernels:
        argv += list(trainer.KERNELS)
    counters = cs.kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = trainer.main(argv)
    out["launches"] = {k: counters[k].launches for k in KERNELS}
    out["samples_per_s"] = out["samples"] / out["loop_s"]
    return out


def profile_trainer(trainer, kernels: bool, trace_dir: Path) -> None:
    """The step of the flagship run past its warm-up: host-clock times,
    one sampled grid update, and a profiler trace of 5 steps."""
    import profile_step_torch

    argv = [*trainer.FLAGSHIP, "--seed", "42"]
    if kernels:
        argv += list(trainer.KERNELS)
    t = trainer.Trainer(trainer.parse_args(argv))
    n_rays = t.args.num_rays

    def step():
        rays, pixels = t.scene.sample_batch(n_rays)
        return t.train_step(rays.origins, rays.viewdirs, pixels)

    for i in range(300):
        if i % 16 == 0:
            t.update_grid(i)
        step()
    ms, live = [], []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n, _ = step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        live.append(int(n))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.update_grid(10**9)
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    mode = "kernels" if kernels else "plain"
    print(f"trainer step ({mode}, past 300 steps): median "
          f"{statistics.median(ms):.3f} ms (min {min(ms):.3f}, max "
          f"{max(ms):.3f}) over 20 steps; live samples median "
          f"{statistics.median(live)}; a sampled grid update {grid_ms:.3f} ms")
    trace_dir.mkdir(parents=True, exist_ok=True)
    trace = trace_dir / f"trainer_step_{mode}.json"
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(profile_step_torch.PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    profile_step_torch._trace_summary(trace, profile_step_torch.PROFILED_STEPS)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="42,43,44")
    ap.add_argument("--modes", default="kernels,plain")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace_dir", type=Path,
                    default=ROOT / "build" / "profiles")
    args = ap.parse_args()
    dev = cs.phase_device()
    cs.phase_build()
    trainer = load_trainer()
    runs = []
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",") if s):
            out = drive(trainer, seed, mode == "kernels", args.max_steps)
            out.update(mode=mode, seed=seed)
            runs.append(out)
            print(f"drive {mode} seed {seed}: PSNR {out['psnr']:.4f} (views "
                  f"{', '.join(f'{p:.4f}' for p in out['psnrs'])}); loop "
                  f"{out['loop_s']:.3f} s, train_time_s "
                  f"{out['train_time_s']:.3f}; {out['samples']} live "
                  f"samples = {out['samples_per_s']:.0f} samples/s; "
                  f"field_budget_dropped {out['field_budget_dropped']}; "
                  f"launches {out['launches']}", flush=True)
            torch.cuda.empty_cache()
    if args.profile:
        for mode in args.modes.split(","):
            profile_trainer(trainer, mode == "kernels", args.trace_dir)
    line = cs.smi_line()
    print(f"nvidia-smi: {line}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=line, device=torch.cuda.get_device_name(dev), runs=runs),
            indent=1))


if __name__ == "__main__":
    main()
