#!/usr/bin/env python3
"""The trainers' drives on one NVIDIA GPU, over several seeds and, where
the trainer has them, with and without the CUDA kernels, in one process.

    python3 scripts/train_drive_torch.py [--trainer tensocp,ngp,mlp,dnerf]
        [--seeds 42,43,44] [--modes kernels,plain] [--max_steps N]
        [--out FILE] [--profile] [--trace_dir DIR]

The trainers (default ``tensocp``): ``tensocp`` and ``ngp`` are
``examples/train_ngp_nerf_torch.py`` at its ``FLAGSHIP`` and ``NGP``
flags, where ``kernels`` adds ``--use_kernel --fused_march``; ``mlp`` and
``dnerf`` are ``examples/train_mlp_nerf_torch.py`` and
``train_mlp_dnerf_torch.py`` at their ``DRIVE`` flags, which have no
kernel switch and run once per seed (mode ``default``). Each run calls the
script's ``main`` with the seed and prints one line: the held-out PSNR per
view and their mean, the training loop's seconds (host clock ending in a
synchronize), the whole run's (``train_time_s``, as the JAX trainer
reports it), the live samples summed over the steps and per second of the
loop, ``field_budget_dropped``, and every kernel's launches over the run.
The card's name and power limit come first and last; ``--out`` keeps
every run as JSON.

``--profile`` then looks inside the step, for each trainer and mode: a
trainer at the drive's flags (seed 42) takes 300 steps with its grid
updates (past the warm-up), then 20 steps timed on the host clock (each
ending in a synchronize), one sampled grid update timed the same way, and
a ``torch.profiler`` trace of 5 steps summed as ``profile_step_torch.py``
sums its traces (device-busy and wall ms per step, launches, host-to-device
copies, device ms by kernel); the traces go to ``--trace_dir`` (default
``build/profiles``). No CPU mode.
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

# trainer -> (script, its flags' name, the kernel flags or None)
TRAINERS = {
    "tensocp": ("train_ngp_nerf_torch.py", "FLAGSHIP", "KERNELS"),
    "ngp": ("train_ngp_nerf_torch.py", "NGP", "KERNELS"),
    "mlp": ("train_mlp_nerf_torch.py", "DRIVE", None),
    "dnerf": ("train_mlp_dnerf_torch.py", "DRIVE", None),
}


def load_trainer(name: str = "tensocp"):
    """The script of trainer ``name`` as a module."""
    script = TRAINERS[name][0]
    spec = importlib.util.spec_from_file_location(
        script[:-3], ROOT / "examples" / script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def drive_argv(name: str, trainer, seed: int, kernels: bool,
               max_steps=None) -> list:
    """The command line of one run of trainer ``name``."""
    _, flags, kernel_flags = TRAINERS[name]
    argv = list(getattr(trainer, flags)) + ["--seed", str(seed)]
    if max_steps is not None:
        argv += ["--max_steps", str(max_steps)]
    if kernels:
        argv += list(getattr(trainer, kernel_flags))
    return argv


def drive(trainer, seed: int, kernels: bool, max_steps=None,
          name: str = "tensocp") -> dict:
    """One run of the trainer's main at its drive's flags; its numbers and
    every kernel's launches."""
    counters = cs.kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = trainer.main(drive_argv(name, trainer, seed, kernels, max_steps))
    out["launches"] = {k: c.launches for k, c in counters.items()}
    out["samples_per_s"] = out["samples"] / out["loop_s"]
    return out


def profile_trainer(trainer, kernels: bool, trace_dir: Path,
                    name: str = "tensocp") -> None:
    """The step of the drive past its warm-up: host-clock times, one
    sampled grid update, and a profiler trace of 5 steps."""
    import profile_step_torch

    t = trainer.Trainer(trainer.parse_args(
        drive_argv(name, trainer, 42, kernels)))
    n_rays = t.args.num_rays

    def step(i=300):
        batch = t.scene.sample_batch(n_rays)
        rays, rest = batch[0], batch[1:]
        if name == "dnerf":  # the rays' times and the step number
            rest = (*rest, i)
        return t.train_step(rays.origins, rays.viewdirs, *rest)

    for i in range(300):
        if i % 16 == 0:
            t.update_grid(i)
        step(i)
    ms, live = [], []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = step()[1]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        live.append(int(n))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.update_grid(10**9)
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    mode = "kernels" if kernels else "plain"
    print(f"{name} trainer step ({mode}, past 300 steps): median "
          f"{statistics.median(ms):.3f} ms (min {min(ms):.3f}, max "
          f"{max(ms):.3f}) over 20 steps; live samples median "
          f"{statistics.median(live)}; a sampled grid update {grid_ms:.3f} ms")
    trace_dir.mkdir(parents=True, exist_ok=True)
    trace = trace_dir / f"{name}_step_{mode}.json"
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
    ap.add_argument("--trainer", default="tensocp",
                    help="comma-separated: " + ", ".join(TRAINERS))
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
    runs = []
    for name in args.trainer.split(","):
        trainer = load_trainer(name)
        modes = (args.modes.split(",") if TRAINERS[name][2]
                 else ["default"])
        for mode in modes:
            for seed in (int(s) for s in args.seeds.split(",") if s):
                out = drive(trainer, seed, mode == "kernels", args.max_steps,
                            name)
                out.update(trainer=name, mode=mode, seed=seed)
                runs.append(out)
                launched = {k: v for k, v in out["launches"].items() if v}
                print(f"drive {name} {mode} seed {seed}: PSNR "
                      f"{out['psnr']:.4f} (views "
                      f"{', '.join(f'{p:.4f}' for p in out['psnrs'])}); loop "
                      f"{out['loop_s']:.3f} s, train_time_s "
                      f"{out['train_time_s']:.3f}; {out['samples']} live "
                      f"samples = {out['samples_per_s']:.0f} samples/s; "
                      f"field_budget_dropped {out['field_budget_dropped']}; "
                      f"launches {launched}", flush=True)
                torch.cuda.empty_cache()
        if args.profile:
            for mode in modes:
                profile_trainer(trainer, mode == "kernels", args.trace_dir,
                                name)
    line = cs.smi_line()
    print(f"nvidia-smi: {line}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=line, device=torch.cuda.get_device_name(dev), runs=runs),
            indent=1))


if __name__ == "__main__":
    main()
