#!/usr/bin/env python3
"""The trainers' drives on one NVIDIA GPU, over several seeds and, where
the trainer has them, with and without the CUDA kernels, in one process.

    python3 scripts/train_drive_torch.py [--trainer tensocp,ngp,mlp,dnerf,
        proposal,proposal360,u360]
        [--seeds 42,43,44] [--modes kernels,plain] [--max_steps N]
        [--init_npz FILE]
        [--out FILE] [--profile] [--trace_dir DIR]

The trainers (default ``tensocp``): ``tensocp``, ``ngp`` and ``u360`` are
``examples/train_ngp_nerf_torch.py`` at its ``FLAGSHIP``, ``NGP`` and
``U360`` (grid-unbounded) flags, where ``kernels`` adds ``--use_kernel
--fused_march``; ``proposal`` and ``proposal360`` are
``examples/train_proposal_nerf_torch.py`` at its ``DRIVE`` and
``DRIVE_360`` flags, where ``kernels`` adds ``--use_kernel``; ``mlp`` and
``dnerf`` are ``examples/train_mlp_nerf_torch.py`` and
``train_mlp_dnerf_torch.py`` at their ``DRIVE`` flags, which have no
kernel switch and run once per seed (mode ``default``). The mode
``twins`` runs the kernel flags' path with K1, K2, K4, K5 and K6
replaced by their plain PyTorch twins, which compute the same numerics
on the card (K4's f32 sums in another order): it tells a kernel's fault
from its numerics. The
proposal trainers also take the modes ``kernels_field`` and
``kernels_proposal`` (the kernels on that field only, the other on its
plain path) and ``--init_npz``: a file of flax trees under
``<seed>/field/`` and ``<seed>/proposal/`` (the JAX script's initial draw
at ``PRNGKey(seed)``, written by ``export_jax_proposal_init`` in
``tests/test_torch_trainer.py``), loaded into both fields before a run at
that seed; ``ngp`` takes one too, of its hash field under
``<seed>/field/`` (``export_jax_ngp_init``). Each run calls the
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
sums its traces (device-busy and idle ms per step, each ``nerfacc.*`` span's
device, self and idle ms, launches, host-to-device copies, device ms by
kernel); the traces go to ``--trace_dir`` (default
``build/profiles``). No CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
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
    "proposal": ("train_proposal_nerf_torch.py", "DRIVE", "KERNELS"),
    "proposal360": ("train_proposal_nerf_torch.py", "DRIVE_360", "KERNELS"),
    "u360": ("train_ngp_nerf_torch.py", "U360", "KERNELS"),
}


# mode -> (the kernel flags given, the field left on its plain path, the
# kernels replaced by their twins)
MODES = {
    "kernels": (True, None, False),
    "plain": (False, None, False),
    "twins": (True, None, True),
    "kernels_field": (True, "proposal", False),
    "kernels_proposal": (True, "field", False),
}
PROPOSAL_TRAINERS = ("proposal", "proposal360")
# the kernels whose plain twins take the wrapper's arguments: K1, K2, K4,
# K5, K6
TWINS = ("cp_level_features", "cp_level_features_res", "cp_level_grads_res",
         "fused_select_grouped", "fused_reselect")


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


@contextlib.contextmanager
def twins_in_place(names):
    """Inside the block each kernel of ``names`` is replaced, in the module
    that calls it, by its plain twin: the path runs as with the kernel, but
    in plain PyTorch, and the kernel's count stays 0."""
    kernels = cs._trainer_kernels()
    swapped = [(kernels[n][0], kernels[n][1], kernels[n][2]) for n in names]
    wrappers = [getattr(module, attr) for module, attr, _ in swapped]
    for module, attr, plain in swapped:
        setattr(module, attr, plain)
    try:
        yield
    finally:
        for (module, attr, _), wrapper in zip(swapped, wrappers):
            setattr(module, attr, wrapper)


def load_jax_init(t, path: Path, seed: int) -> None:
    """Load the JAX script's initial draw at ``PRNGKey(seed)`` from
    ``path`` into the proposal trainer ``t``'s two fields, or into the NGP
    trainer's hash field."""
    from nerfacc_tpu_torch.convert import ngp_from_flax, tensocp_from_flax

    arrays = np.load(path)
    proposal = hasattr(t, "proposal")
    convert = (tensocp_from_flax if proposal or t.args.model != "ngp"
               else ngp_from_flax)
    for name in ("field", "proposal") if proposal else ("field",):
        prefix, tree = f"{seed}/{name}/", {}
        for key in arrays.files:
            if key.startswith(prefix):
                node = tree
                *parents, leaf = key[len(prefix):].split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = arrays[key]
        if not tree:
            raise KeyError(f"{path} holds no {prefix}")
        convert(tree, getattr(t, name))


def plain_levels(t, field: str) -> None:
    """Put the CP levels of the trainer's ``field`` (``field`` or
    ``proposal``) on their plain path."""
    for level in getattr(t, field).cp_levels:
        level.use_kernel = False


def drive(trainer, seed: int, mode: str = "kernels", max_steps=None,
          name: str = "tensocp", init_npz=None) -> dict:
    """One run of the trainer's main at its drive's flags in ``mode`` (one
    of ``MODES``, or ``default`` for a trainer without kernel flags); its
    numbers and every kernel's launches."""
    kernels, plain_field, use_twins = MODES.get(mode, (False, None, False))
    argv = drive_argv(name, trainer, seed, kernels, max_steps)
    t = None
    if plain_field is not None or init_npz is not None:
        t = trainer.Trainer(trainer.parse_args(argv))
        if init_npz is not None:
            load_jax_init(t, init_npz, seed)
        if plain_field is not None:
            plain_levels(t, plain_field)
    counters = cs.kernel_counters()
    for c in counters.values():
        c.launches = 0
    with twins_in_place(TWINS if use_twins else ()):
        out = (trainer.main(argv) if t is None
               else trainer.main(argv, trainer=t))
    del out["trainer"]
    out["launches"] = {k: c.launches for k, c in counters.items()}
    out["samples_per_s"] = out["samples"] / out["loop_s"]
    return out


def check_modes(name: str, modes) -> list:
    """The modes trainer ``name`` runs: ``default`` alone for a trainer
    without kernel flags; raises on a mode it cannot run."""
    if TRAINERS[name][2] is None:
        return ["default"]
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}: one of {list(MODES)}")
        if MODES[mode][1] is not None and name not in PROPOSAL_TRAINERS:
            raise ValueError(f"mode {mode} is for the proposal trainers")
    return list(modes)


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

    grid = getattr(t, "update_grid", None)  # the proposal trainer has none
    for i in range(300):
        if i % 16 == 0 and grid is not None:
            grid(i)
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
    if grid is not None:
        grid(10**9)
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
    ap.add_argument("--init_npz", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace_dir", type=Path,
                    default=ROOT / "build" / "profiles")
    args = ap.parse_args()
    names = args.trainer.split(",")
    try:
        modes = {name: check_modes(name, args.modes.split(","))
                 for name in names}
    except (KeyError, ValueError) as e:
        ap.error(str(e))
    if args.init_npz is not None and set(names) - {*PROPOSAL_TRAINERS,
                                                   "ngp"}:
        ap.error("--init_npz is for the proposal trainers and ngp")
    dev = cs.phase_device()
    cs.phase_build()
    runs = []
    for name in names:
        trainer = load_trainer(name)
        for mode in modes[name]:
            for seed in (int(s) for s in args.seeds.split(",") if s):
                out = drive(trainer, seed, mode, args.max_steps, name,
                            args.init_npz)
                out.update(trainer=name, mode=mode, seed=seed,
                           init=str(args.init_npz or "torch"))
                runs.append(out)
                launched = {k: v for k, v in out["launches"].items() if v}
                print(f"drive {name} {mode} seed {seed}"
                      + (f" (init {args.init_npz.name})" if args.init_npz
                         else "") + ": PSNR "
                      f"{out['psnr']:.4f} (views "
                      f"{', '.join(f'{p:.4f}' for p in out['psnrs'])}); loop "
                      f"{out['loop_s']:.3f} s, train_time_s "
                      f"{out['train_time_s']:.3f}; {out['samples']} live "
                      f"samples = {out['samples_per_s']:.0f} samples/s; "
                      f"field_budget_dropped {out['field_budget_dropped']}; "
                      f"launches {launched}", flush=True)
                torch.cuda.empty_cache()
        if args.profile:
            for mode in modes[name]:
                if mode in ("kernels", "plain", "default"):
                    profile_trainer(trainer, mode == "kernels",
                                    args.trace_dir, name)
    line = cs.smi_line()
    print(f"nvidia-smi: {line}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=line, device=torch.cuda.get_device_name(dev), runs=runs),
            indent=1))


if __name__ == "__main__":
    main()
