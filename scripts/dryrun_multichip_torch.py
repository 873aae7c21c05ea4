#!/usr/bin/env python3
"""The data-parallel training step of the TensoCP and hash-NGP fields over
``torch.distributed``: the port of ``__graft_entry__.dryrun_multichip``, at
the flagship's full width.

    python3 scripts/dryrun_multichip_torch.py --world 2 --backend gloo
    python3 scripts/dryrun_multichip_torch.py --world 1 --backend nccl --model ngp
    torchrun --nproc_per_node 4 scripts/dryrun_multichip_torch.py

One process per card (``--world N`` spawns them with a file rendezvous;
under ``torchrun`` each rank runs the step itself). Two processes may share
one card under gloo, since NCCL refuses a second rank on a device.

The step is the dry run's cadence: ``update_grid_distributed`` (each
rank's own cells, merged by an all-reduce MAX), ``render_rays(...,
aux=pixels, return_compact=True)`` and ``training.compact_mse`` on the
rank's shard of the rays, backward, the **mean** of the gradients and the
loss over the world (one all-reduce of one flat buffer), Adam. The field
is the flagship TensoCP at its default levels ``((128, 64), (512, 128))``
with the CP kernels (``--model ngp``: the reference NGP field, 16 levels x
2 features x 2^19 entries, with K7 and a field budget of half the
samples), the grid ``bench_assets/trained_grid.npz`` at 128^3, 16,384
rays in all from bench.py's stream, 48 slots per ray and 24 after the
flagship trainer's two-stage visibility cull (each rank's budgets are its
rays x 48 and x 24, so K and K2 are the single process's), step 5e-3, the
fused march with dilated probes in 32 groups of 16. The TensoCP step runs
K1 (the grid update and the cull), K2, K4, K5 and K6; the NGP step K5, K6
and K7.

Then the equality check of the dry run: the same weights and rays, with
empty-ray compaction off (a fractional compaction budget truncates other
ray sets per shard) and no grid update (each rank's draws differ by
design); the sharded colours, loss and mean gradients against one process
on the whole batch (rank 0 runs it): colours within rtol 1e-5 / atol 1e-6,
the loss within rtol 1e-5, each gradient within relative L2 5e-3 (adding
per-shard sums, then all-reducing, is another order of summation than one
whole-batch sum; the JAX package measured that split at 1.6-1.9e-3 per
leaf). Prints the cards' names and power limits, each rank's step ms and
losses, the collectives' ms (the gradient all-reduce; the grid's MAX
all-reduce, 128^3 f32 = 8.4 MB) and the check's errors; exits nonzero if
the check fails.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
N_RAYS, K_SLOTS, K_VISIBLE, LR, SEED = 16384, 48, 24, 1e-3, 0
STEPS = 5  # timed steps after one warm-up
TIMEOUT_S = 600.0  # a spawned world's deadline
# the flagship's training march (bench.py --mode train --fused_march),
# with the flagship trainer's two-stage cull (half the slots kept)
MARCH_KW = dict(scene_aabb=AABB, render_step_size=5e-3,
                max_samples_per_ray=1024, coarse_stride=16, probe_dilation=2,
                probe_groups=32, use_pallas=True)
COMPACTION = 0.75  # the step's empty-ray compaction (off for the check)
NGP_FIELD_RATIO = 0.5  # --model ngp: the field's budget, of the samples
# the equality check's bounds (module docstring)
COLOR_RTOL, COLOR_ATOL, LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-6, 1e-5, 5e-3


def make_field(model: str, device, seed: int = SEED):
    """The flagship TensoCP field with the CP kernels, or the reference NGP
    field with K7, from ``seed`` (drawn on the CPU, then moved)."""
    from nerfacc_tpu_torch.models import NGPRadianceField, TensoCPRadianceField

    gen = torch.Generator().manual_seed(seed)
    if model == "ngp":
        return NGPRadianceField(aabb=AABB, pallas_grad=True, generator=gen,
                                device=device)
    return TensoCPRadianceField(aabb=AABB, use_kernel=True, generator=gen,
                                device=device)


def make_grid(device):
    """The trained 128^3 grid of ``bench_assets``."""
    from nerfacc_tpu_torch.convert import grid_from_arrays

    asset = np.load(ROOT / "bench_assets" / "trained_grid.npz")
    return grid_from_arrays(AABB, asset["binary"], asset["occs"],
                            device=device)


def make_batch(n_rays: int, device, seed: int = SEED):
    """bench.py's train-mode rays and pixels (RandomState(seed)): origins
    uniform in [-1, 1]^3, normalised Gaussian directions, uniform pixels,
    (n_rays, 3) f32 each."""
    r = np.random.RandomState(seed)
    o = (r.rand(n_rays, 3) * 2 - 1).astype(np.float32)
    d = r.randn(n_rays, 3).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    px = r.rand(n_rays, 3).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (o, d, px)]


def render_kw(model: str, n_local: int, compaction=COMPACTION,
              k_slots: int = K_SLOTS, k_visible: int = K_VISIBLE,
              march_kw=MARCH_KW) -> dict:
    """``render_rays``' arguments for a shard of ``n_local`` rays: K slots
    per ray and K2 after the cull, whatever the shard's size."""
    kw = dict(march_kw, samples_budget=n_local * k_slots,
              visible_samples_budget=n_local * k_visible,
              compact_rays_fraction=compaction)
    if model == "ngp":
        kw["field_samples_budget"] = int(n_local * k_slots * NGP_FIELD_RATIO)
    return kw


def local_loss(field, grid, o, d, px, kw):
    """``compact_mse`` of one shard's render; returns the loss, the
    selected rays' colours and the live samples."""
    from nerfacc_tpu_torch import compact_mse, render_rays

    colors, _, _, n, sel = render_rays(
        field, o, d, grid=grid, render_bkgd=torch.ones(3, device=o.device),
        aux=px, return_compact=True, **kw)
    return compact_mse(colors, sel, px), colors, n


def _mean_over_world(field, mesh, *scalars):
    """The mean over the mesh of the parameters' gradients and of
    ``scalars``: one all-reduce of one flat buffer (``psum_grads``), then a
    division by the world's size. Returns the scalars' means."""
    from nerfacc_tpu_torch.parallel import psum_grads

    params = [p for p in field.parameters() if p.grad is not None]
    world = mesh.axis_size("data")
    tree = [p.grad for p in params] + [s.detach().float().reshape(1)
                                       for s in scalars]
    summed = psum_grads(tree, mesh=mesh)
    with torch.no_grad():
        for p, g in zip(params, summed):
            p.grad.copy_(g / world)
    return [s[0] / world for s in summed[len(params):]]


def dp_step(field, opt, mesh, kw, key, grid_update: bool = True):
    """The data-parallel training step over ``mesh``: ``step(grid, rays_o,
    rays_d, pixels, step_index) -> (grid, loss, live samples)``, the rays
    the whole batch (each rank trains on its shard). The grid update
    (``update_grid_distributed`` on ``key``, a generator or an int seed
    replicated on every rank; at ``step_index``) runs unless
    ``grid_update`` is False; the loss and the live samples are the
    world's mean and sum."""
    from nerfacc_tpu_torch.parallel import (
        data_parallel,
        update_grid_distributed,
    )

    step_size = kw["render_step_size"]

    def local_step(grid, o, d, px, step_index):
        if grid_update:
            grid = update_grid_distributed(
                grid, key, step_index,
                lambda x: field.query_opacity(x, step_size))
        opt.zero_grad(set_to_none=True)
        loss, _, n = local_loss(field, grid, o, d, px, kw)
        loss.backward()
        world = mesh.axis_size("data")
        loss, n = _mean_over_world(field, mesh, loss, n)
        opt.step()
        return grid, loss, n * world

    return data_parallel(local_step, mesh, batched_args=(1, 2, 3), n_out=3,
                         replicated_out=(0, 1, 2))


def sharded_loss_grads(field, grid, o, d, px, mesh, kw):
    """The equality check's sharded side: each rank's loss and gradients on
    its shard, meaned over the world, and every ray's colour gathered.
    Returns ``(loss, colours (n_rays, 3), {name: gradient})``."""
    from nerfacc_tpu_torch.parallel import data_parallel

    def local(o, d, px):
        field.zero_grad(set_to_none=True)
        loss, colors, _ = local_loss(field, grid, o, d, px, kw)
        loss.backward()
        (loss,) = _mean_over_world(field, mesh, loss)
        return loss, colors.detach()

    loss, colors = data_parallel(local, mesh, batched_args=(0, 1, 2),
                                 n_out=2, replicated_out=(0,))(o, d, px)
    return loss, colors, {k: p.grad.clone()
                          for k, p in field.named_parameters()}


def single_loss_grads(field, grid, o, d, px, kw):
    """The same on the whole batch in one process."""
    field.zero_grad(set_to_none=True)
    loss, colors, _ = local_loss(field, grid, o, d, px, kw)
    loss.backward()
    return loss.detach(), colors.detach(), {
        k: p.grad.clone() for k, p in field.named_parameters()}


def rel_l2(a, b) -> float:
    return float(torch.linalg.norm(a.double() - b.double())
                 / torch.linalg.norm(b.double()).clamp(min=1e-30))


def compare(got, want, color_rtol=COLOR_RTOL, color_atol=COLOR_ATOL,
            loss_rtol=LOSS_RTOL, grad_rel=GRAD_REL_L2) -> dict:
    """Hold ``(loss, colours, grads)`` to another run's; returns the
    errors, and raises past the bounds."""
    (l1, c1, g1), (l0, c0, g0) = got, want
    loss_rel = abs(float(l1) - float(l0)) / abs(float(l0))
    color_err = float((c1 - c0).abs().max())
    bad = (c1 - c0).abs() > color_atol + color_rtol * c0.abs()
    grads = {k: rel_l2(g1[k], g0[k]) for k in g0}
    worst = max(grads, key=grads.get)
    out = dict(loss_rel=loss_rel, color_max_abs=color_err,
               grad_rel_l2=grads[worst], worst_leaf=worst)
    if loss_rel > loss_rtol:
        raise AssertionError(f"loss {float(l1)} vs {float(l0)}: rel "
                             f"{loss_rel:.2e} > {loss_rtol}")
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} colours outside rtol "
                             f"{color_rtol} / atol {color_atol} (max abs "
                             f"{color_err:.2e})")
    if grads[worst] > grad_rel:
        raise AssertionError(f"gradient {worst}: relative L2 "
                             f"{grads[worst]:.2e} > {grad_rel}")
    return out


def time_collectives(field, grid, mesh, iters: int = 10) -> dict:
    """ms of the step's two collectives on this rank: the gradient
    all-reduce (every parameter's size, one flat f32 buffer) and the grid's
    MAX all-reduce (its occupancies). Card: CUDA events; CPU: the host
    clock. Median of ``iters``."""
    buf = torch.zeros(sum(p.numel() for p in field.parameters()),
                      device=grid.occs.device)
    occs = grid.occs.clone()
    out = {}
    for name, t, op in (("grad_allreduce", buf, dist.ReduceOp.SUM),
                        ("grid_max_allreduce", occs, dist.ReduceOp.MAX)):
        times = []
        for _ in range(iters + 1):
            dist.barrier()
            if t.is_cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                dist.all_reduce(t, op=op)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                dist.all_reduce(t, op=op)
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times[1:])
        out[name + "_bytes"] = t.numel() * t.element_size()
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_steps(field, opt, grid, mesh, kw, o, d, px, n_steps: int, key,
              first_step: int = 0, grid_update: bool = True):
    """``n_steps`` data-parallel steps on the batch; per step the host ms
    (ending in a synchronise), the mean loss and the world's live samples.
    Returns ``(grid, records)``."""
    step = dp_step(field, opt, mesh, kw, key, grid_update=grid_update)
    rec = []
    for i in range(n_steps):
        _sync(o.device)
        t0 = time.perf_counter()
        grid, loss, n = step(grid, o, d, px, first_step + i)
        _sync(o.device)
        rec.append(((time.perf_counter() - t0) * 1e3, float(loss), int(n)))
    return grid, rec


def rank_main(rank: int, world: int, init_method, args) -> dict:
    """One rank of the dry run (``launch_world``'s ``fn``, or a torchrun
    rank with ``init_method`` None); returns its numbers."""
    from nerfacc_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        replicate,
    )

    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    if init_method is None:
        init_distributed(device=args.device, backend=args.backend)
    else:
        init_distributed(init_method=init_method, num_processes=world,
                         process_id=rank, device=args.device,
                         backend=args.backend)
    try:
        mesh = make_mesh(device=args.device)
        dev = mesh.device
        rank, world = dist.get_rank(), dist.get_world_size()
        field = replicate(make_field(args.model, dev), mesh)
        grid = make_grid(dev)
        o, d, px = make_batch(N_RAYS, dev)
        opt = torch.optim.Adam(field.parameters(), lr=LR)
        kw = render_kw(args.model, N_RAYS // world)
        key = torch.Generator(device=dev).manual_seed(SEED)
        # warm-up, then the timed steps (the grid update's warm-up path:
        # every cell on every rank, as the dry run's step 0)
        new_grid, _ = run_steps(field, opt, grid, mesh, kw, o, d, px, 1, key)
        new_grid, rec = run_steps(field, opt, new_grid, mesh, kw, o, d, px,
                                  STEPS, key, first_step=1)
        coll = time_collectives(field, grid, mesh)
        # the equality check: fresh weights, no compaction, no grid update
        check_kw = render_kw(args.model, N_RAYS // world, compaction=None)
        field = replicate(make_field(args.model, dev), mesh)
        got = sharded_loss_grads(field, grid, o, d, px, mesh, check_kw)
        errs = None
        if rank == 0:
            whole = render_kw(args.model, N_RAYS, compaction=None)
            errs = compare(got, single_loss_grads(field, grid, o, d, px,
                                                  whole))
        ms = [r[0] for r in rec]
        out = dict(rank=rank, world=world, backend=str(dist.get_backend()),
                   step_ms=ms, losses=[r[1] for r in rec],
                   live=[r[2] for r in rec], collectives=coll, check=errs,
                   occupied=float(new_grid.binary.float().mean()))
        print(f"rank {rank}/{world} ({out['backend']}, {args.model}): step "
              f"median {statistics.median(ms):.3f} ms over {len(ms)} steps; "
              f"losses {[round(x, 6) for x in out['losses']]}; live samples "
              f"(world) {out['live']}; grid occupied {out['occupied']:.4f} "
              f"after the distributed update; gradient all-reduce "
              f"{coll['grad_allreduce']:.3f} ms "
              f"({coll['grad_allreduce_bytes']} bytes), grid MAX all-reduce "
              f"{coll['grid_max_allreduce']:.3f} ms "
              f"({coll['grid_max_allreduce_bytes']} bytes)"
              + (" (gloo stages CUDA tensors through host memory: not "
                 "NCCL's time)" if out["backend"] == "gloo"
                 and dev.type == "cuda" else ""), flush=True)
        if errs is not None:
            print(f"sharded over {world} vs one process on {N_RAYS} rays: "
                  f"loss rel {errs['loss_rel']:.2e}, colours max abs "
                  f"{errs['color_max_abs']:.2e}, worst gradient rel L2 "
                  f"{errs['grad_rel_l2']:.2e} ({errs['worst_leaf']})",
                  flush=True)
        return out
    finally:
        dist.destroy_process_group()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["tensocp", "ngp"], default="tensocp")
    p.add_argument("--world", type=int, default=None,
                   help="spawn this many ranks (default: the torchrun "
                        "rank this process is, else a world of one)")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: NCCL on the card, gloo on the CPU")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def cards() -> str:
    """The cards' names and power limits, as nvidia-smi gives them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(out.stdout.strip().splitlines())


def main(argv=None) -> list:
    from nerfacc_tpu_torch.parallel.multihost import launch_world

    args = parse_args(argv)
    if args.world is None and "RANK" in os.environ:  # a torchrun rank
        return [rank_main(0, 1, None, args)]
    if torch.device(args.device).type == "cuda":
        from nerfacc_tpu_torch import _build

        _build.lib()  # build once, before the ranks start
        print(f"nvidia-smi: {cards()}", flush=True)
    return launch_world(rank_main, args.world or 1, (args,),
                        timeout=TIMEOUT_S)


if __name__ == "__main__":
    main()
