"""Several hosts, several processes (PyTorch port of
:mod:`nerfacc_tpu.parallel.multihost`).

One process per chip, as ``torchrun`` starts them: ``torchrun --nnodes H
--nproc_per_node P`` gives ranks ``h * P + p``. Rays stay with the process
that drew them, so only the gradient and metric reductions and the grid's
MAX merge cross processes. ``make_host_mesh`` lays the world out as
``(hosts, processes per host)``; ``psum_hierarchical`` reduces within a
host's group first, then across hosts.

The same paths run without a cluster: several CPU processes under gloo
stand for hosts and chips (``launch_world`` starts them, each with a
deadline, rendezvousing through a file).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import Mesh, _all_gather_cat, _build_mesh, _world, psum_grads
from .sharding import _leaves, _tree_map

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    init_method: Optional[str] = None,
    device=None,
    backend: Optional[str] = None,
    timeout: float = 300.0,
) -> bool:
    """Initialise the default process group; return whether the world has
    more than one process.

    With no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and returns False
    where there is none (a single process). ``coordinator_address``
    ("host:port"), ``num_processes`` and ``process_id`` rendezvous over TCP;
    ``init_method`` (e.g. ``"file:///path"``) replaces the address. A group
    already up is left as it is. The backend is NCCL on the card (after
    ``torch.cuda.set_device(LOCAL_RANK)``, modulo the cards there are) and
    gloo where ``device`` is ``"cpu"``; ``backend="gloo"`` on the card runs
    several processes on one card, which NCCL refuses. ``timeout`` bounds
    every collective, in seconds.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None or init_method is not None
    if not explicit and not all(k in os.environ for k in _ENV):
        return False
    on_card = torch.device(device or "cuda").type == "cuda"
    kw = dict(backend=backend or ("nccl" if on_card else "gloo"),
              timeout=datetime.timedelta(seconds=timeout))
    if explicit:
        kw.update(init_method=init_method or f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    else:
        kw.update(init_method="env://")
    if on_card:
        # several processes may share a card (gloo): LOCAL_RANK wraps
        local = int(os.environ.get("LOCAL_RANK", 0))
        local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
        if kw["backend"] == "nccl":
            kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(**kw)
    return dist.get_world_size() > 1


def make_host_mesh(host_axis: str = "host", chip_axis: str = "chip",
                   device=None) -> Mesh:
    """2-D ``(hosts, processes per host)`` mesh over the world. Processes
    per host is ``LOCAL_WORLD_SIZE`` (torchrun's; the whole world where it
    is unset), and host ``h`` holds ranks ``h * P .. h * P + P - 1`` along
    the chip axis, so chip-axis collectives stay within a host. With one
    host it is ``(1, world)``."""
    world, _ = _world()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"{per_host} processes per host do not divide a "
                         f"world of {world}")
    return _build_mesh(range(world), (world // per_host, per_host),
                       (host_axis, chip_axis), device)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """All mesh axis names, for sharding a ray batch over every process."""
    return tuple(mesh.axis_names)


def shard_host_batch(tree, mesh: Mesh):
    """Each process's local batch as its shard of the global batch (the
    rank-ordered concatenation of the local batches): the local tensors on
    the mesh's device. Every process must give leading axes of one length,
    as JAX's global arrays require; a mismatch raises ``ValueError`` on
    every process."""
    tree = _tree_map(lambda t: t.to(mesh.device), tree)
    lens = torch.tensor([t.shape[0] for t in _leaves(tree)],
                        dtype=torch.int64, device=mesh.device)
    every = _all_gather_cat(lens[None], mesh, batch_axes(mesh))
    if bool((every != lens[None]).any()):
        raise ValueError(f"local batch lengths differ between processes: "
                         f"{every.tolist()}")
    return tree


def psum_hierarchical(tree, mesh: Mesh):
    """All-reduce SUM over every mesh axis: within each host's chip group,
    then across the host group. Equals one world all-reduce up to the
    order of the sum."""
    return psum_grads(tree, axis=batch_axes(mesh), mesh=mesh)


def _run_rank(rank: int, fn: Callable, world: int, init_method: str,
              out_dir: str, args: tuple) -> None:
    # one host: each process's local rank is its rank, as torchrun sets it
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ.setdefault("LOCAL_WORLD_SIZE", str(world))
    result = fn(rank, world, init_method, *args)
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def launch_world(fn: Callable, world: int, args: Sequence = (),
                 timeout: float = 300.0, env: Optional[dict] = None) -> list:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes of this host and return their results, by rank (each
    process's ``LOCAL_RANK``, so on several cards each takes its own).
    ``init_method`` is a ``file://`` rendezvous of this call alone (no port
    to race for); ``fn`` must be importable by name. ``env`` is set in the
    children. A process
    that fails raises here; past ``timeout`` seconds every process is
    killed and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="nerfacc_world_") as tmp:
        init_method = f"file://{Path(tmp) / 'store'}"
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update({k: str(v) for k, v in (env or {}).items()})
        try:
            ctx = mp.start_processes(
                _run_rank, args=(fn, world, init_method, tmp, tuple(args)),
                nprocs=world, join=False, start_method="spawn")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"a world of {world} ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
