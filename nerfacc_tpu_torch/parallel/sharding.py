"""Data parallelism over ``torch.distributed`` (PyTorch port of
:mod:`nerfacc_tpu.parallel.sharding`).

One process stands for one chip. Rays are embarrassingly parallel and a
ray's samples never leave it, so the render path needs no communication
under a ray-sharded layout:

  * mesh: 1-D ``("data",)`` over every process of the world
    (:class:`Mesh`, a process group per axis);
  * ray batches sharded on ``"data"`` (each process its contiguous slice,
    in rank order); the field's parameters and the occupancy grid
    replicated;
  * the only collectives: an all-reduce SUM of gradients and losses, and an
    all-reduce MAX that merges the occupancy grids' EMA updates.

``data_parallel`` runs a per-shard step on the local slice, as the JAX
package's ``shard_map`` does: the step sees local buffers only (its local
ray count, its local sample budget) and reduces what it must itself.

A mesh made with no process group initialised is a world of one, where
every collective is the identity. Collectives run on the mesh's device:
NCCL on the card, gloo on the CPU. gloo also runs CUDA tensors (two
processes sharing one card, where NCCL refuses a second rank on the
device); its all-gather is staged through page-locked host memory
explicitly, and its all-reduce and broadcast take CUDA tensors as they
are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from ..grid import OccupancyGrid, _draw_cells, _update_grid_at, with_binary

Axis = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of processes: named axes, each with the process group of this
    process's line along it (``None`` without a process group: a world of
    one, every collective the identity), this process's coordinates, the
    device its tensors live on and the backend."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    coords: Tuple[int, ...]
    device: torch.device
    backend: Optional[str]
    ranks: Tuple[int, ...]  # the global rank at each mesh index, row-major
    # per axis, the global ranks of this process's line, in axis order
    lines: Dict[str, Tuple[int, ...]]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: Axis) -> int:
        return math.prod(self.shape[self._dim(a)] for a in _axes(axis))

    def axis_index(self, axis: Axis) -> int:
        """This process's index along ``axis`` (row-major over a tuple)."""
        index = 0
        for a in _axes(axis):
            dim = self._dim(a)
            index = index * self.shape[dim] + self.coords[dim]
        return index

    def _dim(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not one of {self.axis_names}")
        return self.axis_names.index(axis)


def _axes(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _mesh_device(device) -> torch.device:
    """The device a process's tensors live on: the current CUDA device
    unless the caller asks for another (``"cpu"``)."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _backend(device: torch.device) -> str:
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return "nccl" if device.type == "cuda" else "gloo"


def _lines(shape: Tuple[int, ...], dim: int):
    """The mesh indices of every line along ``dim``, each in mesh order."""
    others = [range(n) for i, n in enumerate(shape) if i != dim]
    lines = []
    for rest in itertools.product(*others):
        line = []
        for k in range(shape[dim]):
            coords = list(rest)
            coords.insert(dim, k)
            line.append(_flat(shape, coords))
        lines.append(line)
    return lines


def _flat(shape, coords) -> int:
    index = 0
    for n, c in zip(shape, coords):
        index = index * n + c
    return index


def _build_mesh(ranks: Sequence[int], shape: Tuple[int, ...],
                axis_names: Tuple[str, ...], device) -> Mesh:
    """A mesh of ``shape`` over the global ``ranks`` (row-major). Every
    process of the world must call it with the same arguments: each axis's
    groups are created by all of them, in one order."""
    device = _mesh_device(device)
    world, rank = _world()
    grouped = dist.is_available() and dist.is_initialized()
    ranks = tuple(int(r) for r in ranks)
    if math.prod(shape) != len(ranks) or sorted(ranks) != sorted(set(ranks)):
        raise ValueError(f"ranks {ranks} do not fill a mesh of {shape}")
    if any(not 0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} outside a world of {world}")
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    lines: Dict[str, Tuple[int, ...]] = {}
    for dim, axis in enumerate(axis_names):
        groups[axis] = None
        for line in _lines(shape, dim):
            members = tuple(ranks[i] for i in line)
            group = None
            if grouped:  # every process creates every group, in one order
                group = (dist.group.WORLD
                         if sorted(members) == list(range(world))
                         else dist.new_group(list(members)))
            if rank in members:
                groups[axis], lines[axis] = group, members
    if rank not in ranks:
        raise ValueError(f"rank {rank} is not in the mesh's ranks {ranks}")
    index = ranks.index(rank)
    coords = []
    for n in reversed(shape):
        coords.append(index % n)
        index //= n
    return Mesh(tuple(axis_names), tuple(shape), groups,
                tuple(reversed(coords)), device, _backend(device), ranks,
                lines)


def make_mesh(devices: Optional[Sequence[int]] = None, axis: str = "data",
              device=None) -> Mesh:
    """1-D mesh over every process of the world, or over the global ranks
    ``devices`` in that order (every process calls it with the same list).
    Without an initialised process group it is a world of one. Tensors live
    on ``device``: the current CUDA device unless the caller passes
    ``"cpu"``."""
    world, _ = _world()
    ranks = tuple(range(world)) if devices is None else tuple(devices)
    return _build_mesh(ranks, (len(ranks),), (axis,), device)


_ACTIVE: list = []  # the meshes of the data_parallel calls running


@contextlib.contextmanager
def _active(mesh: Mesh):
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def _the_mesh(mesh: Optional[Mesh]) -> Mesh:
    if mesh is not None:
        return mesh
    if not _ACTIVE:
        raise ValueError("no mesh: call inside data_parallel, or pass mesh=")
    return _ACTIVE[-1]


def _leaves(tree):
    """The tensors of a tree (dict / list / tuple / tensor), in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # namedtuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _fill(tree, values):
    """``tree`` with its tensors replaced by ``values``, in ``_leaves``
    order."""
    it = iter(values)
    return _tree_map(lambda _: next(it), tree)


def _flat_apply(tensors, fn) -> list:
    """``fn`` on one flat buffer per dtype holding ``tensors``; returns the
    results as tensors of the inputs' shapes, in order: one collective per
    dtype, not one per tensor."""
    out = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([tensors[i].reshape(-1) for i in idx])
        buf = fn(buf)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = buf[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


def _all_reduce(buf: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(buf, op=op, group=group)
    return buf


def _all_gather_cat(t: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    """Every process's ``t`` (equal shapes) concatenated on the leading
    axis in the order of ``axis``'s index."""
    axes = _axes(axis)
    if all(mesh.groups[a] is None for a in axes):
        return t
    if len(axes) == 1:
        group, members = mesh.groups[axes[0]], mesh.lines[axes[0]]
    elif axes == mesh.axis_names and len(mesh.ranks) == _world()[0]:
        # every axis in mesh order: the world's gather, in mesh order
        group, members = None, mesh.ranks
    else:
        raise ValueError(f"cannot gather over {axes} of {mesh.axis_names}")
    # a group ranks its members in increasing global rank
    order = [sorted(members).index(r) for r in members]
    n = dist.get_world_size(group)
    src = t.contiguous()
    # gloo's all-gather is specified for CPU tensors: stage a CUDA tensor
    # through page-locked host memory (a transport; the values stay put)
    staged = mesh.backend == "gloo" and src.is_cuda
    if staged:
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        src = host
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat([parts[k] for k in order])
    return out.to(t.device, non_blocking=False) if staged else out


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` (dict / list / tuple, or an ``nn.Module``'s
    parameters and buffers) on the mesh's device, with rank 0's values:
    one broadcast per dtype. A module is moved and updated in place and
    returned; a tree comes back as a new tree."""
    if isinstance(tree, nn.Module):
        tree.to(mesh.device)
        tensors = [t.data for t in (*tree.parameters(), *tree.buffers())]
    else:
        tree = _tree_map(lambda t: t.to(mesh.device), tree)
        tensors = _leaves(tree)
    if not tensors or mesh.size == 1:
        return tree
    group = mesh.groups[mesh.axis_names[0]] if len(mesh.shape) == 1 else None
    src = mesh.ranks[0]

    def bcast(buf):
        dist.broadcast(buf, src=src, group=group)
        return buf

    merged = _flat_apply(tensors, bcast)
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t, v in zip(tensors, merged):
                t.copy_(v)
        return tree
    return _fill(tree, merged)


def shard_batch(tree, mesh: Mesh, axis: Axis = "data"):
    """This process's contiguous slice of every tensor's leading axis (the
    ``axis_index``-th of ``axis_size`` equal slices, as JAX's ``P(axis)``
    splits it), on the mesh's device. A length the axis does not divide
    raises ``ValueError``."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)

    def shard(t):
        if t.ndim == 0 or t.shape[0] % n:
            raise ValueError(
                f"a leading axis of {tuple(t.shape)[:1]} does not split "
                f"into {n} equal shards")
        m = t.shape[0] // n
        return t[i * m:(i + 1) * m].to(mesh.device)

    return _tree_map(shard, tree)


def psum_grads(grads, axis: Axis = "data", mesh: Optional[Mesh] = None):
    """All-reduce SUM over the mesh axis ``axis`` (or over each axis of a
    tuple, the last first: the chip axis of a host x chip mesh before the
    host axis). ``grads`` is a tensor, a tree of tensors or an
    ``nn.Module`` (its parameters' ``.grad``, summed in place). All of it
    travels in one flat buffer per dtype. ``mesh``: that of the enclosing
    ``data_parallel`` call unless given."""
    mesh = _the_mesh(mesh)
    groups = [mesh.groups[a] for a in reversed(_axes(axis))]

    def reduce(buf):
        for group in groups:
            _all_reduce(buf, dist.ReduceOp.SUM, group)
        return buf

    if isinstance(grads, nn.Module):
        ps = [p for p in grads.parameters() if p.grad is not None]
        for p, g in zip(ps, _flat_apply([p.grad for p in ps], reduce)):
            p.grad.copy_(g)
        return grads
    return _fill(grads, _flat_apply(_leaves(grads), reduce))


def data_parallel(
    step_fn: Callable,
    mesh: Mesh,
    axis: Axis = "data",
    *,
    batched_args: Sequence[int],
    n_out: int,
    replicated_out: Sequence[int] = (),
):
    """A function with ``step_fn``'s signature that runs it on this
    process's shard.

    Args:
        step_fn: ``step_fn(*args) -> tuple of n_out outputs``; the
            positional args at ``batched_args`` are sharded on their
            leading axis (``shard_batch``), the rest passed as they are
            (replicated). Inside, ``psum_grads`` and
            ``update_grid_distributed`` reduce over this mesh.
        n_out: the number of outputs.
        replicated_out: outputs the step left equal on every process (its
            all-reduced gradients and losses), returned as they are; every
            other output is per-ray and comes back concatenated over the
            axis on its leading axis (JAX's ``out_specs=P(axis)``), so each
            process holds the whole batch's.
    """
    batched, rep = set(batched_args), set(replicated_out)

    def wrapper(*args):
        args = tuple(shard_batch(a, mesh, axis) if i in batched else a
                     for i, a in enumerate(args))
        with _active(mesh):
            out = step_fn(*args)
        outs = (out,) if n_out == 1 else tuple(out)
        if len(outs) != n_out:
            raise ValueError(f"step_fn returned {len(outs)} outputs, "
                             f"declared {n_out}")
        outs = tuple(
            o if i in rep else _tree_map(
                lambda t: _all_gather_cat(t, mesh, axis), o)
            for i, o in enumerate(outs))
        return outs[0] if n_out == 1 else outs

    return wrapper


def fold_in(key: Union[torch.Generator, int], index: int,
            device=None) -> torch.Generator:
    """A generator for process ``index`` derived from ``key`` (JAX's
    ``fold_in``): a generator's next 63-bit draw, or an int seed, hashed
    with ``index``. Every process draws the same value from a replicated
    generator, so each advances it alike."""
    if isinstance(key, torch.Generator):
        seed = int(torch.randint(0, 2**62, (1,), generator=key,
                                 device=key.device))
        device = key.device if device is None else device
    else:
        seed = int(key)
    digest = hashlib.sha256(f"{seed}:{int(index)}".encode()).digest()
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen


def _update_grid_distributed_at(
    grid: OccupancyGrid,
    indices: torch.Tensor,
    jitter: torch.Tensor,
    occ_eval_fn: Callable[[torch.Tensor], torch.Tensor],
    group,
    warmup: bool,
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    adaptive_thre: bool = True,
) -> OccupancyGrid:
    """The core of ``update_grid_distributed``: this process's update at
    its own ``indices`` and ``jitter``, the occupancies merged by an
    all-reduce MAX over ``group``, and the merge binarised again by
    ``update_grid``'s rule."""
    adaptive = adaptive_thre or warmup
    local = _update_grid_at(grid, indices, jitter, occ_eval_fn,
                            occ_thre=occ_thre, ema_decay=ema_decay,
                            adaptive_thre=adaptive)
    occs = _all_reduce(local.occs.contiguous(), dist.ReduceOp.MAX, group)
    thre = torch.tensor(occ_thre, dtype=torch.float32, device=occs.device)
    if adaptive:
        thre = torch.minimum(torch.mean(occs), thre)
    binary = (occs > thre).reshape(grid.binary.shape)
    return with_binary(dataclasses.replace(local, occs=occs), binary)


def update_grid_distributed(
    grid: OccupancyGrid,
    key: Union[torch.Generator, int],
    step: int,
    occ_eval_fn: Callable[[torch.Tensor], torch.Tensor],
    axis: str = "data",
    *,
    mesh: Optional[Mesh] = None,
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    warmup_steps: int = 256,
    adaptive_thre: bool = True,
) -> OccupancyGrid:
    """The occupancy grid's EMA update under data parallelism (the grid is
    replicated).

    Each process draws its own cells from ``fold_in(key, its index along
    axis)``, evaluates its replica of the field there (``update_grid``'s
    update), and the per-cell estimates merge by an all-reduce MAX: the
    reference's ``occs = max(occs * decay, occ)`` with the cells of every
    process. The merge is binarised again by the rule ``update_grid``
    uses: ``min(mean(occs), occ_thre)`` during warm-up or with
    ``adaptive_thre``, else the fixed ``occ_thre``.
    """
    mesh = _the_mesh(mesh)
    warmup = step < warmup_steps
    # the draws on the grid's device, whatever the key's
    local_key = fold_in(key, mesh.axis_index(axis), device=grid.occs.device)
    indices, jitter = _draw_cells(grid, local_key, warmup)
    return _update_grid_distributed_at(
        grid, indices, jitter, occ_eval_fn, mesh.groups[axis], warmup,
        occ_thre=occ_thre, ema_decay=ema_decay, adaptive_thre=adaptive_thre)
