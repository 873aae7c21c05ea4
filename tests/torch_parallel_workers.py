"""Ranks of the gloo worlds that ``test_torch_parallel.py`` and
``test_torch_multihost.py`` spawn on the CPU (``launch_world``).

Only torch and the port: a spawned rank imports no JAX. Each rank builds
the port's fields from the flax parameters the test hands it (numpy, via
``nerfacc_tpu_torch.convert``), runs the cases it is asked for and returns
numpy arrays; the test holds them to the JAX package's results and to the
port's own single-process run.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT, ROOT / "scripts"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from nerfacc_tpu_torch import (  # noqa: E402
    create_grid,
    render_rays,
    update_grid,
)
from nerfacc_tpu_torch.convert import (  # noqa: E402
    grid_from_arrays,
    tensocp_from_flax,
    vanilla_from_flax,
)
from nerfacc_tpu_torch.models import (  # noqa: E402
    TensoCPRadianceField,
    VanillaNeRFRadianceField,
)
from nerfacc_tpu_torch.parallel import (  # noqa: E402
    batch_axes,
    data_parallel,
    init_distributed,
    make_host_mesh,
    make_mesh,
    psum_grads,
    psum_hierarchical,
    replicate,
    shard_batch,
    shard_host_batch,
    update_grid_distributed,
)
from nerfacc_tpu_torch.parallel.sharding import (  # noqa: E402
    _update_grid_distributed_at,
    fold_in,
)

CPU = torch.device("cpu")
BOX = [-1.5] * 3 + [1.5] * 3


def vanilla(params_np) -> VanillaNeRFRadianceField:
    """The JAX tests' tiny vanilla field (2 x 32), from flax parameters."""
    field = VanillaNeRFRadianceField(net_depth=2, net_width=32, device=CPU)
    vanilla_from_flax(params_np, field)
    return field


def tensocp(params_np, levels, density_bias=3.0) -> TensoCPRadianceField:
    """test_torch_train.py's TensoCP field, from flax parameters."""
    field = TensoCPRadianceField(aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
                                 levels=levels, density_bias=density_bias,
                                 device=CPU)
    tensocp_from_flax(params_np, field)
    return field


def render_local(field, grid, o, d, k_slots, **kw):
    """``test_parallel.py``'s per-shard render: K slots per ray."""
    colors, opacities, depths, _ = render_rays(
        field, o, d, grid=grid, render_bkgd=torch.ones(3),
        samples_budget=o.shape[0] * k_slots, **kw)
    return colors, opacities, depths


def mse_grads(field, grid, o, d, px, kw):
    """``mean((colors - px)^2)`` of a render of K = 64 and its gradients
    (the identical-data control's loss)."""
    field.zero_grad(set_to_none=True)
    colors, _, _ = render_local(field, grid, o, d, 64, **kw)
    loss = torch.mean((colors - px) ** 2)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in field.named_parameters()}


def _np(tree):
    if torch.is_tensor(tree):
        return tree.detach().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree


def ball(x):
    """Occupied inside a ball of radius 0.3 about the unit box's centre."""
    d = torch.linalg.norm(x - 0.5, dim=-1, keepdim=True)
    return torch.where(d < 0.3, 1.0, 0.0)


def fog(x):
    """A low level of occupancy everywhere: above the mean, below 1e-2."""
    return torch.full(x.shape[:-1] + (1,), 5e-3)


# -- the cases of test_torch_parallel.py, each on the rank's mesh ---------

def case_render(mesh, params, rays, kw, k_slots):
    """The sharded render: colours, opacities, depths of every ray."""
    field = vanilla(params)
    grid = create_grid(BOX, resolution=16, occupied=True, device=CPU)
    step = data_parallel(
        lambda o, d: render_local(field, grid, o, d, k_slots, **kw), mesh,
        batched_args=(0, 1), n_out=3)
    with torch.no_grad():
        return _np(step(*(torch.as_tensor(a) for a in rays)))


def case_control(mesh, params, rays, kw):
    """Every shard the same rays: the mean over the world of identical
    per-shard losses and gradients."""
    field = vanilla(params)
    grid = create_grid(BOX, resolution=16, occupied=True, device=CPU)
    world = mesh.axis_size("data")

    def local(o, d, px):
        loss, grads = mse_grads(field, grid, o, d, px, kw)
        loss, grads = psum_grads((loss, grads))
        return loss / world, {k: g / world for k, g in grads.items()}

    tiled = [torch.as_tensor(np.tile(a, (world, 1))) for a in rays]
    return _np(data_parallel(local, mesh, batched_args=(0, 1, 2), n_out=2,
                             replicated_out=(0, 1))(*tiled))


def case_wrapper(mesh):
    def step(w, x):
        local = torch.sum(x * w)
        return psum_grads(local), x * 2.0

    fn = data_parallel(step, mesh, batched_args=(1,), n_out=2,
                       replicated_out=(0,))
    total, doubled = fn(torch.tensor(2.0),
                        torch.arange(16, dtype=torch.float32))
    try:
        shard_batch(torch.zeros(3), mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return _np(total), _np(doubled), refused


def case_grid(mesh, draws, occ, occ_thre, adaptive_thre):
    """``update_grid_distributed`` on an empty 8^3 grid of the unit box,
    past warm-up: through its own draws (the merge, this rank's own update
    and the update of key 0's first draw), and through the JAX package's
    per-device draws (``draws[rank]``)."""
    fn = {"ball": ball, "fog": fog}[occ]
    grid0 = create_grid([0, 0, 0, 1, 1, 1], resolution=8, device=CPU)
    kw = dict(occ_thre=occ_thre, adaptive_thre=adaptive_thre)
    merged = update_grid_distributed(grid0, 0, 10**9, fn, mesh=mesh, **kw)
    own = update_grid(grid0, fold_in(0, mesh.axis_index("data")), 10**9, fn,
                      **kw)
    single = update_grid(grid0, fold_in(0, 0), 10**9, fn, **kw)
    idx, jitter = draws[mesh.axis_index("data")]
    jax_draws = _update_grid_distributed_at(
        grid0, torch.as_tensor(idx), torch.as_tensor(jitter), fn,
        mesh.groups["data"], warmup=False, **kw)
    out = {}
    for name, g in (("merged", merged), ("own", own), ("single", single),
                    ("jax_draws", jax_draws)):
        out[name] = dict(occs=_np(g.occs), binary=_np(g.binary),
                         dilated=_np(g.dilated[1]))
    return out


def case_slice(mesh, params, levels, grid_arrays, rays, kw, k_slots):
    """The slice as a whole: the data-parallel step's equality half
    (``dryrun_multichip_torch.sharded_loss_grads``) on the rank's shard,
    then one full data-parallel step (the distributed grid update, the
    step, Adam); returns the mean loss and gradients, every ray's colour,
    and the step's loss and parameters."""
    import dryrun_multichip_torch as dry

    field = replicate(tensocp(params, levels), mesh)
    grid = grid_from_arrays((-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
                            *grid_arrays, device=CPU)
    o, d, px = (torch.as_tensor(a) for a in rays)
    n_local = o.shape[0] // mesh.axis_size("data")
    loss, colors, grads = dry.sharded_loss_grads(
        field, grid, o, d, px, mesh,
        dict(kw, samples_budget=n_local * k_slots))
    opt = torch.optim.Adam(field.parameters(), lr=1e-3)
    step = dry.dp_step(field, opt, mesh,
                       dict(kw, samples_budget=n_local * k_slots,
                            compact_rays_fraction=0.75),
                       torch.Generator().manual_seed(0))
    new_grid, step_loss, n = step(grid, o, d, px, 0)
    return dict(loss=float(loss), colors=_np(colors), grads=_np(grads),
                step_loss=float(step_loss), live=int(n),
                occupied=int(new_grid.binary.sum()),
                params=_np({k: p for k, p in field.named_parameters()}))


CASES = dict(render=case_render, control=case_control, wrapper=case_wrapper,
             grid=case_grid, slice=case_slice)


def parallel_suite(rank, world, init_method, cases) -> dict:
    """One rank: a 1-D ``data`` mesh over the gloo world, then each case
    of ``cases`` ({label: (case name, kwargs)})."""
    torch.set_num_threads(1)
    init_distributed(init_method=init_method, num_processes=world,
                     process_id=rank, device="cpu", timeout=120)
    try:
        mesh = make_mesh(device="cpu")
        return {label: CASES[name](mesh, **kw)
                for label, (name, kw) in cases.items()}
    finally:
        dist.destroy_process_group()


# -- test_torch_multihost.py ----------------------------------------------

def local_batch(process_id: int, local_n: int):
    """``tests/multihost_worker.py``'s rays of a JAX process (its 4
    devices' worth): RandomState(100 + process_id)."""
    rng = np.random.RandomState(100 + process_id)
    rays_o = (rng.rand(local_n, 3) * 2 - 1).astype(np.float32)
    rays_d = rng.randn(local_n, 3).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    pixels = rng.rand(local_n, 3).astype(np.float32)
    return rays_o, rays_d, pixels


def multihost_rank(rank, world, init_method, params, global_rays) -> dict:
    """One process of a 2-host x 2-chip world (``LOCAL_WORLD_SIZE`` 2):
    ``init_distributed``, ``make_host_mesh``, its own slice of the global
    batch through ``shard_host_batch``, a render and gradient, then
    ``psum_hierarchical`` of the summed squared error and its gradients
    (``multihost_worker.py``'s step, at 8 rays per K-budgeted shard)."""
    torch.set_num_threads(1)
    assert init_distributed(init_method=init_method, num_processes=world,
                            process_id=rank, device="cpu", timeout=120)
    try:
        again = init_distributed()  # a group already up is left as it is
        mesh = make_host_mesh(device="cpu")
        n_local = global_rays[0].shape[0] // world
        mine = [a[rank * n_local:(rank + 1) * n_local] for a in global_rays]
        o, d, px = shard_host_batch([torch.as_tensor(a) for a in mine], mesh)
        field = vanilla(params)
        grid = create_grid(BOX, resolution=8, occupied=True, device=CPU)
        kw = dict(scene_aabb=BOX, render_step_size=5e-2,
                  max_samples_per_ray=64)
        loss = 0.0
        for s in range(0, n_local, 8):  # the JAX mesh's 8-ray shards
            colors, _, _ = render_local(field, grid, o[s:s + 8], d[s:s + 8],
                                        64, **kw)
            loss = loss + torch.sum((colors - px[s:s + 8]) ** 2)
        loss.backward()
        grads = {k: p.grad for k, p in field.named_parameters()}
        loss, grads = psum_hierarchical((loss.detach(), grads), mesh)
        gnorm = sum(float(torch.sum(g * g)) for g in grads.values())
        flat = psum_grads(torch.arange(4.0) + rank, "data",
                          mesh=make_mesh(device="cpu"))
        hier = psum_hierarchical(torch.arange(4.0) + rank, mesh)
        try:
            shard_host_batch(torch.zeros(rank + 1), mesh)
            refused = ""
        except ValueError as e:
            refused = str(e)
        return dict(again=again, shape=mesh.shape, coords=mesh.coords,
                    axes=batch_axes(mesh), loss=float(loss), gnorm=gnorm,
                    grads=_np(grads), flat=_np(flat), hier=_np(hier),
                    refused=refused)
    finally:
        dist.destroy_process_group()
