"""Occupancy grid (PyTorch port of :mod:`nerfacc_tpu.grid`).

The grid is a small dataclass of tensors. The JAX package keeps bit-packed
copies of the binary mask for its TPU row-gather lookup; on the card a
``bool`` volume indexed directly is the natural table, and queries return
the same bits. ``update_grid`` / ``every_n_step`` are the training-time
EMA update; their randomness comes from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple, Union

import torch

from . import tracing
from ._consts import constant
from .contraction import ContractionType, contract, contract_inv

# dilation radii the marcher probes with (``probe_dilation``)
DILATION_RADII = (1, 2, 4)


def dilate_binary(binary: torch.Tensor) -> torch.Tensor:
    """3x3x3 box (max) dilation of a bool volume, separable per axis."""
    x = binary
    for axis in range(3):
        n = x.shape[axis]
        lo = torch.zeros_like(x)
        hi = torch.zeros_like(x)
        lo.narrow(axis, 1, n - 1).copy_(x.narrow(axis, 0, n - 1))
        hi.narrow(axis, 0, n - 1).copy_(x.narrow(axis, 1, n - 1))
        x = x | lo | hi
    return x


def _cell_index(samples, roi, resolution, contraction_type) -> torch.Tensor:
    """Flat nearest-cell index of world-space points, clamped to the grid."""
    dev = samples.device
    res = constant(tuple(float(r) for r in resolution), torch.float32, dev)
    top = constant(tuple(int(r) - 1 for r in resolution), torch.int64, dev)
    unit = contract(samples, roi, contraction_type)
    ixyz = torch.floor(unit * res).to(torch.int64)
    ixyz = torch.minimum(torch.clamp(ixyz, min=0), top)
    return (
        ixyz[..., 0] * (resolution[1] * resolution[2])
        + ixyz[..., 1] * resolution[2]
        + ixyz[..., 2]
    )


def query_grid(
    samples: torch.Tensor,
    grid_roi,
    grid_values: torch.Tensor,
    grid_type: ContractionType,
) -> torch.Tensor:
    """Query a 3D grid at world-space points (0/False outside the roi for
    AABB grids)."""
    flat = _cell_index(samples, grid_roi, tuple(grid_values.shape), grid_type)
    vals = grid_values.reshape(-1)[flat]
    if grid_type == ContractionType.AABB:
        roi = torch.as_tensor(grid_roi, dtype=samples.dtype, device=samples.device)
        inside = torch.all((samples >= roi[:3]) & (samples <= roi[3:]), dim=-1)
        vals = torch.where(inside, vals, torch.zeros_like(vals))
    return vals


@dataclasses.dataclass
class OccupancyGrid:
    """Occupancy grid state.

    Attributes:
        roi_aabb: (6,) f32 region of interest.
        occs: (num_cells,) f32 EMA of per-cell occupancy.
        binary: (resx, resy, resz) bool occupied mask.
        dilated: radius -> the binary mask dilated that many voxels, for
            the strided probes of the marcher (radii 1, 2 and 4).
        resolution: (3,) tuple.
        contraction_type: contraction of the grid.
    """

    roi_aabb: torch.Tensor
    occs: torch.Tensor
    binary: torch.Tensor
    dilated: Dict[int, torch.Tensor]
    resolution: Tuple[int, int, int]
    contraction_type: ContractionType

    @property
    def num_cells(self) -> int:
        rx, ry, rz = self.resolution
        return rx * ry * rz

    def query_occ(self, samples: torch.Tensor) -> torch.Tensor:
        """Binary occupancy at world-space points."""
        return query_grid(
            samples, self.roi_aabb, self.binary, self.contraction_type
        )

    def query_occ_fast(
        self, samples: torch.Tensor, dilated: int = 0
    ) -> torch.Tensor:
        """Occupancy at world-space points from the radius-``dilated``
        table (0 is exact; 1, 2 and 4 are dilated). Same name and bits as
        the JAX package's bit-table lookup.

        A dilated query also widens the AABB test by ``dilated`` voxels:
        a probe just outside the box must still see the boundary voxel's
        dilated bit (the index clamp maps it there). The exact query does
        not widen it.
        """
        table = self.binary if dilated == 0 else self.dilated[int(dilated)]
        flat = _cell_index(
            samples, self.roi_aabb, self.resolution, self.contraction_type
        )
        vals = table.reshape(-1)[flat]
        if self.contraction_type == ContractionType.AABB:
            lo, hi = self.roi_aabb[:3], self.roi_aabb[3:]
            if dilated:
                res = constant(tuple(float(r) for r in self.resolution),
                               torch.float32, lo.device)
                margin = dilated * (hi - lo) / res
                lo, hi = lo - margin, hi + margin
            inside = torch.all((samples >= lo) & (samples <= hi), dim=-1)
            vals = vals & inside
        return vals


Grid = OccupancyGrid  # the reference toolbox's name for the grid type


def with_binary(grid: OccupancyGrid, binary: torch.Tensor) -> OccupancyGrid:
    """Replace the binary mask, keeping the dilated tables in sync."""
    binary = binary.to(device=grid.binary.device, dtype=torch.bool)
    d1 = dilate_binary(binary)
    d2 = dilate_binary(d1)
    d4 = dilate_binary(dilate_binary(d2))
    return dataclasses.replace(
        grid, binary=binary, dilated={1: d1, 2: d2, 4: d4}
    )


def create_grid(
    roi_aabb: Union[Sequence[float], torch.Tensor],
    resolution: Union[int, Sequence[int]] = 128,
    contraction_type: ContractionType = ContractionType.AABB,
    occupied: bool = False,
    device: Union[str, torch.device, None] = None,
) -> OccupancyGrid:
    """Create a fresh occupancy grid (all cells ``occupied`` or empty) on
    ``device`` (None: the CUDA device)."""
    device = torch.device("cuda") if device is None else device
    if isinstance(resolution, int):
        resolution = (resolution,) * 3
    resolution = tuple(int(r) for r in resolution)
    roi_aabb = torch.as_tensor(roi_aabb, dtype=torch.float32, device=device)
    if roi_aabb.shape != (6,):
        raise ValueError(f"Invalid roi_aabb shape: {tuple(roi_aabb.shape)}")
    binary = torch.full(resolution, occupied, dtype=torch.bool, device=device)
    nc = resolution[0] * resolution[1] * resolution[2]
    return OccupancyGrid(
        roi_aabb=roi_aabb,
        occs=torch.zeros((nc,), dtype=torch.float32, device=device),
        binary=binary,
        # the dilation of a constant volume is itself
        dilated={r: binary for r in DILATION_RADII},
        resolution=resolution,
        contraction_type=contraction_type,
    )


def _grid_coords(
    resolution: Tuple[int, int, int], indices: torch.Tensor
) -> torch.Tensor:
    """(N, 3) integer coordinates of flat cell ``indices``, x-major like the
    JAX package's ``_grid_coords`` table."""
    _, ry, rz = resolution
    return torch.stack(
        [indices // (ry * rz), (indices // rz) % ry, indices % rz], dim=-1
    )


def _sample_cells(
    grid: OccupancyGrid, key: torch.Generator, n: int
) -> torch.Tensor:
    """n uniform + n occupied cell indices (with replacement), the
    post-warmup selection. Drawn on ``key``'s device, returned on the
    grid's."""
    dev = grid.occs.device
    uniform_idx = torch.randint(
        0, grid.num_cells, (n,), generator=key, device=key.device
    ).to(dev)
    cdf = torch.cumsum(grid.binary.reshape(-1).to(torch.float32), dim=0)
    total = cdf[-1]
    u = torch.rand((n,), generator=key, device=key.device).to(dev)
    occ_idx = torch.searchsorted(cdf, u * torch.clamp(total, min=1.0),
                                 right=True)
    occ_idx = torch.clamp(occ_idx, 0, grid.num_cells - 1)
    # no occupied cells yet -> fall back to uniform
    occ_idx = torch.where(total > 0, occ_idx, uniform_idx)
    return torch.cat([uniform_idx, occ_idx])


def _chunked_eval(fn, x: torch.Tensor, chunk: int = 1 << 17) -> torch.Tensor:
    """Evaluate ``fn`` over (N, 3) points in chunks of ``chunk`` rows, which
    bounds the field's peak memory on a whole-grid update."""
    return torch.cat([fn(x[i : i + chunk]) for i in range(0, x.shape[0], chunk)])


def _draw_cells(
    grid: OccupancyGrid, key: torch.Generator, warmup: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cells one update evaluates and their (N, 3) jitter in [0, 1),
    drawn from ``key``: every cell during warm-up, else ``num_cells // 4``
    uniform plus as many occupied ones."""
    if warmup:
        indices = torch.arange(grid.num_cells, device=grid.occs.device)
    else:
        indices = _sample_cells(grid, key, grid.num_cells // 4)
    jitter = torch.rand(
        (indices.shape[0], 3), generator=key, device=key.device
    )
    return indices, jitter


def _update_grid_at(
    grid: OccupancyGrid,
    indices: torch.Tensor,
    jitter: torch.Tensor,
    occ_eval_fn: Callable[[torch.Tensor], torch.Tensor],
    occ_thre: float,
    ema_decay: float,
    adaptive_thre: bool,
) -> OccupancyGrid:
    """The update at given flat cell ``indices`` (N,) and per-cell
    ``jitter`` (N, 3) in [0, 1): evaluate one jittered point per cell,
    decay each selected cell once, scatter-max the new estimates and
    binarize (at ``min(mean(occs), occ_thre)`` when ``adaptive_thre``)."""
    dev = grid.occs.device
    indices = indices.to(dev)
    res = constant(tuple(float(r) for r in grid.resolution), torch.float32,
                   dev)
    coords = _grid_coords(grid.resolution, indices).to(torch.float32)
    x_unit = (coords + jitter.to(dev, torch.float32)) / res
    if grid.contraction_type == ContractionType.UN_BOUNDED_SPHERE:
        # only points inside the unit sphere are valid
        valid = torch.linalg.norm(x_unit - 0.5, dim=-1) < 0.5
    else:
        valid = torch.ones(indices.shape, dtype=torch.bool, device=dev)
    x = contract_inv(x_unit, grid.roi_aabb, grid.contraction_type)
    with torch.no_grad():
        occ = _chunked_eval(occ_eval_fn, x).reshape(-1).to(torch.float32)
    occ = torch.where(valid, occ, torch.full_like(occ, -1.0))  # no-op in max

    sel = torch.zeros((grid.num_cells,), dtype=torch.float32, device=dev)
    sel = sel.scatter_reduce(0, indices, valid.to(torch.float32), "amax") > 0
    occs = torch.where(sel, grid.occs * ema_decay, grid.occs)
    occs = occs.scatter_reduce(0, indices, occ, "amax")

    thre = constant(float(occ_thre), torch.float32, dev)
    if adaptive_thre:
        thre = torch.minimum(torch.mean(occs), thre)
    binary = (occs > thre).reshape(grid.binary.shape)
    return with_binary(dataclasses.replace(grid, occs=occs), binary)


def update_grid(
    grid: OccupancyGrid,
    key: torch.Generator,
    step: int,
    occ_eval_fn: Callable[[torch.Tensor], torch.Tensor],
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    warmup_steps: int = 256,
    adaptive_thre: bool = True,
) -> OccupancyGrid:
    """One EMA occupancy update; returns the new grid.

    Args:
        key: ``torch.Generator`` for the cell selection and the jitter
            (it may live on the CPU for a grid on the card).
        step: training step. Before ``warmup_steps`` every cell is
            evaluated; after, ``num_cells // 4`` uniform plus as many
            occupied cells.
        occ_eval_fn: world-space (N, 3) -> (N, 1) occupancy (density times
            step size), evaluated without gradients in chunks of 2^17.
        adaptive_thre: binarize at ``min(mean(occs), occ_thre)``; ``False``
            binarizes at ``occ_thre`` after warmup (warmup is always
            adaptive, so an untrained field is not pruned to nothing).
    """
    with tracing.span("update_grid"):
        warmup = step < warmup_steps
        indices, jitter = _draw_cells(grid, key, warmup)
        tracing.count("grid_cells", indices.shape[0])
        return _update_grid_at(
            grid, indices, jitter, occ_eval_fn, occ_thre=occ_thre,
            ema_decay=ema_decay, adaptive_thre=adaptive_thre or warmup,
        )


def every_n_step(
    grid: OccupancyGrid,
    key: torch.Generator,
    step: int,
    occ_eval_fn: Callable[[torch.Tensor], torch.Tensor],
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    warmup_steps: int = 256,
    n: int = 16,
    adaptive_thre: bool = True,
) -> OccupancyGrid:
    """Update the grid every ``n`` steps; returns the (possibly unchanged)
    grid."""
    if step % n == 0:
        return update_grid(
            grid, key, step, occ_eval_fn,
            occ_thre=occ_thre, ema_decay=ema_decay, warmup_steps=warmup_steps,
            adaptive_thre=adaptive_thre,
        )
    return grid
