"""Occupancy grid (PyTorch port of the query half of :mod:`nerfacc_tpu.grid`).

The grid is a small dataclass of tensors. The JAX package keeps bit-packed
copies of the binary mask for its TPU row-gather lookup; on the card a
``bool`` volume indexed directly is the natural table, and queries return
the same bits. The EMA update (``update_grid``) belongs to training and is
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple, Union

import torch

from .contraction import ContractionType, contract

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
    res = torch.as_tensor(resolution, dtype=torch.int32, device=samples.device)
    unit = contract(samples, roi, contraction_type)
    ixyz = torch.floor(unit * res.to(torch.float32)).to(torch.int64)
    ixyz = torch.minimum(torch.clamp(ixyz, min=0), res.to(torch.int64) - 1)
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
                res = torch.as_tensor(
                    self.resolution, dtype=torch.float32, device=lo.device
                )
                margin = dilated * (hi - lo) / res
                lo, hi = lo - margin, hi + margin
            inside = torch.all((samples >= lo) & (samples <= hi), dim=-1)
            vals = vals & inside
        return vals


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
    device: Union[str, torch.device] = "cpu",
) -> OccupancyGrid:
    """Create a fresh occupancy grid (all cells ``occupied`` or empty)."""
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
