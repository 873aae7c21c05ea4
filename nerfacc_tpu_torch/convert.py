"""Carry weights and grid state over from the JAX package's layouts.

Both functions take numpy arrays (no JAX import): a flax parameter tree
as nested dicts, or the occupancy grid's arrays.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .contraction import ContractionType
from .grid import OccupancyGrid, create_grid, with_binary


def tensocp_from_flax(params_np: Mapping, module) -> None:
    """Load a flax ``TensoCPRadianceField`` tree into the port's module.

    ``params_np`` holds ``level{i}/axis{0,1,2}`` of shape (G, R),
    ``mlp_base/Dense_{0,1}/kernel`` and ``mlp_head/Dense_{0,1,2}/kernel``,
    optionally under a top-level ``"params"`` key. Flax kernels are
    (in, out); each is transposed into torch's (out, in) weight.
    """
    tree = params_np.get("params", params_np)
    state = {}
    for i in range(len(module.cp_levels)):
        for axis in range(3):
            state[f"cp_levels.{i}.axis{axis}"] = tree[f"level{i}"][f"axis{axis}"]
    for head in ("mlp_base", "mlp_head"):
        for j in range(len(getattr(module, head).layers)):
            kernel = np.asarray(tree[head][f"Dense_{j}"]["kernel"])
            state[f"{head}.layers.{j}.weight"] = kernel.T
    own = module.state_dict()
    if set(state) != set(own):
        raise ValueError(
            f"parameter names differ: {sorted(set(state) ^ set(own))}"
        )
    with torch.no_grad():
        for name, value in state.items():
            value = torch.as_tensor(np.array(value, np.float32))
            if value.shape != own[name].shape:
                raise ValueError(
                    f"{name}: shape {tuple(value.shape)} != "
                    f"{tuple(own[name].shape)}"
                )
            own[name].copy_(value)


def grid_from_arrays(
    roi_aabb,
    binary,
    occs=None,
    contraction_type: ContractionType = ContractionType.AABB,
    device="cpu",
) -> OccupancyGrid:
    """Build the port's occupancy grid from a (resx, resy, resz) binary
    mask (and optionally the (num_cells,) EMA occupancies)."""
    binary = np.asarray(binary, dtype=bool)
    grid = create_grid(roi_aabb, resolution=binary.shape,
                       contraction_type=contraction_type, device=device)
    grid = with_binary(grid, torch.as_tensor(binary, device=device))
    if occs is not None:
        grid.occs = torch.as_tensor(
            np.asarray(occs, np.float32).reshape(-1), device=device
        )
    return grid
