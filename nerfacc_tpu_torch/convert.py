"""Carry weights and grid state over from the JAX package's layouts.

The functions take numpy arrays (no JAX import): a flax parameter tree
as nested dicts (TensoCP, hash-NGP, vanilla NeRF, D-NeRF), or the
occupancy grid's arrays.
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
    _dense_kernels(tree, module, state)
    _load_state(module, state)


def _load_state(module, state: Mapping) -> None:
    """Copy ``state`` ({parameter name: array}) into ``module``; raises on
    a name or shape mismatch."""
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


def _dense_kernels(tree: Mapping, module, state: dict) -> None:
    """Flax ``Dense_j/kernel`` (in, out) of both heads, transposed into
    torch's (out, in) weights."""
    for head in ("mlp_base", "mlp_head"):
        for j in range(len(getattr(module, head).layers)):
            kernel = np.asarray(tree[head][f"Dense_{j}"]["kernel"])
            state[f"{head}.layers.{j}.weight"] = kernel.T


def ngp_table_from_flax(table, n_levels: int, n_features: int) -> np.ndarray:
    """The JAX package's flat feature-major hash table (F * L * T,), or a
    gradient of it, in the port's (L, T, F) layout."""
    table = np.asarray(table)
    if table.ndim != 1 or table.size % (n_levels * n_features):
        raise ValueError(
            f"encoder table: shape {table.shape} is not a flat "
            f"({n_features} * {n_levels} * T,)"
        )
    return table.reshape(n_features, n_levels, -1).transpose(1, 2, 0)


def ngp_table_to_flax(table) -> np.ndarray:
    """The inverse: an (L, T, F) table or gradient, flat feature-major."""
    return np.asarray(table).transpose(2, 0, 1).reshape(-1)


def ngp_from_flax(params_np: Mapping, module) -> None:
    """Load a flax ``NGPRadianceField`` tree into the port's module.

    ``params_np`` holds the flat feature-major ``encoder/table``
    (F * L * T,), ``mlp_base/Dense_{0,1}/kernel`` and
    ``mlp_head/Dense_{0,1,2}/kernel``, optionally under a top-level
    ``"params"`` key.
    """
    tree = params_np.get("params", params_np)
    enc = module.encoder
    state = {"encoder.table": ngp_table_from_flax(
        tree["encoder"]["table"], enc.n_levels, enc.n_features)}
    _dense_kernels(tree, module, state)
    _load_state(module, state)


def _dense_tree_state(tree: Mapping, prefix: str = "") -> dict:
    """A flax tree of ``Dense`` layers as the port's state: ``Dense_i``
    becomes ``layers.i``, other names stay, and each (in, out) ``kernel``
    is transposed into torch's (out, in) ``weight``."""
    state = {}
    for key, value in tree.items():
        if key == "kernel":
            state[f"{prefix}weight"] = np.asarray(value).T
        elif key == "bias":
            state[f"{prefix}bias"] = value
        else:
            name = (f"layers.{key[len('Dense_'):]}"
                    if key.startswith("Dense_") else key)
            state.update(_dense_tree_state(value, f"{prefix}{name}."))
    return state


def vanilla_from_flax(params_np: Mapping, module) -> None:
    """Load a flax ``VanillaNeRFRadianceField`` tree (``mlp/base/Dense_i``,
    ``mlp/sigma_layer``, ``mlp/bottleneck_layer``, ``mlp/rgb_layer/Dense_i``,
    each with ``kernel`` and ``bias``; optionally under a top-level
    ``"params"`` key) into the port's module; any tree of the port's MLP
    modules loads the same way."""
    _load_state(module, _dense_tree_state(params_np.get("params", params_np)))


# the D-NeRF tree is the warp's ``warp/Dense_i`` beside the vanilla tree
# under ``nerf``: the same walk
dnerf_from_flax = vanilla_from_flax


def grid_from_arrays(
    roi_aabb,
    binary,
    occs=None,
    contraction_type: ContractionType = ContractionType.AABB,
    device=None,
) -> OccupancyGrid:
    """Build the port's occupancy grid from a (resx, resy, resz) binary
    mask (and optionally the (num_cells,) EMA occupancies) on ``device``
    (None: the CUDA device)."""
    device = torch.device("cuda") if device is None else device
    binary = np.asarray(binary, dtype=bool)
    grid = create_grid(roi_aabb, resolution=binary.shape,
                       contraction_type=contraction_type, device=device)
    grid = with_binary(grid, torch.as_tensor(binary, device=device))
    if occs is not None:
        grid.occs = torch.as_tensor(
            np.asarray(occs, np.float32).reshape(-1), device=device
        )
    return grid
