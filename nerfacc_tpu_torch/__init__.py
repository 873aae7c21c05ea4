"""nerfacc_tpu_torch: the PyTorch + CUDA port of nerfacc_tpu, for Hopper.

The forward render path of the JAX package — occupancy-grid march, the
TensoCP field and dense volume rendering — in PyTorch, with hand-written
CUDA kernels (``ops/``) for march slot selection, stage-2 re-selection and
the CP encoder. The kernels are built with ``nvcc`` at first use; CPU
tensors take each kernel's plain PyTorch twin. Training (grid updates,
backward kernels, optimizers) is not ported yet.
"""

from .contraction import ContractionType, contract, contract_inv
from .grid import OccupancyGrid, create_grid, dilate_binary, query_grid, with_binary
from .intersection import ray_aabb_intersect
from .ray_marching import (
    RaySegments,
    gather_rows_dense,
    march_rays,
    probe_live_groups,
    reselect_visible,
    samples_needed_for_range,
    select_slots,
    select_slots_grouped,
)
from .utils import render_image, render_rays
from .vol_rendering import (
    accumulate_along_rays_dense,
    render_transmittance_from_alpha_dense,
    render_visibility_dense,
    render_weight_from_density_dense,
)

__all__ = [
    "ContractionType",
    "OccupancyGrid",
    "RaySegments",
    "accumulate_along_rays_dense",
    "contract",
    "contract_inv",
    "create_grid",
    "dilate_binary",
    "gather_rows_dense",
    "march_rays",
    "probe_live_groups",
    "query_grid",
    "ray_aabb_intersect",
    "render_image",
    "render_rays",
    "render_transmittance_from_alpha_dense",
    "render_visibility_dense",
    "render_weight_from_density_dense",
    "reselect_visible",
    "samples_needed_for_range",
    "select_slots",
    "select_slots_grouped",
    "with_binary",
]
