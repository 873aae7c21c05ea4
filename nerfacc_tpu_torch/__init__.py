"""nerfacc_tpu_torch: the PyTorch + CUDA port of nerfacc_tpu, for Hopper.

The render path and the TensoCP and hash-NGP training steps of the JAX
package — occupancy-grid march and grid update, the TensoCP and
Instant-NGP fields, live-sample compaction of the field, dense volume
rendering with its closed-form backward, proposal sampling with CDF
resampling and the distortion loss — in PyTorch, with hand-written
CUDA kernels (``ops/``) for march slot selection, stage-2 re-selection,
the CP encoder's forward and table gradients, the hash table's gradient
scatter and the table-gather floor. The kernels are built with ``nvcc`` at
first use; CPU tensors take each kernel's plain PyTorch twin. Entry points
that make tensors (grids, fields, poses) make them on the CUDA device
unless the caller passes ``device``.
"""

from .cdf import ray_resampling_dense
from .contraction import ContractionType, contract, contract_inv
from .grid import (
    Grid,
    OccupancyGrid,
    create_grid,
    dilate_binary,
    every_n_step,
    query_grid,
    update_grid,
    with_binary,
)
from .ops import (
    cp_level_features,
    cp_level_features_res,
    hash_encode_lookup,
    hash_grad_scatter,
)
from .intersection import ray_aabb_intersect
from .losses import distortion_dense as loss_distortion_dense
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
from .sampling import proposal_sampling_with_filter, sample_along_rays
from .training import compact_mse, train_step
from .utils import render_image, render_rays
from .vol_rendering import (
    accumulate_along_rays_dense,
    render_transmittance_from_alpha_dense,
    render_transmittance_from_density_dense,
    render_visibility_dense,
    render_weight_from_alpha_dense,
    render_weight_from_density_dense,
    rendering_dense,
)

__all__ = [
    "ContractionType",
    "Grid",
    "OccupancyGrid",
    "RaySegments",
    "accumulate_along_rays_dense",
    "compact_mse",
    "contract",
    "contract_inv",
    "cp_level_features",
    "cp_level_features_res",
    "create_grid",
    "dilate_binary",
    "every_n_step",
    "gather_rows_dense",
    "hash_encode_lookup",
    "hash_grad_scatter",
    "loss_distortion_dense",
    "march_rays",
    "probe_live_groups",
    "proposal_sampling_with_filter",
    "query_grid",
    "ray_aabb_intersect",
    "ray_resampling_dense",
    "render_image",
    "render_rays",
    "render_transmittance_from_alpha_dense",
    "render_transmittance_from_density_dense",
    "render_visibility_dense",
    "render_weight_from_alpha_dense",
    "render_weight_from_density_dense",
    "rendering_dense",
    "reselect_visible",
    "sample_along_rays",
    "samples_needed_for_range",
    "select_slots",
    "select_slots_grouped",
    "train_step",
    "update_grid",
    "with_binary",
]
