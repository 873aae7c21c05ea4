"""nerfacc_tpu_torch: the PyTorch + CUDA port of nerfacc_tpu, for Hopper.

The reference's flat packed API — ``ray_marching()`` into
``PackedSamples``, ``rendering()`` over ``sigma_fn`` / ``rgb_sigma_fn``
closures (``utils.make_field_fns``), segmented scans, pack / unpack,
flat resampling and the distortion loss — and the JAX package's dense
``(n_rays, K)`` twins beside it: the occupancy-grid march and grid
update, the TensoCP and Instant-NGP fields, live-sample compaction of the
field, proposal sampling, and the TensoCP and hash-NGP training steps.
Hand-written CUDA kernels (``ops/``) do march slot selection, stage-2
re-selection, the CP encoder's forward and table gradients, the hash
table's gradient scatter and the table-gather floor. The kernels are built
with ``nvcc`` at first use; CPU tensors take each kernel's plain PyTorch
twin. Entry points that make tensors (grids, fields, poses) make them on
the CUDA device unless the caller passes ``device``.
"""

import warnings

from .cdf import ResampledRays, ray_resampling, ray_resampling_dense
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
from .losses import distortion as loss_distortion
from .losses import distortion_dense as loss_distortion_dense
from .pack import (
    pack_data,
    pack_info,
    unpack_data,
    unpack_info,
    unpack_info_to_mask,
)
from .ray_marching import (
    PackedSamples,
    RaySegments,
    gather_rows_dense,
    march_rays,
    probe_live_groups,
    ray_marching,
    reselect_visible,
    samples_needed_for_range,
    select_slots,
    select_slots_grouped,
)
from .sampling import proposal_sampling_with_filter, sample_along_rays
from .training import compact_mse, train_step
from .utils import make_field_fns, render_image, render_rays
from .version import __version__
from .vol_rendering import (
    accumulate_along_rays,
    accumulate_along_rays_dense,
    render_transmittance_from_alpha,
    render_transmittance_from_alpha_dense,
    render_transmittance_from_density,
    render_transmittance_from_density_dense,
    render_visibility,
    render_visibility_dense,
    render_weight_from_alpha,
    render_weight_from_alpha_dense,
    render_weight_from_density,
    render_weight_from_density_dense,
    rendering,
    rendering_dense,
)


def unpack_to_ray_indices(*args, **kwargs):
    """Deprecated alias of :func:`unpack_info` (the reference's
    ``__init__.py:26-32``)."""
    warnings.warn(
        "`unpack_to_ray_indices` will be deprecated. Please use "
        "`unpack_info` instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    return unpack_info(*args, **kwargs)


__all__ = [
    "__version__",
    "ContractionType",
    "Grid",
    "OccupancyGrid",
    "PackedSamples",
    "RaySegments",
    "ResampledRays",
    "accumulate_along_rays",
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
    "loss_distortion",
    "loss_distortion_dense",
    "make_field_fns",
    "march_rays",
    "pack_data",
    "pack_info",
    "probe_live_groups",
    "proposal_sampling_with_filter",
    "query_grid",
    "ray_aabb_intersect",
    "ray_marching",
    "ray_resampling",
    "ray_resampling_dense",
    "render_image",
    "render_rays",
    "render_transmittance_from_alpha",
    "render_transmittance_from_alpha_dense",
    "render_transmittance_from_density",
    "render_transmittance_from_density_dense",
    "render_visibility",
    "render_visibility_dense",
    "render_weight_from_alpha",
    "render_weight_from_alpha_dense",
    "render_weight_from_density",
    "render_weight_from_density_dense",
    "rendering",
    "rendering_dense",
    "reselect_visible",
    "sample_along_rays",
    "samples_needed_for_range",
    "select_slots",
    "select_slots_grouped",
    "train_step",
    "unpack_data",
    "unpack_info",
    "unpack_info_to_mask",
    "unpack_to_ray_indices",
    "update_grid",
    "with_binary",
]
