"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin
(the twin runs for CPU tensors; CUDA tensors launch the kernel)."""

from .cp_encoder import (
    cp_features_slice_width,
    cp_grads_slice_width,
    cp_level_features,
    cp_level_features_plain,
    cp_level_features_res,
    cp_level_features_res_fwd,
    cp_level_features_res_plain,
    cp_level_grads,
    cp_level_grads_plain,
    cp_level_grads_res,
    cp_level_grads_res_plain,
)
from .hash_gather import (
    hash_encode_lookup,
    hash_grad_scatter,
    hash_grad_scatter_levels,
    hash_grad_scatter_levels_plain,
    hash_grad_scatter_plain,
)
from .march_select import (
    fused_reselect,
    fused_reselect_plain,
    fused_select_grouped,
    fused_select_grouped_plain,
)
from .sample_compact import compact_live_slots, expand_compact
from .table_gather import table_gather, table_gather_plain

__all__ = [
    "compact_live_slots",
    "cp_features_slice_width",
    "cp_grads_slice_width",
    "cp_level_features",
    "cp_level_features_plain",
    "cp_level_features_res",
    "cp_level_features_res_fwd",
    "cp_level_features_res_plain",
    "cp_level_grads",
    "cp_level_grads_plain",
    "cp_level_grads_res",
    "cp_level_grads_res_plain",
    "expand_compact",
    "fused_reselect",
    "fused_reselect_plain",
    "fused_select_grouped",
    "fused_select_grouped_plain",
    "hash_encode_lookup",
    "hash_grad_scatter",
    "hash_grad_scatter_levels",
    "hash_grad_scatter_levels_plain",
    "hash_grad_scatter_plain",
    "table_gather",
    "table_gather_plain",
]
