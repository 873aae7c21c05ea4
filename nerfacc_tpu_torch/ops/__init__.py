"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin
(the twin runs for CPU tensors; CUDA tensors launch the kernel)."""

from .cp_encoder import (
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
from .march_select import (
    fused_reselect,
    fused_reselect_plain,
    fused_select_grouped,
    fused_select_grouped_plain,
)

__all__ = [
    "cp_level_features",
    "cp_level_features_plain",
    "cp_level_features_res",
    "cp_level_features_res_fwd",
    "cp_level_features_res_plain",
    "cp_level_grads",
    "cp_level_grads_plain",
    "cp_level_grads_res",
    "cp_level_grads_res_plain",
    "fused_reselect",
    "fused_reselect_plain",
    "fused_select_grouped",
    "fused_select_grouped_plain",
]
