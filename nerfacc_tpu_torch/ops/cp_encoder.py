"""CP level features of the TensoCP field: CUDA kernel and plain twin.

``cp_level_features`` replaces the forward of the Pallas kernel
``nerfacc_tpu/ops/cp_encoder.py::_cp_fwd_impl`` (``_fwd_kernel``), which
also serves ``cp_level_features_res``'s (B, R) output. Per level and axis
the feature is ``hat(xu[:, a] * (G - 1)) @ T_a`` with a bf16 hat basis, a
bf16-rounded table and f32 accumulation; the level feature is the product
of the three axis features.

The TPU kernel builds the dense (B, G) basis and multiplies it on the MXU
to avoid gathers. Each basis row has exactly two nonzeros, so the CUDA
kernel (``csrc/cp_encoder.cu``) reads the two table rows each sample
touches instead: no basis and no matrix product exist anywhere. Every
other term of the TPU's row product is an exact zero, so the sum is the
same.

The backward kernels (the table gradients, and the forward that saves
per-axis residuals for them) belong to training and are not ported yet:
asking for a gradient through this wrapper raises.
"""

from __future__ import annotations

import torch

from .. import _build


def hat_basis_bf16(x: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B,) coordinates in [0, 1] -> (B, G) hat basis rounded to bf16, as
    the TPU kernel builds it (``max(0, 1 - |u - j|)`` with u = x (G-1))."""
    u = x * (grid_size - 1)
    nodes = torch.arange(grid_size, dtype=torch.float32, device=x.device)
    return torch.clamp(1.0 - torch.abs(u[:, None] - nodes), min=0.0).to(
        torch.bfloat16
    )


def cp_level_features_plain(xu, t0, t1, t2) -> torch.Tensor:
    """Dense formulation: bf16 basis times bf16 table, f32 accumulation,
    f32 output (the product runs in f32 on bf16-rounded operands, which is
    exact per term)."""
    G = t0.shape[0]
    feats = None
    for axis, table in enumerate((t0, t1, t2)):
        basis = hat_basis_bf16(xu[:, axis], G).to(torch.float32)
        ua = basis @ table.to(torch.bfloat16).to(torch.float32)
        feats = ua if feats is None else feats * ua
    return feats


def cp_level_features(xu, t0, t1, t2) -> torch.Tensor:
    """CP level features ``prod_axes hat(xu[:, a]) @ T_a``, forward only.

    Args:
        xu: (B, 3) f32 coordinates in [0, 1]^3.
        t0, t1, t2: (G, R) f32 per-axis factor tables.

    Returns:
        (B, R) f32 features.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (xu, t0, t1, t2)
    ):
        raise NotImplementedError(
            "cp_level_features has no backward yet (the table-gradient "
            "kernels are not ported); call it under torch.no_grad()"
        )
    if xu.device.type == "cpu":
        return cp_level_features_plain(xu, t0, t1, t2)
    name = "cp_level_features"
    B = xu.shape[0]
    G, R = t0.shape
    dev = xu.device
    args = [_build.cuda_ptr(name, "xu", xu, torch.float32, (B, 3), dev)]
    for arg, t in (("t0", t0), ("t1", t1), ("t2", t2)):
        args.append(_build.cuda_ptr(name, arg, t, torch.float32, (G, R), dev))
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().nerfacc_cp_level_features(
            *args, out.data_ptr(), B, G, R,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, name)
    cp_level_features.launches += 1
    return out


cp_level_features.launches = 0
