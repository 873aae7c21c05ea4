"""March slot selection and stage-2 re-selection: CUDA kernels and their
plain PyTorch twins.

``fused_select_grouped`` replaces the Pallas kernel
``nerfacc_tpu/ops/march_select.py::fused_select_grouped``: per ray, the
inclusive cumsum of per-group live counts, the decimation stride, the rank
search of each slot's group, and the closed-form lattice at the slot's
start, end and group end. ``fused_reselect`` replaces
``fused_reselect``: per ray, the rank and masked-width cumsums over the K
march slots, the re-selection of ``k2`` slots and their exact group
widths.

The Pallas kernels unroll compare/select loops over G and K because the
TPU has no vector gather. The CUDA kernels (``csrc/march_select.cu``) run
one thread per ray with a short serial walk instead. Each wrapper takes
the plain twin for CPU tensors only; for CUDA tensors it launches the
kernel or raises. Each counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import _build
from ..ray_marching import (
    _lattice_t,
    reselect_visible,
    RaySegments,
    select_slots_grouped,
)

Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_select_grouped_plain(
    live_groups: torch.Tensor,
    group_size: torch.Tensor,
    t_min: torch.Tensor,
    *,
    k_slots: int,
    step_size: float,
    cone_angle: float = 0.0,
    dt_max: float = 1e10,
) -> Quad:
    """The unfused ``select_slots_grouped`` + ``_lattice_t`` chain."""
    pos, ok, scale = select_slots_grouped(live_groups, group_size, k_slots)

    def lat(k):
        return _lattice_t(t_min[:, None], k.to(torch.float32), step_size,
                          cone_angle, dt_max)

    ts = lat(pos)
    te = lat(pos.to(torch.float32) + 1.0)
    return ts, te, lat(pos + scale) - ts, ok


def fused_select_grouped(
    live_groups: torch.Tensor,
    group_size: torch.Tensor,
    t_min: torch.Tensor,
    *,
    k_slots: int,
    step_size: float,
    cone_angle: float = 0.0,
    dt_max: float = 1e10,
) -> Quad:
    """Slot selection + lattice evaluation of the grouped march.

    Args:
        live_groups: (R, G) int32 live-candidate counts per probe group.
        group_size: (R, 1) int32 per-ray probe stride.
        t_min: (R,) f32 marching origins.
        k_slots: slots per ray.
        step_size / cone_angle / dt_max: lattice parameters.

    Returns:
        (t_starts, t_ends, deltas, ok): three (R, K) f32 and one (R, K)
        bool. ``ok`` is bit-equal to the plain chain's; t agrees to f32
        rounding.
    """
    kw = dict(k_slots=k_slots, step_size=step_size, cone_angle=cone_angle,
              dt_max=dt_max)
    if live_groups.device.type == "cpu":
        return fused_select_grouped_plain(live_groups, group_size, t_min, **kw)
    name = "fused_select_grouped"
    R, G = live_groups.shape
    dev = live_groups.device
    args = [
        _build.cuda_ptr(name, "live_groups", live_groups, torch.int32,
                        (R, G), dev),
        _build.cuda_ptr(name, "group_size", group_size, torch.int32,
                        (R, 1), dev),
        _build.cuda_ptr(name, "t_min", t_min, torch.float32, (R,), dev),
    ]
    outs = [torch.empty((R, k_slots), dtype=torch.float32, device=dev)
            for _ in range(3)]
    outs.append(torch.empty((R, k_slots), dtype=torch.bool, device=dev))
    cone = float(cone_angle)
    # the lattice constants as the plain chain rounds them to f32
    a_lim = step_size / cone if cone > 0.0 else 0.0
    _build.launch(
        name, "nerfacc_select_grouped", dev,
        *args, *(o.data_ptr() for o in outs), R, G, k_slots,
        float(step_size), cone, float(dt_max), a_lim, math.log1p(cone),
    )
    fused_select_grouped.launches += 1
    return tuple(outs)


fused_select_grouped.launches = 0


def fused_reselect_plain(
    masks: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    deltas: torch.Tensor,
    *,
    k2: int,
) -> Quad:
    """``reselect_visible``'s unfused chain."""
    segs = reselect_visible(
        RaySegments(t_starts=t_starts, t_ends=t_ends, deltas=deltas,
                    masks=masks),
        k2,
        use_pallas=False,
    )
    return segs.t_starts, segs.t_ends, segs.deltas, segs.masks


def fused_reselect(
    masks: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    deltas: torch.Tensor,
    *,
    k2: int,
) -> Quad:
    """Visible-sample re-selection (stage 2 of the two-stage render).

    Re-selects each ray's ``k2`` live slots out of (R, K) masked samples
    with exact decimation-group widths. Returns (t_starts2, t_ends2,
    deltas2, ok2): (R, k2) f32 x3 + bool.
    """
    if masks.device.type == "cpu":
        return fused_reselect_plain(masks, t_starts, t_ends, deltas, k2=k2)
    name = "fused_reselect"
    R, K = masks.shape
    dev = masks.device
    args = [_build.cuda_ptr(name, "masks", masks, torch.bool, (R, K), dev)]
    for arg, t in (("t_starts", t_starts), ("t_ends", t_ends),
                   ("deltas", deltas)):
        args.append(_build.cuda_ptr(name, arg, t, torch.float32, (R, K), dev))
    outs = [torch.empty((R, k2), dtype=torch.float32, device=dev)
            for _ in range(3)]
    outs.append(torch.empty((R, k2), dtype=torch.bool, device=dev))
    _build.launch(name, "nerfacc_reselect", dev,
                  *args, *(o.data_ptr() for o in outs), R, K, k2)
    fused_reselect.launches += 1
    return tuple(outs)


fused_reselect.launches = 0
