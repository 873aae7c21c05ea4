"""Occupancy-grid ray marching into the dense ``(n_rays, K)`` slot layout
(PyTorch port of the dense half of :mod:`nerfacc_tpu.ray_marching`).

The march is the JAX package's, step for step: a closed-form candidate
lattice ``t(k)`` per ray (the reference recurrence ``t += clamp(t * cone,
dt_min, dt_max)`` solved piecewise), strided probes of a dilated occupancy
table per group, sample-rank slot selection with decimation when a ray has
more live candidates than slots, and an exact occupancy re-check at the
selected midpoints. ``use_pallas=True`` routes slot selection and the
stage-2 re-selection through the hand-written CUDA kernels of
:mod:`nerfacc_tpu_torch.ops.march_select`.

Divisions by a float constant divide by a tensor on the input's device:
PyTorch's CUDA kernels turn ``x / python_float`` into ``x * (1 / c)``,
which rounds differently from the division the kernels (and the JAX
package) perform, and a one-ulp change before a ``ceil`` moves a lattice
index by one.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .grid import OccupancyGrid
from .intersection import ray_aabb_intersect

MAX_DIST = 1e10


class RaySegments(NamedTuple):
    """Dense per-ray samples: row r holds ray r's live samples, K slots.

    When a ray has more live candidates than slots, the marcher keeps every
    s-th live candidate (s = ceil(count / K)) and widens that sample's
    integration width ``deltas`` to cover its s-group.
    """

    t_starts: torch.Tensor  # (n_rays, K) f32 — lattice interval start
    t_ends: torch.Tensor  # (n_rays, K) f32 — lattice interval end
    deltas: torch.Tensor  # (n_rays, K) f32 — integration width (>= te - ts)
    masks: torch.Tensor  # (n_rays, K) bool

    @property
    def n_rays(self) -> int:
        return self.t_starts.shape[0]

    @property
    def slots_per_ray(self) -> int:
        return self.t_starts.shape[1]

    @property
    def ray_indices(self) -> torch.Tensor:
        """(n_rays K,) int32: the flat view's sorted ray of each slot."""
        r, k = self.t_starts.shape
        return torch.arange(r, dtype=torch.int32,
                            device=self.t_starts.device).repeat_interleave(k)


class PackedSamples(NamedTuple):
    """Flat packed samples of static capacity (the reference's layout
    ``(ray_indices, t_starts, t_ends)`` plus a validity mask)."""

    ray_indices: torch.Tensor  # (budget,) int32, sorted ascending
    t_starts: torch.Tensor  # (budget, 1) f32
    t_ends: torch.Tensor  # (budget, 1) f32
    masks: torch.Tensor  # (budget,) bool


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true f32 division on every device (see module doc)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def _rdiv(a: float, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` for a float numerator, as a true f32 division."""
    return torch.tensor(a, dtype=b.dtype, device=b.device) / b


def samples_needed_for_range(
    t_min: float,
    t_max: float,
    render_step_size: float,
    cone_angle: float = 0.0,
    dt_max: float = MAX_DIST,
) -> int:
    """Lattice points needed to cover ``[t_min, t_max]`` (the closed-form
    count of the reference's unbounded per-ray marching loop)."""
    if t_max <= t_min:
        return 0
    if cone_angle <= 0.0:
        return int(math.ceil((t_max - t_min) / render_step_size))
    c, dmin, dmax = cone_angle, render_step_size, dt_max
    n_a = math.ceil(max(dmin / c - t_min, 0.0) / dmin)
    t_a = t_min + n_a * dmin
    if t_a >= t_max:
        return int(math.ceil((t_max - t_min) / dmin))
    t_b_end = min(t_max, dmax / c)
    n_b = math.ceil(math.log(t_b_end / t_a) / math.log1p(c))
    if t_max <= dmax / c:
        return int(n_a + n_b)
    t_b = t_a * (1.0 + c) ** n_b
    return int(n_a + n_b + math.ceil((t_max - t_b) / dmax))


def _cone_phases(t_min, step_size, cone_angle, dt_max):
    """Per-ray phase lengths of the cone lattice: (nA, tA, nB)."""
    c, dmin, dmax = cone_angle, step_size, dt_max
    nA = torch.ceil(_div(torch.clamp(dmin / c - t_min, min=0.0), dmin))
    tA = t_min + nA * dmin
    log_grow = math.log1p(c)
    ratio = _rdiv(dmax, c * torch.clamp(tA, min=1e-10))
    nB = torch.ceil(
        _div(torch.clamp(torch.log(torch.clamp(ratio, min=1.0)), min=0.0),
             log_grow)
    )
    return nA, tA, nB


def _lattice_t(
    t_min: torch.Tensor,
    k: torch.Tensor,
    step_size: float,
    cone_angle: float,
    dt_max: float = MAX_DIST,
) -> torch.Tensor:
    """Closed-form lattice position t(k) for broadcastable ``k``.

    Phase A (t < dt_min / cone): linear steps of dt_min; phase B: geometric
    growth by (1 + cone); phase C (t >= dt_max / cone): linear dt_max steps.
    """
    k = k.to(torch.float32)
    t_min = t_min.to(torch.float32)
    if cone_angle <= 0.0:
        return t_min + k * step_size
    nA, _, nB = _cone_phases(t_min, step_size, cone_angle, dt_max)
    kA = torch.minimum(k, nA)
    kB = torch.minimum(torch.clamp(k - nA, min=0.0), nB)
    kC = torch.clamp(k - nA - nB, min=0.0)
    return (t_min + kA * step_size) * torch.exp(
        math.log1p(cone_angle) * kB
    ) + kC * dt_max


def _lattice_k(
    t_min: torch.Tensor,
    t: torch.Tensor,
    step_size: float,
    cone_angle: float,
    dt_max: float = MAX_DIST,
) -> torch.Tensor:
    """Inverse of :func:`_lattice_t`: the fractional index k with t(k) = t."""
    t_min = t_min.to(torch.float32)
    t = t.to(torch.float32)
    if cone_angle <= 0.0:
        return _div(t - t_min, step_size)
    nA, tA, nB = _cone_phases(t_min, step_size, cone_angle, dt_max)
    log_grow = math.log1p(cone_angle)
    tB = tA * torch.exp(log_grow * nB)
    kA = _div(t - t_min, step_size)
    kB = nA + _div(
        torch.log(torch.clamp(t / torch.clamp(tA, min=1e-10), min=1e-30)),
        log_grow,
    )
    kC = nA + nB + _div(t - tB, dt_max)
    return torch.where(t <= tA, kA, torch.where(t <= tB, kB, kC))


def _rank_targets(count: torch.Tensor, k_slots: int, decimate: bool = True):
    """Slot j's sample-rank target, validity and the live candidates it
    stands for, given per-row live counts (R, 1)."""
    j = torch.arange(k_slots, dtype=count.dtype, device=count.device)[None]
    if decimate:
        stride = torch.clamp(torch.div(count + k_slots - 1, k_slots,
                                       rounding_mode="floor"), min=1)
    else:
        stride = torch.ones_like(count)
    tgt = j * stride + 1
    ok = tgt <= count
    scale = torch.minimum(torch.clamp(count - j * stride, min=0), stride)
    return tgt, ok, scale


def select_slots(
    valid: torch.Tensor, k_slots: int, decimate: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row, pick ``k_slots`` live entries: the first K, or — when a row
    has more than K live entries and ``decimate`` — every s-th one
    (s = ceil(count / K)).

    Args:
        valid: (R, S) bool.

    Returns:
        pos (R, K) int32 in [0, S), clamped for invalid slots; ok (R, K)
        bool; scale (R, K) int32, the live candidates each slot stands for.
    """
    S = valid.shape[1]
    c = torch.cumsum(valid.to(torch.int32), dim=1, dtype=torch.int32)
    tgt, ok, scale = _rank_targets(c[:, -1:], k_slots, decimate)
    # the rank-tgt live entry sits after every entry whose running count
    # is below tgt
    pos = torch.searchsorted(c, tgt).to(torch.int32)
    return torch.clamp(pos, max=S - 1), ok, scale


def select_slots_grouped(
    live_per_group: torch.Tensor,
    group_size: Union[int, torch.Tensor],
    k_slots: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample-granular slot selection when group g contributes its first
    ``live_per_group[r, g]`` samples. ``group_size`` is an int or a per-ray
    (R, 1) int32 tensor. Returns (pos, ok, scale) like :func:`select_slots`,
    with positions in sample units (group * group_size + offset).
    """
    G = live_per_group.shape[1]
    c = torch.cumsum(live_per_group, dim=1, dtype=torch.int32)
    tgt, ok, scale = _rank_targets(c[:, -1:], k_slots)
    gidx = torch.clamp(torch.searchsorted(c, tgt).to(torch.int32), max=G - 1)
    cum_before = torch.where(
        gidx > 0,
        torch.gather(c, 1, torch.clamp(gidx - 1, min=0).long()),
        torch.zeros_like(gidx),
    )
    offset = tgt - 1 - cum_before
    if isinstance(group_size, int):
        group_size = torch.full_like(gidx[:, :1], group_size)
    pos = gidx * group_size + torch.minimum(
        torch.clamp(offset, min=0), group_size - 1
    )
    return pos, ok, scale


def gather_rows_dense(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vals[r, idx[r, j]]`` per row."""
    return torch.gather(vals, 1, idx.long())


def _in_range_count(t_min, t_max, step_size, cone_angle, dt_max, S):
    """Candidates in the t-range per ray: t_mid(k) < t_max, decided by the
    closed-form lattice inverse (not a direct compare, which rounds
    differently at the f32 seam and disagrees by one sample)."""
    k_of = _lattice_k(t_min, t_max, step_size, cone_angle, dt_max)
    return torch.clamp(torch.ceil(k_of - 0.5), 0, S).to(torch.int32)


def _probe_layout(
    k_in: torch.Tensor, S: int, C: int, probe_groups: Optional[int]
) -> Tuple[int, torch.Tensor]:
    """(G, per-ray group size (R, 1)) for fixed- or adaptive-stride probes."""
    if probe_groups is None:
        return S // C, torch.full(
            (k_in.shape[0], 1), C, dtype=torch.int32, device=k_in.device
        )
    G = probe_groups
    s = torch.clamp(
        torch.div(k_in[:, None] + G - 1, G, rounding_mode="floor"), 1, C
    )
    return G, s.to(torch.int32)


def probe_live_groups(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t_min: torch.Tensor,
    t_max: torch.Tensor,
    grid: OccupancyGrid,
    render_step_size: float,
    cone_angle: float = 0.0,
    max_samples_per_ray: int = 1024,
    coarse_stride: int = 8,
    dt_max: float = MAX_DIST,
    probe_dilation: int = 1,
    probe_groups: Optional[int] = None,
) -> torch.Tensor:
    """Live-candidate counts per probe group: (n_rays, G) int32.

    One dilated-grid lookup per group at its center candidate; the
    in-t-range candidates of a group are a closed-form prefix. With
    ``probe_groups`` each ray gets exactly that many groups with a per-ray
    stride ``clip(ceil(k_in / G), 1, coarse_stride)``.
    """
    S, C = max_samples_per_ray, coarse_stride
    k_in = _in_range_count(t_min, t_max, render_step_size, cone_angle,
                           dt_max, S)
    G, s = _probe_layout(k_in, S, C, probe_groups)
    g = torch.arange(G, dtype=torch.int32, device=rays_o.device)[None, :]
    sf = s.to(torch.float32)
    kc = (g * s).to(torch.float32) + (sf - 1.0) / 2.0 + 0.5
    t_probe = _lattice_t(t_min[:, None], kc, render_step_size, cone_angle,
                         dt_max)
    # groups straddling t_max probe inside the live range
    t_probe = torch.minimum(t_probe, t_max[:, None] - 0.5 * render_step_size)
    xyz = rays_o[:, None, :] + t_probe[..., None] * rays_d[:, None, :]
    occ = grid.query_occ_fast(xyz, dilated=probe_dilation)
    in_range_g = torch.minimum(torch.clamp(k_in[:, None] - g * s, min=0), s)
    return torch.where(occ, in_range_g, torch.zeros_like(in_range_g))


def march_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t_min: torch.Tensor,
    t_max: torch.Tensor,
    grid: Optional[OccupancyGrid] = None,
    render_step_size: float = 1e-3,
    cone_angle: float = 0.0,
    max_samples_per_ray: int = 1024,
    slots_per_ray: int = 64,
    coarse_stride: int = 1,
    dt_max: float = MAX_DIST,
    live_groups: Optional[torch.Tensor] = None,
    probe_dilation: int = 1,
    exact_recheck: bool = True,
    probe_groups: Optional[int] = None,
    use_pallas: Optional[bool] = None,
) -> RaySegments:
    """Grid-accelerated marching into a dense (n_rays, K) slot layout.

    ``coarse_stride`` > 1 probes occupancy every C-th candidate against a
    dilated grid, selects slots on the group-structured live mask, then
    re-checks the exact grid at the K selected slots.

    ``use_pallas=True`` runs that grouped selection and the lattice
    evaluation in the CUDA kernel
    :func:`nerfacc_tpu_torch.ops.march_select.fused_select_grouped` (the
    name is the JAX package's switch; on this port it selects the CUDA
    kernel, and on CPU tensors its plain PyTorch twin). The default keeps
    the unfused op chain; which is faster on the card is for measurement
    to decide.
    """
    S, K, C = max_samples_per_ray, slots_per_ray, coarse_stride
    if not (K <= S and S % max(C, 1) == 0):
        raise ValueError(f"need K <= S and S % C == 0, got {K}, {S}, {C}")

    if grid is not None and C > 1:
        live_g = live_groups
        if live_g is None:
            live_g = probe_live_groups(
                rays_o, rays_d, t_min, t_max, grid,
                render_step_size=render_step_size, cone_angle=cone_angle,
                max_samples_per_ray=S, coarse_stride=C, dt_max=dt_max,
                probe_dilation=probe_dilation, probe_groups=probe_groups,
            )
        # the per-ray probe layout is a function of the t-range, so it is
        # rebuilt here (works for live_groups gathered by ray compaction)
        k_in = _in_range_count(t_min, t_max, render_step_size, cone_angle,
                               dt_max, S)
        _, group_size = _probe_layout(k_in, S, C, probe_groups)
        if use_pallas:
            from .ops.march_select import fused_select_grouped

            t_starts, t_ends, deltas, ok = fused_select_grouped(
                live_g, group_size, t_min,
                k_slots=K, step_size=render_step_size,
                cone_angle=cone_angle, dt_max=dt_max,
            )
            return _finish_segments(
                rays_o, rays_d, t_starts, t_ends, deltas, ok, grid,
                exact_recheck=exact_recheck,
            )
        pos, ok, scale = select_slots_grouped(live_g, group_size, K)
    else:
        k = torch.arange(S, dtype=torch.float32, device=rays_o.device)[None]
        t_mid = _lattice_t(t_min[:, None], k + 0.5, render_step_size,
                           cone_angle, dt_max)
        k_in = _in_range_count(t_min, t_max, render_step_size, cone_angle,
                               dt_max, S)
        valid = k < k_in[:, None]
        if grid is not None:
            xyz = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
            valid = valid & grid.query_occ_fast(xyz)
        pos, ok, scale = select_slots(valid, K)
    lat = lambda k: _lattice_t(  # noqa: E731
        t_min[:, None], k.to(torch.float32), render_step_size, cone_angle,
        dt_max,
    )
    t_starts = lat(pos)
    t_ends = lat(pos.to(torch.float32) + 1.0)
    # exact decimation-group width: with cone_angle > 0 the later intervals
    # of an s-group are geometrically larger than (te - ts) * scale
    deltas = lat(pos + scale) - t_starts
    return _finish_segments(
        rays_o, rays_d, t_starts, t_ends, deltas, ok, grid,
        exact_recheck=grid is not None and C > 1 and exact_recheck,
    )


def _finish_segments(
    rays_o, rays_d, t_starts, t_ends, deltas, masks, grid, exact_recheck
) -> RaySegments:
    """Optional exact per-slot occupancy re-check + RaySegments assembly."""
    if exact_recheck:
        mid = (t_starts + t_ends) * 0.5
        xyz = rays_o[:, None, :] + mid[..., None] * rays_d[:, None, :]
        masks = masks & grid.query_occ_fast(xyz)
    return RaySegments(
        t_starts=t_starts, t_ends=t_ends, deltas=deltas, masks=masks
    )


def reselect_visible(
    segs: RaySegments, k2: int, use_pallas: Optional[bool] = None
) -> RaySegments:
    """Stage-2 re-selection: re-pack each ray's live samples into ``k2``
    slots, with exact decimation-group widths (group j spans the
    masked-delta cumsum from its own start to the next group's start, or
    to the total for the last live group).

    ``use_pallas=True`` runs the CUDA kernel
    :func:`nerfacc_tpu_torch.ops.march_select.fused_reselect` (its plain
    twin on CPU tensors).
    """
    if use_pallas:
        from .ops.march_select import fused_reselect

        ts2, te2, dt2, ok2 = fused_reselect(
            segs.masks, segs.t_starts, segs.t_ends, segs.deltas, k2=k2
        )
        return RaySegments(t_starts=ts2, t_ends=te2, deltas=dt2, masks=ok2)
    pos2, ok2, _ = select_slots(segs.masks, k2)
    d_live = torch.where(segs.masks, segs.deltas, torch.zeros_like(segs.deltas))
    cd = torch.cumsum(d_live, dim=1)  # inclusive
    start_excl = gather_rows_dense(cd, pos2) - gather_rows_dense(d_live, pos2)
    ok_next = torch.cat([ok2[:, 1:], torch.zeros_like(ok2[:, :1])], dim=1)
    next_start = torch.cat([start_excl[:, 1:], cd[:, -1:]], dim=1)
    widths = torch.where(ok_next, next_start, cd[:, -1:]) - start_excl
    return RaySegments(
        t_starts=gather_rows_dense(segs.t_starts, pos2),
        t_ends=gather_rows_dense(segs.t_ends, pos2),
        deltas=torch.where(ok2, widths, torch.zeros_like(widths)),
        masks=ok2,
    )


_starvation_warned = set()


def _warn_if_lattice_starved(
    scene_aabb,
    near_plane,
    far_plane,
    render_step_size,
    cone_angle,
    dt_max,
    max_samples_per_ray,
):
    """Warn (once per config) when the static candidate lattice cannot
    cover the statically knowable t-range: [near, far] when both are given
    (90% rule), else the aabb diagonal (50% rule, the worst-case span)."""
    t_lo = float(near_plane) if near_plane is not None else 0.0
    coverage = 0.9
    if far_plane is not None:
        t_hi = float(far_plane)
    elif scene_aabb is not None:
        aabb = np.asarray(
            scene_aabb.detach().cpu() if torch.is_tensor(scene_aabb)
            else scene_aabb,
            dtype=np.float64,
        )
        if aabb.size != 6 or not np.isfinite(aabb).all():
            return
        t_hi = t_lo + float(np.linalg.norm(aabb[3:] - aabb[:3]))
        coverage = 0.5
    else:
        return
    if not (t_hi > t_lo) or t_hi >= MAX_DIST:
        return
    key = (
        round(t_lo, 9), round(t_hi, 9), float(render_step_size),
        float(cone_angle), float(dt_max), int(max_samples_per_ray),
    )
    if key in _starvation_warned:
        return
    needed = samples_needed_for_range(
        t_lo, t_lo + coverage * (t_hi - t_lo), render_step_size,
        cone_angle=cone_angle, dt_max=dt_max,
    )
    if max_samples_per_ray < needed:
        _starvation_warned.add(key)
        full = samples_needed_for_range(
            t_lo, t_hi, render_step_size, cone_angle=cone_angle, dt_max=dt_max
        )
        warnings.warn(
            f"max_samples_per_ray={max_samples_per_ray} covers less than "
            f"90% of the t-range [{t_lo:g}, {t_hi:g}] at "
            f"render_step_size={render_step_size:g}, "
            f"cone_angle={cone_angle:g} (full coverage needs {full} "
            "lattice points). The far range is truncated on every ray. "
            "Raise max_samples_per_ray, set cone_angle > 0, or shrink "
            "[near_plane, far_plane].",
            RuntimeWarning,
            stacklevel=3,
        )


def _resolve_t_range(
    rays_o,
    rays_d,
    t_min,
    t_max,
    scene_aabb,
    near_plane,
    far_plane,
    stratified,
    generator,
    render_step_size,
    *,
    cone_angle=None,
    dt_max=MAX_DIST,
    max_samples_per_ray=None,
):
    """t-range priority: explicit > aabb intersect > [0, 1e10], then
    near/far clamps and stratified jitter drawn from ``generator``."""
    if max_samples_per_ray is not None and cone_angle is not None:
        _warn_if_lattice_starved(
            scene_aabb, near_plane, far_plane, render_step_size,
            cone_angle, dt_max, max_samples_per_ray,
        )
    n_rays = rays_o.shape[0]
    if t_min is None or t_max is None:
        if scene_aabb is not None:
            t_min, t_max = ray_aabb_intersect(rays_o, rays_d, scene_aabb)
        else:
            t_min = torch.zeros(n_rays, dtype=rays_o.dtype,
                                device=rays_o.device)
            t_max = torch.full((n_rays,), MAX_DIST, dtype=rays_o.dtype,
                               device=rays_o.device)
    if near_plane is not None:
        t_min = torch.clamp(t_min, min=near_plane)
    if far_plane is not None:
        t_max = torch.clamp(t_max, max=far_plane)
    if stratified:
        u = torch.rand(t_min.shape, generator=generator,
                       device=generator.device).to(t_min.device)
        t_min = t_min + u * render_step_size
    return t_min, t_max


def ray_marching(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t_min: Optional[torch.Tensor] = None,
    t_max: Optional[torch.Tensor] = None,
    scene_aabb: Optional[torch.Tensor] = None,
    grid: Optional[OccupancyGrid] = None,
    sigma_fn: Optional[Callable] = None,
    alpha_fn: Optional[Callable] = None,
    early_stop_eps: float = 1e-4,
    alpha_thre: float = 0.0,
    near_plane: Optional[float] = None,
    far_plane: Optional[float] = None,
    render_step_size: float = 1e-3,
    stratified: bool = False,
    cone_angle: float = 0.0,
    generator: Optional[torch.Generator] = None,
    max_samples_per_ray: int = 512,
    samples_budget: Optional[int] = None,
    visible_samples_budget: Optional[int] = None,
    coarse_stride: int = 1,
    dt_max: float = MAX_DIST,
    probe_dilation: int = 1,
    probe_groups: Optional[int] = None,
    exact_recheck: bool = True,
    use_pallas: Optional[bool] = None,
) -> PackedSamples:
    """March rays with empty- and occluded-space skipping (reference
    ``ray_marching.py:13-222``) into flat packed samples. No gradient is
    taken.

    The t-range is the explicit ``t_min`` / ``t_max``, else the
    ``scene_aabb`` intersection, else ``[0, 1e10]``, clamped to the near
    and far planes; ``stratified`` adds ``U[0, 1) * render_step_size`` to
    ``t_min``, drawn from ``generator`` (required then).

    Static shapes: ``max_samples_per_ray`` is the candidate lattice S;
    ``samples_budget`` gives each ray ``K = min(S, ceil(budget /
    n_rays))`` slots (default S). With ``sigma_fn`` or ``alpha_fn`` every
    slot (dead ones too) goes through the field and the visibility cull
    clears the occluded ones; ``visible_samples_budget`` then re-selects
    the visible samples into ``K2 = min(K, ceil(budget / n_rays))`` slots.
    ``coarse_stride``, ``probe_dilation``, ``probe_groups`` and
    ``exact_recheck`` are :func:`march_rays`' probe knobs;
    ``use_pallas=True`` runs slot selection and re-selection in the CUDA
    kernels (their plain twins on CPU tensors).

    Returns :class:`PackedSamples` of ``n_rays * K`` (or ``K2``) entries,
    ray-major; ``t_ends`` is ``t_starts + deltas``, the width that a
    decimated slot integrates.
    """
    n_rays = rays_o.shape[0]
    if alpha_fn is not None and sigma_fn is not None:
        raise ValueError(
            "Only one of `alpha_fn` and `sigma_fn` should be provided.")
    if stratified and generator is None:
        raise ValueError("stratified=True requires a torch.Generator "
                         "`generator`.")
    with torch.no_grad():
        t_min, t_max = _resolve_t_range(
            rays_o, rays_d, t_min, t_max, scene_aabb, near_plane, far_plane,
            stratified, generator, render_step_size,
            cone_angle=cone_angle, dt_max=dt_max,
            max_samples_per_ray=max_samples_per_ray,
        )
        S = max_samples_per_ray
        K = S if samples_budget is None else min(
            S, max(1, -(-samples_budget // n_rays)))
        segs = march_rays(
            rays_o, rays_d, t_min, t_max, grid,
            render_step_size=render_step_size, cone_angle=cone_angle,
            max_samples_per_ray=S, slots_per_ray=K,
            coarse_stride=coarse_stride if grid is not None else 1,
            dt_max=dt_max, probe_dilation=probe_dilation,
            probe_groups=probe_groups, exact_recheck=exact_recheck,
            use_pallas=use_pallas,
        )
        if sigma_fn is None and alpha_fn is None:
            return _flatten_segments(segs)
        # the visibility cull (reference ray_marching.py:192-220)
        from .vol_rendering import render_visibility_dense

        flat = _flatten_segments(segs)
        if sigma_fn is not None:
            sigmas = sigma_fn(flat.t_starts, flat.t_ends, flat.ray_indices)
            alphas = 1.0 - torch.exp(-sigmas.reshape(n_rays, K) * segs.deltas)
        else:
            alphas = alpha_fn(flat.t_starts, flat.t_ends,
                              flat.ray_indices).reshape(n_rays, K)
        vis = render_visibility_dense(alphas, segs.masks,
                                      early_stop_eps=early_stop_eps,
                                      alpha_thre=alpha_thre)
        segs = segs._replace(masks=segs.masks & vis)
        if visible_samples_budget is not None:
            K2 = min(K, max(1, -(-visible_samples_budget // n_rays)))
            segs = reselect_visible(segs, K2, use_pallas=use_pallas)
        return _flatten_segments(segs)


def _flatten_segments(segs: RaySegments) -> PackedSamples:
    """Dense (R, K) -> flat packed (R K,) with sorted ray indices; the flat
    ``t_ends`` is ``t_starts + deltas``, so ``sigma (t_ends - t_starts)``
    integrates a decimated slot's whole width."""
    return PackedSamples(
        ray_indices=segs.ray_indices,
        t_starts=segs.t_starts.reshape(-1, 1),
        t_ends=(segs.t_starts + segs.deltas).reshape(-1, 1),
        masks=segs.masks.reshape(-1),
    )
