"""Rendering entry points (PyTorch port of :mod:`nerfacc_tpu.utils`).

``render_rays`` renders one ray batch on the dense ``(n_rays, K)`` slot
layout: t-range, strided probes and empty-ray compaction, the grouped
march, the optional two-stage visibility cull with stage-2 re-selection,
then the field query and the composite. ``render_image`` chunks a whole
image through it without gradients. The training step renders with
``return_compact=True`` and the target pixels as ``aux``; with
``field_samples_budget`` the field is evaluated on the live slots only.

``timestamps`` waits for the D-NeRF field and raises
``NotImplementedError``. ``DynamicRayBucketer`` sizes a trainer's ray
batches on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.sample_compact import compact_live_slots, expand_compact
from .ray_marching import (
    _resolve_t_range,
    march_rays,
    probe_live_groups,
    reselect_visible,
    select_slots,
)
from .vol_rendering import (
    accumulate_along_rays_dense,
    render_visibility_dense,
    render_weight_from_density_dense,
)


# padding rays' direction component, 1 / sqrt(3) divided in f32 as the JAX
# package divides it
_PAD_DIR = np.float32(1.0) / np.float32(np.sqrt(3.0))


def _dense_positions(rays_o, rays_d, t_starts, t_ends):
    """Sample midpoints on the dense layout — pure broadcasting."""
    t_mid = (t_starts + t_ends) * 0.5
    return rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]


def _dense_field_query(field, x, rays_d=None, density_only=False):
    """Query a radiance field at dense (R, K, 3) positions."""
    R, K = x.shape[:2]
    xf = x.reshape(R * K, 3)
    if density_only:
        return field.query_density(xf).reshape(R, K)
    d = torch.broadcast_to(rays_d[:, None, :], (R, K, 3)).reshape(R * K, 3)
    rgbs, sigmas = field(xf, d)
    return rgbs.reshape(R, K, 3), sigmas.reshape(R, K)


def _compact_field_query(
    field, rays_o, rays_d, t_starts, t_ends, masks, m_budget,
    density_only=False,
):
    """Query the field on the live slots only (gather-bound encoders).

    Compacts the (R, K) slot buffer's live samples into ``m_budget``
    entries, evaluates the field there, and expands rgb and sigma back to
    the dense layout. Returns ``(rgbs (R, K, 3), sigmas (R, K), masks,
    dropped)``, or ``(sigmas, masks, dropped)`` with ``density_only``:
    ``masks`` excludes any over-budget drops and ``dropped`` counts them.
    """
    R, K = masks.shape
    m_budget = min(m_budget, R * K)  # a budget beyond the buffer is free
    pos, ok, rank, keep, dropped = compact_live_slots(masks, m_budget)
    tc = ((t_starts + t_ends) * 0.5).reshape(-1)[pos]  # (M,)
    ridx = pos // K  # (M,) each compact sample's ray
    dc = rays_d[ridx]
    xc = rays_o[ridx] + tc[:, None] * dc
    if density_only:
        vals = field.query_density(xc).reshape(-1, 1).to(torch.float32)
    else:
        rgbs_c, sigmas_c = field(xc, dc)
        vals = torch.cat(
            [rgbs_c.to(torch.float32), sigmas_c.reshape(-1, 1)], dim=1
        )  # (M, 4)
    dense = expand_compact(vals, rank, keep.reshape(-1), pos, ok)
    if density_only:
        return dense[:, 0].reshape(R, K), keep, dropped
    return (dense[:, :3].reshape(R, K, 3), dense[:, 3].reshape(R, K), keep,
            dropped)


def render_rays(
    field,
    rays_o,
    rays_d,
    *,
    grid=None,
    scene_aabb=None,
    near_plane=None,
    far_plane=None,
    render_step_size=5e-3,
    render_bkgd=None,
    cone_angle=0.0,
    alpha_thre=0.0,
    early_stop_eps=1e-4,
    stratified=False,
    key=None,
    timestamps=None,
    max_samples_per_ray=512,
    samples_budget=None,
    visible_samples_budget=None,
    coarse_stride=1,
    probe_dilation=1,
    compact_rays_fraction=None,
    field_samples_budget=None,
    prefilter_sigma=True,
    dt_max=1e10,
    return_extras=False,
    exact_recheck=True,
    aux=None,
    return_compact=False,
    probe_groups=None,
    use_pallas=None,
):
    """Render one ray batch: march (no grad) + field + composite.

    Arguments are the JAX package's, with the field module in place of
    ``(params, field)`` and ``key`` a ``torch.Generator`` for the
    stratified jitter. Returns ``(colors, opacities, depths, n_samples)``,
    with ``n_samples`` the live sample count, plus an extras dict of the
    per-slot ``weights / t_starts / t_ends / deltas / masks`` (of the
    compacted ray set) and the ``field_budget_dropped`` count when
    ``return_extras``.

    ``samples_budget`` sets ``K = ceil(budget / n_rays)`` slots per ray.
    ``compact_rays_fraction`` (with ``grid`` and ``coarse_stride > 1``)
    drops rays whose probes are all empty and re-spreads the budget over
    the first ``H = fraction * n_rays`` hit rays; hit rays beyond ``H``
    render as background. ``visible_samples_budget`` with
    ``prefilter_sigma`` runs the two-stage render: a density pass, the
    visibility cull, and re-selection into ``K2`` slots per ray.
    ``use_pallas=True`` routes the march selection and the re-selection
    through the CUDA kernels. ``field_samples_budget`` evaluates the field
    on the march-live slots only, compacted into that many entries (for
    gather-bound encoders; size it above the scene's live count:
    over-budget samples are dropped front to back per ray and counted in
    ``field_budget_dropped``).

    ``aux`` is an optional (n_rays, D) per-ray payload (e.g. the target
    pixels), gathered with the compacted rays. ``return_compact`` skips the
    expand-back and returns the compacted outputs with the selection,
    ``(colors, opacities, depths, n_samples, sel)`` with ``sel =
    {"ray_indices" (int32), "ray_ok", "aux"}`` (plus ``sel["extras"]`` with
    ``return_extras``); without ray compaction the selection is every ray.
    Rays left out render exactly ``render_bkgd``, so a full-batch loss
    follows algebraically (``training.compact_mse``).
    """
    if timestamps is not None:
        raise NotImplementedError("time-conditioned fields are not ported yet")
    n_rays = rays_o.shape[0]
    if stratified and key is None:
        raise ValueError("stratified=True requires a torch.Generator `key`.")
    with torch.no_grad():
        t_min, t_max = _resolve_t_range(
            rays_o, rays_d, None, None, scene_aabb, near_plane, far_plane,
            stratified, key, render_step_size,
            cone_angle=cone_angle, dt_max=dt_max,
            max_samples_per_ray=max_samples_per_ray,
        )
    S = max_samples_per_ray

    live_groups = None
    ray_sel = None  # (indices, valid) of compacted rays
    n_out = n_rays
    if (
        compact_rays_fraction is not None
        and grid is not None
        and coarse_stride > 1
    ):
        live_g = probe_live_groups(
            rays_o, rays_d, t_min, t_max, grid,
            render_step_size=render_step_size, cone_angle=cone_angle,
            max_samples_per_ray=S, coarse_stride=coarse_stride,
            dt_max=dt_max, probe_dilation=probe_dilation,
            probe_groups=probe_groups,
        )
        hit = live_g.sum(dim=1) > 0
        H = max(1, int(round(n_rays * compact_rays_fraction)))
        # the first H hit rays; slots past the last hit point at the last
        # ray and are invalid
        posr, okr, _ = select_slots(hit[None, :], H, decimate=False)
        # int32 as the JAX package returns it; PyTorch's row gathers and
        # index_copy_ take int64, cast where they index
        ray_sel = (posr[0], okr[0])
        ridx = posr[0].long()
        rays_o, rays_d = rays_o[ridx], rays_d[ridx]
        t_min, t_max = t_min[ridx], t_max[ridx]
        live_groups = live_g[ridx]
        if aux is not None:
            aux = aux.to(torch.float32)[ridx]
        n_rays = H

    K = S if samples_budget is None else min(
        S, max(1, -(-samples_budget // n_rays))
    )
    segs = march_rays(
        rays_o, rays_d, t_min, t_max, grid,
        render_step_size=render_step_size,
        cone_angle=cone_angle,
        max_samples_per_ray=S,
        slots_per_ray=K,
        coarse_stride=coarse_stride if grid is not None else 1,
        dt_max=dt_max,
        live_groups=live_groups,
        probe_dilation=probe_dilation,
        exact_recheck=exact_recheck,
        probe_groups=probe_groups,
        use_pallas=use_pallas,
    )
    if ray_sel is not None:
        segs = segs._replace(masks=segs.masks & ray_sel[1][:, None])

    two_stage = prefilter_sigma and visible_samples_budget is not None
    if two_stage:
        # stage 1: a density pass without gradients -> visibility cull ->
        # re-selection into the smaller visible budget
        with torch.no_grad():
            if field_samples_budget is not None:
                sigmas, keep1, _ = _compact_field_query(
                    field, rays_o, rays_d, segs.t_starts, segs.t_ends,
                    segs.masks, field_samples_budget, density_only=True,
                )
                segs = segs._replace(masks=keep1)
            else:
                x = _dense_positions(
                    rays_o, rays_d, segs.t_starts, segs.t_ends
                )
                sigmas = _dense_field_query(field, x, density_only=True)
            alphas = 1.0 - torch.exp(-sigmas * segs.deltas)
            vis = render_visibility_dense(
                alphas, segs.masks,
                early_stop_eps=early_stop_eps, alpha_thre=alpha_thre,
            )
            K2 = min(K, max(1, -(-visible_samples_budget // n_rays)))
            segs = reselect_visible(
                segs._replace(masks=segs.masks & vis), K2,
                use_pallas=use_pallas,
            )

    t_starts, t_ends, deltas = segs.t_starts, segs.t_ends, segs.deltas
    if field_samples_budget is not None:
        rgbs, sigmas, masks, field_dropped = _compact_field_query(
            field, rays_o, rays_d, t_starts, t_ends, segs.masks,
            field_samples_budget,
        )
    else:
        x = _dense_positions(rays_o, rays_d, t_starts, t_ends)
        rgbs, sigmas = _dense_field_query(field, x, rays_d=rays_d)
        masks = segs.masks
        field_dropped = torch.zeros(
            (), dtype=torch.int32, device=masks.device
        )
    if prefilter_sigma and not two_stage:
        # one field pass: the cull only refines the composite's mask
        alphas = 1.0 - torch.exp(-sigmas.detach() * deltas)
        masks = masks & render_visibility_dense(
            alphas, masks, early_stop_eps=early_stop_eps,
            alpha_thre=alpha_thre,
        )
    weights = render_weight_from_density_dense(
        t_starts, t_starts + deltas, sigmas, masks=masks
    )
    colors = accumulate_along_rays_dense(weights, values=rgbs, masks=masks)
    opacities = accumulate_along_rays_dense(weights, masks=masks)
    t_mid = (t_starts + t_ends) * 0.5
    depths = accumulate_along_rays_dense(
        weights, values=t_mid[..., None], masks=masks
    )
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)
    extras = None
    if return_extras:
        extras = {
            "weights": weights, "t_starts": t_starts, "t_ends": t_ends,
            "deltas": deltas, "masks": masks,
            "field_budget_dropped": field_dropped,
        }

    if return_compact:
        ridx, ray_ok = ray_sel if ray_sel is not None else (
            torch.arange(n_rays, dtype=torch.int32, device=masks.device),
            torch.ones((n_rays,), dtype=torch.bool, device=masks.device),
        )
        sel = {"ray_indices": ridx, "ray_ok": ray_ok, "aux": aux}
        if return_extras:
            sel["extras"] = extras
        return colors, opacities, depths, masks.sum(), sel

    if ray_sel is not None:
        # expand back to the full batch: rays without live samples render
        # pure background with zero opacity and depth. Invalid selection
        # slots write into an extra drop row, cut off after, so no real
        # row is written by them
        ridx, ray_ok = ray_sel
        dest = torch.where(ray_ok, ridx, torch.full_like(ridx, n_out)).long()

        def expand(vals, fill):
            fill = torch.as_tensor(fill, dtype=vals.dtype, device=vals.device)
            buf = torch.broadcast_to(fill, (n_out + 1,) + vals.shape[1:])
            return buf.clone().index_copy_(0, dest, vals)[:n_out]

        colors = expand(colors, 0.0 if render_bkgd is None else render_bkgd)
        opacities = expand(opacities, 0.0)
        depths = expand(depths, 0.0)
    n_samples = masks.sum()
    if return_extras:
        return colors, opacities, depths, n_samples, extras
    return colors, opacities, depths, n_samples


def render_image(
    field,
    rays_o,
    rays_d,
    *,
    test_chunk_size: int = 8192,
    eval_samples_per_ray: int = 128,
    eval_visible_samples_per_ray: Optional[int] = None,
    **kwargs,
):
    """Chunked whole-image render without gradients.

    ``rays_o`` / ``rays_d`` are flat (h*w, 3); returns (colors, opacities,
    depths) of the same leading shape. The per-chunk ``samples_budget`` is
    ``test_chunk_size * eval_samples_per_ray``; with
    ``eval_visible_samples_per_ray`` a given ``visible_samples_budget`` is
    rescaled to ``test_chunk_size * eval_visible_samples_per_ray``. The
    last chunk is padded with rays from the origin along ``(1,1,1)/sqrt(3)``
    (finite through ``1 / rays_d``).
    """
    n = rays_o.shape[0]
    chunk = test_chunk_size
    kwargs = dict(kwargs)
    kwargs["samples_budget"] = chunk * eval_samples_per_ray
    if (
        eval_visible_samples_per_ray is not None
        and kwargs.get("visible_samples_budget") is not None
    ):
        kwargs["visible_samples_budget"] = chunk * eval_visible_samples_per_ray
    # eval renders are exact: live-sample compaction is a train-step budget
    kwargs.pop("field_samples_budget", None)
    if kwargs.get("timestamps") is not None:
        raise NotImplementedError("time-conditioned fields are not ported yet")
    kwargs.pop("timestamps", None)
    pad = (-n) % chunk
    if pad:
        rays_o = torch.cat(
            [rays_o, torch.zeros((pad, 3), dtype=rays_o.dtype,
                                 device=rays_o.device)]
        )
        rays_d = torch.cat(
            [rays_d, torch.full((pad, 3), float(_PAD_DIR),
                                dtype=rays_d.dtype, device=rays_d.device)]
        )
    outs = []
    with torch.no_grad():
        for i in range(0, n + pad, chunk):
            colors, opacities, depths, _ = render_rays(
                field, rays_o[i : i + chunk], rays_d[i : i + chunk], **kwargs
            )
            outs.append((colors, opacities, depths))
    return tuple(torch.cat([o[j] for o in outs])[:n] for j in range(3))


class DynamicRayBucketer:
    """Dynamic ray-batch sizing on a ladder of batch sizes (a copy of the
    JAX package's host-side ``nerfacc_tpu.utils.DynamicRayBucketer``).

    The reference resizes ``num_rays`` every step to keep the live samples
    per batch near a target (``train_ngp_nerf.py:236-241``). Here ray
    counts snap to a geometric ladder of buckets, and the controller
    tracks an EMA of live samples per ray to pick the bucket whose
    expected sample count is closest to the target. Stateful, on the host.
    """

    def __init__(
        self,
        target_samples: int,
        init_num_rays: int = 4096,
        min_num_rays: int = 1024,
        max_num_rays: int = 65536,
        ema: float = 0.9,
    ):
        self.target = target_samples
        self.ema = ema
        self.buckets = []
        b = min_num_rays
        while b <= max_num_rays:
            self.buckets.append(b)
            b *= 2
        self.num_rays = min(self.buckets, key=lambda x: abs(x - init_num_rays))
        self._spr = None  # EMA of live samples per ray

    def update(self, n_live_samples: int, num_rays_used: int) -> int:
        """Feed back a step's live sample count; returns the next batch
        size (one of the buckets)."""
        spr = max(n_live_samples, 1) / max(num_rays_used, 1)
        self._spr = (
            spr if self._spr is None
            else self.ema * self._spr + (1 - self.ema) * spr
        )
        want = self.target / self._spr
        self.num_rays = min(self.buckets, key=lambda x: abs(x - want))
        return self.num_rays
