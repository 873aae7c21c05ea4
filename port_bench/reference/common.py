"""The plain reference of what the benchmark's cells drive: the occupancy
grid and its update, the budgeted march, the visibility cull, the
composite, the loss and Adam, written out in plain PyTorch.

It imports nothing of the program and nothing of JAX. It states the
semantics that ``nerfacc_tpu_torch`` documents for these calls at the
cells' settings (axis-aligned box, no cone, grouped probes or the exact
lattice, rank decimation, live-sample budgets), each as the simplest
tensor code that gives them, so that a fault in the program's kernels,
fused chains or bookkeeping shows as a difference.

Every division by a constant divides by a tensor: a CUDA ``x / 0.005``
is computed as ``x * 200``, which rounds differently, and a lattice
index moves by one where it is rounded up.

Matrix products go through :func:`linear`. ``tf32=True`` rounds both of
its operands to TF32 (10 mantissa bits, round to nearest even) and
multiplies in f32: what the card's tensor cores do with TF32 on. That is
the control of the comparison, which has to fail.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

MISS = 1e10


def tensor_div(a: torch.Tensor, b: float) -> torch.Tensor:
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (nearest, ties to
    even); infinities and NaNs are not expected here."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _LinearTF32(torch.autograd.Function):
    """A linear layer whose three products (forward, and the input's and
    the weight's gradients) take their operands rounded to TF32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        rx, rw = round_tf32(x), round_tf32(weight)
        ctx.save_for_backward(rx, rw)
        ctx.has_bias = bias is not None
        return F.linear(rx, rw, bias)

    @staticmethod
    def backward(ctx, g):
        rx, rw = ctx.saved_tensors
        rg = round_tf32(g)
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return rg @ rw, rg.reshape(-1, g.shape[-1]).T @ rx.reshape(
            -1, rx.shape[-1]), gb


def linear(x, weight, bias=None, tf32: bool = False) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` in f32; with ``tf32`` every product takes
    its operands rounded to TF32 (the control)."""
    if tf32:
        return _LinearTF32.apply(x, weight, bias)
    return F.linear(x, weight, bias)


# ---------------------------------------------------------------- grid


class Grid(NamedTuple):
    """An occupancy grid over an axis-aligned box: the EMA occupancies
    (res^3,), the binary mask (res, res, res) and its dilations by
    radius (a (2 r + 1)^3 box max)."""

    aabb: torch.Tensor  # (6,)
    occs: torch.Tensor
    binary: torch.Tensor
    dilated: Dict[int, torch.Tensor]

    @property
    def res(self) -> int:
        return self.binary.shape[0]


def dilate(binary: torch.Tensor, radius: int) -> torch.Tensor:
    x = binary.to(torch.float32)[None, None]
    k = 2 * radius + 1
    return F.max_pool3d(x, k, stride=1, padding=radius)[0, 0] > 0


def make_grid(aabb, occs, binary, radii=(1, 2, 4)) -> Grid:
    binary = binary.to(torch.bool)
    return Grid(aabb=aabb, occs=occs, binary=binary,
                dilated={r: dilate(binary, r) for r in radii})


def grid_lookup(grid: Grid, x: torch.Tensor, radius: int = 0):
    """Occupancy of world points ``x`` (..., 3) from the exact mask or the
    one dilated by ``radius`` cells. Points outside the box read empty;
    a dilated lookup widens the box by ``radius`` cells (the clamp maps
    such a point onto the boundary cell)."""
    lo, hi = grid.aabb[:3], grid.aabb[3:]
    res = grid.res
    table = grid.binary if radius == 0 else grid.dilated[radius]
    unit = (x - lo) / (hi - lo)
    ijk = torch.floor(unit * float(res)).to(torch.int64).clamp(0, res - 1)
    flat = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]
    occ = table.reshape(-1)[flat]
    if radius:
        margin = radius * (hi - lo) / float(res)
        lo, hi = lo - margin, hi + margin
    inside = ((x >= lo) & (x <= hi)).all(dim=-1)
    return occ & inside


def update_grid(grid: Grid, density_fn, step_size: float,
                generator: torch.Generator, occ_thre: float = 1e-2,
                ema_decay: float = 0.95, chunk: int = 1 << 17) -> Grid:
    """The occupancy update past warm-up: a quarter of the cells drawn
    uniformly and as many drawn from the occupied ones (inverse CDF of the
    mask), one jittered point in each, density times ``step_size`` as the
    occupancy, each drawn cell decayed once, the max taken, and the mask
    set at ``min(mean(occs), occ_thre)``. The draws are taken from
    ``generator`` in this order: the uniform cells, the occupied cells'
    uniforms, the jitter."""
    res, dev = grid.res, grid.occs.device
    n_cells = res ** 3
    n = n_cells // 4
    gdev = generator.device
    uniform = torch.randint(0, n_cells, (n,), generator=generator,
                            device=gdev).to(dev)
    cdf = torch.cumsum(grid.binary.reshape(-1).to(torch.float32), dim=0)
    total = cdf[-1]
    u = torch.rand((n,), generator=generator, device=gdev).to(dev)
    occupied = torch.searchsorted(cdf, u * torch.clamp(total, min=1.0),
                                  right=True).clamp(0, n_cells - 1)
    occupied = torch.where(total > 0, occupied, uniform)
    cells = torch.cat([uniform, occupied])
    jitter = torch.rand((cells.shape[0], 3), generator=generator,
                        device=gdev).to(dev)
    ijk = torch.stack([cells // (res * res), (cells // res) % res,
                       cells % res], dim=-1).to(torch.float32)
    lo, hi = grid.aabb[:3], grid.aabb[3:]
    x = (ijk + jitter) / float(res) * (hi - lo) + lo
    with torch.no_grad():
        occ = torch.cat([density_fn(x[i:i + chunk]).reshape(-1)
                         for i in range(0, x.shape[0], chunk)]) * step_size
    drawn = torch.zeros(n_cells, dtype=torch.bool, device=dev)
    drawn[cells] = True
    occs = torch.where(drawn, grid.occs * ema_decay, grid.occs)
    occs = occs.scatter_reduce(0, cells, occ.to(torch.float32), "amax")
    thre = torch.minimum(occs.mean(),
                         torch.tensor(occ_thre, device=dev))
    return make_grid(grid.aabb, occs, (occs > thre).reshape(res, res, res),
                     tuple(grid.dilated))


# ---------------------------------------------------------------- march


class Samples(NamedTuple):
    """Each ray's selected samples in K slots: lattice interval
    ``[t_starts, t_ends)``, the width the slot integrates (``deltas``,
    wider where it stands for several candidates) and the live mask."""

    t_starts: torch.Tensor
    t_ends: torch.Tensor
    deltas: torch.Tensor
    masks: torch.Tensor


def ray_box(rays_o, rays_d, aabb):
    """Slab test: (t_min, t_max) with t_min >= 0; misses get 1e10 both."""
    inv = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * inv
    t1 = (aabb[3:] - rays_o) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1).clamp(min=0.0)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = t_far >= t_near
    miss = torch.full_like(t_near, MISS)
    return torch.where(hit, t_near, miss), torch.where(hit, t_far, miss)


def in_range_count(t_min, t_max, step, n_lattice):
    """Lattice candidates k whose midpoint t_min + (k + 1/2) step lies
    before t_max, as the count ceil((t_max - t_min) / step - 1/2)."""
    k = torch.ceil(tensor_div(t_max - t_min, step) - 0.5)
    return k.clamp(0, n_lattice).to(torch.int64)


def select_ranks(live: torch.Tensor, k_slots: int):
    """Per row of the candidate mask ``live`` (R, S): slot j takes the
    live candidate of rank j * s + 1, s = ceil(count / K), and stands for
    the s candidates from there (fewer at the end). Returns (position
    (R, K) clamped into the row, ok, scale)."""
    c = torch.cumsum(live.to(torch.int64), dim=1)
    count = c[:, -1:]
    j = torch.arange(k_slots, device=live.device)[None]
    stride = torch.clamp((count + k_slots - 1) // k_slots, min=1)
    target = j * stride + 1
    ok = target <= count
    scale = torch.minimum(torch.clamp(count - j * stride, min=0), stride)
    pos = torch.searchsorted(c, target).clamp(max=live.shape[1] - 1)
    return pos, ok, scale


def lattice(t_min, k, step):
    return t_min[:, None] + k.to(torch.float32) * step


def march(rays_o, rays_d, t_min, t_max, grid: Grid, *, step: float,
          n_lattice: int, k_slots: int, coarse_stride: int,
          probe_groups: int, probe_dilation: int) -> Samples:
    """The budgeted march over the lattice t_min + k step, k < n_lattice.

    ``coarse_stride == 1``: a candidate is live when its midpoint is
    inside the range and in an occupied cell. Otherwise each ray's range
    is cut into ``probe_groups`` groups of s = clip(ceil(k_in / G), 1,
    coarse_stride) candidates; a group's in-range candidates are live when
    the grid dilated by ``probe_dilation`` is occupied at the group's
    centre (clamped half a step before t_max), and the selected slots are
    then checked again against the exact grid at their midpoints.
    Either way K slots are taken by :func:`select_ranks`.
    """
    R, dev = rays_o.shape[0], rays_o.device
    k_in = in_range_count(t_min, t_max, step, n_lattice)
    k = torch.arange(n_lattice, device=dev)[None]
    in_range = k < k_in[:, None]
    if coarse_stride == 1:
        mid = lattice(t_min, k.to(torch.float32) + 0.5, step)
        xyz = rays_o[:, None] + mid[..., None] * rays_d[:, None]
        live = in_range & grid_lookup(grid, xyz)
        recheck = False
    else:
        G = probe_groups
        s = torch.clamp((k_in + G - 1) // G, 1, coarse_stride)[:, None]
        g = torch.arange(G, device=dev)[None]
        centre = (g * s).to(torch.float32) + (s.to(torch.float32) - 1) / 2
        t_probe = torch.minimum(lattice(t_min, centre + 0.5, step),
                                t_max[:, None] - 0.5 * step)
        xyz = rays_o[:, None] + t_probe[..., None] * rays_d[:, None]
        occ = grid_lookup(grid, xyz, probe_dilation)  # (R, G)
        group = k // s  # (R, S)
        covered = group < G
        live = in_range & covered & torch.gather(
            occ, 1, group.clamp(max=G - 1))
        recheck = True
    pos, ok, scale = select_ranks(live, k_slots)
    t_starts = lattice(t_min, pos, step)
    t_ends = lattice(t_min, pos + 1, step)
    deltas = lattice(t_min, pos + scale, step) - t_starts
    if recheck:
        mid = (t_starts + t_ends) * 0.5
        xyz = rays_o[:, None] + mid[..., None] * rays_d[:, None]
        ok = ok & grid_lookup(grid, xyz)
    return Samples(t_starts, t_ends, deltas, ok)


def budget_keep(masks: torch.Tensor, budget: int):
    """The live slots a field budget of ``budget`` evaluations keeps:
    all of them when they fit; otherwise each ray keeps its first
    max(1, floor(c_r * budget / count)) live slots (the ratio in f32),
    and slots past the budget in row-major order are dropped too."""
    c = torch.cumsum(masks.to(torch.int64), dim=1)
    c_r = c[:, -1]
    count = c_r.sum()
    if int(count) > budget:
        ratio = torch.tensor(float(budget), device=masks.device) / count.to(
            torch.float32)
        quota = torch.maximum(torch.floor(c_r.to(torch.float32) * ratio)
                              .to(torch.int64), torch.clamp(c_r, max=1))
    else:
        quota = c_r
    keep = masks & (c <= quota[:, None])
    rank = torch.cumsum(keep.reshape(-1).to(torch.int64), 0) - 1
    return keep & (rank < budget).reshape(masks.shape)


def midpoints(rays_o, rays_d, s: Samples):
    mid = (s.t_starts + s.t_ends) * 0.5
    return rays_o[:, None] + mid[..., None] * rays_d[:, None]


def eval_live(fn, masks, *inputs, width: int, chunk: int = 1 << 17):
    """``fn`` on the live slots of ``masks`` only (in chunks), put back on
    the (R, K) layout with zeros elsewhere: (R, K, width)."""
    idx = masks.reshape(-1).nonzero()[:, 0]
    flat = [t.reshape(-1, t.shape[-1]) for t in inputs]
    outs = [fn(*(t[idx[i:i + chunk]] for t in flat))
            for i in range(0, idx.shape[0], chunk)]
    out = torch.zeros(masks.numel(), width, device=masks.device)
    if outs:
        out = out.index_put((idx,), torch.cat(outs))
    return out.reshape(masks.shape + (width,))


def alphas(sigmas, deltas, masks):
    sd = torch.where(masks, sigmas * deltas, torch.zeros_like(sigmas))
    return 1.0 - torch.exp(-sd)


def visible(sigmas, deltas, masks, early_stop_eps: float = 1e-4):
    """Slots whose transmittance before them, the product of (1 - alpha)
    over the live slots ahead, is at least ``early_stop_eps``."""
    a = alphas(sigmas, deltas, masks)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(a[:, :1]), 1.0 - a[:, :-1]], dim=1), dim=1)
    return masks & (trans >= early_stop_eps)


def reselect(s: Samples, k2: int) -> Samples:
    """Each ray's live slots into ``k2`` slots by :func:`select_ranks`; a
    kept slot integrates the live widths from its own slot up to the next
    kept one (the last kept one, up to the row's end)."""
    pos, ok, _ = select_ranks(s.masks, k2)
    d_live = torch.where(s.masks, s.deltas, torch.zeros_like(s.deltas))
    cum = torch.cumsum(d_live, dim=1)
    start = torch.gather(cum, 1, pos) - torch.gather(d_live, 1, pos)
    ok_next = torch.cat([ok[:, 1:], torch.zeros_like(ok[:, :1])], dim=1)
    nxt = torch.cat([start[:, 1:], cum[:, -1:]], dim=1)
    width = torch.where(ok_next, nxt, cum[:, -1:]) - start
    return Samples(torch.gather(s.t_starts, 1, pos),
                   torch.gather(s.t_ends, 1, pos),
                   torch.where(ok, width, torch.zeros_like(width)), ok)


def composite(sigmas, rgbs, s: Samples, bkgd):
    """Weights w_i = T_i (1 - exp(-sigma_i delta_i)), T_i = exp(-sum_{j<i}
    sigma_j delta_j) over the live slots, each slot the interval from
    t_starts to t_starts + deltas (so delta_i is that difference, as
    rounded in f32); returns (colors on ``bkgd``, opacities (R, 1), depths
    (R, 1) at the lattice intervals' midpoints)."""
    delta = (s.t_starts + s.deltas) - s.t_starts
    sd = torch.where(s.masks, sigmas * delta, torch.zeros_like(sigmas))
    trans = torch.exp(-(torch.cumsum(sd, dim=1) - sd))
    w = torch.where(s.masks, trans * (1.0 - torch.exp(-sd)),
                    torch.zeros_like(sd))
    opacity = w.sum(dim=1, keepdim=True)
    color = (w[..., None] * rgbs).sum(dim=1) + bkgd * (1.0 - opacity)
    depth = (w * (s.t_starts + s.t_ends) * 0.5).sum(dim=1, keepdim=True)
    return color, opacity, depth


def render(field, rays_o, rays_d, grid: Grid, r: dict, *, stratify=None,
           train: bool = False):
    """One batch through the march, the optional density pass and cull
    with re-selection, the field and the composite on a white
    background. ``r`` holds the render settings (``step``, ``n_lattice``,
    ``slots``, ``visible_slots`` or None, ``coarse_stride``,
    ``probe_groups``, ``probe_dilation``, ``field_budget`` or None,
    ``early_stop_eps``); ``stratify`` (n_rays,) uniforms move each ray's
    start by that share of a step. Returns (colors, opacities, depths,
    live samples, density-pass samples)."""
    with torch.no_grad():
        t_min, t_max = ray_box(rays_o, rays_d, grid.aabb)
        if stratify is not None:
            t_min = t_min + stratify * r["step"]
        s = march(rays_o, rays_d, t_min, t_max, grid, step=r["step"],
                  n_lattice=r["n_lattice"], k_slots=r["slots"],
                  coarse_stride=r["coarse_stride"],
                  probe_groups=r["probe_groups"],
                  probe_dilation=r["probe_dilation"])
        n_density = 0
        if r["visible_slots"] is not None:
            masks = s.masks
            if r["field_budget"] is not None:
                masks = budget_keep(masks, r["field_budget"])
            n_density = int(masks.sum())
            sig = eval_live(field.density, masks, midpoints(rays_o, rays_d, s),
                            width=1)[..., 0]
            s = s._replace(masks=masks)
            s = reselect(s._replace(
                masks=visible(sig, s.deltas, s.masks, r["early_stop_eps"])),
                r["visible_slots"])
        masks = s.masks
        if r["field_budget"] is not None:
            masks = budget_keep(masks, r["field_budget"])
        s = s._replace(masks=masks)
        x = midpoints(rays_o, rays_d, s)
        dirs = torch.broadcast_to(rays_d[:, None], x.shape)
    with torch.set_grad_enabled(train):
        out = eval_live(lambda a, b: torch.cat(field(a, b), dim=-1), s.masks,
                        x, dirs, width=4)
        rgbs, sigmas = out[..., :3], out[..., 3]
        if r["visible_slots"] is None:
            # one field pass: the cull only trims what is composited
            s = s._replace(masks=visible(sigmas.detach(), s.deltas, s.masks,
                                         r["early_stop_eps"]))
        bkgd = torch.ones(3, device=rays_o.device)
        color, opacity, depth = composite(sigmas, rgbs, s, bkgd)
    return color, opacity, depth, int(s.masks.sum()), n_density


class Adam:
    """Adam written out: m, v, bias corrections, ``p -= lr m_hat /
    (sqrt(v_hat) + eps)``."""

    def __init__(self, params: List[torch.Tensor], lr: float, eps: float,
                 betas=(0.9, 0.999)):
        self.params, self.lr, self.eps, self.betas = params, lr, eps, betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def mse(colors, pixels) -> torch.Tensor:
    return ((colors - pixels) ** 2).mean()


def stratify_uniforms(generator: torch.Generator, n_rays: int, device):
    """The per-ray start jitter a training render draws, in its order."""
    return torch.rand((n_rays,), generator=generator,
                      device=generator.device).to(device)
