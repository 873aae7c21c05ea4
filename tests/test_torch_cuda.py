"""The CUDA kernels of nerfacc_tpu_torch against their plain twins, on the
card. Tests marked ``cuda`` skip where there is no CUDA device; on the
card run them without the JAX-side conftest (the card's machine has no
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports no JAX. Tolerances: masks bit-equal and t within
rtol 1e-5 / atol 1e-6 (the march kernels keep the plain chain's f32
operations; only cumsum order differs; the t that re-selection gathers
are copies, bit-equal); CP features within 1e-6 absolute
(both sum the same two exact products; bit-equal through either of the
forward's two kernels) and the bf16 residuals equal; CP table gradients
within 1e-5 of the largest |gradient| (the kernels add in atomic order,
the plain product in cuBLAS's order); the hash-table scatter, per level
and all levels in one launch, within 1e-5 of the largest |sum| (atomic
order against ``index_add_``'s); the table gather bit-equal (indices
outside the table clamped into it, as the kernel documents). The MLP
fields and the time-conditioned render, card against CPU: f32 GEMMs
summed in another order (TF32 off), outputs within rtol 1e-5 / atol 1e-5,
gradients within 1e-3 in L2 (a relu at 0 may flip), render masks
bit-equal and colours within 1e-5. The proposal trainer's step, card
against CPU: bf16 heads, loss within 1e-4 relative; the resampled
intervals move with the proposal's density, so the gradients are held
to the JAX package's bound for the bf16 CP level (5e-2 in L2); with the
CPU's resampled intervals given to the card's step, only the heads' bf16
roundings and K4's order of sums differ: 1e-2 in L2. The data-parallel
step in a world of one under NCCL against ``train_step``: loss within
1e-6 relative, gradients within 1e-5 in relative L2 (K4 and K7 add in
atomic order). ``quant_int8`` card vs CPU: the forward and the bf16 level
features bit-equal, the table gradient within 1e-5 of its largest entry
(atomic order). ``gather_mode="per_level"`` vs packed on the card: the
forward bit-equal, the backward's inputs bit-equal and its results
within 1e-5 of the largest entry. The fused hash encoder: its indices and
weights bit-equal to ``hash_grid_indices``, its features bit-equal to
the corner-order sum ``acc + w * f`` written here and within 8 f32 ulps
of the largest feature of ``hash_encode_lookup`` (whose corner sum has
another order), its table gradient within 1e-5 of the largest entry of
the plain path's (both add in atomic order). The exact stride-1 march's
kernel (``march_dense``): starts, ends, widths and masks bit-equal to
``march_rays``' plain chain, and a view rendered through it equal to one
rendered through the chain, colour for colour. The CUDA graphs of the
render's gradient-free stages (``nerfacc_tpu_torch.graphs``), at the
benchmark cells' settings: a view's colours, opacities and depths
bit-equal to the eager path's; the NGP step, eager and graphed from one
state each step, losses, live samples, grid and heads bit-equal, the
table's gradient within its atomic-order bound; the vanilla step
bit-equal over five steps; the counters under the profiler equal; no
synchronisation under ``set_sync_debug_mode("error")``; a field that
reads the host falls back; a view under ``torch.inference_mode`` runs
eagerly.
"""

import contextlib

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import _build, render_rays
from nerfacc_tpu_torch.convert import grid_from_arrays
from nerfacc_tpu_torch.grid import create_grid
from nerfacc_tpu_torch.models import (
    DNeRFRadianceField,
    NGPRadianceField,
    TensoCPRadianceField,
    VanillaNeRFRadianceField,
)
from nerfacc_tpu_torch.models import HashEncoder, hash_grid_indices
from nerfacc_tpu_torch.models.hash_encoding import _level_resolutions
from nerfacc_tpu_torch.ops import (
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
    cp_level_grads_slice_width,
    cp_level_grads_staged,
    fused_reselect,
    fused_reselect_plain,
    fused_select_grouped,
    fused_select_grouped_plain,
    hash_encode,
    hash_encode_lookup,
    hash_encode_plain,
    hash_grad_scatter,
    hash_grad_scatter_levels,
    hash_grad_scatter_levels_plain,
    hash_grad_scatter_plain,
    march_dense,
    table_gather,
    table_gather_plain,
)
from nerfacc_tpu_torch.training import train_step

torch.set_num_threads(1)

# table gradients: max abs error over the largest |gradient| of the twin
GRAD_REL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _select_args(R, G, C, K, seed, device):
    rng = np.random.RandomState(seed)
    gsize = rng.randint(1, C + 1, size=(R, 1))
    live = rng.randint(0, C + 1, size=(R, G)) * (rng.rand(R, G) < 0.4)
    live = np.minimum(live, gsize).astype(np.int32)
    t_min = (rng.rand(R) * 2.0 + 0.05).astype(np.float32)
    return [torch.as_tensor(a, device=device)
            for a in (live, gsize.astype(np.int32), t_min)]


def _reselect_args(R, K, seed, device):
    rng = np.random.RandomState(seed)
    masks = rng.rand(R, K) < 0.5
    ts = np.sort(rng.rand(R, K), axis=1).astype(np.float32)
    dt = (rng.rand(R, K) * 0.01 + 1e-3).astype(np.float32)
    return [torch.as_tensor(a, device=device)
            for a in (masks, ts, (ts + dt).astype(np.float32), dt)]


def _assert_quads(got, want):
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    # no toolkit: the build raises, nothing falls back
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "no_nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.cuda
@pytest.mark.parametrize("G,R", [(33, 8), (512, 128)])
def test_cp_kernel_matches_plain(cuda_device, G, R):
    rng = np.random.RandomState(5)
    xu = rng.rand(3001, 3).astype(np.float32)
    xu[:10] = 1.0
    xu[10:20] = 0.0
    tables = [(rng.randn(G, R) * 0.2).astype(np.float32) for _ in range(3)]
    args = [torch.as_tensor(a, device=cuda_device) for a in (xu, *tables)]
    before = cp_level_features.launches
    got = cp_level_features(*args)
    torch.cuda.synchronize()
    assert cp_level_features.launches == before + 1
    torch.testing.assert_close(got, cp_level_features_plain(*args),
                               rtol=0.0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("G,R,B,width", [
    (128, 64, 131072, 64),    # the coarse level whole, a chunk of update_grid
    (512, 128, 131072, 64),   # the fine level in two slices
    (512, 128, 70001, 64),    # ragged chunks and a ragged last run
    (128, 128, 70001, 128),   # a warp per sample
    (64, 96, 70001, 32),      # three slices of 32, four samples per step
    (2048, 32, 70001, 0),     # tables beyond a block's shared memory
    (128, 48, 70001, 0),      # R no multiple of 32
    (128, 64, 1, 0),          # small batches read the tables from memory
    (512, 128, 65535, 0),
])
def test_cp_forward_kernels_are_bit_equal(cuda_device, G, R, B, width):
    # K1 and K2 through both of their kernels, chosen by shape, with
    # samples at u == 0 and u == G - 1 (one tap) at the start and the end
    assert cp_features_slice_width(G, R, B) == width
    rng = np.random.RandomState(17)
    xu = rng.rand(B, 3).astype(np.float32)
    xu[:10] = 1.0
    xu[10:20] = 0.0
    xu[-3:] = 1.0
    tables = [(rng.randn(G, R) * 0.2).astype(np.float32) for _ in range(3)]
    args = [torch.as_tensor(a, device=cuda_device) for a in (xu, *tables)]
    before = (cp_level_features.launches, cp_level_features_res.launches)
    got = cp_level_features(*args)
    feats, us = cp_level_features_res_fwd(*args)
    torch.cuda.synchronize()
    assert (cp_level_features.launches,
            cp_level_features_res.launches) == (before[0] + 1, before[1] + 1)
    want, want_us = cp_level_features_res_plain(*args)
    assert torch.equal(got, want) and torch.equal(feats, want)
    for u, w in zip(us, want_us):
        assert u.dtype == torch.bfloat16 and torch.equal(u, w)
    if width:
        # tables 4 bytes off a 16-byte boundary: the other kernel, by pointer
        store = torch.empty(3 * G * R + 1, device=cuda_device)
        views = []
        for i, t in enumerate(args[1:]):
            v = store[1 + i * G * R:1 + (i + 1) * G * R].view(G, R)
            v.copy_(t)
            views.append(v)
        assert views[0].data_ptr() % 16 == 4
        assert torch.equal(cp_level_features(args[0], *views), want)


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= GRAD_REL * scale


def _ray_ordered_xu(B, rng, step=5e-3 / 3.0, per_ray=48):
    """B points in [0, 1]^3 laid along rays, ``per_ray`` consecutive
    samples ``step`` apart on each (the order the training step feeds its
    samples), clipped into the cube."""
    n_rays = -(-B // per_ray)
    o = rng.rand(n_rays, 3)
    d = rng.randn(n_rays, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = step * np.arange(per_ray)
    x = o[:, None, :] + t[None, :, None] * d[:, None, :]
    return np.clip(x.reshape(-1, 3)[:B], 0.0, 1.0).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("points", ["random", "ray-ordered"])
@pytest.mark.parametrize("G,R,B,zero_g,k3_width", [
    (33, 8, 3001, False, 0),
    (512, 128, 3001, False, 0),   # K4: four slices of 32 features
    (128, 64, 3001, False, 0),    # K4: one slice, all 64 features
    (33, 48, 3001, False, 0),     # K4: one slice, a warp's second pass half idle
    (512, 48, 70001, False, 16),  # K4: slices of 32 and 16 features, many chunks
    (1024, 128, 3001, False, 0),  # tables beyond shared memory: global atomics
    (128, 64, 0, False, 0),
    (128, 64, 3001, True, 0),     # an all-zero cotangent adds nothing
    # K3 with its partial tables and the staged tables in shared memory
    (128, 64, 70001, False, 64),    # the coarse level whole, a warp a sample
    (128, 48, 70001, False, 16),    # R no multiple of 32: four samples a step
    (256, 96, 70001, False, 32),    # three slices, two samples per step
    # K3 with its partial tables alone, the tables through L1 / L2
    (512, 128, 70001, False, 32),   # four slices, two samples per step
    (256, 64, 70001, False, 64),    # one slice, a warp a sample
    (128, 64, 70001, True, 64),     # an all-zero cotangent adds nothing
    (128, 64, 65535, False, 0),     # a batch below K3's threshold
    (1024, 128, 70001, False, 0),   # tables beyond shared memory
])
def test_cp_training_kernels_match_plain(cuda_device, G, R, B, zero_g,
                                         k3_width, points):
    # K2, K3 and K4 at a ragged B with samples at u == 0 and u == G - 1,
    # on uniform random points and on points laid along rays
    rng = np.random.RandomState(6)
    if points == "random":
        xu = rng.rand(B, 3).astype(np.float32)
    else:
        xu = _ray_ordered_xu(B, rng)
    xu[:10] = 1.0
    xu[10:20] = 0.0
    tables = [(rng.randn(G, R) * 0.2).astype(np.float32) for _ in range(3)]
    g = rng.randn(B, R).astype(np.float32) * (0.0 if zero_g else 1.0)
    xu, t0, t1, t2, g = (torch.as_tensor(a, device=cuda_device)
                         for a in (xu, *tables, g))
    counters = (cp_level_features_res, cp_level_grads, cp_level_grads_res)
    before = [fn.launches for fn in counters]
    # which of K3's and K4's kernels this shape takes
    assert cp_level_grads_slice_width(G, R, B) == k3_width
    if k3_width:
        # the cases' staged slices hold 8,192 nodes x features (144 KB with
        # the partial tables), the unstaged ones 16,384 (192 KB alone)
        assert cp_level_grads_staged(G, k3_width) == (G * k3_width <= 8192)
    assert (cp_grads_slice_width(G, R) == 0) == (G == 1024)

    feats, us = cp_level_features_res_fwd(xu, t0, t1, t2)
    want_feats, want_us = cp_level_features_res_plain(xu, t0, t1, t2)
    torch.testing.assert_close(feats, want_feats, rtol=0.0, atol=1e-6)
    assert torch.equal(feats, cp_level_features(xu, t0, t1, t2))  # K1's
    for u, want in zip(us, want_us):
        assert torch.equal(u, want)
    got3 = cp_level_grads(xu, t0, t1, t2, g)
    got4 = cp_level_grads_res(xu, g, *us, G)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [b + 1 for b in before]
    if B == 0 or zero_g:
        for d in (*got3, *got4):
            assert d.shape == (G, R) and not bool(d.any())
        return
    want3 = cp_level_grads_plain(xu, t0, t1, t2, g)
    _assert_grads_close(got3, want3)
    _assert_grads_close(got4, cp_level_grads_res_plain(xu, g, *us, G))
    if k3_width:
        # tables 4 bytes off a 16-byte boundary (staged: the same kernel,
        # it stages them word by word; unstaged: the global-atomic kernel,
        # by pointer, as it reads two features at a time), then g too (the
        # global-atomic kernel, by pointer)
        store = torch.empty(3 * G * R + B * R + 1, device=cuda_device)
        views = []
        for i, t in enumerate((t0, t1, t2, g)):
            n = t.numel()
            v = store[1 + i * G * R:1 + i * G * R + n].view(t.shape)
            v.copy_(t)
            views.append(v)
        assert views[0].data_ptr() % 16 == 4 and views[3].data_ptr() % 8 == 4
        _assert_grads_close(cp_level_grads(xu, *views[:3], g), want3)
        _assert_grads_close(cp_level_grads(xu, *views), want3)


@pytest.mark.cuda
def test_cp_autograd_ops_launch_their_kernels(cuda_device):
    rng = np.random.RandomState(7)
    xu = torch.as_tensor(rng.rand(500, 3).astype(np.float32),
                         device=cuda_device)
    tables = [torch.as_tensor((rng.randn(33, 8) * 0.2).astype(np.float32),
                              device=cuda_device).requires_grad_()
              for _ in range(3)]
    for op, fwd, bwd in ((cp_level_features, cp_level_features,
                          cp_level_grads),
                         (cp_level_features_res, cp_level_features_res,
                          cp_level_grads_res)):
        n_fwd, n_bwd = fwd.launches, bwd.launches
        op(xu, *tables).square().sum().backward()
        assert (fwd.launches, bwd.launches) == (n_fwd + 1, n_bwd + 1)
        assert all(t.grad is not None for t in tables)
    # no gradient to take: the residual op runs K1 alone
    n_k1, n_k2 = cp_level_features.launches, cp_level_features_res.launches
    with torch.no_grad():
        cp_level_features_res(xu, *tables)
    assert cp_level_features.launches == n_k1 + 1
    assert cp_level_features_res.launches == n_k2


def _small_train_scene(device):
    aabb = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
    rng = np.random.RandomState(0)
    binary = np.zeros((32, 32, 32), bool)
    binary[6:26, 6:26, 6:26] = rng.rand(20, 20, 20) < 0.5
    field = TensoCPRadianceField(
        aabb=aabb, levels=((16, 8), (32, 16)), use_kernel=True,
        density_bias=3.0, generator=torch.Generator().manual_seed(1),
        device=device,
    )
    o = rng.randn(64, 3)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(64, 3) * 0.8
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays = [torch.as_tensor(a.astype(np.float32), device=device)
            for a in (o, d, rng.rand(64, 3))]
    kw = dict(scene_aabb=aabb, render_step_size=1e-2,
              max_samples_per_ray=512, samples_budget=64 * 24,
              coarse_stride=8, probe_dilation=1, probe_groups=16,
              compact_rays_fraction=0.75, use_pallas=True)
    return field, grid_from_arrays(aabb, binary, device=device), rays, kw


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    # one small train step through the kernels vs the plain twins on the
    # CPU, from the same weights and rays. The heads round f32 sums taken
    # in another order to bf16, which can move a value by one bf16 step
    # (2^-8 relative): loss within 1e-4, each gradient within 1e-2 in L2.
    results = []
    for device in (cuda_device, torch.device("cpu")):
        field, grid, (o, d, px), kw = _small_train_scene(device)
        opt = torch.optim.Adam(field.parameters(), lr=5e-4)
        counts = (cp_level_features_res.launches, cp_level_grads_res.launches,
                  fused_select_grouped.launches)
        loss, n = train_step(field, opt, grid, o, d, px, **kw)
        launched = [a - b for a, b in zip(
            (cp_level_features_res.launches, cp_level_grads_res.launches,
             fused_select_grouped.launches), counts)]
        grads = {k: p.grad.detach().cpu() for k, p in field.named_parameters()}
        results.append((float(loss), int(n), grads, launched))
    (loss_c, n_c, g_c, l_c), (loss_h, n_h, g_h, l_h) = results
    assert l_c == [2, 2, 1] and l_h == [0, 0, 0]
    assert abs(loss_c - loss_h) <= 1e-4 * loss_h
    assert abs(n_c - n_h) <= 2 and n_h > 200
    for k, want in g_h.items():
        err = float(torch.linalg.norm(g_c[k] - want))
        assert err <= 1e-2 * float(torch.linalg.norm(want)), k


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(512, 3001), (1 << 19, 200003)])
def test_hash_scatter_kernel_matches_plain(cuda_device, T, B):
    # ragged B, padding rows (-1), few entries (contention) and many
    rng = np.random.RandomState(13)
    idx = rng.randint(0, T, B).astype(np.int32)
    idx[::17] = -1
    v = rng.randn(B, 2).astype(np.float32)
    v[5::29] = 0.0  # pairs the kernel skips
    idx, v = (torch.as_tensor(a, device=cuda_device) for a in (idx, v))
    before = hash_grad_scatter.launches
    got = hash_grad_scatter(idx, v, T)
    torch.cuda.synchronize()
    assert hash_grad_scatter.launches == before + 1
    want = hash_grad_scatter_plain(idx, v, T)
    want64 = torch.zeros((T, 2), dtype=torch.float64, device=cuda_device)
    live = idx >= 0
    want64.index_add_(0, idx[live].long(), v[live].double())
    scale = float(want64.abs().max())
    assert float((got - want).abs().max()) <= GRAD_REL * scale
    assert float((got.double() - want64).abs().max()) <= GRAD_REL * scale
    # into a slice of a zeroed gradient, added in place
    grad = torch.zeros((3, T, 2), device=cuda_device)
    out = hash_grad_scatter(idx, v, T, out=grad[1])
    assert out.data_ptr() == grad[1].data_ptr()
    assert float((grad[1] - want).abs().max()) <= GRAD_REL * scale
    assert not bool(grad[0].any()) and not bool(grad[2].any())
    with pytest.raises(TypeError):
        hash_grad_scatter(idx.long(), v, T)
    with pytest.raises(ValueError):
        hash_grad_scatter(idx, v, T, out=grad[:, :, 0])


def _ray_points(n_rays, per_ray, seed):
    """Points along rays, front to back, a step of 5e-3 / 3 apart in the
    unit cube: consecutive samples share cells on the coarse levels."""
    rng = np.random.RandomState(seed)
    o = rng.rand(n_rays, 1, 3) * 0.6 + 0.2
    d = rng.randn(n_rays, 1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = (rng.rand(n_rays, 1, 1) * 0.1
         + np.arange(per_ray)[None, :, None] * (5e-3 / 3))
    return np.clip(o + t * d, 0.0, 1.0).reshape(-1, 3).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("points,N,offset", [
    ("random", 20003, 0),
    ("rays", 24 * 833, 0),
    ("rays", 24 * 833 + 5, 0),   # a ragged last run
    ("rays", 24 * 833, 1),       # rows 4 bytes off a 16-byte boundary
    ("random", 1, 0),
    ("random", 0, 0),
])
def test_hash_scatter_levels_kernel_matches_plain(cuda_device, points, N,
                                                  offset):
    # 8 levels over 2^14 entries: dense and hashed; the sums of the
    # kernel (runs first, then atomic order) against index_add_'s
    L, T = 8, 1 << 14
    res = _level_resolutions(L, 16, 1.4472692012786865)
    rng = np.random.RandomState(18)
    x = (_ray_points(N // 24 + 1, 24, 19)[:N] if points == "rays"
         else rng.rand(N, 3).astype(np.float32))
    idx, w = hash_grid_indices(
        torch.as_tensor(x, device=cuda_device),
        torch.as_tensor(res, device=cuda_device),
        torch.as_tensor((res + 1) ** 3 <= T, device=cuda_device), T)
    g = torch.as_tensor(rng.randn(N, 2 * L).astype(np.float32),
                        device=cuda_device)
    g[5::29] = 0.0         # samples the kernel skips
    idx[::17, 8:16] = -1   # padding: skipped
    idx[3::17, 16:24] -= T  # level 2's corners pointing into level 1
    if offset:
        # the same rows through views that start off a 16-byte boundary
        def shifted(t):
            store = torch.empty(t.numel() + offset, dtype=t.dtype,
                                device=cuda_device)
            view = store[offset:].view(t.shape)
            view.copy_(t)
            assert view.data_ptr() % 16 == 4 * offset
            return view
        idx, w = shifted(idx), shifted(w)
    before = hash_grad_scatter_levels.launches
    d_table = torch.zeros((L + 1, T, 2), device=cuda_device)
    out = hash_grad_scatter_levels(idx, w, g, d_table[:L])
    torch.cuda.synchronize()
    assert hash_grad_scatter_levels.launches == before + 1
    assert out.data_ptr() == d_table.data_ptr()
    assert not bool(d_table[L].any())  # nothing past the last level
    want = hash_grad_scatter_levels_plain(idx, w, g,
                                          torch.zeros_like(d_table[:L]))
    if N == 0:
        assert not bool(out.any())
        return
    want64 = hash_grad_scatter_levels_plain(
        idx, w.double(), g.double(),
        torch.zeros((L, T, 2), dtype=torch.float64, device=cuda_device))
    scale = float(want64.abs().max())
    assert float((out - want).abs().max()) <= GRAD_REL * scale
    assert float((out.double() - want64).abs().max()) <= GRAD_REL * scale
    with pytest.raises(TypeError):
        hash_grad_scatter_levels(idx.long(), w, g, d_table[:L])
    with pytest.raises(ValueError):
        hash_grad_scatter_levels(  # not contiguous
            idx, w, g, d_table[:, :, :1].expand(L + 1, T, 2)[:L])
    with pytest.raises(ValueError):
        hash_grad_scatter_levels(idx, w, g[:, :-1], d_table[:L])


@pytest.mark.cuda
@pytest.mark.parametrize("N", [0, 1, 3, 4, 262144 + 37, 1000003])
def test_table_gather_kernel_matches_plain(cuda_device, N):
    rng = np.random.RandomState(14)
    T = 1 << 19
    table = torch.as_tensor(rng.randint(0, 2 ** 31, T).astype(np.int32),
                            device=cuda_device)
    # four spare words: views that start 4, 8 and 12 bytes off a 16-byte
    # boundary, each N long (the size of the output)
    store = torch.as_tensor(rng.randint(0, T, N + 4).astype(np.int32),
                            device=cuda_device)
    before = table_gather.launches
    for offset in range(4):
        idx = store[offset:offset + N]
        assert idx.is_contiguous()
        assert N == 0 or idx.data_ptr() % 16 == 4 * offset
        got = table_gather(idx, table)
        torch.cuda.synchronize()
        assert got.shape == (N,) and got.dtype == torch.int32
        assert torch.equal(got, table_gather_plain(idx, table))
    assert table_gather.launches == before + 4
    # indices outside the table are clamped into it, on both kernels
    wild = store.clone()
    wild[::3] = -7
    wild[1::5] = T + 11
    for offset in (0, 1):
        idx = wild[offset:offset + N]
        want = table_gather_plain(idx.clamp(0, T - 1), table)
        assert torch.equal(table_gather(idx, table), want)
    with pytest.raises(TypeError):
        table_gather(store[:N], table.float())
    with pytest.raises(ValueError):
        table_gather(store[:N].reshape(1, -1), table)
    with pytest.raises(ValueError):
        table_gather(store[::2], table)  # not contiguous


def _encode_case(L, log2_T, N, seed, device):
    """Points (random, with 0, 1, faces and points outside [0, 1]^3) and
    the level arguments of an encoder of L levels over 2^log2_T entries."""
    T = 1 << log2_T
    res = _level_resolutions(L, 16, 1.4472692012786865)
    rng = np.random.RandomState(seed)
    x = rng.rand(N, 3).astype(np.float32)
    if N >= 16:
        x[0], x[1], x[2] = 0.0, 1.0, (0.0, 1.0, 0.5)
        x[3] = np.nextafter(np.float32(1.0), np.float32(0.0))
        x[4:8] = rng.uniform(-0.5, 1.5, (4, 3))
        x[8:12] = rng.uniform(-3.0, 4.0, (4, 3))
        x[12:16, 0] = np.float32(7.0) / np.float32(res[1])  # on a face
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(res, device=device),
            torch.as_tensor((res + 1) ** 3 <= T, device=device), T)


def _corner_order_sum(table, idx, w, packed):
    """The fused forward's blend written out: acc = acc + w_j * f_j for
    corners j = 0..7 from 0, on the table rounded to bf16 where
    ``packed``."""
    L, T, F = table.shape
    N = idx.shape[0]
    tf = table.detach().float()
    if packed:
        tf = tf.to(torch.bfloat16).float()
    rows = tf.reshape(L * T, F)[idx.long()].reshape(N, L, 8, F)
    wv = w.reshape(N, L, 8)
    acc = torch.zeros((N, L, F), device=table.device)
    for j in range(8):
        acc = acc + wv[:, :, j, None] * rows[:, :, j]
    return acc.permute(0, 2, 1).reshape(N, F * L)


@pytest.mark.cuda
@pytest.mark.parametrize("F,packed,L,log2_T,N", [
    (2, True, 8, 14, 20003),    # dense and hashed levels, N * L ragged
    (2, False, 8, 14, 20003),
    (1, False, 8, 14, 4097),
    (4, True, 8, 14, 4097),
    (8, False, 8, 14, 4097),
    (2, True, 16, 19, 131075),  # the NGP field's table
    (2, True, 16, 19, 1),
    (2, True, 16, 19, 0),
])
def test_hash_encode_kernel_matches_its_twins(cuda_device, F, packed, L,
                                              log2_T, N):
    x, res, dense, T = _encode_case(L, log2_T, N, 21, cuda_device)
    rng = np.random.RandomState(22)
    table = torch.as_tensor(rng.randn(L, T, F).astype(np.float32),
                            device=cuda_device).requires_grad_()
    want_idx, want_w = hash_grid_indices(x, res, dense, T)
    before = hash_encode.launches
    # the table takes a gradient: the kernel writes the backward's inputs
    out = hash_encode(x, table, res, dense, T, packed_gather=packed)
    torch.cuda.synchronize()
    assert hash_encode.launches == before + 1
    assert out.shape == (N, F * L) and out.grad_fn is not None
    idx, w = out.grad_fn.saved_tensors
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    assert torch.equal(idx, want_idx) and torch.equal(w, want_w)
    assert torch.equal(out.detach(),
                       _corner_order_sum(table, want_idx, want_w, packed))
    lookup = hash_encode_lookup(table, want_idx, want_w, T,
                                packed_gather=packed).detach()
    if N:
        ulp = float(np.spacing(np.float32(lookup.abs().max().item())))
        assert float((out.detach() - lookup).abs().max()) <= 8 * ulp
    # no gradient: only the features are written and nothing is saved. The
    # path with a gradient allocates the features and two (N, 8 L) arrays;
    # this one less than the features and one of them (a block the
    # allocator does not split may hold up to 1 MB more than asked)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        bare = hash_encode(x, table, res, dense, T, packed_gather=packed)
    torch.cuda.synchronize()
    assert hash_encode.launches == before + 2 and bare.grad_fn is None
    assert torch.cuda.max_memory_allocated() - base <= 4 * N * L * (F + 8)
    assert torch.equal(bare, out.detach())
    frozen = table.detach()
    assert hash_encode(x, frozen, res, dense, T,
                       packed_gather=packed).grad_fn is None
    torch.cuda.synchronize()
    assert hash_encode.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("pallas_scatter", [True, False])
def test_hash_encode_table_gradient_equals_the_plain_path(cuda_device,
                                                          pallas_scatter):
    # through K7 and through index_add_, on the indices the kernel wrote
    x, res, dense, T = _encode_case(16, 19, 65539, 23, cuda_device)
    L = res.shape[0]
    rng = np.random.RandomState(24)
    start = torch.as_tensor(rng.randn(L, T, 2).astype(np.float32) * 1e-2,
                            device=cuda_device)
    g = torch.as_tensor(rng.randn(x.shape[0], 2 * L).astype(np.float32),
                        device=cuda_device)
    grads = []
    for fn in (hash_encode, hash_encode_plain):
        table = start.clone().requires_grad_()
        (fn(x, table, res, dense, T, pallas_scatter) * g).sum().backward()
        torch.cuda.synchronize()
        grads.append(table.grad)
    scale = float(grads[1].abs().max())
    assert scale > 0.1
    assert float((grads[0] - grads[1]).abs().max()) <= GRAD_REL * scale


@pytest.mark.cuda
def test_hash_encoder_chooses_the_kernel_by_its_table(cuda_device):
    # F in (1, 2, 4, 8): one launch of the fused forward; any other F the
    # plain path, which reads f32
    x = torch.rand(1000, 3, device=cuda_device)
    args = {}
    for F, launches in ((2, 1), (4, 1), (3, 0)):
        enc = HashEncoder(n_levels=4, n_features=F, log2_hashmap_size=12,
                          generator=torch.Generator().manual_seed(F),
                          device=cuda_device)
        args[F] = (x, enc.table, enc._res, enc._dense, enc.n_entries, False,
                   F in (2, 4))
        before = hash_encode.launches
        out = enc(x)
        torch.cuda.synchronize()
        assert hash_encode.launches == before + launches
        want = hash_encode_plain(*args[F])
        ulp = float(np.spacing(np.float32(want.abs().max().item())))
        assert float((out - want).abs().max()) <= 8 * ulp
    with pytest.raises(ValueError, match="features"):
        hash_encode(*args[3])  # F = 3 on the card
    with pytest.raises(ValueError, match="contiguous"):
        hash_encode(x.t().contiguous().t(), *args[2][1:])
    with pytest.raises(TypeError):
        hash_encode(x, args[2][1].double(), *args[2][2:])


@pytest.mark.cuda
def test_launch_on_a_device_that_is_not_current(cuda_device):
    # the launch helper enters the device guard only when it has to: with
    # two cards, tensors of cuda:0 while cuda:1 is current; with one, the
    # guard's own path, with an index that is not the current one's
    rng = np.random.RandomState(15)
    table = torch.as_tensor(rng.randint(0, 2 ** 31, 4096).astype(np.int32),
                            device=cuda_device)
    idx = torch.as_tensor(rng.randint(0, 4096, 1001).astype(np.int32),
                          device=cuda_device)
    want = table_gather_plain(idx, table)
    masks, ts, te, dt = _reselect_args(64, 16, seed=16, device=cuda_device)
    want_quad = fused_reselect_plain(masks, ts, te, dt, k2=8)
    if torch.cuda.device_count() > 1:
        with torch.cuda.device(1):
            assert torch.cuda.current_device() == 1
            got = table_gather(idx, table)
            got_quad = fused_reselect(masks, ts, te, dt, k2=8)
            assert torch.cuda.current_device() == 1
    else:
        entered = []
        real_guard = torch.cuda.device

        class Guard(real_guard):
            def __enter__(self):
                entered.append(self.idx)
                return super().__enter__()

        # same device: no guard; a current device reported as another: guard
        torch.cuda.device = Guard
        try:
            got = table_gather(idx, table)
            assert entered == []
            real_current = torch.cuda.current_device
            torch.cuda.current_device = lambda: 1
            try:
                got_quad = fused_reselect(masks, ts, te, dt, k2=8)
            finally:
                torch.cuda.current_device = real_current
            assert entered == [0]
        finally:
            torch.cuda.device = real_guard
    torch.cuda.synchronize()
    assert got.device == cuda_device and torch.equal(got, want)
    _assert_quads(got_quad, want_quad)
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_ngp_train_step_on_card_matches_cpu(cuda_device):
    # one small hash-NGP step, table gradient through K7 on the card and
    # through its twin on the CPU, from the same weights and rays. f32
    # heads: loss within 1e-5, each gradient within 1e-3 in L2 (sums in
    # another order; a visibility flip moves more and would show)
    results = []
    for device in (cuda_device, torch.device("cpu")):
        _, grid, (o, d, px), kw = _small_train_scene(device)
        field = NGPRadianceField(
            aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), n_levels=4,
            log2_hashmap_size=13, pallas_grad=True,
            generator=torch.Generator().manual_seed(2), device=device)
        with torch.no_grad():  # a table of order 1: the encoder matters
            field.encoder.table.mul_(1e4)
        opt = torch.optim.Adam(field.parameters(), lr=5e-4)
        k7 = hash_grad_scatter_levels.launches
        loss, n = train_step(field, opt, grid, o, d, px,
                             field_samples_budget=64 * 12, **kw)
        grads = {k: p.grad.detach().cpu() for k, p in field.named_parameters()}
        results.append((float(loss), int(n), grads,
                        hash_grad_scatter_levels.launches - k7))
    (loss_c, n_c, g_c, l_c), (loss_h, n_h, g_h, l_h) = results
    assert (l_c, l_h) == (1, 0)  # one launch for all levels
    assert abs(loss_c - loss_h) <= 1e-5 * loss_h
    assert abs(n_c - n_h) <= 2 and n_h > 200
    for k, want in g_h.items():
        err = float(torch.linalg.norm(g_c[k] - want))
        assert err <= 1e-3 * float(torch.linalg.norm(want)), k


@pytest.mark.cuda
@pytest.mark.parametrize("cone", [0.0, 0.004])
def test_select_kernel_matches_plain(cuda_device, cone):
    # 1001 rays: a ragged last block
    args = _select_args(1001, 32, 16, 64, seed=9, device=cuda_device)
    kw = dict(k_slots=64, step_size=5e-3, cone_angle=cone)
    _assert_quads(fused_select_grouped(*args, **kw),
                  fused_select_grouped_plain(*args, **kw))


@pytest.mark.cuda
def test_reselect_kernel_matches_plain(cuda_device):
    args = _reselect_args(1001, 64, seed=10, device=cuda_device)
    _assert_quads(fused_reselect(*args, k2=32),
                  fused_reselect_plain(*args, k2=32))


def _off_boundary(t):
    """A copy of ``t`` whose storage starts 4 bytes off a 16-byte
    boundary (element size 4) or 1 byte off it (bool)."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = store[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1001, 12289])
@pytest.mark.parametrize("G,K", [
    (16, 8), (16, 80), (32, 24), (32, 48), (32, 64), (64, 48), (64, 64),
    (33, 5), (1100, 300),  # ragged rows; more groups than a chunk holds
])
def test_select_kernel_shapes(cuda_device, R, G, K):
    live, gsize, t_min = _select_args(R, G, 16, K, seed=13,
                                      device=cuda_device)
    live[0] = 0  # an all-dead ray
    live[1], gsize[1] = 16, 16  # every group full: count > K, decimated
    live[2], gsize[2] = 0, 16  # count == K exactly, in the last groups
    full, rest = divmod(K, 16)
    live[2, G - full:] = 16
    if rest:
        live[2, G - full - 1] = rest
    assert int(live[2].sum()) == K
    cone = 0.004 if G == 32 else 0.0
    kw = dict(k_slots=K, step_size=5e-3, cone_angle=cone)
    want = fused_select_grouped_plain(live, gsize, t_min, **kw)
    _assert_quads(fused_select_grouped(live, gsize, t_min, **kw), want)
    # the same rows through views off a 16-byte boundary
    got = fused_select_grouped(_off_boundary(live)[1:],
                               _off_boundary(gsize)[1:],
                               _off_boundary(t_min)[1:], **kw)
    _assert_quads(got, tuple(w[1:] for w in want))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1001, 12289])
@pytest.mark.parametrize("K,K2", [
    (8, 8), (24, 8), (48, 24), (64, 24), (64, 32), (80, 32), (45, 45),
    (33, 7), (300, 200),  # more output slots than a tile holds
])
def test_reselect_kernel_shapes(cuda_device, R, K, K2):
    masks, ts, te, dt = _reselect_args(R, K, seed=14, device=cuda_device)
    masks[0] = False  # an all-dead ray
    masks[1] = True  # an all-live ray
    masks[2] = False  # count == K2 * stride exactly
    masks[2, :(2 * K2 if 2 * K2 <= K else K2)] = True
    masks[3] = False  # the last source slot only
    masks[3, K - 1] = True
    want = fused_reselect_plain(masks, ts, te, dt, k2=K2)
    got = fused_reselect(masks, ts, te, dt, k2=K2)
    _assert_quads(got, want)
    # the gathered t are copies: bit-equal
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    off = fused_reselect(*(_off_boundary(a)[1:] for a in (masks, ts, te, dt)),
                         k2=K2)
    _assert_quads(off, tuple(w[1:] for w in want))
    assert torch.equal(off[0], want[0][1:])


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    masks, ts, te, dt = _reselect_args(64, 16, seed=11, device=cuda_device)
    with pytest.raises(TypeError):
        fused_reselect(masks.to(torch.int32), ts, te, dt, k2=8)
    with pytest.raises(ValueError):
        fused_reselect(masks, ts.t().contiguous().t(), te, dt, k2=8)
    with pytest.raises(ValueError):
        fused_reselect(masks, ts.cpu(), te, dt, k2=8)
    live, gsize, t_min = _select_args(64, 8, 8, 8, seed=12,
                                      device=cuda_device)
    with pytest.raises(ValueError):
        fused_select_grouped(live, gsize[:, 0], t_min, k_slots=8,
                             step_size=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16384, 65536])
def test_hash_scatter_levels_at_the_ngp_drive_shapes(cuda_device, N):
    # the NGP drive's table gradient: 16 levels x 2^19 entries, the field
    # pass's 16,384 compacted samples (4,096 rays x 4 visible slots) and
    # the field budget's 65,536, on points laid along rays
    L, T = 16, 1 << 19
    res = _level_resolutions(L, 16, 1.4472692012786865)
    rng = np.random.RandomState(21)
    x = _ray_points(N // 16, 16, 22)
    idx, w = hash_grid_indices(
        torch.as_tensor(x, device=cuda_device),
        torch.as_tensor(res, device=cuda_device),
        torch.as_tensor((res + 1) ** 3 <= T, device=cuda_device), T)
    g = torch.as_tensor(rng.randn(N, 2 * L).astype(np.float32),
                        device=cuda_device)
    before = hash_grad_scatter_levels.launches
    got = hash_grad_scatter_levels(idx, w, g,
                                   torch.zeros((L, T, 2), device=cuda_device))
    want = hash_grad_scatter_levels_plain(
        idx, w, g, torch.zeros((L, T, 2), device=cuda_device))
    torch.cuda.synchronize()
    assert hash_grad_scatter_levels.launches == before + 1
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= GRAD_REL * scale


def _mlp_fields(device):
    vanilla = VanillaNeRFRadianceField(
        generator=torch.Generator().manual_seed(7), device=device)
    dnerf = DNeRFRadianceField(generator=torch.Generator().manual_seed(8),
                               device=device)
    return vanilla, dnerf


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vanilla", "dnerf"])
def test_mlp_fields_on_card_match_cpu(cuda_device, name):
    # the same weights (one seed) on the card in cuBLAS f32 (TF32 off) and
    # on the CPU: f32 sums in another order through 8 layers of 256 (one
    # value in 4,096 moved by 1.5e-6 in the first run): outputs within
    # rtol 1e-5 / atol 1e-5. A trunk relu whose input sits within that
    # rounding of 0 can flip and move its sample's share of a gradient
    # (the D-NeRF trunk's first layer read 2.7e-4 in L2): gradients within
    # 1e-3 in L2, the bound of the NGP step's card-vs-CPU test. The D-NeRF
    # warp's output layer is zeroed, so the warped points are the inputs
    # on both devices: its last bit would otherwise reach the degree-9
    # encoding x 512 (tests/test_torch_mlp.py)
    rng = np.random.RandomState(23)
    x = (rng.rand(4096, 3) * 3.0 - 1.5).astype(np.float32)
    d = rng.randn(4096, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.rand(4096, 1).astype(np.float32)
    w = rng.randn(4096, 3).astype(np.float32)
    results = []
    for device in (cuda_device, torch.device("cpu")):
        vanilla, dnerf = _mlp_fields(device)
        xt, dt, tt, wt = (torch.as_tensor(a, device=device)
                          for a in (x, d, t, w))
        if name == "vanilla":
            field, outs = vanilla, list(vanilla(xt, dt))
        else:
            field = dnerf
            with torch.no_grad():
                dnerf.warp.layers[-1].weight.zero_()
                dnerf.warp.layers[-1].bias.zero_()
            outs = [*dnerf(xt, tt, dt), dnerf.warp_displacement(xt, tt)]
        sum(torch.sum(o * wt[:, :o.shape[1]]) for o in outs).backward()
        grads = {n: p.grad.cpu() for n, p in field.named_parameters()}
        results.append(([o.detach().cpu() for o in outs], grads))
    (outs_c, g_c), (outs_h, g_h) = results
    for a, b in zip(outs_c, outs_h):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for k, want in g_h.items():
        err = float(torch.linalg.norm(g_c[k] - want))
        assert err <= 1e-3 * float(torch.linalg.norm(want)), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "ray compaction"])
def test_render_with_timestamps_on_card_matches_cpu(cuda_device, mode):
    # the D-NeRF field through render_rays with per-ray times: the card
    # (the fused march where the stride takes it) against the CPU's plain
    # twins on the same weights: masks bit-equal, colours within 1e-5
    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    rng = np.random.RandomState(24)
    binary = np.zeros((32, 32, 32), bool)
    binary[4:28, 4:28, 4:28] = rng.rand(24, 24, 24) < 0.6
    o = rng.randn(256, 3)
    o = 2.8 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(256, 3) * 0.8
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.rand(256, 1)
    kw = dict(scene_aabb=aabb, render_step_size=1e-2,
              max_samples_per_ray=512, samples_budget=256 * 24,
              return_extras=True, use_pallas=True)
    if mode == "ray compaction":
        kw.update(coarse_stride=8, probe_dilation=1, probe_groups=16,
                  compact_rays_fraction=0.75)
    results = []
    for device in (cuda_device, torch.device("cpu")):
        _, dnerf = _mlp_fields(device)
        rays = [torch.as_tensor(a.astype(np.float32), device=device)
                for a in (o, d, t)]
        with torch.no_grad():
            c, op, dep, n, ex = render_rays(
                dnerf, rays[0], rays[1], timestamps=rays[2],
                grid=grid_from_arrays(aabb, binary, device=device),
                render_bkgd=torch.ones(3, device=device), **kw)
        results.append([v.cpu() for v in (c, op, dep, ex["masks"])])
    (c1, o1, d1, m1), (c2, o2, d2, m2) = results
    assert torch.equal(m1, m2) and int(m1.sum()) > 500
    for a, b in ((c1, c2), (o1, o2), (d1, d2)):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5)


@pytest.mark.cuda
def test_select_kernel_at_the_unbounded_recipe(cuda_device):
    # K5 at the grid-unbounded recipe's train step: 4,096 rays x 146 groups
    # of 16 x 128 slots, cone 0.004 from a jittered near plane 0.2 at step
    # 1e-2, so that the selected slots reach t ~ 1e4
    R, G, C, K = 4096, 146, 16, 128
    live, gsize, t_min = _select_args(R, G, C, K, seed=15, device=cuda_device)
    gsize[::2] = C  # most rays fill every group of the 2,336-point lattice
    live = torch.minimum(live, gsize)
    t_min = 0.2 + 1e-2 * torch.rand(R, generator=torch.Generator().manual_seed(
        16)).to(cuda_device)
    kw = dict(k_slots=K, step_size=1e-2, cone_angle=0.004)
    got = fused_select_grouped(live, gsize, t_min, **kw)
    want = fused_select_grouped_plain(live, gsize, t_min, **kw)
    _assert_quads(got, want)
    assert float(got[1][got[3]].max()) > 5e3


@pytest.mark.cuda
def test_reselect_kernel_at_the_unbounded_recipe(cuda_device):
    # K6 at the recipe's 128 -> 64 (the register path's longest row), on
    # the train step's 4,096 rays and an evaluation chunk's 2,048, with t
    # out to 1e4
    for R in (4096, 2048):
        masks, ts, te, dt = _reselect_args(R, 128, seed=17,
                                           device=cuda_device)
        ts, te = ts * 1e4, ts * 1e4 + dt
        want = fused_reselect_plain(masks, ts, te, dt, k2=64)
        got = fused_reselect(masks, ts, te, dt, k2=64)
        _assert_quads(got, want)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("G,B", [(64, 262144), (192, 393216)])
def test_cp_kernels_at_the_proposal_levels(cuda_device, G, B):
    # K1 / K2 / K4 at the proposal field's one level of 32 features: the
    # proposal drives' (64, 32) over 4,096 x 64 coarse samples and the 360
    # drive's (192, 32) over 4,096 x 96; the repo's bounds (features 1e-6
    # absolute, gradients 1e-5 of the largest), inside the JAX package's
    # (1e-3 forward, 5e-2 gradients)
    rng = np.random.RandomState(18)
    xu = _ray_ordered_xu(B, rng, step=1.0 / 64, per_ray=B // 4096)
    tables = [(rng.randn(G, 32) * 0.2).astype(np.float32) for _ in range(3)]
    g = rng.randn(B, 32).astype(np.float32)
    xu, t0, t1, t2, g = (torch.as_tensor(a, device=cuda_device)
                         for a in (xu, *tables, g))
    feats, us = cp_level_features_res_fwd(xu, t0, t1, t2)
    want_feats, want_us = cp_level_features_res_plain(xu, t0, t1, t2)
    torch.testing.assert_close(feats, want_feats, rtol=0.0, atol=1e-6)
    assert torch.equal(feats, cp_level_features(xu, t0, t1, t2))
    for u, want in zip(us, want_us):
        assert torch.equal(u, want)
    _assert_grads_close(cp_level_grads_res(xu, g, *us, G),
                        cp_level_grads_res_plain(xu, g, *us, G))


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("unbounded", [False, True])
def test_proposal_step_on_card_matches_cpu(cuda_device, unbounded, fixed):
    # one proposal-trainer step (both fields through K2 / K4 on the card,
    # the plain twins on the CPU) from the same weights, rays, pixels and
    # jitter. The heads round f32 sums to bf16, which may move a value one
    # bf16 step: loss within 1e-4. A moved proposal density moves the
    # resampled intervals, and with them the main field's hat taps: each
    # gradient within the JAX package's bound for the bf16 CP level, 5e-2
    # in L2 (measured up to 1.7e-2 on the main field's tables, 1e-3 or
    # less elsewhere). ``fixed``: the card's step renders the main field
    # on the CPU step's resampled intervals, so both fields see the same
    # points on both devices: each gradient within 1e-2 in L2 (measured
    # up to 5.6e-5 bounded, 5.8e-4 unbounded)
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "train_proposal_nerf_torch", Path(__file__).resolve().parents[1]
        / "examples" / "train_proposal_nerf_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    flags = ["--num_rays", "256", "--image_size", "16", "--train_views", "4",
             "--n_coarse", "32", "--n_fine", "16", "--prop_grid", "16",
             "--use_kernel"]
    if unbounded:
        flags += ["--scene", "procedural360", "--unbounded"]
    rng = np.random.RandomState(19)
    u = torch.as_tensor(rng.rand(256).astype(np.float32))
    px = torch.as_tensor(rng.rand(256, 3).astype(np.float32))
    sampling = module.proposal_sampling_with_filter
    cpu_segs = []

    def keep_or_give_segments(*args, **kw):
        segs, rounds = sampling(*args, **kw)
        if not cpu_segs:  # the CPU step: keep its intervals
            cpu_segs.append(segs)
            return segs, rounds
        dev = segs.t_starts.device
        return type(segs)(*(a.to(dev) for a in cpu_segs[0])), rounds

    results, rays = [], None
    for device in (torch.device("cpu"), cuda_device):
        t = module.Trainer(module.parse_args(flags + ["--device",
                                                      device.type]))
        if rays is None:  # the CPU scene's rays for both
            rays, _ = t.scene.sample_batch(256)
        before = (cp_level_features_res.launches,
                  cp_level_grads_res.launches)
        if fixed:
            module.proposal_sampling_with_filter = keep_or_give_segments
        try:
            colors, _, dist, colors_prop, live = t.forward(
                rays.origins.to(device), rays.viewdirs.to(device),
                u.to(device))
        finally:
            module.proposal_sampling_with_filter = sampling
        loss = t.loss(colors, colors_prop, dist, px.to(device))
        loss.backward()
        launched = (cp_level_features_res.launches - before[0],
                    cp_level_grads_res.launches - before[1])
        grads = {f"{name}.{k}": p.grad.detach().cpu()
                 for name, m in (("field", t.field), ("proposal", t.proposal))
                 for k, p in m.named_parameters()}
        results.append((float(loss.detach()), int(live), grads, launched))
    (loss_h, n_h, g_h, l_h), (loss_c, n_c, g_c, l_c) = results
    # the main field's two levels and the proposal's one (density, then
    # colour): four K2 and four K4 launches on the card, none on the CPU
    assert l_c == (4, 4) and l_h == (0, 0)
    assert abs(loss_c - loss_h) <= 1e-4 * loss_h and n_c == n_h > 0
    errs = {k: float(torch.linalg.norm(g_c[k] - want)
                     / torch.linalg.norm(want)) for k, want in g_h.items()}
    print(f"proposal step card vs CPU (unbounded {unbounded}, fixed "
          f"{fixed}): largest gradient L2 error {max(errs.values()):.3e}")
    assert max(errs.values()) <= (1e-2 if fixed else 5e-2), errs


# The flat packed API on the card against the same calls on the CPU. The
# scans are the same elementwise adds and products in the same order on
# both devices: within 1e-6 relative. Segment sums add in atomic order on
# the card and exp rounds in its own way there: the renders within rtol
# 1e-5 / atol 1e-6. Integer outputs bit-equal.
FLAT_R, FLAT_K = 16384, 64


def _flat_inputs(device, ragged):
    rng = np.random.RandomState(11)
    t = np.sort(rng.rand(FLAT_R, FLAT_K + 1).astype(np.float32), axis=1)
    sig = (rng.rand(FLAT_R, FLAT_K) * 20.0).astype(np.float32)
    rgb = rng.rand(FLAT_R * FLAT_K, 3).astype(np.float32)
    mask = rng.rand(FLAT_R, FLAT_K) < (0.5 if ragged else 1.1)
    ri = np.repeat(np.arange(FLAT_R, dtype=np.int32), FLAT_K)
    arrs = dict(ts=t[:, :-1].reshape(-1, 1), te=t[:, 1:].reshape(-1, 1),
                sig=sig.reshape(-1, 1), rgb=rgb, ri=ri,
                mask=mask.reshape(-1))
    return {k: torch.as_tensor(v, device=device) for k, v in arrs.items()}


def _flat_render(x, n_rays, segmented):
    import nerfacc_tpu_torch.vol_rendering as pvr
    from nerfacc_tpu_torch import rendering

    pvr.DENSE_BRIDGE = not segmented
    try:
        sig = x["sig"].clone().requires_grad_()
        out = rendering(x["ts"], x["te"], x["ri"], n_rays,
                        rgb_sigma_fn=lambda a, b, r: (x["rgb"], sig),
                        render_bkgd=torch.ones(3, device=sig.device),
                        masks=x["mask"])
        out[0].sum().backward()
    finally:
        pvr.DENSE_BRIDGE = True
    return [o.detach().cpu() for o in out] + [sig.grad.cpu()]


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True])
def test_flat_scans_and_rendering_on_card_match_cpu(cuda_device, segmented):
    from nerfacc_tpu_torch import scan

    cpu = torch.device("cpu")
    xc, xh = _flat_inputs(cuda_device, True), _flat_inputs(cpu, True)
    for name in ("exclusive_segment_cumsum", "reverse_exclusive_segment_cumsum",
                 "exclusive_segment_cumprod"):
        fn = getattr(scan, name)
        v = 1.0 - xc["sig"][:, 0] * 0.01
        got = fn(v, xc["ri"], FLAT_R).cpu()
        want = fn(v.cpu(), xh["ri"], FLAT_R)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    got = scan.segment_sum(xc["rgb"], xc["ri"], FLAT_R).cpu()
    torch.testing.assert_close(
        got, scan.segment_sum(xh["rgb"], xh["ri"], FLAT_R),
        rtol=1e-5, atol=1e-6)
    for a, b in zip(_flat_render(xc, FLAT_R, segmented),
                    _flat_render(xh, FLAT_R, segmented)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_pack_and_unpack_on_card_are_bit_equal_to_cpu(cuda_device):
    from nerfacc_tpu_torch import pack_data, pack_info, unpack_info

    cpu = torch.device("cpu")
    outs = []
    for device in (cuda_device, cpu):
        x = _flat_inputs(device, True)
        data = torch.cat([x["ts"], x["te"]], 1).reshape(FLAT_R, FLAT_K, 2)
        mask = x["mask"].reshape(FLAT_R, FLAT_K)
        packed, info, valid = pack_data(data, mask)
        ri = unpack_info(info, packed.shape[0])
        cut = pack_data(data, mask, FLAT_R * 20)  # past the capacity
        outs.append([t.cpu() for t in (packed, info, valid, ri,
                                       pack_info(ri, FLAT_R, valid), *cut)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ray_marching_kernels_on_the_trained_grid(cuda_device):
    # ray_marching(use_pallas=True) on the trained 128^3 grid (K5, then K6
    # after an analytic cull) against the unfused march: masks bit-equal
    from pathlib import Path

    from nerfacc_tpu_torch import ray_marching

    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    asset = np.load(Path(__file__).resolve().parents[1] / "bench_assets"
                    / "trained_grid.npz")
    grid = grid_from_arrays(aabb, asset["binary"], asset["occs"],
                            device=cuda_device)
    rng = np.random.RandomState(12)
    o = rng.randn(4096, 3)
    o = 3.2 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(4096, 3) * 0.5
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.as_tensor(a.astype(np.float32), device=cuda_device)
            for a in (o, d))

    def sigma_fn(ts, te, ri):
        x = o[ri.long()] + (ts + te) / 2.0 * d[ri.long()]
        return torch.where((x * x).sum(-1, keepdim=True) < 0.8, 30.0, 0.5)

    kw = dict(scene_aabb=aabb, grid=grid, sigma_fn=sigma_fn,
              render_step_size=5e-3, max_samples_per_ray=1024,
              samples_budget=4096 * 48, visible_samples_budget=4096 * 24,
              coarse_stride=16, probe_dilation=2, probe_groups=32)
    n5, n6 = fused_select_grouped.launches, fused_reselect.launches
    a = ray_marching(o, d, use_pallas=True, **kw)
    assert (fused_select_grouped.launches - n5,
            fused_reselect.launches - n6) == (1, 1)
    b = ray_marching(o, d, use_pallas=False, **kw)
    assert torch.equal(a.masks, b.masks) and int(a.masks.sum()) > 10000
    assert torch.equal(a.ray_indices, b.ray_indices)
    for x, y in ((a.t_starts, b.t_starts), (a.t_ends, b.t_ends)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def _trained_grid(device):
    from pathlib import Path

    asset = np.load(Path(__file__).resolve().parents[1] / "bench_assets"
                    / "trained_grid.npz")
    return grid_from_arrays((-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
                            asset["binary"], asset["occs"], device=device)


def _view_rays(R, seed, device):
    """Rays at the trained grid from a sphere of radius 3.2, then rays
    that miss the box and ``render_image``'s pad rays (the origin along
    (1, 1, 1) / sqrt(3)): (o, d, t_min, t_max)."""
    from nerfacc_tpu_torch import ray_aabb_intersect

    rng = np.random.RandomState(seed)
    o = rng.randn(R, 3)
    o = 3.2 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(R, 3) * 0.5
    d[:64] = o[:64]  # away from the box: t_min = t_max = 1e10
    o[64:96] = 0.0
    d[64:96] = 1.0
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.as_tensor(a.astype(np.float32), device=device)
            for a in (o, d))
    t_min, t_max = ray_aabb_intersect(o, d, (-1.5,) * 3 + (1.5,) * 3)
    assert bool((t_min[:64] == 1e10).all() & (t_max[:64] == 1e10).all())
    return o, d, t_min, t_max


def _march_both(o, d, t_min, t_max, grid, **kw):
    from nerfacc_tpu_torch.ray_marching import march_rays

    kw = dict(dict(render_step_size=5e-3, max_samples_per_ray=1024,
                   slots_per_ray=128), **kw)
    n = march_dense.launches
    got = march_rays(o, d, t_min, t_max, grid, use_pallas=True, **kw)
    assert march_dense.launches == n + 1
    want = march_rays(o, d, t_min, t_max, grid, use_pallas=None, **kw)
    assert march_dense.launches == n + 1
    for name in ("t_starts", "t_ends", "deltas", "masks"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("cone", [0.0, 0.004])
@pytest.mark.parametrize("R", [8192, 4097])
def test_march_dense_kernel_on_the_trained_grid(cuda_device, R, cone):
    # the view's shapes: S = 1,024 lattice points, K = 128 slots
    grid = _trained_grid(cuda_device)
    o, d, t_min, t_max = _view_rays(R, seed=21, device=cuda_device)
    want = _march_both(o, d, t_min, t_max, grid, cone_angle=cone)
    live = want.masks.sum(dim=1)
    # misses carry nothing; rows above K (decimated: a slot spans its
    # group) and rows below it are both present
    assert not bool(live[:64].any())
    decimated = (want.masks & (want.deltas > (want.t_ends - want.t_starts)
                               * 1.5)).any(dim=1)
    assert int(decimated.sum()) > 10
    assert int(((live > 0) & (live < 128)).sum()) > 10
    assert int(want.masks.sum()) > 100000


@pytest.mark.cuda
@pytest.mark.parametrize("S,K,cone", [
    (2048, 300, 0.0),  # rows longer than a warp holds, slots past a tile
    (2048, 64, 0.004),
    (1024, 1024, 0.0),  # every lattice point a slot
    (96, 32, 0.0),  # a lattice shorter than the t-range: clamped
])
def test_march_dense_kernel_shapes(cuda_device, S, K, cone):
    grid = _trained_grid(cuda_device)
    o, d, t_min, t_max = _view_rays(1001, seed=22, device=cuda_device)
    step = 2.5e-3 if S == 2048 else 5e-3
    _march_both(o, d, t_min, t_max, grid, render_step_size=step,
                max_samples_per_ray=S, slots_per_ray=K, cone_angle=cone)


@pytest.mark.cuda
def test_march_dense_counts_its_rays(cuda_device):
    from nerfacc_tpu_torch import tracing

    grid = _trained_grid(cuda_device)
    o, d, t_min, t_max = _view_rays(1000, seed=23, device=cuda_device)
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        march_dense(o, d, t_min, t_max, grid, k_slots=64, max_samples=1024,
                    step_size=5e-3)
    assert tracing.snapshot() == {"march_kernel_rays": 1000}
    tracing.reset()


@pytest.mark.cuda
def test_render_image_through_the_march_kernel_is_exact(cuda_device,
                                                        monkeypatch):
    # a 200 x 200 view at the view cell's settings through the kernel,
    # against the same view with the plain chain in the march and K6 in
    # the cull in both: the same slots, so the same colours
    from nerfacc_tpu_torch import graphs, render_image, utils

    grid = _trained_grid(cuda_device)
    field = NGPRadianceField(
        aabb=(-1.5,) * 3 + (1.5,) * 3, generator=torch.Generator()
        .manual_seed(5), device=cuda_device)
    # a denser field than the initial tables give, so the cull cuts
    table = field.encoder.table
    with torch.no_grad():
        table.copy_(torch.rand(table.shape, generator=torch.Generator()
                               .manual_seed(6)) * 4.0 - 2.0)
    o, d, _, _ = _view_rays(40000, seed=24, device=cuda_device)
    kw = dict(grid=grid, scene_aabb=(-1.5,) * 3 + (1.5,) * 3,
              render_step_size=5e-3, max_samples_per_ray=1024,
              coarse_stride=1, use_pallas=True, early_stop_eps=1e-4,
              test_chunk_size=8192, eval_samples_per_ray=128,
              visible_samples_budget=8192 * 64,
              render_bkgd=torch.ones(3, device=cuda_device))
    n5, n6 = march_dense.launches, fused_reselect.launches
    with torch.no_grad():
        got = render_image(field, o, d, **kw)
    assert (march_dense.launches - n5, fused_reselect.launches - n6) == (5, 5)
    plain = utils.march_rays

    def chain(*args, **k):
        return plain(*args, **dict(k, use_pallas=None))

    monkeypatch.setattr(utils, "march_rays", chain)
    graphs.forget(field)  # its graphs hold the kernel's march
    with torch.no_grad():
        want = render_image(field, o, d, **kw)
    assert march_dense.launches - n5 == 5
    assert fused_reselect.launches - n6 == 10
    for name, a, b in zip(("colors", "opacities", "depths"), got, want):
        assert torch.equal(a, b), name
    assert float(got[1].max()) > 0.01


@pytest.mark.cuda
def test_march_dense_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    import dataclasses

    grid = _trained_grid(cuda_device)
    o, d, t_min, t_max = _view_rays(256, seed=25, device=cuda_device)
    kw = dict(k_slots=32, max_samples=256, step_size=5e-3)
    with pytest.raises(ValueError):
        march_dense(o, d.cpu(), t_min, t_max, grid, **kw)
    with pytest.raises(ValueError):
        march_dense(o, d, t_min.cpu(), t_max, grid, **kw)
    with pytest.raises(TypeError):
        march_dense(o, d.double(), t_min, t_max, grid, **kw)
    with pytest.raises(ValueError):
        march_dense(o.t().contiguous().t(), d, t_min, t_max, grid, **kw)
    with pytest.raises(ValueError):
        march_dense(o, d, t_min[:128], t_max, grid, **kw)
    with pytest.raises(TypeError):
        march_dense(o, d, t_min, t_max, dataclasses.replace(
            grid, binary=grid.binary.to(torch.uint8)), **kw)
    with pytest.raises(ValueError):
        march_dense(o, d, t_min, t_max, dataclasses.replace(
            grid, contraction_type=grid.contraction_type.UN_BOUNDED_TANH),
            **kw)
    with pytest.raises(ValueError):
        march_dense(o, d, t_min, t_max, grid, k_slots=512, max_samples=256,
                    step_size=5e-3)


# The on-disk datasets: a fixture written on the card against the same
# call on the CPU (one 8-bit level, as the two packages' fixtures are
# held in tests/test_torch_datasets.py: the renders differ in f32 rounding
# only, and a straight colour only where its alpha is at least 8/255);
# the loaders' batches on the card against the CPU loaders' at one seed
# (the host draws and assembles them alike, so pixels and origins are
# bit-equal, and the native path's directions too; PyTorch's generate_rays
# on the card within 1e-6); the page-locked upload bit-equal to a plain
# .to(device) of the same batch.


def _same_fixture_images(a_dir, b_dir):
    from nerfacc_tpu_torch.datasets.image_io import imread

    names = sorted(p.relative_to(a_dir) for p in a_dir.rglob("*.png"))
    assert names and names == sorted(p.relative_to(b_dir)
                                     for p in b_dir.rglob("*.png"))
    for name in names:
        a = imread(a_dir / name).astype(np.int16)
        b = imread(b_dir / name).astype(np.int16)
        diff = np.abs(a - b)
        if a.shape[-1] == 4:
            assert diff[..., 3].max() <= 1, name
            assert diff[..., :3][b[..., 3] >= 8].max(initial=0) <= 1, name
        else:
            assert diff.max() <= 1, name


@pytest.mark.cuda
def test_fixtures_on_card_match_cpu(cuda_device, tmp_path):
    from nerfacc_tpu_torch.datasets import fixtures

    for dev in ("card", "cpu"):
        where = cuda_device if dev == "card" else torch.device("cpu")
        fixtures.write_blender_fixture(tmp_path / dev / "b", n_train=3,
                                       n_val=0, n_test=1, width=32,
                                       height=32, device=where)
        fixtures.write_blender_fixture(tmp_path / dev / "d", n_train=3,
                                       n_val=0, n_test=1, width=32,
                                       height=32, dynamic=True, device=where)
        fixtures.write_colmap_fixture(tmp_path / dev / "c", n_images=4,
                                      width=32, height=32, device=where)
    for kind in ("b", "d", "c"):
        _same_fixture_images(tmp_path / "card" / kind, tmp_path / "cpu" / kind)
    for name in ("cameras.bin", "images.bin"):
        assert ((tmp_path / "card/c/procedural360/sparse/0" / name)
                .read_bytes() == (tmp_path / "cpu/c/procedural360/sparse/0"
                                  / name).read_bytes())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_loader_batches_on_card_match_cpu(cuda_device, tmp_path,
                                          monkeypatch, path):
    from nerfacc_tpu_torch import data_io
    from nerfacc_tpu_torch.datasets import (
        dnerf_synthetic,
        fixtures,
        nerf_360_v2,
        nerf_synthetic,
    )

    if path == "native":
        assert data_io.lib() is not None, "the native assembler must build"
    else:
        monkeypatch.setattr(data_io, "lib", lambda: None)
    cpu = torch.device("cpu")
    fixtures.write_blender_fixture(tmp_path / "b", n_train=3, n_val=0,
                                   n_test=1, width=24, height=24,
                                   device=cuda_device)
    fixtures.write_blender_fixture(tmp_path / "d", n_train=3, n_val=0,
                                   n_test=1, width=24, height=24,
                                   dynamic=True, device=cuda_device)
    fixtures.write_colmap_fixture(tmp_path / "c", n_images=9, width=24,
                                  height=24, device=cuda_device)
    cases = (
        (nerf_synthetic.SubjectLoader, "b", "procedural",
         dict(color_bkgd_aug="random")),
        (dnerf_synthetic.SubjectLoader, "d", "procedural", {}),
        (nerf_360_v2.SubjectLoader, "c", "procedural360", dict(factor=1)),
    )
    for cls, sub, subject, kw in cases:
        card, host = (cls(subject, str(tmp_path / sub), seed=4, device=dev,
                          **kw) for dev in (cuda_device, cpu))
        for name in ("images", "test_images", "train_poses", "K"):
            assert torch.equal(getattr(card, name).cpu(),
                               getattr(host, name)), name
        for _ in range(3):
            (rays, px, *t), (hrays, hpx, *ht) = (
                card.sample_batch(4099), host.sample_batch(4099))
            assert rays.origins.device == px.device == card.device
            assert torch.equal(px.cpu(), hpx)
            assert torch.equal(rays.origins.cpu(), hrays.origins)
            native = path == "native" and sub == "b"
            torch.testing.assert_close(rays.viewdirs.cpu(), hrays.viewdirs,
                                       rtol=0.0, atol=0.0 if native else 1e-6)
            for a, b in zip(t, ht):
                assert torch.equal(a.cpu(), b)
            assert torch.equal(card.bkgd.cpu(), host.bkgd)


@pytest.mark.cuda
def test_pinned_upload_matches_a_plain_copy(cuda_device, tmp_path):
    from nerfacc_tpu_torch import data_io
    from nerfacc_tpu_torch.datasets import fixtures, nerf_synthetic

    assert data_io.lib() is not None, "the native assembler must build"
    fixtures.write_blender_fixture(tmp_path, n_train=4, n_val=0, n_test=1,
                                   width=32, height=32, device=cuda_device)
    loader = nerf_synthetic.SubjectLoader("procedural", str(tmp_path),
                                          color_bkgd_aug="random", seed=9,
                                          device=cuda_device)
    rng = np.random.RandomState(9)
    # five batches back to back, the page-locked buffers written while the
    # card may still be copying the last ones
    got = [loader.sample_batch(n) for n in (8192, 8192, 8192, 1000, 8192)]
    for (rays, px), n in zip(got, (8192, 8192, 8192, 1000, 8192)):
        bkgd = rng.rand(3).astype(np.float32)
        o, d, p = data_io.sample_ray_batch(
            loader._images_np, loader._poses_np, loader._intrin_np, bkgd,
            seed=int(rng.randint(0, 2**31)), num_rays=n)
        for a, b in ((rays.origins, o), (rays.viewdirs, d), (px, p)):
            assert torch.equal(a, torch.from_numpy(b).to(cuda_device))


def _dryrun_script():
    """``scripts/dryrun_multichip_torch.py`` (the data-parallel step)."""
    import sys
    from pathlib import Path

    scripts = str(Path(__file__).resolve().parent.parent / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import dryrun_multichip_torch

    return dryrun_multichip_torch


def _rel_l2(a, b) -> float:
    return float(torch.linalg.norm(a.double() - b.double())
                 / torch.linalg.norm(b.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tensocp", "ngp"])
def test_world_of_one_under_nccl_matches_the_single_process_step(
        cuda_device, tmp_path, model):
    # the data-parallel step (no grid update) in a world of one under
    # NCCL against training.train_step from the same weights and rays:
    # loss within rtol 1e-6, each gradient within relative L2 1e-5 (K4 and
    # K7 add in atomic order: two single-process runs differ alike)
    import torch.distributed as dist

    from nerfacc_tpu_torch.parallel import init_distributed, make_mesh

    dry = _dryrun_script()
    init_distributed(init_method=f"file://{tmp_path / 'store'}",
                     num_processes=1, process_id=0, timeout=120)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        assert mesh.groups["data"] is not None  # the collectives run
        runs = []
        for data_parallel in (True, False, False):
            _, grid, (o, d, px), kw = _small_train_scene(cuda_device)
            if model == "ngp":
                field = NGPRadianceField(
                    aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), n_levels=4,
                    log2_hashmap_size=13, pallas_grad=True,
                    generator=torch.Generator().manual_seed(2),
                    device=cuda_device)
                kw = dict(kw, field_samples_budget=64 * 12)
            else:
                field, *_ = _small_train_scene(cuda_device)
            opt = torch.optim.Adam(field.parameters(), lr=5e-4)
            if data_parallel:
                step = dry.dp_step(field, opt, mesh, kw, None,
                                   grid_update=False)
                _, loss, n = step(grid, o, d, px, 0)
            else:
                loss, n = train_step(field, opt, grid, o, d, px, **kw)
            runs.append((float(loss), int(n), {
                k: p.grad.detach().clone()
                for k, p in field.named_parameters()}))
    finally:
        dist.destroy_process_group()
    (loss_dp, n_dp, g_dp), (loss_1, n_1, g_1), (_, _, g_2) = runs
    assert abs(loss_dp - loss_1) <= 1e-6 * loss_1 and n_dp == n_1 > 200
    for k, want in g_1.items():
        spread = _rel_l2(g_2[k], want)
        assert _rel_l2(g_dp[k], want) <= 1e-5, (k, spread)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tensocp", "ngp"])
def test_dryrun_script_in_a_world_of_one(cuda_device, model):
    # the script end to end at full width: one spawned rank under NCCL,
    # a warm-up and five timed steps with the grid update, then its own
    # equality check against one process on the whole batch (the script
    # raises past its bounds)
    dry = _dryrun_script()
    (out,) = dry.main(["--world", "1", "--backend", "nccl", "--model",
                       model])
    assert out["world"] == 1 and out["backend"] == "nccl"
    assert len(out["step_ms"]) == dry.STEPS
    assert all(np.isfinite(out["losses"])) and min(out["live"]) > 0
    assert 0 < out["occupied"] < 1
    assert out["check"]["loss_rel"] <= dry.LOSS_RTOL
    assert out["check"]["grad_rel_l2"] <= dry.GRAD_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 10**9])
def test_update_grid_distributed_draws_on_the_grid_device(cuda_device, step):
    # an int key: a grid on the card draws its cells and jitter on the
    # card, from fold_in(key, rank) made there (warm-up: every cell with
    # its jitter; after it, the sampled cells); a world of one without a
    # process group, so the merge is the rank's own update, bit for bit
    from nerfacc_tpu_torch.grid import _draw_cells, _update_grid_at
    from nerfacc_tpu_torch.parallel import make_mesh, update_grid_distributed
    from nerfacc_tpu_torch.parallel.sharding import fold_in

    def ball(x):
        d = torch.linalg.norm(x - 0.5, dim=-1, keepdim=True)
        return torch.where(d < 0.3, 1.0, 0.0)

    grid = create_grid([0, 0, 0, 1, 1, 1], resolution=32, device=cuda_device)
    merged = update_grid_distributed(grid, 7, step, ball,
                                     mesh=make_mesh(device=cuda_device))
    key = fold_in(7, 0, device=cuda_device)
    assert key.device.type == "cuda"
    idx, jitter = _draw_cells(grid, key, warmup=step < 256)
    assert jitter.is_cuda
    want = _update_grid_at(grid, idx, jitter, ball, occ_thre=1e-2,
                           ema_decay=0.95, adaptive_thre=True)
    assert merged.occs.is_cuda and torch.equal(merged.occs, want.occs)
    assert torch.equal(merged.binary, want.binary)
    assert int(merged.binary.sum()) > 0


@pytest.mark.cuda
def test_quant_int8_on_card_matches_cpu(cuda_device):
    # the int8 forward is integer arithmetic with tensor divisors: the
    # card's result equals the CPU's bit for bit; the table gradient adds
    # exact bf16 products in atomic order on the card: within 1e-5 of its
    # largest entry
    from nerfacc_tpu_torch.models.tensorf import hat_matmul_int8

    rng = np.random.RandomState(12)
    G, R, B = 512, 128, 262144
    u = torch.as_tensor((rng.rand(B) * (G - 1)).astype(np.float32))
    table = torch.as_tensor((rng.randn(G, R) * 0.2).astype(np.float32))
    g = torch.as_tensor(rng.randn(B, R).astype(np.float32)).to(
        torch.bfloat16).float()
    out, grads = [], []
    for dev in (cuda_device, torch.device("cpu")):
        t = table.to(dev).requires_grad_(True)
        y = hat_matmul_int8(u.to(dev), t)
        y.backward(g.to(dev))
        out.append(y.detach().cpu())
        grads.append(t.grad.cpu())
    assert torch.equal(out[0], out[1])
    scale = float(grads[1].abs().max())
    assert float((grads[0] - grads[1]).abs().max()) <= GRAD_REL * scale
    # the flagship field's levels: bf16 features equal
    fields = [TensoCPRadianceField(
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), quant_int8=True,
        generator=torch.Generator().manual_seed(3), device=dev)
        for dev in (cuda_device, torch.device("cpu"))]
    xu = torch.as_tensor(rng.rand(65536, 3).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(fields[0].cp_levels, fields[1].cp_levels):
            fa, fb = a(xu.to(cuda_device)).cpu(), b(xu)
            assert fa.dtype == torch.bfloat16 and torch.equal(fa, fb)


@pytest.mark.cuda
@pytest.mark.parametrize("pallas_grad", [False, True])
def test_per_level_gather_equals_packed_on_card(cuda_device, pallas_grad,
                                                monkeypatch):
    # the reference NGP encoder (16 levels x 2^19 entries): the forward is
    # bit-equal; the backward gets bit-equal inputs (the same function of
    # them: K7 or index_add_, whose atomics add in run order), and its
    # results agree within 1e-5 of the largest entry
    from nerfacc_tpu_torch.models import HashEncoder
    from nerfacc_tpu_torch.ops import hash_gather as hg

    seen = []
    name = "hash_grad_scatter_levels" if pallas_grad else "_index_add_levels"
    real = getattr(hg, name)

    def record(*args):
        seen.append([a.clone() for a in args])
        return real(*args)

    record.launches = 0
    monkeypatch.setattr(hg, name, record)
    x = torch.rand(65536, 3, generator=torch.Generator().manual_seed(5))
    g = torch.randn(65536, 32, generator=torch.Generator().manual_seed(6))
    out, grads = [], []
    for mode in ("packed", "per_level"):
        enc = HashEncoder(pallas_grad=pallas_grad, gather_mode=mode,
                          generator=torch.Generator().manual_seed(4),
                          device=cuda_device)
        y = enc(x.to(cuda_device))
        (y * g.to(cuda_device)).sum().backward()
        out.append(y.detach())
        grads.append(enc.table.grad)
    assert torch.equal(out[0], out[1])
    assert len(seen) == 2
    for a, b in zip(*seen):
        assert torch.equal(a, b)
    scale = float(grads[0].abs().max())
    assert scale > 0
    assert float((grads[1] - grads[0]).abs().max()) <= GRAD_REL * scale


# ------------------------------------------------- CUDA graphs of the render

NGP_AABB = (-1.5,) * 3 + (1.5,) * 3
# the benchmark's cells: the view, the NGP step, the vanilla step
GRAPH_VIEW_KW = dict(
    scene_aabb=NGP_AABB, render_step_size=5e-3, max_samples_per_ray=1024,
    coarse_stride=1, use_pallas=True, early_stop_eps=1e-4,
    test_chunk_size=8192, eval_samples_per_ray=128,
    eval_visible_samples_per_ray=64, visible_samples_budget=8192 * 64)
GRAPH_NGP_KW = dict(
    scene_aabb=NGP_AABB, render_step_size=5e-3, max_samples_per_ray=1024,
    samples_budget=1 << 20, visible_samples_budget=1 << 19,
    field_samples_budget=1 << 19, coarse_stride=16, probe_groups=64,
    probe_dilation=2, use_pallas=True, early_stop_eps=1e-4,
    stratified=True)
GRAPH_VANILLA_KW = dict(
    scene_aabb=NGP_AABB, render_step_size=5e-3, max_samples_per_ray=1024,
    samples_budget=131072, early_stop_eps=1e-4, stratified=True)


@contextlib.contextmanager
def _graphs_off(monkeypatch):
    """A context in which every call takes the eager path."""
    from nerfacc_tpu_torch import graphs

    with monkeypatch.context() as m:
        m.setattr(graphs, "_device", lambda leaves: None)
        yield


def _dense_ngp(device, seed=5):
    """The NGP cell's field, with tables denser than their initial draw
    gives, so that the cull cuts."""
    field = NGPRadianceField(aabb=NGP_AABB, pallas_grad=True,
                             generator=torch.Generator().manual_seed(seed),
                             device=device)
    table = field.encoder.table
    with torch.no_grad():
        table.copy_(torch.rand(table.shape, generator=torch.Generator()
                               .manual_seed(seed + 1)) * 4.0 - 2.0)
    return field


def _batches(n_steps, n_rays, seed, device):
    out = []
    for i in range(n_steps):
        o, d, _, _ = _view_rays(n_rays, seed=seed + i, device=device)
        px = torch.rand((n_rays, 3), generator=torch.Generator()
                        .manual_seed(seed + i)).to(device)
        out.append((o, d, px))
    return out


class _Trainee:
    """One field's training state as the benchmark's train cell keeps it:
    Adam, the grid, the stratify and grid generators, a restore."""

    def __init__(self, field, grid0, seed, lr, eps):
        self.field, self.grid0, self.seed = field, grid0, seed
        self.w0 = [p.detach().clone() for p in field.parameters()]
        self.opt = torch.optim.Adam(field.parameters(), lr=lr, eps=eps)
        dev = grid0.binary.device
        self.gens = (torch.Generator(device=dev), torch.Generator(device=dev))
        self.restore()

    def restore(self):
        with torch.no_grad():
            for p, w in zip(self.field.parameters(), self.w0):
                p.copy_(w)
        for state in self.opt.state.values():
            for v in state.values():
                v.zero_()
        self.grid = self.grid0
        self.gens[0].manual_seed(self.seed)
        self.gens[1].manual_seed(self.seed + 1)

    def step(self, i, batch, kw):
        from nerfacc_tpu_torch import update_grid

        if i % 16 == 0:
            self.grid = update_grid(
                self.grid, self.gens[1], step=256 + i,
                occ_eval_fn=lambda x: self.field.query_opacity(x, 5e-3),
                occ_thre=0.01, ema_decay=0.95)
        loss, n = train_step(self.field, self.opt, self.grid, *batch,
                             key=self.gens[0], **kw)
        return loss, n, [p.grad.clone() for p in self.field.parameters()]

    def take(self, other):
        """Take ``other``'s weights, Adam state and generators."""
        with torch.no_grad():
            for p, q in zip(self.field.parameters(),
                            other.field.parameters()):
                p.copy_(q)
                for k, v in self.opt.state[p].items():
                    v.copy_(other.opt.state[q][k])
        for g, h in zip(self.gens, other.gens):
            g.set_state(h.get_state())


@pytest.mark.cuda
def test_graphed_view_is_bit_equal_to_eager(cuda_device, monkeypatch):
    # 200 x 200 views at the view cell's settings (five chunks of 8,192,
    # the last padded): the first view captures, the others replay, each
    # on new rays; every output bit-equal to the eager path's
    from nerfacc_tpu_torch import _consts, graphs, render_image

    monkeypatch.setattr(_consts, "_cache", {})  # as in a fresh process
    grid = _trained_grid(cuda_device)
    field = _dense_ngp(cuda_device)
    kw = dict(GRAPH_VIEW_KW, grid=grid,
              render_bkgd=torch.ones(3, device=cuda_device))
    views = [_view_rays(40000, seed=s, device=cuda_device)[:2]
             for s in (31, 32, 31)]
    n = graphs.stats["captures"]
    with torch.no_grad():
        got = [render_image(field, o, d, **kw) for o, d in views]
        assert graphs.stats["captures"] == n + 1
        with _graphs_off(monkeypatch):
            want = [render_image(field, o, d, **kw) for o, d in views]
    for g, w in zip(got, want):
        for name, a, b in zip(("colors", "opacities", "depths"), g, w):
            assert torch.equal(a, b), name
    assert float(got[0][1].max()) > 0.01
    assert not torch.equal(got[0][0], got[1][0])


@pytest.mark.cuda
def test_render_image_under_inference_mode_runs_eagerly(cuda_device,
                                                        monkeypatch):
    # a view under torch.inference_mode takes the eager path, and the same
    # key under no_grad then captures and replays: all bit-equal
    from nerfacc_tpu_torch import graphs, render_image

    grid = _trained_grid(cuda_device)
    field = _dense_ngp(cuda_device)
    kw = dict(GRAPH_VIEW_KW, grid=grid,
              render_bkgd=torch.ones(3, device=cuda_device))
    o, d, _, _ = _view_rays(20000, seed=35, device=cuda_device)
    with _graphs_off(monkeypatch), torch.no_grad():
        want = render_image(field, o, d, **kw)
    n = graphs.stats["captures"]
    with torch.inference_mode():
        got = [render_image(field, o, d, **kw)]
    assert graphs.stats["captures"] == n
    with torch.no_grad():
        got += [render_image(field, o, d, **kw) for _ in range(2)]
    assert graphs.stats["captures"] == n + 1
    for g in got:
        for name, a, b in zip(("colors", "opacities", "depths"), g, want):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_graphed_ngp_steps_match_eager_step_for_step(cuda_device,
                                                     monkeypatch):
    # the NGP cell's step, 20 steps with grid updates at steps 0 and 16 and
    # the cell's restore at step 10; each step eager and graphed from one
    # state. Losses, live samples, the grid and the heads' gradients and
    # weights bit-equal; the table's gradient within GRAD_REL of its
    # largest entry (K7 adds in atomic order, so two eager steps differ
    # as much), and its weights then within Adam's step of that
    from nerfacc_tpu_torch import graphs

    grid0 = _trained_grid(cuda_device)
    runs = [_Trainee(_dense_ngp(cuda_device), grid0, 7, 1e-2, 1e-15)
            for _ in range(2)]  # eager, graphed
    batches = _batches(20, 32768, 40, cuda_device)
    captures = None
    for i, batch in enumerate(batches):
        if i == 10:
            for r in runs:
                r.restore()
        with _graphs_off(monkeypatch):
            eager = runs[0].step(i, batch, GRAPH_NGP_KW)
        graphed = runs[1].step(i, batch, GRAPH_NGP_KW)
        if i == 0:
            captures = graphs.stats["captures"]
        assert torch.equal(eager[0], graphed[0]), i
        assert torch.equal(eager[1], graphed[1]), i
        assert torch.equal(runs[0].grid.occs, runs[1].grid.occs), i
        for k, (a, b) in enumerate(zip(eager[2], graphed[2])):
            if k == 0:  # encoder.table
                scale = float(a.abs().max())
                assert float((a - b).abs().max()) <= GRAD_REL * scale, i
            else:
                assert torch.equal(a, b), (i, k)
        for k, (p, q) in enumerate(zip(runs[0].field.parameters(),
                                       runs[1].field.parameters())):
            if k:
                assert torch.equal(p, q), (i, k)
            else:
                torch.testing.assert_close(p, q, rtol=0, atol=2e-2)
        runs[0].take(runs[1])
    # a new batch, a new grid, a restore: no new capture
    assert graphs.stats["captures"] == captures
    assert int(eager[1]) > 10000


@pytest.mark.cuda
def test_graphed_vanilla_steps_are_bit_equal_to_eager(cuda_device,
                                                      monkeypatch):
    # the vanilla cell's step (exact march, no kernel, no atomics): five
    # steps from one start, a grid update at step 0, everything bit-equal
    from nerfacc_tpu_torch import graphs

    grid0 = _trained_grid(cuda_device)
    fields = [VanillaNeRFRadianceField(
        generator=torch.Generator().manual_seed(9), device=cuda_device)
        for _ in range(2)]
    runs = [_Trainee(f, grid0, 11, 5e-4, 1e-8) for f in fields]
    batches = _batches(5, 2048, 60, cuda_device)
    n = graphs.stats["captures"]
    outs = []
    for k, r in enumerate(runs):
        ctx = _graphs_off(monkeypatch) if k == 0 else contextlib.nullcontext()
        with ctx:
            outs.append([r.step(i, b, GRAPH_VANILLA_KW)
                         for i, b in enumerate(batches)])
    assert graphs.stats["captures"] == n + 1
    for i, (a, b) in enumerate(zip(*outs)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), i
        for g, h in zip(a[2], b[2]):
            assert torch.equal(g, h), i
    for p, q in zip(*(f.parameters() for f in fields)):
        assert torch.equal(p, q)


def _counters(fn):
    from nerfacc_tpu_torch import tracing

    tracing.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    counts = tracing.snapshot()
    tracing.reset()
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ngp_step", "vanilla_step", "view"])
def test_graphed_counters_equal_eager_under_the_profiler(cuda_device,
                                                         monkeypatch, cell):
    from nerfacc_tpu_torch import render_image

    grid0 = _trained_grid(cuda_device)
    if cell == "view":
        field = _dense_ngp(cuda_device)
        o, d, _, _ = _view_rays(40000, seed=33, device=cuda_device)
        kw = dict(GRAPH_VIEW_KW, grid=grid0,
                  render_bkgd=torch.ones(3, device=cuda_device))

        def run():
            with torch.no_grad():
                render_image(field, o, d, **kw)

        run()  # the capture, outside the profiler
        with _graphs_off(monkeypatch):
            eager = _counters(run)
        graphed = _counters(run)
    else:
        ngp = cell == "ngp_step"
        runs = [_Trainee(_dense_ngp(cuda_device) if ngp else
                         VanillaNeRFRadianceField(
                             generator=torch.Generator().manual_seed(9),
                             device=cuda_device),
                         grid0, 13, 1e-2, 1e-15) for _ in range(2)]
        kw = GRAPH_NGP_KW if ngp else GRAPH_VANILLA_KW
        batches = _batches(2, 32768 if ngp else 2048, 70, cuda_device)
        runs[1].step(0, batches[0], kw)  # the capture, outside the profiler
        runs[0].take(runs[1])
        runs[0].grid = runs[1].grid
        with _graphs_off(monkeypatch):
            eager = _counters(lambda: runs[0].step(1, batches[1], kw))
        graphed = _counters(lambda: runs[1].step(1, batches[1], kw))
    assert graphed.pop("graph_rays") == eager["rays"]
    assert graphed.pop("graph_captures") == 0
    assert graphed.pop("graph_fallbacks") == 0
    assert graphed == eager


@pytest.mark.cuda
@pytest.mark.parametrize("graphed", [True, False])
@pytest.mark.parametrize("setting", ["step", "view"])
def test_render_rays_does_not_synchronise(cuda_device, monkeypatch, setting,
                                          graphed):
    # the cells' render_rays under set_sync_debug_mode("error"): the
    # capture, the replays and the eager path, in a process whose
    # constants are not made yet
    from nerfacc_tpu_torch import _consts

    monkeypatch.setattr(_consts, "_cache", {})
    grid = _trained_grid(cuda_device)
    field = _dense_ngp(cuda_device)
    ctx = contextlib.nullcontext() if graphed else _graphs_off(monkeypatch)
    with ctx:
        for i, (o, d, px) in enumerate(_batches(
                3, 32768 if setting == "step" else 8192, 80, cuda_device)):
            gen = torch.Generator(device=cuda_device).manual_seed(i)
            torch.cuda.set_sync_debug_mode("error")
            try:
                if setting == "step":
                    out = render_rays(
                        field, o, d, grid=grid, key=gen, aux=px,
                        return_compact=True,
                        render_bkgd=torch.ones(3, device=cuda_device),
                        **GRAPH_NGP_KW)
                else:
                    with torch.no_grad():  # a chunk of the view
                        out = render_rays(
                            field, o, d, grid=grid, scene_aabb=NGP_AABB,
                            render_step_size=5e-3, max_samples_per_ray=1024,
                            samples_budget=8192 * 128,
                            visible_samples_budget=8192 * 64,
                            use_pallas=True, early_stop_eps=1e-4,
                            render_bkgd=torch.ones(3, device=cuda_device))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if setting == "step":
                out[0].sum().backward()


@pytest.mark.cuda
def test_a_field_that_reads_the_host_falls_back_on_the_card(cuda_device,
                                                             monkeypatch):
    # a field whose density pass reads a value back: its warm-up
    # synchronises, so the key stays eager, counted once, and the view
    # equals the eager path's
    from nerfacc_tpu_torch import graphs, render_image

    class HostReading(NGPRadianceField):
        def query_density(self, x, return_feat=False):
            if float(x.abs().max()) < 0:  # a read back: a synchronisation
                raise AssertionError("unreachable")
            return super().query_density(x, return_feat)

    field = HostReading(aabb=NGP_AABB, pallas_grad=True,
                        generator=torch.Generator().manual_seed(5),
                        device=cuda_device)
    grid = _trained_grid(cuda_device)
    o, d, _, _ = _view_rays(20000, seed=34, device=cuda_device)
    kw = dict(GRAPH_VIEW_KW, grid=grid)
    stats = dict(graphs.stats)
    with torch.no_grad(), pytest.warns(RuntimeWarning, match="synchron"):
        got = [render_image(field, o, d, **kw) for _ in range(2)]
        with _graphs_off(monkeypatch):
            want = render_image(field, o, d, **kw)
    assert graphs.stats == dict(stats, fallbacks=stats["fallbacks"] + 1)
    for g in got:
        for a, b in zip(g, want):
            assert torch.equal(a, b)
