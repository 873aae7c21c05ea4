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
roundings and K4's order of sums differ: 1e-2 in L2.
"""

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import _build, render_rays
from nerfacc_tpu_torch.convert import grid_from_arrays
from nerfacc_tpu_torch.models import (
    DNeRFRadianceField,
    NGPRadianceField,
    TensoCPRadianceField,
    VanillaNeRFRadianceField,
)
from nerfacc_tpu_torch.models import hash_grid_indices
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
    hash_grad_scatter,
    hash_grad_scatter_levels,
    hash_grad_scatter_levels_plain,
    hash_grad_scatter_plain,
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
