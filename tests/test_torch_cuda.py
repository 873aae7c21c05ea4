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
outside the table clamped into it, as the kernel documents).
"""

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import _build
from nerfacc_tpu_torch.convert import grid_from_arrays
from nerfacc_tpu_torch.models import NGPRadianceField, TensoCPRadianceField
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
