"""The CUDA kernels of nerfacc_tpu_torch against their plain twins, on the
card. Tests marked ``cuda`` skip where there is no CUDA device; on the
card run them without the JAX-side conftest (the card's machine has no
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports no JAX. Tolerances: masks bit-equal and t within
rtol 1e-5 / atol 1e-6 (the march kernels keep the plain chain's f32
operations; only cumsum order differs); CP features within 1e-6 absolute
(both sum the same two exact products).
"""

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import _build
from nerfacc_tpu_torch.ops import (
    cp_level_features,
    cp_level_features_plain,
    fused_reselect,
    fused_reselect_plain,
    fused_select_grouped,
    fused_select_grouped_plain,
)

torch.set_num_threads(1)


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
