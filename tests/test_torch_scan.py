"""The port's segmented scans (``nerfacc_tpu_torch/scan.py``) against the
JAX package's and a float64 brute force, on the same numpy-seeded inputs.

Tolerances are the JAX package's own (``tests/test_scan.py``):
- the scans against brute force and against JAX: rtol 1e-5 / atol 1e-5
  (the product rtol 1e-4); ``segment_sum`` the same;
- zero propagation of the product: atol 1e-6;
- bench scale, 8,192 rays x 64 samples (524,288 samples): the exclusive
  sum within 1e-4 and ``T = exp(-acc)`` within 1e-5 of a float64 per-ray
  oracle; the segmented transmittance within 1e-6 of the dense twin's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu.scan as jscan
import nerfacc_tpu_torch.vol_rendering as pvr
from nerfacc_tpu_torch import (
    render_transmittance_from_density,
    render_transmittance_from_density_dense,
)
from nerfacc_tpu_torch import scan as pscan

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
PROD_TOL = dict(rtol=1e-4, atol=1e-5)


def _brute(x, seg, n, kind):
    x = x.astype(np.float64)
    out = np.zeros_like(x)
    if kind == "sum":
        return np.bincount(seg, weights=x, minlength=n)
    for s in range(n):
        idx = np.where(seg == s)[0]
        v = x[idx]
        if kind == "excl":
            out[idx] = np.cumsum(v) - v
        elif kind == "incl":
            out[idx] = np.cumsum(v)
        elif kind == "rev_excl":
            out[idx] = np.cumsum(v[::-1])[::-1] - v
        elif kind == "prod_excl":
            out[idx] = np.concatenate([[1.0], np.cumprod(v)[:-1]])
    return out


SCANS = {
    "sum": "segment_sum",
    "excl": "exclusive_segment_cumsum",
    "incl": "inclusive_segment_cumsum",
    "rev_excl": "reverse_exclusive_segment_cumsum",
    "prod_excl": "exclusive_segment_cumprod",
}


def _segments(seed, n_rays=23, n=600):
    """Sorted segment ids with empty segments (gaps) and one long run."""
    rng = np.random.RandomState(seed)
    seg = np.sort(rng.randint(0, n_rays, size=n))
    seg[seg == 5] = 6  # an empty segment
    seg[-150:] = n_rays - 1  # a run longer than 128
    return np.sort(seg).astype(np.int32)


@pytest.mark.parametrize("kind", list(SCANS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scan_matches_jax_and_brute_force(kind, seed):
    n_rays = 23
    seg = _segments(seed, n_rays)
    rng = np.random.RandomState(10 + seed)
    x = rng.rand(seg.shape[0]).astype(np.float32)
    if kind == "prod_excl":
        x = (0.5 + 0.5 * x).astype(np.float32)  # products stay away from 0
    name = SCANS[kind]
    got = getattr(pscan, name)(torch.as_tensor(x), torch.as_tensor(seg),
                               n_rays).numpy()
    want_j = np.asarray(getattr(jscan, name)(jnp.asarray(x), jnp.asarray(seg),
                                             n_rays))
    tol = PROD_TOL if kind == "prod_excl" else TOL
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _brute(x, seg, n_rays, kind), **tol)
    np.testing.assert_allclose(got, want_j, **tol)


def test_scans_of_one_segment_and_of_singletons():
    # n = 1, one segment of all samples and every sample its own segment
    for seg in (np.zeros(1, np.int32), np.zeros(37, np.int32),
                np.arange(37, dtype=np.int32)):
        x = np.random.RandomState(len(seg)).rand(len(seg)).astype(np.float32)
        n = int(seg.max()) + 1
        for kind, name in SCANS.items():
            got = getattr(pscan, name)(torch.as_tensor(x),
                                       torch.as_tensor(seg), n).numpy()
            np.testing.assert_allclose(got, _brute(x, seg, n, kind),
                                       **PROD_TOL)


def test_segment_cumprod_zero_propagation():
    x = torch.tensor([0.5, 0.0, 0.3, 0.9, 1.0, 0.0, 0.2])
    seg = torch.tensor([0, 0, 0, 0, 1, 1, 1], dtype=torch.int32)
    got = pscan.exclusive_segment_cumprod(x, seg, 2).numpy()
    want = np.array([1.0, 0.5, 0.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[2:4] == 0).all() and got[6] == 0  # exactly zero, no division


def test_scans_accumulate_in_f32():
    # a bf16 input is summed in f32 and rounded once to bf16
    seg = torch.zeros(512, dtype=torch.int32)
    x = torch.full((512,), 1.0 / 256, dtype=torch.bfloat16)
    got = pscan.inclusive_segment_cumsum(x, seg, 1)
    assert got.dtype == torch.bfloat16
    assert float(got[-1]) == 2.0  # a bf16 running sum would stall at 1.0


def test_flat_cumsum_precision_bench_scale():
    # late rays at 8,192 x 64: a global cumsum less per-ray offsets loses
    # up to 2.4e-2 in T there; the reset operator keeps per-ray precision
    rng = np.random.RandomState(7)
    n_rays, k = 8192, 64
    seg = np.repeat(np.arange(n_rays, dtype=np.int32), k)
    x = (rng.rand(n_rays * k) * 0.5).astype(np.float32)
    got = pscan.exclusive_segment_cumsum(
        torch.as_tensor(x), torch.as_tensor(seg), n_rays).numpy()
    want64 = (np.cumsum(x.astype(np.float64).reshape(n_rays, k), axis=1)
              - x.reshape(n_rays, k)).reshape(-1)
    assert np.abs(got - want64).max() < 1e-4
    err_T = np.abs(np.exp(-got.astype(np.float64)) - np.exp(-want64))
    assert err_T.max() < 1e-5


def test_segmented_transmittance_matches_dense_bench_scale(monkeypatch):
    # the segmented path itself (the bridge is off) against the dense twin
    monkeypatch.setattr(pvr, "DENSE_BRIDGE", False)
    rng = np.random.RandomState(3)
    n_rays, k = 8192, 64
    t = np.sort(rng.rand(n_rays, k + 1).astype(np.float32), axis=1)
    sig = (rng.rand(n_rays, k) * 20.0).astype(np.float32)
    seg = torch.arange(n_rays, dtype=torch.int32).repeat_interleave(k)
    dense = render_transmittance_from_density_dense(
        torch.as_tensor(t[:, :-1]), torch.as_tensor(t[:, 1:]),
        torch.as_tensor(sig))
    flat = render_transmittance_from_density(
        torch.as_tensor(t[:, :-1].reshape(-1, 1)),
        torch.as_tensor(t[:, 1:].reshape(-1, 1)),
        torch.as_tensor(sig.reshape(-1, 1)), ray_indices=seg, n_rays=n_rays)
    np.testing.assert_allclose(flat.numpy().reshape(n_rays, k),
                               dense.numpy(), atol=1e-6)
