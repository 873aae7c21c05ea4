"""The port's render path as a whole vs the JAX package's.

``render_rays`` with the fused march (``use_pallas=True``) and the TensoCP
field on its kernel path (``use_kernel=True``) on both sides, from the same
flax parameters: empty-ray compaction, the grouped march, the two-stage
visibility cull with stage-2 re-selection, the composite and the
expand-back. JAX runs its Pallas kernels in interpret mode; the port's
wrappers run their plain twins on the CPU.

Tolerances: the march before the density-dependent cull is bit-equal in
its masks and within rtol 1e-5 / atol 1e-6 in t. The field agrees to f32
rounding (see test_torch_tensorf.py), so a slot's visibility can flip at
the ``early_stop_eps`` threshold only when its transmittance sits within
f32 rounding of it; the count of such flips is reported and bounded at 2.
Colors, opacities and depths then agree within 1e-4 absolute (depth in
scene units, t <= 5).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu as jx
from nerfacc_tpu.datasets.rays import generate_rays as jax_generate_rays
from nerfacc_tpu.datasets.rays import look_at_poses as jax_look_at_poses
from nerfacc_tpu.models import TensoCPRadianceField as JaxTensoCP
from nerfacc_tpu.utils import render_image as jax_render_image
from nerfacc_tpu.utils import render_rays as jax_render_rays
from nerfacc_tpu_torch import render_image, render_rays
from nerfacc_tpu_torch.convert import grid_from_arrays, tensocp_from_flax
from nerfacc_tpu_torch.datasets import generate_rays, look_at_poses
from nerfacc_tpu_torch.models import TensoCPRadianceField

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
LEVELS = ((16, 8), (32, 16))
N_RAYS = 64
KW = dict(
    scene_aabb=AABB,
    render_step_size=1e-2,
    max_samples_per_ray=512,
    samples_budget=N_RAYS * 24,
    visible_samples_budget=N_RAYS * 12,
    coarse_stride=8,
    probe_dilation=1,
    probe_groups=16,
    compact_rays_fraction=0.75,
    use_pallas=True,
)


@pytest.fixture(scope="module")
def scene():
    """Both packages' field (same flax parameters) and 32^3 grid."""
    rng = np.random.RandomState(0)
    binary = np.zeros((32, 32, 32), bool)
    binary[6:26, 6:26, 6:26] = rng.rand(20, 20, 20) < 0.5
    jgrid = jx.with_binary(jx.create_grid(jnp.asarray(AABB), resolution=32),
                           jnp.asarray(binary))
    tgrid = grid_from_arrays(AABB, binary, device="cpu")
    # density_bias 3: dense enough that the early-stop cull removes slots
    kw = dict(aabb=AABB, levels=LEVELS, use_kernel=True, density_bias=3.0)
    jfield = JaxTensoCP(**kw)
    x0 = jnp.zeros((8, 3))
    params = jfield.init(jax.random.PRNGKey(1), x0, x0)
    tfield = TensoCPRadianceField(device="cpu", **kw)
    tensocp_from_flax(jax.tree_util.tree_map(np.asarray, params), tfield)
    return jfield, params, jgrid, tfield, tgrid


def _camera_rays(n, seed):
    """Rays from outside the box aimed near its centre; some miss it."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 0.8
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _render_both(scene, o, d, **over):
    jfield, params, jgrid, tfield, tgrid = scene
    kw = dict(KW, **over)
    kw_j = dict(kw, render_bkgd=jnp.ones(3), return_extras=True)
    kw_t = dict(kw, render_bkgd=torch.ones(3), return_extras=True)
    a = jax_render_rays(params, jfield, jnp.asarray(o), jnp.asarray(d),
                        grid=jgrid, **kw_j)
    with torch.no_grad():
        b = render_rays(tfield, torch.as_tensor(o), torch.as_tensor(d),
                        grid=tgrid, **kw_t)
    return a, b


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0,
                               atol=atol)


def test_march_before_the_cull_is_bit_equal(scene):
    o, d = _camera_rays(N_RAYS, seed=2)
    a, b = _render_both(scene, o, d, prefilter_sigma=False)
    ea, eb = a[4], b[4]
    np.testing.assert_array_equal(eb["masks"].numpy(), np.asarray(ea["masks"]))
    assert eb["masks"].shape == (48, 32) and int(eb["masks"].sum()) > 200
    for n in ("t_starts", "t_ends", "deltas"):
        np.testing.assert_allclose(eb[n].numpy(), np.asarray(ea[n]),
                                   rtol=1e-5, atol=1e-6)
    _close(b[0], a[0], 1e-4)


def test_two_stage_render_matches_jax(scene):
    o, d = _camera_rays(N_RAYS, seed=3)
    (cj, oj, dj, nj, ej), (ct, ot, dt, nt, et) = _render_both(scene, o, d)
    # the stage-2 layout: 48 compacted rays x 16 visible slots
    assert et["masks"].shape == (48, 16)
    flips = int(np.abs(et["masks"].sum(1).numpy()
                       - np.asarray(ej["masks"]).sum(1)).sum())
    assert flips <= 2, f"{flips} visibility flips"
    assert abs(int(nt) - int(nj)) <= 2
    _close(ct, cj, 1e-4)
    _close(ot, oj, 1e-4)
    _close(dt, dj, 1e-4)
    # the cull removed slots, and rays without live samples are background
    assert float(ot.max()) > 0.99
    miss = (ot[:, 0] == 0).numpy()
    assert miss.sum() > 0
    assert bool((ct[torch.as_tensor(miss)] == 1.0).all())
    assert bool((dt[torch.as_tensor(miss)] == 0.0).all())


def test_render_image_matches_jax(scene):
    # one 16x16 view; a 96-ray chunk pads the last chunk with 32 rays
    jfield, params, jgrid, tfield, tgrid = scene
    W = 16
    focal = 0.5 * W / np.tan(0.5 * np.deg2rad(45.0))
    K = np.asarray([[focal, 0, W / 2], [0, focal, W / 2], [0, 0, 1]],
                   np.float32)
    y, x = np.meshgrid(np.arange(W), np.arange(W), indexing="ij")
    pose_j = jax_look_at_poses(3, radius=2.6, elevation_deg=20.0)[1]
    pose_t = look_at_poses(3, radius=2.6, elevation_deg=20.0,
                          device="cpu")[1]
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j), atol=1e-7)
    rj = jax_generate_rays(jnp.asarray(x.reshape(-1)),
                           jnp.asarray(y.reshape(-1)), pose_j, jnp.asarray(K))
    rt = generate_rays(torch.as_tensor(x.reshape(-1)),
                       torch.as_tensor(y.reshape(-1)), pose_t,
                       torch.as_tensor(K))
    np.testing.assert_allclose(rt.viewdirs.numpy(), np.asarray(rj.viewdirs),
                               rtol=1e-6, atol=1e-6)
    kw = {k: v for k, v in KW.items() if k != "samples_budget"}
    kw.update(test_chunk_size=96, eval_samples_per_ray=24,
              eval_visible_samples_per_ray=12)
    out_j = jax_render_image(params, jfield, rj.origins, rj.viewdirs,
                             grid=jgrid, render_bkgd=jnp.ones(3), **kw)
    out_t = render_image(tfield, rt.origins, rt.viewdirs, grid=tgrid,
                         render_bkgd=torch.ones(3), **kw)
    for a, b in zip(out_t, out_j):
        assert a.shape[0] == W * W and bool(torch.isfinite(a).all())
        _close(a, b, 1e-4)
    assert float(out_t[1].max()) > 0.5


def test_entry_points_default_to_the_card():
    # without a device argument the constructors ask for the CUDA device
    # and PyTorch raises where there is none; the CPU must be asked for
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a CUDA device")
    from nerfacc_tpu_torch import create_grid

    with pytest.raises((AssertionError, RuntimeError)):
        create_grid(AABB)
    with pytest.raises((AssertionError, RuntimeError)):
        grid_from_arrays(AABB, np.zeros((4, 4, 4), bool))
    with pytest.raises((AssertionError, RuntimeError)):
        look_at_poses(2, radius=2.0)
    with pytest.raises((AssertionError, RuntimeError)):
        TensoCPRadianceField(aabb=AABB, levels=((4, 2),))
    grid = create_grid(AABB, resolution=4, device="cpu")
    assert grid.binary.device.type == "cpu" and grid.num_cells == 64


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import nerfacc_tpu_torch, nerfacc_tpu_torch.ops, "
        "nerfacc_tpu_torch.models, nerfacc_tpu_torch.datasets, "
        "nerfacc_tpu_torch.convert, chip_smoke\n"
        "import nerfacc_tpu_torch.ops.hash_gather, "
        "nerfacc_tpu_torch.ops.sample_compact, "
        "nerfacc_tpu_torch.ops.table_gather, "
        "nerfacc_tpu_torch.models.hash_encoding, "
        "nerfacc_tpu_torch.models.mlp, nerfacc_tpu_torch.models.encoders, "
        "nerfacc_tpu_torch.checkpoint\n"
        "sys.path.insert(0, 'scripts')\n"
        "import bench_hash_torch, profile_step_torch, "
        "bench_march_select_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'nerfacc_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
