"""The port's on-disk datasets against the JAX package's: the fixture
writers (``datasets/fixtures.py``), the blender, D-NeRF and COLMAP-360
loaders and their ``sample_batch``, on tiny fixtures (16-24 px, 3-16
views) that both packages write and both read.

Bounds, with their reasons:
- fixtures written by the two packages: the PNGs within one 8-bit level
  (the two ``render_gt`` agree within ~1e-5 before quantising, so a value
  near a rounding edge may land one level apart; the test counts them);
  an RGBA colour only where its alpha is at least 8/255, since the
  straight colour ``c_black / alpha`` magnifies the renders' difference
  where alpha nears 0, and there the white composite within 1/255,
  ``transform_matrix`` within f32 rounding (both cast the same float64
  poses to f32), ``cameras.bin`` / ``images.bin`` bit-equal (both come
  from the same numpy float64 arithmetic);
- a loader of either package on the same directory: images, test images,
  poses, intrinsics, times and the 360 split and normalisation bit-equal
  (the same bytes through the same numpy arithmetic); the 360 poses
  against the fixture's own within 1e-5 (through COLMAP's quaternions and
  back, as ``tests/test_e2e_dataset.py`` holds them);
- ``sample_batch`` at one seed: the same draws in the same order, so
  pixels and origins bit-equal; on the native path the directions too
  (the same C code built with the same flags on this machine); on the
  numpy path the directions within ``tests/test_data_io.py``'s bound
  (rtol 1e-4, atol 1e-5: PyTorch and XLA order the f32 products apart);
- the analytic oracle of ``tests/test_e2e_dataset.py``: the loader's rays
  re-rendered through the field match the loaded pixels within mean 0.01
  and max 0.1 (PNG quantisation and the alpha recomposition);
- a loader-fed trainer resumed from a checkpoint: the same next batch,
  bit for bit.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu.data_io as jax_data_io
from nerfacc_tpu.datasets import dnerf_synthetic as jax_dnerf
from nerfacc_tpu.datasets import fixtures as jax_fixtures
from nerfacc_tpu.datasets import nerf_360_v2 as jax_360
from nerfacc_tpu.datasets import nerf_synthetic as jax_blender
from nerfacc_tpu_torch import data_io
from nerfacc_tpu_torch.checkpoint import CheckpointManager
from nerfacc_tpu_torch.datasets import (
    dnerf_synthetic,
    fixtures,
    image_io,
    nerf_360_v2,
    nerf_synthetic,
)
from nerfacc_tpu_torch.datasets.procedural import (
    render_gt,
    render_gt_dynamic,
    render_gt_env,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
RAY_RTOL, RAY_ATOL = 1e-4, 1e-5
ORACLE_MEAN, ORACLE_MAX = 0.01, 0.1
SIZE, COLMAP_SIZE = 24, 16
# kind -> (port writer, JAX writer, keyword arguments)
WRITERS = {
    "blender": (fixtures.write_blender_fixture,
                jax_fixtures.write_blender_fixture,
                dict(subject_id="procedural", n_train=4, n_val=2, n_test=3,
                     width=SIZE, height=SIZE)),
    "dnerf": (fixtures.write_blender_fixture,
              jax_fixtures.write_blender_fixture,
              dict(subject_id="procedural", n_train=4, n_val=0, n_test=3,
                   width=SIZE, height=SIZE, dynamic=True)),
    "colmap": (fixtures.write_colmap_fixture,
               jax_fixtures.write_colmap_fixture,
               dict(subject_id="procedural360", n_images=16,
                    width=COLMAP_SIZE, height=COLMAP_SIZE)),
}
# kind -> (port loader, JAX loader, subject, splits)
LOADERS = {
    "blender": (nerf_synthetic.SubjectLoader, jax_blender.SubjectLoader,
                "procedural", ("train", "val", "trainval", "test")),
    "dnerf": (dnerf_synthetic.SubjectLoader, jax_dnerf.SubjectLoader,
              "procedural", ("train", "test")),
    "colmap": (nerf_360_v2.SubjectLoader, jax_360.SubjectLoader,
               "procedural360", ("train", "test")),
}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(kind, writer) -> the fixture's root directory, written once by each
    package."""
    out = {}
    for kind, (port_write, jax_write, kw) in WRITERS.items():
        for writer in ("port", "jax"):
            root = tmp_path_factory.mktemp(f"{kind}_{writer}")
            if writer == "port":
                port_write(root, device=CPU, **kw)
            else:
                jax_write(root, **kw)
            out[kind, writer] = root
    return out


def _loaders(roots, kind, writer, split, **kw):
    port_cls, jax_cls, subject, _ = LOADERS[kind]
    root = str(roots[kind, writer])
    if kind == "colmap":
        kw.setdefault("factor", 1)
    return (port_cls(subject, root, split=split, device=CPU, **kw),
            jax_cls(subject, root, split=split, **kw))


def _equal(got, want, what):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want),
                                  err_msg=what)


# --------------------------------------------------------------------------
# the fixture writers


def _pngs(subj: Path) -> list:
    return sorted(p.relative_to(subj) for p in subj.rglob("*.png"))


@pytest.mark.parametrize("kind", list(WRITERS))
def test_fixtures_match_the_jax_writers(roots, kind):
    subject = WRITERS[kind][2]["subject_id"]
    port, jax_subj = (roots[kind, w] / subject for w in ("port", "jax"))
    names = _pngs(port)
    assert names == _pngs(jax_subj) and names
    differ, total = 0, 0
    for name in names:
        a = image_io.imread(port / name).astype(np.int16)
        b = image_io.imread(jax_subj / name).astype(np.int16)
        assert a.shape == b.shape, name
        diff = np.abs(a - b)
        if a.shape[-1] == 4:
            # a colour is straight, c_black / alpha: where alpha rounds to
            # a few levels that quotient magnifies the renders' 1e-5, so
            # it is held where alpha weighs it in a composite (>= 8/255),
            # and the white composite, which the loaders read, everywhere
            assert diff[..., 3].max() <= 1, name
            assert diff[..., :3][b[..., 3] >= 8].max(initial=0) <= 1, name
            comp = [x[..., :3] / 255 * (x[..., 3:] / 255)
                    + 1 - x[..., 3:] / 255 for x in (a, b)]
            assert np.abs(comp[0] - comp[1]).max() <= 1 / 255, name
        else:
            assert diff.max() <= 1, (name, diff.max())
        differ += int((diff > 0).any(-1).sum())
        total += a.shape[0] * a.shape[1]
    print(f"{kind}: {differ} of {total} pixels differ")
    assert differ <= total // 50
    if kind == "colmap":
        for name in ("cameras.bin", "images.bin"):
            assert ((port / "sparse" / "0" / name).read_bytes()
                    == (jax_subj / "sparse" / "0" / name).read_bytes())
        return
    for meta in sorted(port.glob("transforms_*.json")):
        got = json.loads(meta.read_text())
        want = json.loads((jax_subj / meta.name).read_text())
        assert got["camera_angle_x"] == want["camera_angle_x"]
        assert len(got["frames"]) == len(want["frames"])
        for f, g in zip(got["frames"], want["frames"]):
            assert f["file_path"] == g["file_path"]
            assert f.get("time") == g.get("time")
            np.testing.assert_allclose(f["transform_matrix"],
                                       g["transform_matrix"], rtol=2**-23,
                                       atol=2**-24)


# --------------------------------------------------------------------------
# the loaders on the same directories


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", list(LOADERS))
def test_loaders_read_each_others_fixtures(roots, kind, writer):
    for split in LOADERS[kind][3]:
        port, jax_loader = _loaders(roots, kind, writer, split)
        where = f"{kind} {writer}-written, {split}"
        for name in ("images", "test_images", "train_poses", "test_poses",
                     "K", "aabb", "bkgd"):
            got, want = getattr(port, name), getattr(jax_loader, name)
            assert got.dtype == torch.float32 and got.device == CPU, name
            _equal(got, want, f"{where}: {name}")
        assert (port.height, port.width) == (jax_loader.height,
                                             jax_loader.width)
        if kind == "dnerf":
            _equal(port.timestamps, jax_loader.timestamps, where)
        if kind == "blender" and split == "trainval":
            assert port.images.shape[0] == 6  # train + val
    if kind == "colmap":
        # the every-8th split over 16 images, in one normalised frame
        train, _ = _loaders(roots, kind, writer, "train")
        test, _ = _loaders(roots, kind, writer, "test")
        assert (train.images.shape[0], test.images.shape[0]) == (14, 2)
        # the raw poses through COLMAP's quaternions and back: f32 rounding
        norm = fixtures.normalize_poses(
            fixtures.opencv_circle_poses(16, radius=3.2))
        for loader, sel in ((test, [0, 8]),
                            (train, [i for i in range(16) if i % 8])):
            np.testing.assert_allclose(loader.train_poses.numpy(), norm[sel],
                                       atol=1e-5)


def _batch_pair(port, jax_loader, n):
    got, want = port.sample_batch(n), jax_loader.sample_batch(n)
    assert len(got) == len(want)
    return got, want


def _check_batch(got, want, native, what):
    (rays, pixels, *t), (jrays, jpixels, *jt) = got, want
    _equal(pixels, jpixels, f"{what}: pixels")
    _equal(rays.origins, jrays.origins, f"{what}: origins")
    if native:
        _equal(rays.viewdirs, jrays.viewdirs, f"{what}: viewdirs")
    else:
        np.testing.assert_allclose(rays.viewdirs.numpy(),
                                   np.asarray(jrays.viewdirs), rtol=RAY_RTOL,
                                   atol=RAY_ATOL, err_msg=what)
    for a, b in zip(t, jt):
        assert a.shape == (pixels.shape[0], 1)
        _equal(a, b, f"{what}: timestamps")


@pytest.mark.parametrize("aug", ["white", "random"])
@pytest.mark.parametrize("native", [True, False])
def test_blender_sample_batch_matches_jax(roots, monkeypatch, native, aug):
    if native and (data_io.lib() is None or jax_data_io.lib() is None):
        pytest.skip("no g++ to build the native assemblers")
    if not native:  # both loaders take their numpy path
        monkeypatch.setattr(data_io, "lib", lambda: None)
        monkeypatch.setattr(jax_data_io, "lib", lambda: None)
    port, jax_loader = _loaders(roots, "blender", "jax", "train",
                                color_bkgd_aug=aug, seed=11)
    for step in range(3):  # the draws continue in the same order
        got, want = _batch_pair(port, jax_loader, 300)
        _check_batch(got, want, native, f"step {step}")
        _equal(port.bkgd, jax_loader.bkgd, f"step {step}: bkgd")
    if aug == "random":
        assert not torch.equal(port.bkgd, torch.ones(3))


@pytest.mark.parametrize("kind", ["dnerf", "colmap"])
def test_numpy_loaders_sample_batch_matches_jax(roots, kind):
    aug = {"colmap": "random", "dnerf": "white"}[kind]
    port, jax_loader = _loaders(roots, kind, "port", "train",
                                color_bkgd_aug=aug, seed=5)
    for step in range(2):
        got, want = _batch_pair(port, jax_loader, 257)
        _check_batch(got, want, False, f"{kind} step {step}")


# --------------------------------------------------------------------------
# the analytic oracle of tests/test_e2e_dataset.py on the port's loaders


def _close_to_field(img, got, what, max_bound=True):
    err = (img - got).abs()
    assert float(err.mean()) < ORACLE_MEAN, (what, float(err.mean()))
    if max_bound:
        assert float(err.max()) < ORACLE_MAX, (what, float(err.max()))


def test_blender_loader_oracle(roots):
    root = str(roots["blender", "port"])
    test = nerf_synthetic.SubjectLoader("procedural", root, split="test",
                                        device=CPU)
    assert test.test_images.shape == (3, SIZE, SIZE, 3)
    for i in range(test.test_poses.shape[0]):
        rays = test.rays_for_view(test.test_poses[i])
        img = render_gt(rays.origins, rays.viewdirs, torch.ones(3))
        _close_to_field(img.reshape(SIZE, SIZE, 3), test.test_images[i],
                        f"view {i}")
    train = nerf_synthetic.SubjectLoader("procedural", root, split="train",
                                         color_bkgd_aug="random", seed=3,
                                         device=CPU)
    rays, pixels = train.sample_batch(256)
    assert rays.origins.shape == (256, 3) and pixels.shape == (256, 3)
    want = render_gt(rays.origins, rays.viewdirs, train.bkgd)
    _close_to_field(want, pixels, "batch", max_bound=False)


def test_dnerf_loader_oracle(roots):
    root = str(roots["dnerf", "port"])
    test = dnerf_synthetic.SubjectLoader("procedural", root, split="test",
                                         device=CPU)
    assert test.timestamps.tolist() == [0.0, 0.5, 1.0]
    for i in range(3):
        rays = test.rays_for_view(test.test_poses[i])
        t = torch.full((rays.origins.shape[0], 1), float(test.timestamps[i]))
        img = render_gt_dynamic(rays.origins, rays.viewdirs, torch.ones(3), t)
        _close_to_field(img.reshape(SIZE, SIZE, 3), test.test_images[i],
                        f"view {i}", max_bound=False)
    train = dnerf_synthetic.SubjectLoader("procedural", root, split="train",
                                          device=CPU)
    rays, pixels, ts = train.sample_batch(128)
    assert ts.shape == (128, 1)
    want = render_gt_dynamic(rays.origins, rays.viewdirs, train.bkgd, ts)
    _close_to_field(want, pixels, "batch", max_bound=False)


def test_colmap_360_loader_oracle(roots):
    root = str(roots["colmap", "port"])
    raw = fixtures.opencv_circle_poses(16, radius=3.2)
    center = raw[:, :, 3].mean(axis=0)
    scale = 1.0 / max(np.abs(raw[:, :, 3] - center).max(), 1e-6)
    for split in ("test", "train"):
        loader = nerf_360_v2.SubjectLoader("procedural360", root,
                                           split=split, factor=1, device=CPU)
        rays = loader.rays_for_view(loader.test_poses[0])
        o_raw = rays.origins / float(scale) + torch.as_tensor(center)
        img = render_gt_env(o_raw.to(torch.float32), rays.viewdirs)
        _close_to_field(img.reshape(COLMAP_SIZE, COLMAP_SIZE, 3),
                        loader.images[0], split, max_bound=False)
        rays, pixels = loader.sample_batch(128)
        o_raw = rays.origins / float(scale) + torch.as_tensor(center)
        want = render_gt_env(o_raw.to(torch.float32), rays.viewdirs)
        _close_to_field(want, pixels, f"{split} batch", max_bound=False)


# --------------------------------------------------------------------------
# a loader-fed trainer's checkpoint


def _trainer_module():
    spec = importlib.util.spec_from_file_location(
        "train_ngp_nerf_torch_ds", ROOT / "examples" / "train_ngp_nerf_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("native", [True, False])
def test_resumed_loader_trainer_draws_the_same_batch(roots, tmp_path,
                                                      monkeypatch, native):
    if native and data_io.lib() is None:
        pytest.skip("no g++ to build the native assembler")
    if not native:
        monkeypatch.setattr(data_io, "lib", lambda: None)
    trainer = _trainer_module()
    flags = ["--device", "cpu", "--num_rays", "32", "--grid_resolution",
             "16", "--levels", "8x4,16x8", "--samples_budget", "1024",
             "--visible_samples_budget", "512", "--test_chunk_size", "64",
             "--eval_views", "1", "--data_root",
             str(roots["blender", "port"]), "--ckpt_dir", str(tmp_path),
             "--ckpt_every", "1"]
    out = trainer.main(flags + ["--max_steps", "2"])
    resumed = trainer.Trainer(trainer.parse_args(flags))
    assert resumed.load_state(CheckpointManager(tmp_path).restore()) == 1
    a, b = out["trainer"].scene, resumed.scene
    for _ in range(2):
        (ra, pa), (rb, pb) = a.sample_batch(32), b.sample_batch(32)
        for x, y in ((ra.origins, rb.origins), (ra.viewdirs, rb.viewdirs),
                     (pa, pb)):
            assert torch.equal(x, y)


# --------------------------------------------------------------------------
# imports


def test_port_imports_no_jax_nor_imageio():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import nerfacc_tpu_torch\n"
        "for m in pkgutil.walk_packages(nerfacc_tpu_torch.__path__,\n"
        "                               'nerfacc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for path in ('examples/train_ngp_nerf_torch.py',\n"
        "             'examples/train_mlp_nerf_torch.py',\n"
        "             'examples/train_mlp_dnerf_torch.py',\n"
        "             'scripts/run_realdata_drill_torch.py',\n"
        "             'scripts/run_fullprotocol_gate_torch.py'):\n"
        "    spec = importlib.util.spec_from_file_location('m', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import nerfacc_tpu_torch.datasets.fixtures as f\n"
        "assert 'nerfacc_tpu_torch.data_io' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'nerfacc_tpu',\n"
        "              'imageio', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
