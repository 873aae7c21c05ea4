"""The exact stride-1 march's kernel (``ops.march_select.march_dense``) as
far as the CPU reaches it: ``march_dense_plain``, the statement of the
kernel's algorithm (live bits a chunk of lattice points at a time, ranks
by count, the scatter of every rank the stride divides into its slot,
slots assembled a tile at a time), bit-equal to ``march_rays``' plain
chain; ``march_rays``' routing to the wrapper; the wrapper's refusals, its
launch against a stand-in for the library, and the ``march_kernel_rays``
counter. Port only: no JAX. The kernel itself is held to the chain on
the card (``tests/test_torch_cuda.py``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import _build, ray_aabb_intersect, render_rays, tracing
from nerfacc_tpu_torch.contraction import ContractionType
from nerfacc_tpu_torch.convert import grid_from_arrays
from nerfacc_tpu_torch.models import VanillaNeRFRadianceField
from nerfacc_tpu_torch.ops import march_dense, march_dense_plain
from nerfacc_tpu_torch.ops import march_select
from nerfacc_tpu_torch.ray_marching import march_rays

torch.set_num_threads(1)

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
STEP = 1e-2


def _scene(seed, n=96, res=32):
    """A grid with an occupied core and an empty shell, and rays at it:
    random rays through the box, rays that miss it (t_min = t_max = 1e10),
    rays that cross the empty shell only, and ``render_image``'s pad ray
    (the origin along (1, 1, 1) / sqrt(3))."""
    rng = np.random.RandomState(seed)
    binary = np.zeros((res,) * 3, bool)
    lo, hi = res // 4, 3 * res // 4
    binary[lo:hi, lo:hi, lo:hi] = rng.rand(hi - lo, hi - lo, hi - lo) < 0.6
    grid = grid_from_arrays(AABB, binary, device="cpu")
    o = rng.randn(n, 3)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 0.6
    # misses: pointing away from the box
    d[:6] = o[:6]
    # the empty shell only: skimming a face of the box
    o[6:10] = [[-2.0, 0.95, 0.95], [0.97, -2.0, -0.96], [0.9, 0.9, 3.0],
               [-0.96, 2.0, 0.0]]
    d[6:10] = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0],
               [0.0, -1.0, 0.0]]
    o[10] = 0.0
    d[10] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.as_tensor(a, dtype=torch.float32) for a in (o, d))
    t_min, t_max = ray_aabb_intersect(o, d, AABB)
    return o, d, t_min, t_max, grid


def _quad(segs):
    return segs.t_starts, segs.t_ends, segs.deltas, segs.masks


def _chain(o, d, t_min, t_max, grid, *, S, K, cone):
    return _quad(march_rays(o, d, t_min, t_max, grid, render_step_size=STEP,
                            cone_angle=cone, max_samples_per_ray=S,
                            slots_per_ray=K))


def _assert_bit_equal(got, want):
    for name, a, b in zip(("t_starts", "t_ends", "deltas", "masks"), got,
                          want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("K", [8, 64, 256])
@pytest.mark.parametrize("cone", [0.0, 0.004])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_statement_is_bit_equal_to_the_chain(seed, cone, K):
    o, d, t_min, t_max, grid = _scene(seed)
    S = 512
    want = _chain(o, d, t_min, t_max, grid, S=S, K=K, cone=cone)
    got = march_dense_plain(o, d, t_min, t_max, grid, k_slots=K,
                            max_samples=S, step_size=STEP, cone_angle=cone)
    _assert_bit_equal(got, want)
    # the rows the case is for: misses and the empty shell have no live
    # point; some rows have more live points than slots (decimated: a
    # slot's width spans its group), some fewer
    live = want[3].sum(dim=1)
    assert not bool(live[:10].any())
    decimated = (want[3] & (want[2] > (want[1] - want[0]) * 1.5)).any(dim=1)
    assert bool(decimated.any()) == (K < 256)
    assert bool(((live > 0) & ~decimated & (live < K)).any())
    # slots past the last target: position S - 1, width 0
    dead = ~want[3]
    assert bool((got[2][dead] == 0).all())


@pytest.mark.parametrize("chunk,tile", [(1024, 128), (96, 7), (32, 1),
                                        (64, 200)])
def test_plain_statement_walks_chunks_and_tiles(chunk, tile):
    # rows longer than a chunk and more slots than a tile: the count over
    # every chunk first, then each tile's walk with the rank carried
    o, d, t_min, t_max, grid = _scene(3, n=40)
    for S, K, cone in ((512, 200, 0.0), (384, 24, 0.004), (256, 256, 0.0)):
        want = _chain(o, d, t_min, t_max, grid, S=S, K=K, cone=cone)
        got = march_dense_plain(o, d, t_min, t_max, grid, k_slots=K,
                                max_samples=S, step_size=STEP,
                                cone_angle=cone, chunk=chunk, tile=tile)
        _assert_bit_equal(got, want)


def test_plain_statement_at_a_truncated_lattice():
    # S below the points in range: k_in is clamped to S, as in the chain
    o, d, t_min, t_max, grid = _scene(4, n=32)
    want = _chain(o, d, t_min, t_max, grid, S=64, K=16, cone=0.0)
    got = march_dense_plain(o, d, t_min, t_max, grid, k_slots=16,
                            max_samples=64, step_size=STEP)
    _assert_bit_equal(got, want)


def _spy(monkeypatch):
    calls = []
    wrapped = march_select.march_dense

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return wrapped(*args, **kw)

    monkeypatch.setattr(march_select, "march_dense", spy)
    return calls


@pytest.mark.parametrize("case,reached", [
    ("use_pallas", True), ("default", False), ("use_pallas False", False),
    ("coarse_stride 8", False), ("unbounded grid", False),
    ("no grid", False),
])
def test_march_rays_routes_to_the_kernel_only_where_it_applies(
        monkeypatch, case, reached):
    o, d, t_min, t_max, grid = _scene(5, n=48)
    kw = dict(render_step_size=STEP, max_samples_per_ray=512,
              slots_per_ray=32)
    use_pallas = {"default": None, "use_pallas False": False}.get(case, True)
    if case == "coarse_stride 8":
        kw.update(coarse_stride=8, probe_groups=16)
    if case == "unbounded grid":
        grid = dataclasses.replace(
            grid, contraction_type=ContractionType.UN_BOUNDED_SPHERE)
    if case == "no grid":
        grid = None
    calls = _spy(monkeypatch)
    got = _quad(march_rays(o, d, t_min, t_max, grid, use_pallas=use_pallas,
                           **kw))
    assert calls == ([48] if reached else [])
    want = _quad(march_rays(o, d, t_min, t_max, grid, use_pallas=None,
                            **kw))
    # on CPU tensors the wrapper runs its plain twin: the same bits
    _assert_bit_equal(got, want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    o, d, t_min, t_max, grid = _scene(6, n=16)
    kw = dict(step_size=STEP, max_samples=64)
    sphere = dataclasses.replace(
        grid, contraction_type=ContractionType.UN_BOUNDED_SPHERE)
    with pytest.raises(ValueError, match="AABB"):
        march_dense(o, d, t_min, t_max, sphere, k_slots=8, **kw)
    for k_slots in (0, 65):
        with pytest.raises(ValueError, match="k_slots"):
            march_dense(o, d, t_min, t_max, grid, k_slots=k_slots, **kw)


def _on_meta(grid, *tensors):
    """The tensors and the grid's on the meta device: a device that is
    not the CPU, so the wrapper takes its kernel's branch."""
    meta = torch.device("meta")
    grid = dataclasses.replace(grid, roi_aabb=grid.roi_aabb.to(meta),
                               binary=grid.binary.to(meta))
    return grid, [t.to(meta) for t in tensors]


@pytest.fixture
def stand_in(monkeypatch):
    """``_build``'s pointer check without its device test and a launch
    that records its arguments (no library, no CUDA runtime)."""
    launches = []

    def cuda_ptr(kernel, name, t, dtype, shape, device):
        if t.device != device:
            raise ValueError(f"{kernel}: {name} on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}")
        if t.shape != shape:
            raise ValueError(f"{kernel}: {name} must have shape {shape}")
        return 0

    monkeypatch.setattr(_build, "cuda_ptr", cuda_ptr)
    monkeypatch.setattr(_build, "launch",
                        lambda *args: launches.append(args))
    return launches


def _profiled(fn):
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    counts = tracing.snapshot()
    tracing.reset()
    return out, counts


@pytest.mark.parametrize("cone", [0.0, 0.004])
def test_wrapper_launches_once_and_counts_its_rays(stand_in, cone):
    o, d, t_min, t_max, grid = _scene(7, n=24)
    grid, args = _on_meta(grid, o, d, t_min, t_max)
    n = march_dense.launches
    out, counts = _profiled(lambda: march_dense(
        *args, grid, k_slots=16, max_samples=128, step_size=STEP,
        cone_angle=cone))
    assert march_dense.launches == n + 1
    assert counts == {"march_kernel_rays": 24}
    assert [tuple(t.shape) for t in out] == [(24, 16)] * 4
    assert [t.dtype for t in out] == [torch.float32] * 3 + [torch.bool]
    (kernel, symbol, device, *rest), = stand_in
    assert (kernel, symbol, device) == ("march_dense", "nerfacc_march_dense",
                                        torch.device("meta"))
    # ten pointers, R, S, K, the resolution, then the lattice's constants
    assert rest[10:16] == [24, 128, 16, 32, 32, 32]
    a_lim = STEP / cone if cone else 0.0
    assert rest[16:] == [STEP, cone, 1e10, a_lim, math.log1p(cone)]
    # no profiler: nothing counted
    tracing.reset()
    march_dense(*args, grid, k_slots=16, max_samples=128, step_size=STEP)
    assert tracing.snapshot() == {}


def test_wrapper_checks_its_arguments_before_the_launch(stand_in):
    o, d, t_min, t_max, grid = _scene(8, n=16)
    grid, (o, d, t_min, t_max) = _on_meta(grid, o, d, t_min, t_max)
    kw = dict(k_slots=8, max_samples=64, step_size=STEP)
    with pytest.raises(TypeError):
        march_dense(o.double(), d, t_min, t_max, grid, **kw)
    with pytest.raises(ValueError):
        march_dense(o, d, t_min[:4], t_max, grid, **kw)
    with pytest.raises(TypeError):
        march_dense(o, d, t_min, t_max,
                    dataclasses.replace(grid, binary=grid.binary.float()),
                    **kw)
    assert stand_in == []


def test_cpu_paths_count_no_kernel_rays():
    # the counter sits beside ``rays``: on CPU tensors the twin runs, and
    # no ray is counted as the kernel's
    o, d, _, _, grid = _scene(9, n=32)
    field = VanillaNeRFRadianceField(
        net_depth=2, net_width=16, skip_layer=1, net_width_condition=8,
        generator=torch.Generator().manual_seed(2), device="cpu")
    for use_pallas in (None, True):
        with torch.no_grad():
            _, counts = _profiled(lambda: render_rays(
                field, o, d, grid=grid, scene_aabb=AABB,
                render_step_size=STEP, max_samples_per_ray=512,
                samples_budget=32 * 24, use_pallas=use_pallas))
        assert counts["rays"] == 32
        assert "march_kernel_rays" not in counts
