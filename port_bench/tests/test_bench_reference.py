"""The benchmark's plain reference held to ``nerfacc_tpu_torch`` on the
CPU at small sizes: the march (grouped probes and the exact lattice),
the field budget, the cull, the re-selection, both fields, the grid
update and Adam. The reference imports neither package; these tests
import both.

Masks and counts must be equal. Floats agree to f32 rounding: the two
sides sum in other orders (rtol 1e-5, atol 1e-6; the table's gradient,
summed over many corners, 1e-5 of its largest entry)."""

import numpy as np
import pytest
import torch

import nerfacc_tpu_torch as nt
from nerfacc_tpu_torch.convert import grid_from_arrays
from nerfacc_tpu_torch.ops.sample_compact import compact_live_slots
from nerfacc_tpu_torch.ray_marching import march_rays, reselect_visible
from nerfacc_tpu_torch.vol_rendering import render_visibility_dense
from port_bench.harness import cells
from port_bench.reference import common as ref
from port_bench.tests import small

torch.set_num_threads(1)
AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()),
                               np.asarray(want.detach()), rtol=rtol, atol=atol)


def _grids(radii=(1, 2)):
    binary, occs = small.small_grid_arrays()
    prog = grid_from_arrays(AABB, binary, occs, device="cpu")
    plain = ref.make_grid(torch.tensor(AABB), torch.as_tensor(occs),
                          torch.as_tensor(binary), radii)
    return prog, plain


def _rays(n=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = (torch.rand((n, 3), generator=g) * 2 - 1) * 3.0
    target = (torch.rand((n, 3), generator=g) * 2 - 1) * 0.8
    d = torch.nn.functional.normalize(target - o, dim=-1)
    return o, d


@pytest.mark.parametrize("stride,groups,dilation", [(1, None, 0),
                                                    (16, 64, 2), (8, 32, 1)])
def test_march_matches_the_program(stride, groups, dilation):
    prog, plain = _grids()
    o, d = _rays()
    t_min, t_max = ref.ray_box(o, d, plain.aabb)
    pt_min, pt_max = nt.ray_aabb_intersect(o, d, AABB)
    _close(t_min, pt_min, 0, 0)
    _close(t_max, pt_max, 0, 0)
    kw = dict(step=5e-3, n_lattice=1024, k_slots=32, coarse_stride=stride,
              probe_groups=groups, probe_dilation=dilation)
    s = ref.march(o, d, t_min, t_max, plain, **kw)
    segs = march_rays(o, d, pt_min, pt_max, prog, render_step_size=5e-3,
                      max_samples_per_ray=1024, slots_per_ray=32,
                      coarse_stride=stride, probe_groups=groups,
                      probe_dilation=max(dilation, 1))
    assert torch.equal(s.masks, segs.masks)
    assert int(s.masks.sum()) > 0
    m = s.masks
    for a, b in ((s.t_starts, segs.t_starts), (s.t_ends, segs.t_ends),
                 (s.deltas, segs.deltas)):
        _close(a[m], b[m])


def test_budget_cull_and_reselection_match_the_program():
    g = torch.Generator().manual_seed(3)
    masks = torch.rand((40, 24), generator=g) < 0.6
    for budget in (200, 400, 10_000):
        keep = ref.budget_keep(masks, budget)
        assert torch.equal(keep, compact_live_slots(masks, budget)[3])
    sig = torch.rand((40, 24), generator=g) * 40
    deltas = torch.rand((40, 24), generator=g) * 0.02
    alphas = 1.0 - torch.exp(-sig * deltas)
    assert torch.equal(ref.visible(sig, deltas, masks),
                       render_visibility_dense(alphas, masks))
    ts = torch.cumsum(torch.rand((40, 24), generator=g) * 0.01, 1)
    s = ref.Samples(ts, ts + 0.005, deltas, masks)
    got = ref.reselect(s, 7)
    want = reselect_visible(nt.RaySegments(ts, ts + 0.005, deltas, masks), 7)
    assert torch.equal(got.masks, want.masks)
    _close(got.deltas, want.deltas)
    _close(got.t_starts[got.masks], want.t_starts[want.masks])


@pytest.mark.parametrize("workload", ["instant_ngp.train",
                                      "vanilla_nerf.train"])
def test_fields_match_the_program(workload):
    cell = small.small_cell(workload)
    w = cell.reference.init_weights(cell.config, 5, "cpu")
    field, leaves = cell.program.build(cell.config, w, "cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    plain = cell.reference.Field(cell.config, params)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((300, 3), generator=g) * 2 - 1) * 1.2
    d = torch.nn.functional.normalize(torch.randn((300, 3), generator=g), -1)
    rgb, sigma = field(x, d)
    rgb_r, sigma_r = plain(x, d)
    _close(rgb, rgb_r)
    _close(sigma, sigma_r, atol=1e-5)
    _close(field.query_density(x), plain.density(x), atol=1e-5)
    loss = (rgb * torch.arange(3.0)).sum() + sigma.sum()
    grads = torch.autograd.grad(loss, leaves)
    loss_r = (rgb_r * torch.arange(3.0)).sum() + sigma_r.sum()
    grads_r = torch.autograd.grad(loss_r, plain.leaves())
    for a, b in zip(grads, grads_r):
        scale = float(b.abs().max()) or 1.0
        _close(a / scale, b / scale, 0, 1e-5)


def test_grid_update_matches_the_program():
    cell = small.small_cell("instant_ngp.train")
    w = cell.reference.init_weights(cell.config, 2, "cpu")
    field, _ = cell.program.build(cell.config, w, "cpu")
    prog, plain = _grids(())
    g1 = torch.Generator().manual_seed(9)
    g2 = torch.Generator().manual_seed(9)
    new = nt.update_grid(prog, g1, 300,
                         lambda x: field.query_opacity(x, 5e-3))
    plain_field = cell.reference.Field(cell.config, w)
    new_r = ref.update_grid(plain, plain_field.density, 5e-3, g2)
    _close(new.occs, new_r.occs, 1e-6, 1e-9)
    assert torch.equal(new.binary, new_r.binary)
    assert not torch.equal(new.binary, prog.binary)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(4)
    p = [torch.randn((5, 3), generator=g), torch.randn(7, generator=g)]
    q = [t.clone().requires_grad_(True) for t in p]
    opt = torch.optim.Adam(q, lr=1e-2, eps=1e-15)
    adam = ref.Adam([t.clone() for t in p], 1e-2, 1e-15)
    for _ in range(3):
        grads = [torch.randn(t.shape, generator=g) for t in p]
        for t, gr in zip(q, grads):
            t.grad = gr.clone()
        opt.step()
        adam.step(grads)
    for a, b in zip(adam.params, q):
        _close(a, b)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12), 3.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, -1.0, 3.0])
    assert torch.equal(ref.round_tf32(x), want)


def test_the_reference_imports_neither_package():
    import ast
    from pathlib import Path

    root = Path(ref.__file__).parent
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "nerfacc_tpu_torch", "nerfacc_tpu", "jax", "port_bench"), (
                    path, name)


def test_configs_name_what_the_cells_run():
    bench = cells.benchmark()
    for entry in bench["configs"]:
        cfg = cells.load(next(w["name"] for w in bench["workloads"]
                              if w["config"] == entry["name"])).config
        assert cfg["name"] == entry["name"]
        assert cfg["reduced"] == entry["reduced"] == []
        assert cfg["source"] == entry["source"]
