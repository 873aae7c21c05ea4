"""The port's spans and counters (``nerfacc_tpu_torch.tracing``) on the CPU.

With no profiler recording, the entry points enter no
``record_function`` and count nothing. Under ``torch.profiler`` (CPU
activity) the chrome trace holds every ``nerfacc.*`` span nested as
``tracing``'s docstring lists them, on the two-stage path with a field
budget and on the dense single-stage path; the outputs are bit-equal with
and without the profiler; the counters equal counts taken apart from
them. Port only: no JAX.
"""

import copy
import json

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import (
    render_image,
    render_rays,
    tracing,
    train_step,
    update_grid,
)
from nerfacc_tpu_torch.convert import grid_from_arrays
from nerfacc_tpu_torch.models import NGPRadianceField, VanillaNeRFRadianceField

torch.set_num_threads(1)

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
N_RAYS = 64
BASE = dict(scene_aabb=AABB, render_step_size=1e-2, max_samples_per_ray=512,
            samples_budget=N_RAYS * 24)
PATHS = {
    # the NGP step's: probes, ray compaction, two stages, field budgets
    "two_stage": dict(BASE, coarse_stride=8, probe_dilation=1,
                      probe_groups=16, compact_rays_fraction=0.75,
                      visible_samples_budget=N_RAYS * 12,
                      field_samples_budget=N_RAYS * 12),
    # vanilla NeRF's: the exact march, one dense field pass
    "dense": dict(BASE),
}
RENDER = ["march", "field", "cull", "composite"]
CHILDREN = {
    "two_stage": {"train_step": ["optimizer", "render", "loss", "backward",
                                 "optimizer"],
                  "render": ["march", "density_pass", "cull", "field",
                             "composite"],
                  "density_pass": ["encoder"], "field": ["encoder"]},
    "dense": {"train_step": ["optimizer", "render", "loss", "backward",
                             "optimizer"],
              "render": RENDER, "field": ["encoder", "encoder"]},
}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    binary = np.zeros((32, 32, 32), bool)
    binary[6:26, 6:26, 6:26] = rng.rand(20, 20, 20) < 0.5
    grid = grid_from_arrays(AABB, binary, device="cpu")
    o = rng.randn(N_RAYS, 3)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(N_RAYS, 3) * 0.8
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = tuple(torch.as_tensor(a, dtype=torch.float32)
                 for a in (o, d, rng.rand(N_RAYS, 3)))
    fields = {
        "two_stage": NGPRadianceField(
            aabb=AABB, n_levels=4, log2_hashmap_size=13, device="cpu",
            generator=torch.Generator().manual_seed(1)),
        "dense": VanillaNeRFRadianceField(
            net_depth=4, net_width=32, skip_layer=2, net_width_condition=16,
            generator=torch.Generator().manual_seed(2), device="cpu"),
    }
    return grid, rays, fields


def _step(field, grid, rays, kw):
    field = copy.deepcopy(field)
    opt = torch.optim.Adam(field.parameters(), lr=1e-2)
    loss, n = train_step(field, opt, grid, *rays,
                         key=torch.Generator().manual_seed(3),
                         stratified=True, **kw)
    return [loss, n] + [p.detach() for p in field.parameters()]


def _occ(field):
    return lambda x: field.query_opacity(x, 1e-2)


ENTRIES = {
    "train_step": lambda f, g, r, kw: _step(f, g, r, kw),
    "render_rays": lambda f, g, r, kw: list(render_rays(
        f, r[0], r[1], grid=g, **kw)),
    "render_image": lambda f, g, r, kw: list(render_image(
        f, r[0], r[1], grid=g, test_chunk_size=24, eval_samples_per_ray=16,
        eval_visible_samples_per_ray=8,
        **dict(kw, samples_budget=None))),
    "update_grid": lambda f, g, r, kw: [update_grid(
        g, torch.Generator().manual_seed(4), 300, _occ(f)).occs],
}


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _spans(prof, tmp_path):
    """The nerfacc spans of the trace: (name, parent name) in start
    order, nested by interval on their thread."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation"
                 and e["name"].startswith(tracing.PREFIX)),
                key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for e in ev:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        out.append((e["name"][len(tracing.PREFIX):],
                    stack[-1]["name"][len(tracing.PREFIX):]
                    if stack else None))
        stack.append(e)
    return out


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_tracing_off_enters_no_span_and_counts_nothing(scene, monkeypatch,
                                                       entry):
    grid, rays, fields = scene
    entered = []
    real = torch.profiler.record_function

    def counting(*args, **kw):
        entered.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    tracing.reset()
    assert not tracing.enabled()
    ENTRIES[entry](fields["two_stage"], grid, rays, PATHS["two_stage"])
    tracing.count("rays", 5)
    assert entered == [] and tracing.snapshot() == {}


@pytest.mark.parametrize("path", list(PATHS))
def test_train_step_spans_nest_as_listed(scene, tmp_path, path):
    grid, rays, fields = scene
    _, prof = _profiled(lambda: _step(fields[path], grid, rays, PATHS[path]))
    got = _spans(prof, tmp_path)
    children = {}
    for name, parent in got:
        children.setdefault(parent, []).append(name)
    assert children.pop(None) == ["train_step"]
    assert children == CHILDREN[path]


@pytest.mark.parametrize("entry,root,kids", [
    ("render_image", "render_image", ["render"] * 3),
    ("update_grid", "update_grid", ["encoder"]),
])
def test_view_and_grid_spans_nest_as_listed(scene, tmp_path, entry, root,
                                            kids):
    grid, rays, fields = scene
    kw = dict(PATHS["dense"], visible_samples_budget=1)
    _, prof = _profiled(lambda: ENTRIES[entry](fields["two_stage"], grid,
                                              rays, kw))
    got = _spans(prof, tmp_path)
    assert [n for n, p in got if p is None] == [root]
    assert [n for n, p in got if p == root] == kids
    if entry == "render_image":  # the view's dense two-stage chunks
        assert [n for n, p in got if p == "render"] == [
            "march", "density_pass", "cull", "field", "composite"] * 3


@pytest.mark.parametrize("entry,path", [
    ("train_step", "two_stage"), ("train_step", "dense"),
    ("render_image", "dense"), ("update_grid", "two_stage"),
])
def test_outputs_are_bit_equal_under_the_profiler(scene, entry, path):
    grid, rays, fields = scene
    args = (fields[path], grid, rays, PATHS[path])
    plain = ENTRIES[entry](*args)
    traced, _ = _profiled(lambda: ENTRIES[entry](*args))
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def _counted(fn):
    tracing.reset()
    out, _ = _profiled(fn)
    counts = tracing.snapshot()
    tracing.reset()
    return out, counts


@pytest.mark.parametrize("path", list(PATHS))
def test_counters_equal_independent_counts(scene, path):
    grid, rays, fields = scene
    field, kw = fields[path], dict(PATHS[path], return_extras=True)
    o, d, _ = rays
    with torch.no_grad():
        (colors, _, _, n, extras), c = _counted(
            lambda: render_rays(field, o, d, grid=grid, **kw))
        # the march alone: no cull, no budget, every live slot composited
        bare = dict(kw, visible_samples_budget=None,
                    field_samples_budget=None, prefilter_sigma=False)
        march = render_rays(field, o, d, grid=grid, **bare)
        sel = render_rays(field, o, d, grid=grid, return_compact=True,
                          **bare)[4]
    n_rays = int(sel["ray_ok"].shape[0])
    k = -(-kw["samples_budget"] // n_rays)
    assert c["rays"] == N_RAYS
    assert c["rays_hit"] == int(sel["ray_ok"].sum())
    assert c["march_live"] == int(march[3]) > 0
    assert c["field_live"] == int(n) > 0
    if path == "two_stage":
        assert c["rays_hit"] < N_RAYS
        k2 = -(-kw["visible_samples_budget"] // n_rays)
        assert c["density_rows"] == min(kw["field_samples_budget"],
                                        n_rays * k)
        assert c["density_live"] == min(c["march_live"], c["density_rows"])
        assert c["field_rows"] == min(kw["field_samples_budget"],
                                      n_rays * k2)
        assert c["field_budget_dropped"] == int(
            extras["field_budget_dropped"])
    else:
        assert c["rays_hit"] == N_RAYS
        assert "density_rows" not in c and "field_budget_dropped" not in c
        assert c["field_rows"] == N_RAYS * k
    assert c["field_live"] <= c["march_live"] <= c.get(
        "density_rows", c["field_rows"])


def test_view_counts_its_dense_density_pass(scene):
    grid, rays, fields = scene
    kw = dict(PATHS["dense"], visible_samples_budget=1)
    _, c = _counted(lambda: ENTRIES["render_image"](
        fields["two_stage"], grid, rays, kw))
    # three chunks of 24 rays and 16 slots; the visible budget 8 a ray
    assert c["rays"] == 72 and c["density_rows"] == 72 * 16
    assert c["field_rows"] == 72 * 8
    assert c["density_live"] == c["march_live"] > c["field_live"] > 0


def test_grid_update_counts_its_cells(scene):
    grid, rays, fields = scene
    _, c = _counted(lambda: ENTRIES["update_grid"](fields["two_stage"], grid,
                                                   rays, None))
    # every cell through the NGP field's encoder, on the CPU's plain path
    cells = 2 * (grid.num_cells // 4)
    assert c == {"grid_cells": cells, "encoder_rows": cells}


@pytest.mark.parametrize("path", list(PATHS))
def test_encoder_counts_its_rows(scene, path):
    # the NGP field's hash encoder counts each row of both queries; on the
    # CPU no row goes through the kernel. The MLP field has no hash encoder
    grid, rays, fields = scene
    field = fields["two_stage"] if path == "two_stage" else fields["dense"]
    with torch.no_grad():
        _, c = _counted(lambda: render_rays(field, rays[0], rays[1],
                                            grid=grid, **PATHS[path]))
    assert "encoder_kernel_rows" not in c
    if path == "two_stage":
        assert c["encoder_rows"] == c["density_rows"] + c["field_rows"] > 0
    else:
        assert "encoder_rows" not in c


@pytest.mark.parametrize("value", [7, torch.tensor(7)])
def test_reset_zeroes_the_totals(value):
    tracing.reset()
    _profiled(lambda: tracing.count("rays", value))
    assert tracing.snapshot() == {"rays": 7}
    tracing.reset()
    assert tracing.snapshot() == {}
