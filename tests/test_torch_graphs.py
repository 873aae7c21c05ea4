"""The CUDA-graph replay of ``render_rays``' gradient-free stages
(``nerfacc_tpu_torch.graphs``) on the CPU, and the cached constants that
replaced the uploads inside those stages.

CPU tensors never take the graph path. The rest runs the capture and
replay logic against a stand-in for the CUDA runtime: its graphs capture
nothing and replay nothing, so a replay hands out copies of what the
capture's own run computed, which equal a fresh run's wherever the inputs
are the same. With it: the stages with gradients stay eager, and so does
inference mode; the key follows shapes, settings, parameter addresses,
the field's attributes and the matmul precision, and not a new batch or a
new grid; ``forget`` drops what a rebound function would leave stale; a
refused capture falls back and is counted; the spans, counts and kernel
launches of a replay equal the eager path's. The CUDA graphs themselves are
held to the eager path on the card, in ``test_torch_cuda.py``. Port only:
no JAX.
"""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import graphs, render_image, render_rays, tracing
from nerfacc_tpu_torch import train_step
from nerfacc_tpu_torch._consts import constant
from nerfacc_tpu_torch.contraction import ContractionType
from nerfacc_tpu_torch.convert import grid_from_arrays
from nerfacc_tpu_torch.grid import _cell_index, with_binary
from nerfacc_tpu_torch.intersection import ray_aabb_intersect
from nerfacc_tpu_torch.models import NGPRadianceField
from nerfacc_tpu_torch.models.encoders import SinusoidalEncoder
from nerfacc_tpu_torch.ray_marching import _div, _rdiv
from nerfacc_tpu_torch.utils import _all_stages, _gradient_free_stages

torch.set_num_threads(1)

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
N_RAYS = 48
# the NGP step's path at test size: probes, ray compaction, two stages,
# field budgets
TRAIN_KW = dict(scene_aabb=AABB, render_step_size=1e-2,
                max_samples_per_ray=256, samples_budget=N_RAYS * 16,
                coarse_stride=8, probe_dilation=1, probe_groups=16,
                compact_rays_fraction=0.75,
                visible_samples_budget=N_RAYS * 8,
                field_samples_budget=N_RAYS * 8)
# the view's: the exact march, a dense two-stage render
VIEW_KW = dict(scene_aabb=AABB, render_step_size=1e-2,
               max_samples_per_ray=256, test_chunk_size=32,
               eval_samples_per_ray=16, eval_visible_samples_per_ray=8,
               visible_samples_budget=1)


class StandInGraph:
    """Captures nothing, replays nothing; ``refuse`` raises as the runtime
    does at a capture it cannot take."""

    def __init__(self, log, refuse):
        self.log, self.refuse = log, refuse

    def capture_begin(self, pool=None):
        if self.refuse:
            raise RuntimeError("stand-in: capture refused")
        self.log.append("begin")

    def capture_end(self):
        self.log.append("end")

    def replay(self):
        self.log.append("replay")


class StandInRuntime:
    """The CUDA runtime's part in a capture, on the CPU, once ``on``."""

    def __init__(self):
        self.on, self.refuse, self.log, self.abandons = False, False, [], 0

    def usable(self, device):
        return True

    def graph(self):
        return StandInGraph(self.log, self.refuse)

    def pool(self, device):
        return (0, 0)

    def on_side_stream(self, device):
        return contextlib.nullcontext()

    def strict(self):
        return contextlib.nullcontext()

    def abandoned(self, device, pool):
        self.abandons += 1


@pytest.fixture
def stand_in(monkeypatch):
    """The stand-in runtime; once it is ``on``, CPU tensors are taken as
    the card's."""
    runtime = StandInRuntime()
    monkeypatch.setattr(graphs, "_runtime", runtime)
    monkeypatch.setattr(graphs, "_device", lambda leaves: (
        torch.device("cpu") if runtime.on else None))
    monkeypatch.setattr(graphs, "stats", {"captures": 0, "fallbacks": 0})
    return runtime


@pytest.fixture
def scene():
    rng = np.random.RandomState(0)
    binary = np.zeros((32, 32, 32), bool)
    binary[6:26, 6:26, 6:26] = rng.rand(20, 20, 20) < 0.5
    grid = grid_from_arrays(AABB, binary, device="cpu")
    field = NGPRadianceField(aabb=AABB, n_levels=4, log2_hashmap_size=12,
                             device="cpu",
                             generator=torch.Generator().manual_seed(1))
    return grid, field


def _rays(seed, n=N_RAYS):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.randn(n, 3) * 0.8
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tuple(torch.as_tensor(a, dtype=torch.float32)
                 for a in (o, d, rng.rand(n, 3)))


def _step(field, grid, rays, seed=3, **kw):
    """One train step from a copy of ``field``: loss, live samples, the
    gradients and the weights after."""
    opt = torch.optim.Adam(field.parameters(), lr=1e-2)
    loss, n = train_step(field, opt, grid, *rays,
                         key=torch.Generator().manual_seed(seed),
                         stratified=True, **dict(TRAIN_KW, **kw))
    return ([loss, n] + [p.grad.clone() for p in field.parameters()]
            + [p.detach().clone() for p in field.parameters()])


def _view_rays(seed):
    """Two chunks of the same 32 rays: a stand-in replay of the second
    hands out what the capture computed for the first, which equals it."""
    return tuple(torch.cat([t, t]) for t in _rays(seed, n=32))


def _view(field, grid, rays):
    with torch.no_grad():
        return list(render_image(field, rays[0], rays[1], grid=grid,
                                 **VIEW_KW))


def _site(field, fn):
    return graphs._sites.get(field, {}).get(fn)


def _profiled(fn):
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    counts = tracing.snapshot()
    tracing.reset()
    return out, counts


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["step", "view"])
def test_cpu_tensors_never_take_the_graph_path(scene, entry):
    grid, field = scene
    before = dict(graphs.stats)
    run = ((lambda: _step(copy.deepcopy(field), grid, _rays(1)))
           if entry == "step" else (lambda: _view(field, grid, _rays(1))))
    _, counts = _profiled(run)
    assert counts["rays"] > 0 and counts.get("graph_rays", 0) == 0
    assert "graph_captures" not in counts
    assert graphs.stats == before and field not in graphs._sites


def test_the_train_step_graphs_only_its_gradient_free_stages(scene,
                                                             stand_in):
    grid, field = scene
    rays = _rays(1)
    want = _step(copy.deepcopy(field), grid, rays)
    stand_in.on = True
    graphed = copy.deepcopy(field)
    got = _step(graphed, grid, rays)
    _equal(got, want)
    assert graphs.stats == {"captures": 1, "fallbacks": 0}
    assert _site(graphed, _all_stages) is None
    (entry,) = _site(graphed, _gradient_free_stages).values()
    spans = [e[1] for e in entry.events if e[0] == "enter"]
    assert spans == ["march", "density_pass", "encoder", "cull"]
    # the field's query and the composite took gradients eagerly
    assert all(p.grad is not None for p in graphed.parameters())


def test_a_view_graphs_every_stage(scene, stand_in):
    grid, field = scene
    rays = _view_rays(2)
    want = _view(field, grid, rays)
    stand_in.on = True
    _equal(_view(field, grid, rays), want)
    (entry,) = _site(field, _all_stages).values()
    spans = [e[1] for e in entry.events if e[0] == "enter"]
    assert spans == ["march", "density_pass", "encoder", "cull", "field",
                     "encoder", "composite"]
    # every cut between two spans ended one graph and began the next
    assert stand_in.log.count("begin") == stand_in.log.count("end")
    # two chunks: the first runs and captures, the second replays
    assert graphs.stats["captures"] == 1
    assert stand_in.log.count("replay") == stand_in.log.count("end")
    assert entry.events.count(("enter", "composite")) == 1


def test_a_replay_hands_out_copies_of_the_capture_outputs(scene, stand_in):
    grid, field = scene
    o, d, _ = _rays(3)
    stand_in.on = True
    with torch.no_grad():
        first = render_rays(field, o, d, grid=grid, scene_aabb=AABB,
                            render_step_size=1e-2)
        again = render_rays(field, o, d, grid=grid, scene_aabb=AABB,
                            render_step_size=1e-2)
    (entry,) = _site(field, _all_stages).values()
    for a, b, static in zip(first, again, entry.outputs):
        assert torch.equal(a, b) and torch.equal(a, static)
        assert a.data_ptr() != static.data_ptr() != b.data_ptr()


def test_the_key_follows_shapes_settings_and_parameters(scene, stand_in):
    grid, field = scene
    stand_in.on = True

    def render(rays, grid=grid, **kw):
        with torch.no_grad():
            render_rays(field, rays[0], rays[1], grid=grid,
                        **dict(dict(scene_aabb=AABB, render_step_size=1e-2),
                               **kw))
        return graphs.stats["captures"]

    site = lambda: _site(field, _all_stages)  # noqa: E731
    assert render(_rays(4)) == 1
    (entry,) = site().values()
    b = _rays(5)
    # a new batch of the same shapes, and a new grid object: the same key,
    # with the new batch copied into the capture's inputs
    assert render(b) == 1 and torch.equal(entry.inputs[0], b[0])
    new_grid = with_binary(grid, ~grid.binary)
    assert render(b, grid=new_grid) == 1
    assert torch.equal(entry.inputs[4], new_grid.binary)
    assert render(b, grid=dataclasses.replace(grid)) == 1
    # the shapes, a setting, a replaced parameter: new keys
    assert render(_rays(4, n=N_RAYS + 1)) == 2
    assert render(b, render_step_size=2e-2) == 3
    layer = field.mlp_base.layers[0]
    layer.weight = torch.nn.Parameter(layer.weight.detach().clone())
    assert render(b) == 4
    assert len(site()) == 4


@pytest.mark.parametrize("change", ["mode", "gather_mode", "precision"])
def test_the_key_follows_the_fields_attributes_and_the_precision(
        scene, stand_in, change):
    grid, field = scene
    o, d, _ = _rays(14)
    stand_in.on = True

    def view():
        with torch.no_grad():
            render_rays(field, o, d, grid=grid, scene_aabb=AABB,
                        render_step_size=1e-2)
        return graphs.stats["captures"]

    precision = torch.get_float32_matmul_precision()
    assert view() == 1
    try:
        if change == "mode":
            field.eval()
        elif change == "gather_mode":
            field.encoder.gather_mode = "per_level"
        else:
            torch.set_float32_matmul_precision(
                "high" if precision == "highest" else "highest")
        assert (view(), view()) == (2, 2)
    finally:
        torch.set_float32_matmul_precision(precision)


def test_forget_drops_the_captures(scene, stand_in):
    grid, field = scene
    other = copy.deepcopy(field)
    o, d, _ = _rays(15)
    stand_in.on = True

    def view(f):
        with torch.no_grad():
            render_rays(f, o, d, grid=grid, scene_aabb=AABB,
                        render_step_size=1e-2)
        return graphs.stats["captures"]

    assert (view(field), view(other), view(field)) == (1, 2, 2)
    graphs.forget(field)
    assert field not in graphs._sites and other in graphs._sites
    assert (view(field), view(other)) == (3, 3)
    graphs.forget()
    assert len(graphs._sites) == 0 and view(other) == 4


@pytest.mark.parametrize("how", ["inference_mode", "inference_tensor"])
def test_inference_runs_eagerly(scene, stand_in, how):
    grid, field = scene
    o, d, _ = _rays(16)
    kw = dict(grid=grid, scene_aabb=AABB, render_step_size=1e-2)
    with torch.no_grad():
        want = render_rays(field, o, d, **kw)
    stand_in.on = True
    if how == "inference_mode":
        with torch.inference_mode():
            got = render_rays(field, o, d, **kw)
    else:
        with torch.inference_mode():
            oi, di = o.clone(), d.clone()
        with torch.no_grad():
            got = render_rays(field, oi, di, **kw)
    _equal(got, want)
    assert graphs.stats["captures"] == 0 and _site(field, _all_stages) is None
    # the same key outside inference captures, and replays
    for _ in range(2):
        with torch.no_grad():
            _equal(render_rays(field, o, d, **kw), want)
    assert graphs.stats["captures"] == 1


def test_each_call_counts_the_kernel_launches_of_the_eager_path(
        scene, stand_in, monkeypatch):
    """A kernel launched in the stages counts once a call: in the first
    run, not in the capture, and at each replay from the capture's
    tally."""
    from nerfacc_tpu_torch import utils

    grid, field = scene
    o, d, _ = _rays(17)
    kernel = type("StandInWrapper", (), {"launches": 0})()
    real = utils._march

    def march(*args):
        kernel.launches += 1
        return real(*args)

    monkeypatch.setattr(utils, "_march", march)
    monkeypatch.setattr(graphs, "_launch_counters", lambda: [kernel])
    counts, replays = [], []
    for on in (False, True, True, True):  # eager, capture, two replays
        stand_in.on = on
        with torch.no_grad():
            render_rays(field, o, d, grid=grid, scene_aabb=AABB,
                        render_step_size=1e-2)
        counts.append(kernel.launches)
        replays.append(stand_in.log.count("replay"))
    assert counts == [1, 2, 3, 4] and graphs.stats["captures"] == 1
    (entry,) = _site(field, _all_stages).values()
    assert entry.launches == [(kernel, 1)]
    # the first run's outputs are the capture call's: it replays nothing
    graphs_a_call = len(entry.graphs)
    assert replays == [0, 0, graphs_a_call, 2 * graphs_a_call]


def test_an_argument_that_cannot_be_keyed_runs_eagerly(scene, stand_in):
    grid, field = scene
    o, d, _ = _rays(13)
    kw = dict(grid=grid, render_step_size=1e-2)
    with torch.no_grad():
        want = render_rays(field, o, d, scene_aabb=AABB, **kw)
        stand_in.on = True
        got = render_rays(field, o, d, scene_aabb=np.array(AABB), **kw)
    _equal(got, want)
    assert graphs.stats["captures"] == 0 and _site(field, _all_stages) is None


def test_the_cache_stays_small(scene, stand_in, monkeypatch):
    grid, field = scene
    monkeypatch.setattr(graphs, "ENTRIES", 2)
    stand_in.on = True
    for n in range(5):
        o, d, _ = _rays(6, n=8 + n)
        with torch.no_grad():
            render_rays(field, o, d, grid=grid, scene_aabb=AABB,
                        render_step_size=1e-2)
    assert len(_site(field, _all_stages)) == 2
    assert graphs.stats["captures"] == 5


def test_a_refused_capture_falls_back_and_is_counted(scene, stand_in):
    grid, field = scene
    rays = _view_rays(7)
    want = _view(field, grid, rays)
    stand_in.on = stand_in.refuse = True
    with pytest.warns(RuntimeWarning, match="capture raised"):
        got = _view(field, grid, rays)
    _equal(got, want)
    assert graphs.stats == {"captures": 0, "fallbacks": 1}
    (entry,) = _site(field, _all_stages).values()
    assert entry is None
    # the key stays eager: a later call neither captures nor replays
    _, counts = _profiled(lambda: _view(field, grid, rays))
    assert graphs.stats == {"captures": 0, "fallbacks": 1}
    assert counts["graph_fallbacks"] == counts["graph_captures"] + 2 == 2
    assert counts.get("graph_rays", 0) == 0 and "replay" not in stand_in.log


def test_a_capture_that_raises_mid_graph_is_abandoned(scene, stand_in,
                                                      monkeypatch):
    grid, field = scene
    real = graphs._Recorder.span

    def failing(self, name):
        if name == "cull":
            raise RuntimeError("stand-in: a synchronisation while capturing")
        return real(self, name)

    rays = _view_rays(8)
    want = _view(field, grid, rays)
    monkeypatch.setattr(graphs._Recorder, "span", failing)
    stand_in.on = True
    with pytest.warns(RuntimeWarning, match="synchronisation"):
        _equal(_view(field, grid, rays), want)
    assert graphs.stats["fallbacks"] == 1 and stand_in.abandons == 1


@pytest.mark.parametrize("entry", ["step", "view"])
def test_no_capture_is_made_under_the_profiler(scene, stand_in, entry):
    grid, field = scene
    rays = _rays(9)
    stand_in.on = True
    run = ((lambda: _step(copy.deepcopy(field), grid, rays))
           if entry == "step" else (lambda: _view(field, grid, rays)))
    _, counts = _profiled(run)
    assert graphs.stats["captures"] == 0 and "begin" not in stand_in.log
    assert counts.get("graph_rays", 0) == 0


@pytest.mark.parametrize("entry", ["step", "view"])
def test_a_replay_counts_what_the_eager_path_counts(scene, stand_in, entry):
    grid, field = scene
    rays = _rays(10) if entry == "step" else _view_rays(10)
    trained = copy.deepcopy(field)
    run = ((lambda: _step(trained, grid, rays))
           if entry == "step" else (lambda: _view(field, grid, rays)))
    want, eager = _profiled(run)
    stand_in.on = True
    for profiled in (False, True):  # the capture, then a replay
        if entry == "step":  # each from the weights the eager run had
            trained.load_state_dict(field.state_dict())
        got, replayed = _profiled(run) if profiled else (run(), None)
    assert graphs.stats["captures"] == 1
    _equal(got, want)
    assert replayed.pop("graph_rays") == eager["rays"]
    assert replayed.pop("graph_captures") == replayed.pop(
        "graph_fallbacks") == 0
    assert replayed == eager


def test_the_stratified_jitter_is_the_eager_paths(scene, stand_in):
    """Each step, captured or replayed, draws its jitter from the caller's
    generator before the graphs, as many uniforms as the eager path: the
    generators stand where the eager steps left theirs."""
    grid, field = scene
    rays = _rays(11)
    gens = []
    for on in (False, True):
        stand_in.on = on
        gen = torch.Generator().manual_seed(5)
        trained = copy.deepcopy(field)
        opt = torch.optim.Adam(trained.parameters(), lr=1e-2)
        for _ in range(3):
            train_step(trained, opt, grid, *rays, key=gen, stratified=True,
                       **TRAIN_KW)
        gens.append(gen)
    assert graphs.stats["captures"] == 1
    assert torch.equal(torch.rand(64, generator=gens[0]),
                       torch.rand(64, generator=gens[1]))


@pytest.mark.parametrize("value", [5e-3, 1e-2, 3.0, 0.1, 1e10])
def test_the_cached_divisors_are_the_old_uploads(value):
    a = torch.linspace(-3.0, 7.0, 1001)
    _equal([_div(a, value), _rdiv(value, a + 11.0)],
           [a / torch.tensor(value), torch.tensor(value) / (a + 11.0)])
    assert constant(float(value), torch.float32, "cpu") is constant(
        float(value), torch.float32, "cpu")


@pytest.mark.parametrize("res", [(32, 32, 32), (7, 13, 128)])
def test_the_cached_resolution_gives_the_old_cells(res):
    x = torch.rand(4096, 3) * 2.4 - 1.2
    roi = torch.tensor(AABB)
    r = torch.as_tensor(res, dtype=torch.int32)
    unit = (x - roi[:3]) / (roi[3:] - roi[:3])
    ixyz = torch.floor(unit * r.to(torch.float32)).to(torch.int64)
    ixyz = torch.minimum(torch.clamp(ixyz, min=0), r.to(torch.int64) - 1)
    want = ixyz[:, 0] * (res[1] * res[2]) + ixyz[:, 1] * res[2] + ixyz[:, 2]
    got = _cell_index(x, roi, res, ContractionType.AABB)
    assert torch.equal(got, want)


@pytest.mark.parametrize("aabb", [AABB, [-1.5, -1.2, -1.0, 1.5, 1.3, 1.1],
                                  np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
                                           np.float32)])
def test_the_cached_aabb_gives_the_old_t_range(aabb):
    o, d, _ = _rays(12, n=257)
    box = torch.as_tensor(aabb, dtype=torch.float32)
    inv_d = 1.0 / d
    t0, t1 = (box[:3] - o) * inv_d, (box[3:] - o) * inv_d
    near = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    miss = torch.full_like(near, 1e10)
    want = [torch.where(far >= near, near, miss),
            torch.where(far >= near, far, miss)]
    _equal(list(ray_aabb_intersect(o, d, aabb)), want)


def test_the_cached_frequencies_give_the_old_encoding():
    x = torch.rand(333, 3) * 3.0 - 1.5
    enc = SinusoidalEncoder(3, 0, 10)
    scales = torch.tensor([2.0**i for i in range(10)])
    xb = (x[..., None, :] * scales[:, None]).reshape(333, 30)
    want = torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * np.pi], -1))],
                     -1)
    assert torch.equal(enc(x), want)
