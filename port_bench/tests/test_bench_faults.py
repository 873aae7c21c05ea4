"""``correct`` at the tests' sizes on the CPU: a sound run reads true; a
run whose timed path is broken underneath reads false, once for each
fault the cells can have; a program that turns TF32 on reads false, and
the reference still runs in full f32; and the control, the reference in
TF32 put in the program's place, fails the limits. The harness's look
for a card is skipped: ``run.run`` is called with the CPU device."""

import pytest
import torch

import nerfacc_tpu_torch as nt
from port_bench import run as bench_run
from port_bench.harness import compare, train, view
from port_bench.tests import small

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _run(workload, monkeypatch, seed=4):
    small.use_small_grid(monkeypatch)
    return bench_run.run(workload, seed, 0.3, False, CPU,
                         cell=small.small_cell(workload))


@pytest.mark.parametrize("workload", ["instant_ngp.train",
                                      "vanilla_nerf.train",
                                      "instant_ngp.view"])
def test_a_sound_run_is_correct(workload, monkeypatch):
    out = _run(workload, monkeypatch)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def _unchanged_state(monkeypatch):
    """The step computes its loss and leaves the weights as they were."""
    step = nt.train_step

    def frozen(field, optimizer, grid, *args, **kw):
        saved = [p.detach().clone() for p in field.parameters()]
        out = step(field, optimizer, grid, *args, **kw)
        with torch.no_grad():
            for p, s in zip(field.parameters(), saved):
                p.copy_(s)
        return out

    monkeypatch.setattr(nt, "train_step", frozen)


def _frozen_leaf(monkeypatch):
    """The step leaves one leaf as it was: the one with the least
    gradient (in ``instant_ngp`` the first density layer, whose gradient
    is small because the table starts at +-1e-4)."""
    step = nt.train_step

    def frozen(field, optimizer, grid, *args, **kw):
        saved = [p.detach().clone() for p in field.parameters()]
        out = step(field, optimizer, grid, *args, **kw)
        params = list(field.parameters())
        i = min(range(len(params)), key=lambda j: float(params[j].grad.norm()))
        with torch.no_grad():
            params[i].copy_(saved[i])
        return out

    monkeypatch.setattr(nt, "train_step", frozen)


def _unchanged_grid(monkeypatch):
    monkeypatch.setattr(nt, "update_grid", lambda grid, *a, **k: grid)


def _half_batch(monkeypatch):
    """The loss over half the rays: the mean taken over the rest."""
    step = nt.train_step

    def half(field, optimizer, grid, rays_o, rays_d, pixels, **kw):
        h = rays_o.shape[0] // 2
        return step(field, optimizer, grid, rays_o[:h], rays_d[:h],
                    pixels[:h], **kw)

    monkeypatch.setattr(nt, "train_step", half)


@pytest.mark.parametrize("workload", ["instant_ngp.train",
                                      "vanilla_nerf.train"])
@pytest.mark.parametrize("fault", [_unchanged_state, _frozen_leaf,
                                   _unchanged_grid, _half_batch])
def test_a_broken_training_step_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(workload, monkeypatch)["correct"]


@pytest.mark.parametrize("fault", ["first_pixel", "last_chunk"])
def test_an_altered_view_is_not_correct(fault, monkeypatch):
    render = nt.render_image

    def altered(*args, **kw):
        colors, opacities, depths = render(*args, **kw)
        colors = colors.clone()
        if fault == "first_pixel":
            colors[0] += 0.01
        else:
            colors[-kw["test_chunk_size"] // 2:] = 1.0
        return colors, opacities, depths

    monkeypatch.setattr(nt, "render_image", altered)
    assert not _run("instant_ngp.view", monkeypatch)["correct"]


@pytest.mark.parametrize("workload", ["instant_ngp.train",
                                      "instant_ngp.view"])
def test_a_program_in_tf32_is_not_correct(workload, monkeypatch):
    """The program's field build turns TF32 on for the whole process: the
    run reads false, and the reference's products run with it off."""
    small.use_small_grid(monkeypatch)
    cell = small.small_cell(workload)
    build, linear, seen = cell.program.build, cell.reference.linear, []

    def build_tf32(*args, **kw):
        torch.backends.cuda.matmul.allow_tf32 = True
        return build(*args, **kw)

    def watched(*args, **kw):
        seen.append(compare.tf32_matmuls())
        return linear(*args, **kw)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(cell.program, "build", build_tf32)
    monkeypatch.setattr(cell.reference, "linear", watched)
    out = bench_run.run(workload, 4, 0.3, False, CPU, cell=cell)
    assert torch.backends.cuda.matmul.allow_tf32  # the program's setting
    assert out["checks"]["matmul_tf32"] == {"value": 1.0, "limit": 0}
    assert not out["correct"]
    assert seen and not any(seen)
    del out["checks"]["matmul_tf32"]
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload,runner", [
    ("instant_ngp.train", train), ("vanilla_nerf.train", train),
    ("instant_ngp.view", view)])
def test_the_control_fails_the_limits(workload, runner, monkeypatch):
    small.use_small_grid(monkeypatch)
    d = runner.Cell(small.small_cell(workload), 6, CPU)
    d.setup()
    d.window(0.2, spans=False)
    d.free()
    bounds = compare.limits(workload)
    del bounds["matmul_tf32"]  # read by ``run.run`` from PyTorch's flags
    with compare.reference_precision():
        numbers = d.check("control")
    assert not compare.verdict({k: numbers[k] for k in bounds}, bounds)[0]
