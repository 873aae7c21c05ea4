"""The guards of the harness: no JAX after a run, no result without a
card or without the program, the names of ``BENCHMARK.json``, and the
per-layer metrics' operation and byte counts."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import run as bench_run
from port_bench.harness import cells
from port_bench.tests import small

ROOT = Path(__file__).resolve().parent.parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_a_run_loads_no_jax(monkeypatch):
    small.use_small_grid(monkeypatch)
    cell = small.small_cell("instant_ngp.train")
    out = bench_run.run("instant_ngp.train", 3, 0.5, False,
                        torch.device("cpu"), cell=cell)
    assert out["attempted"] > 0 and list(out)[-1] == "checks"
    assert bench_run.forbidden_modules() == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping", "nerfacc_tpu_torch.ops", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nerfacc_tpu.utils", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert bench_run.forbidden_modules() == ["jax", "nerfacc_tpu"]


def test_without_a_card_there_is_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # main() points the bytecode cache into the checkout: undo it after
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", sys.dont_write_bytecode)
    code = bench_run.main(["--workload", "instant_ngp.train", "--seed", "1",
                           "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "CUDA" in out.err


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "instant_ngp.train", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_names_units_and_entries_keep_to_the_contract():
    bench = cells.benchmark()
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    work = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) and len(set(work)) == len(work)
    for n in names + work + [c["name"] for c in bench["configs"]]:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(work)
        assert (ROOT / "port_bench/layer_metrics" / f"{m['name']}.py").exists()
    for w in work:
        cell = cells.load(w)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer and (ROOT / f"port_bench/limits/{w}.json").exists()
    for path in (ROOT / "port_bench").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


@pytest.mark.parametrize("workload", ["instant_ngp.train",
                                      "instant_ngp.view"])
def test_metric_counts_repeat_exactly(workload):
    cell = cells.load(workload)
    for entry, reader in cell.per_layer:
        for fn in ("work", "flops", "select_bytes", "reselect_bytes"):
            f = getattr(reader, fn, None)
            if f is None:
                continue
            args = {"work": (131072, 16, 1 << 19, 2),
                    "flops": ([[32, 64], [64, 16]],),
                    "select_bytes": (8192, 64, 32),
                    "reselect_bytes": (8192, 128, 64)}[fn]
            assert f(*args) == f(*args)
    scatter = [r for e, r in cell.per_layer
               if e["name"] == "hash_scatter_roofline.train"]
    if scatter:
        ops, moved = scatter[0].work(131072, 16, 1 << 19, 2)
        assert moved == 131072 * 1152 + 16 * (1 << 19) * 2 * 4


def test_rooflines_count_the_work_the_inputs_need():
    """K7's share counts each traced step's live samples, not the padded
    field budget; K6's counts the view's last chunk at its own rays."""
    from types import SimpleNamespace as NS

    cell = cells.load("instant_ngp.train")
    reader = dict((e["name"], r) for e, r in cell.per_layer)[
        "hash_scatter_roofline.train"]
    cfg = cell.config
    k7 = {"name": reader.KERNEL, "dur": 400.0}
    live = [240000, 250000]

    def share(counts):
        ctx = {"cell": cell, "trace": NS(kernels=[k7, k7], units=2),
               "runner": NS(stretch_live=[counts])}
        return reader.read(ctx)

    want = sum(max(reader.work(n, 16, 1 << 19, 2)[1] / 3.35e12,
                   reader.work(n, 16, 1 << 19, 2)[0] / 67e12)
               for n in live) / 800e-6 * 100
    assert share(live) == pytest.approx(want, rel=1e-12)
    assert share([cfg["train"]["field_samples_budget"]] * 2) > 1.5 * share(
        live)

    view = cells.load("instant_ngp.view")
    reader = dict((e["name"], r) for e, r in view.per_layer)[
        "march_select_roofline.render"]
    v = view.config["view"]
    n_rays, chunk = 40000, v["test_chunk_size"]
    k6 = {"name": reader.RESELECT, "dur": 100.0}
    ctx = {"cell": view, "trace": NS(kernels=[k6] * 5, units=1),
           "runner": NS(rays=[(torch.zeros(n_rays, 3), None)])}
    moved = reader.reselect_bytes(n_rays, 128, 64)
    assert n_rays % chunk and reader.read(ctx) == pytest.approx(
        100 * moved / 3.35e12 / 500e-6, rel=1e-12)
