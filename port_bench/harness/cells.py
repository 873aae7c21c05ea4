"""A cell of ``BENCHMARK.json`` and everything it names, found by name:
``configs/<config>.json`` with ``reference/<config>.py`` (its plain
reference and the draw of its weights) and ``program/<config>.py`` (the
program's field built with those weights); ``traffic/<traffic>.json``,
whose ``kind`` names the runner ``harness/<kind>.py``; and
``layer_metrics/<metric>.py`` for each per-layer metric the cell
reports."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_module(path: Path, package: str) -> ModuleType:
    """Import the file ``path`` as a module of ``package`` (its relative
    imports resolve there); names may hold dots."""
    name = f"{package}._{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    module.__package__ = package
    spec.loader.exec_module(module)
    return module


class Cell(NamedTuple):
    workload: dict
    config: dict
    traffic: dict
    reference: ModuleType
    program: ModuleType
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # (entry, reader module) of its per-layer metrics


def reports(metric: dict, workload: str, e2e_names) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str, bench: dict = None) -> dict:
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return work[name]


def load(name: str, bench: dict = None) -> Cell:
    bench = bench or benchmark()
    w = workload(name, bench)
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [(m, load_module(BENCH / "layer_metrics" / f"{m['name']}.py",
                                 "port_bench.layer_metrics"))
                 for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(
        w, config, traffic,
        load_module(BENCH / "reference" / f"{w['config']}.py",
                    "port_bench.reference"),
        load_module(BENCH / "program" / f"{w['config']}.py",
                    "port_bench.program"),
        e2e, per_layer)
