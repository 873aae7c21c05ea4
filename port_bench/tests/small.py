"""The cells at the sizes a CPU test holds: every width the same kind,
tables, batches, views and the grid cut down. Test code only."""

from __future__ import annotations

import copy

import numpy as np
import torch

from port_bench.harness import cells, train

GRID_RES = 32


def small_grid_arrays():
    """The trained grid max-pooled from 128^3 to 32^3."""
    asset = np.load(train.ASSETS / "trained_grid.npz")
    binary, occs = asset["binary"], asset["occs"]
    f = 128 // GRID_RES
    b = torch.as_tensor(binary).reshape(GRID_RES, f, GRID_RES, f, GRID_RES, f)
    o = torch.as_tensor(occs).reshape(GRID_RES, f, GRID_RES, f, GRID_RES, f)
    return (b.any(5).any(3).any(1).numpy(),
            o.amax(5).amax(3).amax(1).reshape(-1).numpy())


def small_cell(workload: str) -> cells.Cell:
    cell = cells.load(workload)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["grid_resolution"] = GRID_RES
    if cfg["name"] == "instant_ngp":
        cfg.update(levels=4, log2_table=10)
        cfg["linear_layers"]["density"][0][0] = 8
    if "train" in cfg:
        t = cfg["train"]
        scale = 64 / t["rays"]
        t["rays"] = 64
        for k in ("samples_budget", "visible_samples_budget",
                  "field_samples_budget"):
            if t.get(k) is not None:
                t[k] = int(t[k] * scale)
        t["grid_every"] = 2
    if "view" in cfg:
        cfg["view"]["test_chunk_size"] = 96
    if tr["kind"] == "train":
        tr["episode_steps"] = 4
        tr["train_views"].update(width=32, height=32)
        tr["gt_samples"] = 64
    else:
        tr["views"].update(width=12, height=12,
                           rings=[[20.0, 2], [42.0, 2]])
    tr["traced_units"] = 2
    return cell._replace(config=cfg, traffic=tr)


def use_small_grid(monkeypatch=None):
    """Make the runners load the 32^3 grid (through ``monkeypatch`` when
    a test gives one)."""
    if monkeypatch is not None:
        monkeypatch.setattr(train, "load_grid_arrays", small_grid_arrays)
    else:
        train.load_grid_arrays = small_grid_arrays
