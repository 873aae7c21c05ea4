"""The runner of ``kind: train`` traffic: training episodes through the
program's ``train_step`` and ``update_grid``.

Set-up builds one training object (the field with the benchmark's
weights, Adam, the trained grid from ``assets/``, the episode's batches)
and drives it through the first three steps of an episode, which the
check keeps. Every episode of the window starts from the same saved
state: the weights copied back, Adam's moments and step count zeroed,
the saved grid, the two generators seeded again; so every step measured
lies on one trajectory, however many a faster program gets through. The
grid is updated before every ``grid_every``-th step, on its sampled path.
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path

import numpy as np
import torch

import nerfacc_tpu_torch as nt
from nerfacc_tpu_torch.convert import grid_from_arrays

from ..reference import common as ref
from . import traffic as tg
from .compare import faint_gap, leaf_gap, norms, rel_gap

ASSETS = Path(__file__).resolve().parent.parent / "assets"
CHECK_STEPS = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_grid_arrays():
    """The trained grid of ``assets/``: (binary (128,)*3, occs (128^3,))."""
    asset = np.load(ASSETS / "trained_grid.npz")
    return asset["binary"], asset["occs"]


class Cell:
    unit = "step"

    def __init__(self, cell, seed: int, device):
        cfg, t = cell.config, cell.config["train"]
        self.cell, self.cfg, self.t, self.dev = cell, cfg, t, device
        self.seed = seed
        self.render_kw = dict(
            scene_aabb=tuple(cfg["aabb"]),
            render_step_size=cfg["render_step_size"],
            max_samples_per_ray=t["max_samples_per_ray"],
            samples_budget=t["samples_budget"],
            visible_samples_budget=t["visible_samples_budget"],
            field_samples_budget=t["field_samples_budget"],
            coarse_stride=t["coarse_stride"],
            probe_groups=t["probe_groups"],
            probe_dilation=t["probe_dilation"],
            use_pallas=t["use_pallas"],
            early_stop_eps=t["early_stop_eps"],
            stratified=True,
        )
        marks = [time.perf_counter()]
        self.weights = cell.reference.init_weights(
            cfg, tg.subseed(seed, "weights"), device)
        self.field, self.leaves = cell.program.build(cfg, self.weights,
                                                     device)
        self.opt = torch.optim.Adam(self.field.parameters(), lr=t["lr"],
                                    eps=t["eps"], betas=tuple(t["betas"]))
        binary, occs = load_grid_arrays()
        self.grid0 = grid_from_arrays(cfg["aabb"], binary, occs,
                                      device=device)
        _sync(device)
        marks.append(time.perf_counter())
        self.o, self.d, self.px = tg.train_batches(cell.traffic, t["rays"],
                                                   seed, device)
        _sync(device)
        marks.append(time.perf_counter())
        self.setup_parts = {"program": marks[1] - marks[0],
                            "traffic": marks[2] - marks[1]}
        self.steps = cell.traffic["episode_steps"]
        self.gen_strat = torch.Generator(device=device)
        self.gen_grid = torch.Generator(device=device)
        self.live = torch.zeros((), dtype=torch.int64, device=device)
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self.update_events = None
        self.stretch_live = []  # each traced stretch's live samples a step
        self.restore()

    # ------------------------------------------------------------ episode

    def restore(self) -> None:
        with torch.no_grad():
            for p, w in zip(self.leaves, self.weights.values()):
                p.copy_(w)
        for state in self.opt.state.values():
            for v in state.values():
                v.zero_()
        self.grid = self.grid0
        self.gen_strat.manual_seed(tg.subseed(self.seed, "stratify"))
        self.gen_grid.manual_seed(tg.subseed(self.seed, "grid"))
        self.i = 0

    def occ_eval(self, x):
        return self.field.query_opacity(x, self.cfg["render_step_size"])

    def step(self):
        """Step ``self.i`` of the episode; returns (loss, live samples)."""
        t, i = self.t, self.i
        if i % t["grid_every"] == 0:
            ev = self.update_events
            if ev is not None:
                ev.append(torch.cuda.Event(enable_timing=True))
                ev[-1].record()
            # past the 256-step warm-up: the sampled update
            self.grid = nt.update_grid(
                self.grid, self.gen_grid, step=256 + i,
                occ_eval_fn=self.occ_eval, occ_thre=t["occ_thre"],
                ema_decay=t["ema_decay"])
            if ev is not None:
                ev.append(torch.cuda.Event(enable_timing=True))
                ev[-1].record()
        loss, n = nt.train_step(
            self.field, self.opt, self.grid, self.o[i], self.d[i],
            self.px[i], key=self.gen_strat, **self.render_kw)
        self.live += n
        self.bad += ~torch.isfinite(loss)
        self.i += 1
        if self.i == self.steps:
            self.restore()
        return loss, n

    # ------------------------------------------------------------ phases

    def setup(self) -> None:
        """Drive the first steps of an episode and keep what the check
        compares: each step's loss and live samples, the first gradient
        as Adam holds it, the change of the weights, the grid after its
        update."""
        b1 = self.t["betas"][0]
        t0 = time.perf_counter()
        self.seen = {"loss": [], "live": []}
        for k in range(CHECK_STEPS):
            loss, n = self.step()
            self.seen["loss"].append(float(loss))
            self.seen["live"].append(int(n))
            if k == 0:
                self.seen["grid"] = self.grid.occs.clone()
                self.seen["grad"] = [
                    self.opt.state[p]["exp_avg"] / (1.0 - b1)
                    for p in self.leaves]
        self.seen["change"] = [p.detach() - w for p, w in
                               zip(self.leaves, self.weights.values())]
        self.restore()
        self.live.zero_()
        self.bad.zero_()
        _sync(self.dev)
        self.setup_parts["first steps"] = time.perf_counter() - t0

    def window(self, seconds: float, spans: bool) -> dict:
        self.update_events = [] if spans else None
        n = 0
        _sync(self.dev)
        t0 = time.perf_counter()
        stamps = []
        while time.perf_counter() - t0 < seconds:
            stamps.append(time.perf_counter())
            self.step()
            n += 1
        _sync(self.dev)
        elapsed = time.perf_counter() - t0
        out = {"units": n, "seconds": elapsed,
               "unit_seconds": [b - a for a, b in zip(stamps, stamps[1:])],
               "metrics": {"train_step_ms": 1e3 * elapsed / n},
               "failed": int(self.bad),
               "counters": {"live_samples": int(self.live),
                            "grid_updates": 0, "grid_update_ms": 0.0}}
        if spans:
            ev = self.update_events
            out["counters"]["grid_updates"] = len(ev) // 2
            out["counters"]["grid_update_ms"] = sum(
                a.elapsed_time(b) for a, b in zip(ev[::2], ev[1::2]))
        self.update_events = None
        return out

    def stretch(self, n: int):
        self.stretch_live.append([self.step()[1] for _ in range(n)])

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("field", "leaves", "opt", "grid", "grid0"):
            setattr(self, name, None)

    # ------------------------------------------------------------ check

    def check(self, mode: str = "program") -> dict:
        """The numbers compared: the reference drives the same start
        through the same steps, and each number is the distance from it
        of the program's readings (``mode="program"``), of the reference
        in TF32 (``"control"``) or of the reference with a planted fault
        (``"half_batch"``, ``"unchanged"``).

        The change of the faint leaves, whose reference gradient is under
        a thousandth of the median leaf's, is compared apart, each leaf
        against its own change: Adam moves such a leaf as far as any
        other, and its change is the noisiest. ``program`` also keeps, in
        ``leaf_readings``, each leaf's reference gradient norm over the
        median leaf's and its gap of change over its own."""
        want = self.reference_run()
        got = (self.seen if mode == "program" else self.reference_run(
            tf32=mode == "control", fault="" if mode == "control" else mode))
        if mode == "program":
            g = norms(want["grad"])
            med = statistics.median(g)
            self.leaf_readings = {
                name: {"grad_share": gi / med, "change_gap": rel_gap(a, b)}
                for name, gi, a, b in zip(self.weights, g, norms(
                    got["change"]), norms(want["change"]))}
        return {
            "loss_gap": max(rel_gap(a, b) for a, b in
                            zip(got["loss"], want["loss"])),
            "live_gap": max(rel_gap(a, b) for a, b in
                            zip(got["live"], want["live"])),
            "grad_gap": leaf_gap(got["grad"], want["grad"]),
            "change_gap": leaf_gap(got["change"], want["change"],
                                   include=[not f for f in want["faint"]]),
            "faint_change_gap": faint_gap(got["change"], want["change"],
                                          want["faint"]),
            "grid_gap": float((got["grid"] - want["grid"]).abs().max()
                              / want["grid"].abs().max()),
        }

    def reference_settings(self) -> dict:
        t = self.t
        n = t["rays"]
        slots = min(t["max_samples_per_ray"], -(-t["samples_budget"] // n))
        vis = t["visible_samples_budget"]
        return {
            "step": self.cfg["render_step_size"],
            "n_lattice": t["max_samples_per_ray"],
            "slots": slots,
            "visible_slots": None if vis is None else min(slots, -(-vis // n)),
            "coarse_stride": t["coarse_stride"],
            "probe_groups": t["probe_groups"],
            "probe_dilation": t["probe_dilation"],
            "field_budget": t["field_samples_budget"],
            "early_stop_eps": t["early_stop_eps"],
        }

    def reference_run(self, tf32: bool = False, fault: str = "") -> dict:
        """The reference's first steps. ``fault`` plants one in it, for
        reading what a faulty program would read: ``half_batch`` (the
        loss over half the rays) or ``unchanged`` (a step that leaves the
        weights, Adam's state and the grid as they were)."""
        cell, t, dev = self.cell, self.t, self.dev
        params = {k: w.clone().requires_grad_(True)
                  for k, w in self.weights.items()}
        field = cell.reference.Field(self.cfg, params, tf32=tf32)
        leaves = field.leaves()
        adam = ref.Adam(leaves, t["lr"], t["eps"], tuple(t["betas"]))
        binary, occs = load_grid_arrays()
        radii = (t["probe_dilation"],) if t["coarse_stride"] > 1 else ()
        grid = ref.make_grid(
            torch.tensor(self.cfg["aabb"], device=dev),
            torch.as_tensor(occs, device=dev),
            torch.as_tensor(binary, device=dev), radii)
        g_strat = tg.generator(self.seed, "stratify", dev)
        g_grid = tg.generator(self.seed, "grid", dev)
        r = self.reference_settings()
        out = {"loss": [], "live": []}
        for i in range(CHECK_STEPS):
            if i % t["grid_every"] == 0 and fault != "unchanged":
                grid = ref.update_grid(
                    grid, field.density, self.cfg["render_step_size"],
                    g_grid, t["occ_thre"], t["ema_decay"])
            if i == 0:
                out["grid"] = grid.occs
            o, d, px = self.o[i], self.d[i], self.px[i]
            u = ref.stratify_uniforms(g_strat, o.shape[0], dev)
            if fault == "half_batch":
                h = o.shape[0] // 2
                o, d, px, u = o[:h], d[:h], px[:h], u[:h]
            color, _, _, live, _ = ref.render(field, o, d, grid, r,
                                              stratify=u, train=True)
            loss = ref.mse(color, px)
            grads = torch.autograd.grad(loss, leaves)
            if fault == "unchanged":
                grads = [torch.zeros_like(g) for g in grads]
            if i == 0:
                out["grad"] = [g.detach() for g in grads]
            if fault != "unchanged":
                adam.step(grads)
            out["loss"].append(float(loss.detach()))
            out["live"].append(live)
        out["change"] = [p.detach() - w for p, w in
                         zip(leaves, self.weights.values())]
        g = norms(out["grad"])
        out["faint"] = [x < 1e-3 * statistics.median(g) for x in g]
        return out
