"""The runner of ``kind: view`` traffic: one client in a closed loop,
each request one whole view through the program's ``render_image``,
timed from its start to its synchronised completion. The rays of every
pose are made at set-up; the seed orders the poses. The check's views
are drawn from the seed before the window (two of its first
``SAMPLE_RANGE``) and its last view is kept too; only those outputs stay
on the card, so the window allocates no more memory as it goes."""

from __future__ import annotations

import time

import torch

import nerfacc_tpu_torch as nt
from nerfacc_tpu_torch.convert import grid_from_arrays

from ..reference import common as ref
from . import traffic as tg
from . import train as _train
from .train import _sync

SAMPLED_VIEWS, SAMPLE_RANGE = 2, 100
RAY_CHUNK = 1 << 13


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class Cell:
    unit = "view"

    def __init__(self, cell, seed: int, device):
        cfg, v = cell.config, cell.config["view"]
        self.cell, self.cfg, self.v, self.dev, self.seed = (
            cell, cfg, v, device, seed)
        chunk = v["test_chunk_size"]
        self.render_kw = dict(
            scene_aabb=tuple(cfg["aabb"]),
            render_step_size=cfg["render_step_size"],
            max_samples_per_ray=v["max_samples_per_ray"],
            coarse_stride=v["coarse_stride"],
            use_pallas=v["use_pallas"],
            early_stop_eps=v["early_stop_eps"],
            test_chunk_size=chunk,
            eval_samples_per_ray=v["eval_samples_per_ray"],
            visible_samples_budget=chunk * v["eval_visible_samples_per_ray"],
            render_bkgd=torch.ones(3, device=device),
        )
        t0 = time.perf_counter()
        self.weights = cell.reference.init_weights(
            cfg, tg.subseed(seed, "weights"), device)
        self.field, _ = cell.program.build(cfg, self.weights, device)
        binary, occs = _train.load_grid_arrays()
        self.grid = grid_from_arrays(cfg["aabb"], binary, occs,
                                     device=device)
        _sync(device)
        t1 = time.perf_counter()
        self.rays, self.order = tg.view_requests(cell.traffic, seed, device)
        _sync(device)
        self.setup_parts = {"program": t1 - t0,
                            "traffic": time.perf_counter() - t1}
        g = tg.generator(seed, "checked", "cpu")
        self.sample = set(torch.randperm(SAMPLE_RANGE, generator=g)[
            :SAMPLED_VIEWS].tolist())
        self.k = 0  # views recorded
        self.kept = {}  # view index -> (pose, colors, opacities, depths)
        self.keep_all = False
        self.bad = torch.zeros((), dtype=torch.int64, device=device)

    def request(self, record: bool = True) -> float:
        pose = self.order[self.k % len(self.order)]
        o, d = self.rays[pose]
        t0 = time.perf_counter()
        with torch.no_grad():
            out = nt.render_image(self.field, o, d, grid=self.grid,
                                  **self.render_kw)
        _sync(self.dev)
        elapsed = time.perf_counter() - t0
        if record:
            self.bad += ~torch.isfinite(out[0]).all()
            prev = self.k - 1
            if prev not in self.sample and not self.keep_all:
                self.kept.pop(prev, None)  # the latest view stays
            self.kept[self.k] = (pose,) + tuple(out)
            self.k += 1
        return elapsed

    def setup(self) -> None:
        t0 = time.perf_counter()
        for _ in range(2):
            self.request(record=False)
        self.setup_parts["first views"] = time.perf_counter() - t0

    def window(self, seconds: float, spans: bool) -> dict:
        lat = []
        _sync(self.dev)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self.request())
        elapsed = time.perf_counter() - t0
        n_rays = self.rays[0][0].shape[0]
        self.n_window = len(lat)
        self.keep_all = True  # the traced views after the window
        failed = int(self.bad)
        return {"units": len(lat), "seconds": elapsed, "failed": failed,
                "unit_seconds": lat,
                "metrics": {
                    "render_rays_per_s": len(lat) * n_rays / elapsed,
                    "render_view_p95_ms": 1e3 * percentile(lat, 95.0)}}

    def stretch(self, n: int) -> None:
        for _ in range(n):
            self.request()

    def free(self) -> None:
        self.field = self.grid = None

    # ------------------------------------------------------------ check

    def traced_views(self) -> range:
        """The views of the first traced stretch."""
        n = min(self.k - self.n_window, self.cell.traffic["traced_units"])
        return range(self.n_window, self.n_window + n)

    def checked(self) -> list:
        """The views the check compares: the window's last, those of the
        seed's sample it reached, and those of the first traced
        stretch."""
        n = self.n_window
        want = ({i for i in self.sample if i < n} | {n - 1}
                | set(self.traced_views()))
        return sorted(want & set(self.kept))

    def reference_settings(self) -> dict:
        v = self.v
        slots = min(v["max_samples_per_ray"], v["eval_samples_per_ray"])
        return {"step": self.cfg["render_step_size"],
                "n_lattice": v["max_samples_per_ray"], "slots": slots,
                "visible_slots": min(slots,
                                     v["eval_visible_samples_per_ray"]),
                "coarse_stride": v["coarse_stride"], "probe_groups": None,
                "probe_dilation": 0, "field_budget": None,
                "early_stop_eps": v["early_stop_eps"]}

    def reference_view(self, field, grid, pose: int, fault: str = ""):
        """The reference's colours, opacities, depths of one pose, and its
        live and density-pass samples. ``fault="blank_chunk"`` leaves the
        last chunk of rays unrendered (background), for reading what a
        program that loses part of an answer would read."""
        o, d = self.rays[pose]
        r = self.reference_settings()
        outs, live, dens = [], 0, 0
        for i in range(0, o.shape[0], RAY_CHUNK):
            c, op, dp, n_l, n_d = ref.render(field, o[i:i + RAY_CHUNK],
                                             d[i:i + RAY_CHUNK], grid, r)
            outs.append((c, op, dp))
            live, dens = live + n_l, dens + n_d
        c, op, dp = (torch.cat([x[j] for x in outs]) for j in range(3))
        if fault == "blank_chunk":
            tail = o.shape[0] - (o.shape[0] - 1) % self.v[
                "test_chunk_size"] - 1
            c, op, dp = c.clone(), op.clone(), dp.clone()
            c[tail:], op[tail:], dp[tail:] = 1.0, 0.0, 0.0
        return (c, op, dp), live, dens

    def check(self, mode: str = "program") -> dict:
        """The numbers compared, over the checked views: the program's
        outputs (``mode="program"``), the reference in TF32
        (``"control"``) or with a planted fault against the reference."""
        dev = self.dev
        binary, occs = _train.load_grid_arrays()
        grid = ref.make_grid(torch.tensor(self.cfg["aabb"], device=dev),
                             torch.as_tensor(occs, device=dev),
                             torch.as_tensor(binary, device=dev), ())
        field = self.cell.reference.Field(self.cfg, self.weights)
        other = (self.cell.reference.Field(self.cfg, self.weights, tf32=True)
                 if mode == "control" else field)
        diffs = {"color": [], "opacity": [], "depth": []}
        self.counts = {}
        for idx in self.checked():
            pose = self.kept[idx][0]
            want, live, dens = self.reference_view(field, grid, pose)
            self.counts[idx] = (live, dens)
            if mode == "program":
                got = self.kept[idx][1:]
            else:
                got = self.reference_view(
                    other, grid, pose,
                    "" if mode == "control" else mode)[0]
            for key, a, b in zip(diffs, got, want):
                diffs[key].append((a - b).abs().reshape(-1))
        out = {}
        for key, parts in diffs.items():
            v = torch.cat(parts).double()
            out[f"{key}_max"] = float(v.max())
            out[f"{key}_mean"] = float(v.mean())
            out[f"{key}_p99"] = float(torch.quantile(v[:1 << 24], 0.99))
        return out
