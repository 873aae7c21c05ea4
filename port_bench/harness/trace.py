"""The traced stretches: ``torch.profiler`` over a fixed number of steps
or views after the window, twice. The first records the card's activity
alone, which costs the host least: its busy time (the union of the
device operations' intervals) over its wall time gives the idle share,
and its kernels the launches. The second records the host's operations
too: each device operation with the CPU operation that launched it, for
the metrics that sort kernels by what launched them and for the
breakdown (the device operations that took most time; the longest idle
gaps, by the host operation that ended them with a launch). Each chrome
trace is written under the checkout's ``build/port_bench/`` and
overwritten by the next traced run."""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path

import torch

TRACES = Path(__file__).resolve().parent.parent.parent / "build" / "port_bench"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: list, wall_s: float, units: int):
        self.wall_s, self.units = wall_s, units
        ops = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "cpu_op":
                ops[e.get("args", {}).get("External id")] = e["name"]
        self.device = sorted(
            ({"name": e["name"], "cat": e["cat"], "ts": float(e["ts"]),
              "dur": float(e["dur"]),
              "op": ops.get(e.get("args", {}).get("External id"), "")}
             for e in events
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
            key=lambda e: e["ts"])
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        busy, end, gaps = 0.0, None, defaultdict(float)
        for e in self.device:
            stop = e["ts"] + e["dur"]
            if end is not None and e["ts"] > end:
                gaps[e["op"] or e["name"]] += e["ts"] - end
            start = e["ts"] if end is None else max(e["ts"], end)
            busy += max(0.0, stop - start)
            end = stop if end is None else max(end, stop)
        self.busy_s = busy * 1e-6
        self.gaps = gaps

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e["name"]] += e["dur"] * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in top],
                "idle_gaps": [[n[:200], s * 1e-6] for n, s in gaps]}

    def kernel_seconds(self, match) -> float:
        return sum(e["dur"] for e in self.kernels if match(e)) * 1e-6


def profile(run, units: int, name: str, device, host: bool) -> Trace:
    """Trace ``run()`` (``units`` steps or views) on ``device``; ``host``
    records the CPU operations too."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        activities.append(torch.profiler.ProfilerActivity.CPU)
        name += ".host"
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    TRACES.mkdir(parents=True, exist_ok=True)
    path = TRACES / f"{name}.json"
    prof.export_chrome_trace(str(path))
    return Trace(json.loads(path.read_text())["traceEvents"], wall, units)
