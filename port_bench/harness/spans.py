"""The program's own spans and counters, read for the per-layer metrics.

Spans: the chrome trace of the stretch traced with the host's operations
(``build/port_bench/<cell>.host.json``, written by ``trace.profile``)
holds the program's ``nerfacc.*`` spans as the host's annotations. Each
device operation (kernel, copy, set) is attributed to the innermost span
open at its launch: the CUDA API call that the operation's
``correlation`` id names gives the launching thread and time, which also
covers kernels launched through ``ctypes``, without an ATen operation. A
launch on a thread with no open span (autograd's backward thread) goes
to the span open at that time on the main thread, the thread of the
longest span. An operation whose launch the trace lacks goes to the span
open on the main thread when it starts. Each idle gap on the device
timeline goes to the span of the launch that ended it.

Device time is the union of the operations' intervals, each operation
counted for the part no earlier one covers, so the stages partition the
busy time. Per unit (step or view), for each span name: ``device_ms``
(the operations launched inside it, children included), ``self_ms``
(inside it and in no child), ``idle_ms`` (gaps ended by such launches)
and ``launches`` (kernels). The table, with the program's counters
(totals over both traced stretches, where a profiler records), goes to
``build/port_bench/<cell>.stages.json``. A program without the spans
or the counters gives no number, and raises nothing."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from .trace import DEVICE_CATS, TRACES

PREFIX = "nerfacc."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(no span)"


def _thread(e) -> tuple:
    return e.get("pid"), e.get("tid")


class Spans:
    """The ``nerfacc.*`` spans of a trace, per thread, nested."""

    def __init__(self, events: list):
        by_thread = defaultdict(list)
        for e in events:
            if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX)):
                ts = float(e["ts"])
                by_thread[_thread(e)].append(
                    {"name": e["name"][len(PREFIX):], "ts": ts,
                     "end": ts + float(e["dur"]), "parent": None})
        self.threads = {}
        for key, spans in by_thread.items():
            spans.sort(key=lambda s: (s["ts"], -s["end"]))
            stack = []
            for s in spans:
                while stack and stack[-1]["end"] <= s["ts"]:
                    stack.pop()
                s["parent"] = stack[-1] if stack else None
                stack.append(s)
            self.threads[key] = (spans, [s["ts"] for s in spans])
        longest = max(((s["end"] - s["ts"], key)
                       for key, (spans, _) in self.threads.items()
                       for s in spans), default=(0.0, None))
        self.main = longest[1]

    def open_at(self, thread, t: float):
        """The innermost span open on ``thread`` at ``t``, or None."""
        if thread not in self.threads:
            return None
        spans, starts = self.threads[thread]
        i = bisect.bisect_right(starts, t) - 1
        s = spans[i] if i >= 0 else None
        while s is not None and s["end"] < t:
            s = s["parent"]
        return s

    def at_launch(self, thread, t: float):
        return self.open_at(thread, t) or self.open_at(self.main, t)


def chain(span) -> set:
    """The names of ``span`` and of every span around it."""
    names = set()
    while span is not None:
        names.add(span["name"])
        span = span["parent"]
    return names


def stage_table(events: list, units: int) -> dict:
    """Per unit, for each span name (and ``OUTSIDE``): device, self and
    idle milliseconds, and kernels launched; with the totals."""
    spans = Spans(events)
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (_thread(e), float(e["ts"]))
    device = sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") in DEVICE_CATS),
                    key=lambda e: float(e["ts"]))
    rows = defaultdict(lambda: {"device_ms": 0.0, "self_ms": 0.0,
                                "idle_ms": 0.0, "launches": 0})
    busy = idle = covered = 0.0
    unlinked, end = 0, None
    for e in device:
        ts, stop = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        link = launches.get(e.get("args", {}).get("correlation"))
        if link is None:
            unlinked += 1
            span = spans.open_at(spans.main, ts)
        else:
            span = spans.at_launch(*link)
        names = chain(span) or {OUTSIDE}
        own = span["name"] if span is not None else OUTSIDE
        gap = ts - end if end is not None and ts > end else 0.0
        part = max(0.0, stop - (ts if end is None else max(ts, end)))
        end = stop if end is None else max(end, stop)
        busy, idle = busy + part, idle + gap
        if span is not None:
            covered += part
        rows[own]["self_ms"] += part
        for n in names:
            rows[n]["device_ms"] += part
            rows[n]["idle_ms"] += gap
            rows[n]["launches"] += e["cat"] == "kernel"
    per = 1e-3 / units  # us in all -> ms a unit
    table = {n: {"device_ms": r["device_ms"] * per,
                 "self_ms": r["self_ms"] * per,
                 "idle_ms": r["idle_ms"] * per,
                 "launches": r["launches"] / units}
             for n, r in sorted(rows.items())}
    return {"units": units, "device_ms": busy * per, "idle_ms": idle * per,
            "under_spans": covered / busy if busy else 0.0,
            "unlinked_ops": unlinked, "stages": table}


def counters() -> dict:
    """The program's counters, or an empty dict when it has none."""
    try:
        from nerfacc_tpu_torch import tracing
    except ImportError:
        return {}
    return tracing.snapshot()


def table(ctx: dict) -> dict:
    """The stage table of the cell's hosted stretch, with the counters,
    read once per run and written beside its trace."""
    if "stages" not in ctx:
        name = ctx["cell"].workload["name"]
        path = TRACES / f"{name}.host.json"
        events = json.loads(path.read_text())["traceEvents"]
        out = stage_table(events, ctx["host_trace"].units)
        out["counters"] = counters()
        (TRACES / f"{name}.stages.json").write_text(
            json.dumps(out, indent=1))
        ctx["stages"] = out
    return ctx["stages"]


def stage_ms(ctx: dict, name: str):
    """Device ms a unit launched inside the spans ``nerfacc.<name>``,
    children included; None where the program has no such span."""
    row = table(ctx)["stages"].get(name)
    return None if row is None else row["device_ms"]


def live_share(ctx: dict, live: str, rows: str):
    """``100 * live / rows`` of the program's counters, None where it
    counts no rows."""
    c = table(ctx)["counters"]
    if not c.get(rows):
        return None
    return 100.0 * c.get(live, 0) / c[rows]
