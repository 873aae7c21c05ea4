#!/usr/bin/env python3
"""Run one cell of the benchmark of ``nerfacc_tpu_torch`` once:

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
Set-up (building the program's objects, the traffic, the first steps the
check keeps, the warm-up) is timed as ``setup_s``; then the window runs
for ``--seconds``. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from the window's counters and
from a profiled stretch after it. Then the program's state is freed and
the plain reference checks what the timed path produced, in full f32
whatever the program set; the check also fails a run whose products
PyTorch's flags let run in TF32 where the configuration states f32, read
after the checked steps, the window and the traced stretches. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared beside its limit, which also
end standard error). Exits non-zero, with no result, without enough
cards, without the program, or when JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "nerfacc_tpu")


class NoResult(Exception):
    """The run cannot give a result (exit code 2)."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, the part before the first
    dot, is one of ``FORBIDDEN`` as a whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float = None, cell=None) -> dict:
    """One run of ``workload`` (or of ``cell``, the loaded cell, as the
    tests give it at their sizes) on ``device``; returns the result's
    object. No check of the device here: the caller makes it."""
    import torch

    try:
        import nerfacc_tpu_torch  # noqa: F401
    except ImportError as e:
        raise NoResult(f"the program nerfacc_tpu_torch is missing: {e}")
    from port_bench.harness import cells, compare
    from port_bench.harness import trace as tracing

    t_start = T_START if t_start is None else t_start
    cell = cell or cells.load(workload)
    runner = importlib.import_module(
        f"port_bench.harness.{cell.traffic['kind']}")
    t_cell = time.perf_counter()
    d = runner.Cell(cell, seed, device)
    d.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    tf32_seen = compare.tf32_matmuls()
    win = d.window(seconds, spans=trace)
    tf32_seen = tf32_seen or compare.tf32_matmuls()
    times = win["unit_seconds"]
    tenth = max(len(times) // 10, 1)
    print(f"window: {win['units']} {d.unit}s in {win['seconds']:.3f} s; "
          f"mean {d.unit} s in the first tenth "
          f"{statistics.mean(times[:tenth] or [0.0]):.6f}, the last "
          f"{statistics.mean(times[-tenth:] or [0.0]):.6f}; "
          f"setup {setup_s:.3f} s: before the cell {t_cell - t_start:.3f}, "
          + ", ".join(f"{k} {v:.3f}" for k, v in d.setup_parts.items()),
          file=sys.stderr)
    traced = hosted = None
    if trace:
        n = cell.traffic["traced_units"]
        traced = tracing.profile(lambda: d.stretch(n), n, workload, device,
                                 host=False)
        hosted = tracing.profile(lambda: d.stretch(n), n, workload, device,
                                 host=True)
        tf32_seen = tf32_seen or compare.tf32_matmuls()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    d.free()
    bounds = compare.limits(workload)
    with compare.reference_precision():
        numbers = d.check()
    numbers["matmul_tf32"] = compare.precision_gap(cell.config, tf32_seen)
    correct, checks = compare.verdict(
        {k: numbers.get(k, float("nan")) for k in bounds}, bounds)
    metrics = {}
    if trace:
        ctx = {"cell": cell, "window": win, "trace": traced,
               "host_trace": hosted, "runner": d}
        for entry, reader in cell.per_layer:
            value = reader.read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": values[entry["name"]],
                                      "unit": entry["unit"]}
    n_dev = cell.workload["chips"]
    result = {
        "correct": correct,
        "attempted": win["units"],
        "failed": win["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": n_dev,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.wall_s
        result["breakdown"] = hosted.breakdown()
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise NoResult(f"modules of JAX or the JAX package loaded: {found}")
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    # the bytecode of every module the run imports (PyTorch's compiler
    # stack too, which building the optimizer loads) is cached inside
    # the checkout, so only the first run there compiles it
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    import torch

    from port_bench.harness import cells

    try:
        chips = cells.workload(args.workload)["chips"]
    except (KeyError, FileNotFoundError) as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0))
    except NoResult as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
