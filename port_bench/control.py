#!/usr/bin/env python3
"""Readings for the limits of ``correct``: for each seed, one process
sets a cell up and runs a short window, then reads every number the
check can compare, for the program (``program``), for the reference in
TF32 in the program's place (``control``), and for the reference with a
planted fault (``half_batch`` and ``unchanged`` for training,
``blank_chunk`` for views).
One JSON line per seed and mode.

    python3 port_bench/control.py --workload instant_ngp.train \\
        --seeds 11 12 13 --seconds 2 --modes program control half_batch

``--small`` runs the tests' sizes (on the CPU with ``--device cpu``),
to rehearse. Not run by the benchmark's own runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--modes", nargs="+", default=["program", "control"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)

    import importlib

    import torch

    from port_bench.harness import cells, compare

    device = torch.device(args.device)
    if args.small:
        from port_bench.tests import small

        small.use_small_grid()
        cell = small.small_cell(args.workload)
    else:
        cell = cells.load(args.workload)
    runner = importlib.import_module(
        f"port_bench.harness.{cell.traffic['kind']}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        d = runner.Cell(cell, seed, device)
        d.setup()
        win = d.window(args.seconds, spans=False)
        d.free()
        for mode in args.modes:
            t1 = time.perf_counter()
            with compare.reference_precision():
                numbers = d.check(mode)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "numbers": numbers,
                              "units": win["units"],
                              "leaves": (getattr(d, "leaf_readings", None)
                                         if mode == "program" else None),
                              "check_s": time.perf_counter() - t1,
                              "run_s": t1 - t0}), flush=True)
        del d
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
