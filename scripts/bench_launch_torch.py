#!/usr/bin/env python3
"""Host cost of one kernel-wrapper call of nerfacc_tpu_torch, on one NVIDIA
GPU.

    python3 scripts/bench_launch_torch.py [--root DIR ...] [--calls N]

For two wrappers whose device work is a few microseconds, ``table_gather``
at one index and ``fused_reselect`` at 64 rays x 16 slots, it makes
``--calls`` calls (default 1,000) without synchronising in between and
divides the host clock by the count: what a call costs the Python thread
(argument checks, output allocation, the ctypes call, the launch). One
PyTorch indexing call ``table[idx]`` on the same input stands beside them.
The median and the least of nine such rounds are reported (the host is
shared, so the least is the steadier of the two).

``--root`` names a checkout whose ``nerfacc_tpu_torch`` is measured
(default: the one this script lies in). Given several roots, each is
measured in a process of its own, in the order given, so that two versions
can be compared on one card in turns: ``--root old --root . --root .
--root old``.

It prints the card's name and power limit first and has no CPU mode.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROUNDS = 9


def us_per_call(fn, calls: int) -> tuple:
    """(median, least) over ROUNDS of the host microseconds per
    un-synchronised call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(rounds), min(rounds)


def host_cost(device=None, calls: int = 1000) -> dict:
    """``{name: (median, least) host us per call}`` for the two wrappers
    and for PyTorch's indexing, from the ``nerfacc_tpu_torch`` that is
    first on the path."""
    from nerfacc_tpu_torch.ops import fused_reselect, table_gather

    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError("host_cost measures launches on a card")
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(0, 2 ** 31 - 1, (1 << 19,), generator=gen,
                          device=dev, dtype=torch.int32)
    idx = torch.zeros((1,), dtype=torch.int32, device=dev)
    idx_long = idx.long()
    R, K, k2 = 64, 16, 8
    masks = torch.rand((R, K), generator=gen, device=dev) < 0.5
    ts = torch.rand((R, K), generator=gen, device=dev).sort(dim=1).values
    dt = torch.full((R, K), 1e-2, device=dev)
    te = ts + dt
    return {
        "table_gather": us_per_call(lambda: table_gather(idx, table), calls),
        "fused_reselect": us_per_call(
            lambda: fused_reselect(masks, ts, te, dt, k2=k2), calls),
        "table[idx]": us_per_call(lambda: table[idx_long], calls),
    }


def format_cost(cost: dict, calls: int = 1000) -> str:
    return (f"({calls} un-synchronised calls; median and least of {ROUNDS} "
            "rounds) " + "  ".join(f"{k} {med:.2f} ({low:.2f})"
                                   for k, (med, low) in cost.items()))


def _measure_here(calls: int) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script measures a GPU")
    import nerfacc_tpu_torch
    from nerfacc_tpu_torch import _build

    _build.lib()  # the build is not part of a call
    cost = host_cost(calls=calls)
    root = Path(nerfacc_tpu_torch.__file__).resolve().parent.parent
    print(f"host us per wrapper call in {root}: {format_cost(cost, calls)}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", type=Path,
                    help="checkout to measure (repeatable)")
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    here = Path(__file__).resolve().parent.parent
    roots = args.root or [here]
    if len(roots) == 1:
        sys.path.insert(0, str(roots[0].resolve()))
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
        _measure_here(args.calls)
        return
    for root in roots:
        subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--root",
             str(root), "--calls", str(args.calls)],
            check=True,
        )


if __name__ == "__main__":
    main()
