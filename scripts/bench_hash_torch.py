#!/usr/bin/env python3
"""Hash-table gather measurements on one NVIDIA GPU (the ``r5gather``
subcommand of ``scripts/bench_hash.py``, for nerfacc_tpu_torch).

    python3 scripts/bench_hash_torch.py r5gather [--n_samples N] [--corners NP]

(a) one gather over the full 16-level table against 16 gathers over the
    per-level 2 MB slices, through PyTorch indexing, at ``n_samples`` x 16
    levels x 8 corners indices: ns per index of both;
(d) the table-gather floor: the CUDA kernel ``table_gather`` at
    ``corners`` indices into one level's 2^19-word table, ns per index,
    beside PyTorch's own indexing on the same inputs (results must be
    equal); then the same at ``n_samples`` x 8 indices, one level's corner
    count, where the card and not the launch bounds the time. Beside each:
    the least time the bytes could take (indices, table and words once
    over the memory rate) and the rate of L2 traffic the kernel reached,
    every gathered word moving a 32-byte sector out of L2
    (``scripts/bench_gather_variants_torch.py`` measures the L2's read
    rate to hold that against).

It prints the card's name and power limit first and has no CPU mode.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

L, T = 16, 1 << 19
HBM_BYTES_PER_S = 3.35e12  # the H100's published memory rate


def _median_ms(fn, iters: int = 10) -> float:
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def r5gather(n_samples: int = 786432, corners: int = 262144,
             device=None) -> dict:
    """Run both measurements on ``device`` (None: the CUDA device) and
    return ``{name: value}``: ns per index of each gather, and the ms of
    the kernel and of PyTorch's indexing in (d)."""
    from nerfacc_tpu_torch.ops import table_gather, table_gather_plain

    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError("r5gather measures the card: it has no CPU mode")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_idx = n_samples * L * 8
    out = {}

    # (a) full table vs per-level slices, PyTorch indexing
    table = torch.randint(0, 2 ** 31 - 1, (L * T,), generator=gen,
                          device=dev, dtype=torch.int32)
    idx_all = torch.randint(0, L * T, (n_samples, L * 8), generator=gen,
                            device=dev)
    ms = _median_ms(lambda: table[idx_all])
    out["full_table_ns_per_idx"] = ms * 1e6 / n_idx
    print(f"G full-table gather ({n_idx / 1e6:.1f}M idx over "
          f"{L * T * 4 / 1e6:.0f} MB): {ms:.3f} ms = "
          f"{out['full_table_ns_per_idx']:.4f} ns/idx", flush=True)
    del idx_all
    idx_l = torch.randint(0, T, (L, n_samples * 8), generator=gen, device=dev)
    ms = _median_ms(lambda: [table[lev * T:(lev + 1) * T][idx_l[lev]]
                             for lev in range(L)])
    out["per_level_ns_per_idx"] = ms * 1e6 / n_idx
    print(f"G per-level gather {L} x ({n_samples * 8 / 1e6:.1f}M idx over "
          f"{T * 4 / 1e6:.0f} MB): {ms:.3f} ms = "
          f"{out['per_level_ns_per_idx']:.4f} ns/idx", flush=True)
    del idx_l

    # (d) the gather floor: the kernel beside PyTorch's indexing, at the
    # asked size (a call this short is bounded by its launch) and at one
    # level's corner count of the step (bounded by the card)
    level = table[:T].contiguous()
    for label, n in (("", corners), ("_level", n_samples * 8)):
        idx = torch.randint(0, T, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        idx_long = idx.long()
        got, want = table_gather(idx, level), table_gather_plain(idx, level)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("table_gather differs from table[idx]")
        k_ms = _median_ms(lambda: table_gather(idx, level), 20)
        i_ms = _median_ms(lambda: level[idx_long], 20)
        out[f"kernel{label}_ms"], out[f"indexing{label}_ms"] = k_ms, i_ms
        out[f"kernel{label}_sector_bytes_per_s"] = 32 * n / (k_ms * 1e-3)
        out[f"kernel{label}_ns_per_idx"] = k_ms * 1e6 / n
        out[f"indexing{label}_ns_per_idx"] = i_ms * 1e6 / n
        print(f"P table_gather kernel ({n / 1e3:.0f}k idx over "
              f"{T * 4 / 1e6:.0f} MB): {k_ms:.4f} ms = "
              f"{k_ms * 1e6 / n:.4f} ns/idx; PyTorch indexing {i_ms:.4f} ms "
              f"= {i_ms * 1e6 / n:.4f} ns/idx; bound "
              f"{4 * (2 * n + T) / HBM_BYTES_PER_S * 1e3:.4f} ms (indices, "
              f"table and words once over 3.35 TB/s); the kernel moved "
              f"{32 * n / (k_ms * 1e-3) / 1e12:.3f} TB/s of 32-byte L2 "
              f"sectors; results equal",
              flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("r5gather", help="forward-gather measurements")
    p.add_argument("--n_samples", type=int, default=786432)
    p.add_argument("--corners", type=int, default=262144)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script measures a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    r5gather(args.n_samples, args.corners)


if __name__ == "__main__":
    main()
