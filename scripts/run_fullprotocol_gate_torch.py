#!/usr/bin/env python3
"""The full-protocol gate on the card: the port's twin of
``scripts/run_fullprotocol_gate.py``.

The reference's headline is NGP on Lego: 800x800, 100 train views, 20k
steps, 35.50 PSNR in 287 s on a TITAN RTX (the reference toolbox's own
numbers). No published dataset ships with the repository, so this gate
writes the procedural scene in the same protocol as an on-disk blender
fixture (800x800, 100 train views over the upper hemisphere, 8 test
views, rendered on the card) and drives
``examples/train_ngp_nerf_torch.py`` through the loader at the protocol's
scale: a 128^3 grid, batches sized to 2^18 samples
(``--target_sample_batch_size``), cosine learning-rate decay, 20k steps,
with the kernels (``--use_kernel --fused_march``).

    python3 scripts/run_fullprotocol_gate_torch.py --model ngp
    python3 scripts/run_fullprotocol_gate_torch.py --model tensorf \\
        --max_steps 20000

The fixture is kept under ``--fixture_dir`` (default
``build/fixtures/nerfsynth800``) and reused while it has the asked views.
Prints the trainer's output, then one JSON line with ``psnr``,
``train_time_s`` (the trainer's) and ``wall_s`` (the run's, fixture load
included) beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from run_realdata_drill_torch import KERNELS, load_trainer  # noqa: E402

SUBJECT = "procedural"


def write_fixture(root, size: int = 800, n_train: int = 100,
                  n_test: int = 8, device=None) -> Path:
    """The protocol fixture under ``root``: ``n_train`` train and
    ``n_test`` test views over the upper hemisphere, ``size`` pixels
    square, no val split."""
    from nerfacc_tpu_torch.datasets.fixtures import write_blender_fixture

    return write_blender_fixture(root, SUBJECT, n_train=n_train, n_val=0,
                                 n_test=n_test, height=size, width=size,
                                 hemisphere=True, device=device)


def protocol_argv(root, model: str = "ngp", max_steps: int = 20000,
                  num_rays: int = 8192, eval_views: int = 8) -> list:
    """The trainer's command line at the protocol's scale on the fixture
    under ``root``."""
    return [
        "--scene", SUBJECT, "--data_root", str(root), "--model", model,
        "--max_steps", str(max_steps), "--num_rays", str(num_rays),
        # the reference protocol: a 128^3 grid and 2^18-sample batches;
        # cosine decay stands in for its step schedule
        "--grid_resolution", "128", "--max_samples_per_ray", "1024",
        "--samples_budget", str(1 << 18),
        "--visible_samples_budget", str(1 << 17),
        "--target_sample_batch_size", str(1 << 18), "--lr_decay",
        "--test_chunk_size", "8192", "--eval_views", str(eval_views),
        "--coarse_stride", "16", "--probe_groups", "32", *KERNELS,
    ]


def ensure_fixture(root: Path, size: int, n_train: int, n_test: int) -> None:
    marker = root / SUBJECT / "transforms_train.json"
    if marker.exists():
        if len(json.loads(marker.read_text())["frames"]) == n_train:
            print(f"fixture exists: {root / SUBJECT}", flush=True)
            return
    t0 = time.perf_counter()
    write_fixture(root, size, n_train, n_test)
    print(f"fixture rendered in {time.perf_counter() - t0:.1f} s "
          f"({n_train} train + {n_test} test views at {size}x{size})",
          flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", type=str, default="tensorf",
                    choices=["tensorf", "ngp"])
    ap.add_argument("--max_steps", type=int, default=20000)
    ap.add_argument("--num_rays", type=int, default=8192)
    ap.add_argument("--image_size", type=int, default=800)
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--eval_views", type=int, default=8)
    ap.add_argument("--fixture_dir", type=str,
                    default=str(ROOT / "build" / "fixtures" / "nerfsynth800"))
    ap.add_argument("--gen_only", action="store_true")
    args = ap.parse_args()

    root = Path(args.fixture_dir)
    ensure_fixture(root, args.image_size, args.n_train,
                   max(args.eval_views, 1))
    if args.gen_only:
        return
    argv = protocol_argv(root, args.model, args.max_steps, args.num_rays,
                         args.eval_views)
    print("train_ngp_nerf_torch.py " + " ".join(argv), flush=True)
    t0 = time.perf_counter()
    out = load_trainer().main(argv)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "gate": "fullprotocol800",
        "model": args.model,
        "steps": args.max_steps,
        "psnr": out["psnr"],
        "train_time_s": out["train_time_s"],
        "wall_s": wall,
        "device": smi_line(),
        "reference_anchor": {"psnr": 35.50, "time_s": 287,
                             "source": "the reference toolbox's NGP on "
                             "Lego, TITAN RTX"},
    }), flush=True)


if __name__ == "__main__":
    main()
