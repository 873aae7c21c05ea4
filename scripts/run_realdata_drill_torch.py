#!/usr/bin/env python3
"""The real-data drill on the card: the port's twin of
``scripts/run_realdata_drill.py``.

Writes a blender-format fixture of the procedural scene (96x96, 24 train,
2 val and 4 test views, rendered on the card) into a temporary directory,
then drives ``examples/train_ngp_nerf_torch.py`` through the on-disk loader
and the native batch assembler (``--data_root``) for 1,000 steps with the
TensoCP field at its default levels and the kernels (``--use_kernel
--fused_march``), and requires the held-out PSNR to exceed 25: deep
enough that a sign error in the loader's pose or ray conventions cannot
hide behind a few steps.

    python3 scripts/run_realdata_drill_torch.py [--max_steps 1000]

Prints the trainer's output and ``drill PSNR=...``; exits nonzero at or
under the threshold.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the trainer's flags after --data_root (run_realdata_drill.py's recipe)
DRILL = ("--max_steps", "1000", "--num_rays", "4096",
         "--grid_resolution", "96", "--max_samples_per_ray", "512",
         "--samples_budget", "131072", "--visible_samples_budget", "65536",
         "--test_chunk_size", "4096", "--eval_views", "2")
KERNELS = ("--use_kernel", "--fused_march")


def write_fixture(root, image_size: int = 96, device=None) -> Path:
    """The drill's blender fixture under ``root``: 24 train and 4 test
    views (and the writer's 2 val views) of ``image_size`` pixels."""
    from nerfacc_tpu_torch.datasets.fixtures import write_blender_fixture

    return write_blender_fixture(root, n_train=24, n_test=4,
                                 height=image_size, width=image_size,
                                 device=device)


def drill_argv(root, max_steps: int = 1000) -> list:
    """The trainer's command line on the fixture under ``root``."""
    return ["--scene", "procedural", "--data_root", str(root), *DRILL,
            *KERNELS, "--max_steps", str(max_steps)]


def load_trainer():
    spec = importlib.util.spec_from_file_location(
        "train_ngp_nerf_torch", ROOT / "examples" / "train_ngp_nerf_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max_steps", type=int, default=1000)
    ap.add_argument("--threshold", type=float, default=25.0)
    ap.add_argument("--image_size", type=int, default=96)
    args = ap.parse_args()

    with tempfile.TemporaryDirectory(prefix="blender_drill_") as root:
        write_fixture(root, args.image_size)
        argv = drill_argv(root, args.max_steps)
        print("train_ngp_nerf_torch.py " + " ".join(argv), flush=True)
        psnr = load_trainer().main(argv)["psnr"]
    print(f"drill PSNR={psnr} (threshold {args.threshold})", flush=True)
    sys.exit(0 if psnr > args.threshold else 1)


if __name__ == "__main__":
    main()
