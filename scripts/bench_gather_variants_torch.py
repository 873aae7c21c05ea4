#!/usr/bin/env python3
"""Design variants of the table gather (K8) timed beside the package's
kernel and PyTorch's indexing, on one NVIDIA GPU (Hopper).

    python3 scripts/bench_gather_variants_torch.py

It builds ``scripts/csrc/gather_variants.cu`` with ``nvcc`` into
``build/gather_variants/`` and, at 262,144 and 6,291,456 indices into a
2^19-word table, prints the time per call (ten calls back to back between
one pair of CUDA events, median of 20 windows, so that the host's share of
a call does not count) of:

- the L2's read rate first (16-byte reads past L1 of a 16 MB buffer, 20
  passes in one launch), and from it each size's L2 sector floor: a random
  4-byte read moves a whole 32-byte sector out of L2;
- ``table[idx]`` and the package's ``table_gather``;
- 16-byte gathers with 1, 2 or 4 vectors per thread and step, at 0 (one
  thread per vector), 4, 8 or 16 blocks per SM, with and without the
  streaming hints;
- the table held in the distributed shared memory of a cluster of 16
  thread blocks.

Every variant's result is compared with ``table[idx]`` first. The variants
are measurements only: the package's kernel is the one in
``nerfacc_tpu_torch/csrc/table_gather.cu``. No CPU mode.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
SOURCE = ROOT / "scripts" / "csrc" / "gather_variants.cu"
BUILD_DIR = ROOT / "build" / "gather_variants"
T = 1 << 19
CALLS = 10


def build() -> ctypes.CDLL:
    from nerfacc_tpu_torch import _build

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / "libgather_variants.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    handle.variants_gather_vec4.argtypes = [i, i, i, p, p, p, n, i, p]
    handle.variants_gather_cluster.argtypes = [p, p, p, n, i, p, p]
    handle.variants_read_l2.argtypes = [p, n, i, p, p]
    handle.variants_error_string.argtypes = [i]
    handle.variants_error_string.restype = ctypes.c_char_p
    return handle


def per_call_ms(fn) -> float:
    fn()
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script measures a GPU")
    from nerfacc_tpu_torch.ops import table_gather

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    lib = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(0, 2 ** 31 - 1, (T,), generator=gen, device=dev,
                          dtype=torch.int32)
    clusters = ctypes.c_int(0)

    def check(err, what):
        if err:
            msg = lib.variants_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err}: {msg}")

    def stream():
        return torch._C._cuda_getCurrentRawStream(0)

    buf = torch.ones((1 << 22,), dtype=torch.int32, device=dev)  # 16 MB
    sink = torch.zeros((1,), dtype=torch.int32, device=dev)
    passes = 20

    def read():
        check(lib.variants_read_l2(buf.data_ptr(), buf.numel() // 4, passes,
                                   sink.data_ptr(), stream()), "read_l2")
    l2_rate = buf.numel() * 4 * passes / (per_call_ms(read) * 1e-3)
    print(f"L2 read rate (16 MB, {passes} passes per launch): "
          f"{l2_rate / 1e12:.3f} TB/s")

    for n in (262144, 6291456):
        idx = torch.randint(0, T, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        idx_long = idx.long()
        want = table[idx_long]
        out = torch.empty_like(idx)
        ptrs = (idx.data_ptr(), table.data_ptr(), out.data_ptr(), n, T)

        print(f"N={n}, per call over {CALLS} calls back to back (L2 sector "
              f"floor {32 * n / l2_rate * 1e3:.4f} ms, byte bound "
              f"{4 * (2 * n + T) / 3.35e12 * 1e3:.4f} ms):")
        print(f"  table[idx]: {per_call_ms(lambda: table[idx_long]):.4f} ms")
        print("  the package's table_gather: "
              f"{per_call_ms(lambda: table_gather(idx, table)):.4f} ms",
              flush=True)
        for vectors in (1, 2, 4):
            for blocks_per_sm in (0, 4, 8, 16):
                for hints in (1, 0):
                    def run():
                        check(lib.variants_gather_vec4(
                            vectors, hints, blocks_per_sm, *ptrs, stream()),
                            "gather_vec4")
                    out.zero_()
                    run()
                    torch.cuda.synchronize()
                    if not torch.equal(out[:n // 4 * 4], want[:n // 4 * 4]):
                        raise AssertionError("gather_vec4 differs")
                    print(f"  {vectors} vectors per step, {blocks_per_sm} "
                          f"blocks per SM, streaming hints "
                          f"{'on' if hints else 'off'}: "
                          f"{per_call_ms(run):.4f} ms", flush=True)

        def run_cluster():
            check(lib.variants_gather_cluster(
                *ptrs, ctypes.byref(clusters), stream()), "gather_cluster")
        out.zero_()
        run_cluster()
        torch.cuda.synchronize()
        if not torch.equal(out[:n // 4 * 4], want[:n // 4 * 4]):
            raise AssertionError("gather_cluster differs")
        print(f"  table in the shared memory of clusters of 16 blocks "
              f"({clusters.value} clusters at once): "
              f"{per_call_ms(run_cluster):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
