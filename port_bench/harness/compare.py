"""The distances that decide ``correct``, and the verdict against each
cell's limits (``limits/<workload>.json``: a number's name and the most
it may read); the precision the reference runs in, and the reading of
the precision the program ran in."""

from __future__ import annotations

import contextlib
import json
import statistics
from pathlib import Path

import torch

LIMITS = Path(__file__).resolve().parent.parent / "limits"


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|, 0 where both are 0."""
    if a == b:
        return 0.0
    return abs(a - b) / abs(b) if b else float("inf")


def norms(leaves) -> list:
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def leaf_gap(program, reference, include=None) -> float:
    """The worst leaf's gap of norms: |norm(program leaf) - norm(reference
    leaf)| over the larger of the reference leaf's norm and the median
    reference leaf's norm (some gradients are all but zero). ``include``
    leaves out the leaves it marks False."""
    p, r = norms(program), norms(reference)
    keep = [True] * len(r) if include is None else include
    med = statistics.median(x for x, k in zip(r, keep) if k)
    return max(abs(a - b) / max(b, med)
               for a, b, k in zip(p, r, keep) if k)


def faint_gap(program, reference, faint) -> float:
    """The worst gap of norms over the leaves ``faint`` marks, each over
    its own reference norm; 0 where it marks none."""
    return max((rel_gap(a, b) for a, b, f in
                zip(norms(program), norms(reference), faint) if f),
               default=0.0)


def tf32_matmuls() -> bool:
    """Whether cuBLAS may run f32 matrix products in TF32 under PyTorch's
    flags as they stand (``set_float32_matmul_precision("high")`` sets
    this flag too). Read per backend: the generic precision getter
    raises once the legacy and the per-backend setters were mixed."""
    return bool(torch.backends.cuda.matmul.allow_tf32)


def precision_gap(config: dict, tf32_seen: bool) -> float:
    """1 where the program ran its f32 products in another precision than
    the configuration states (``matmul_peak``), else 0."""
    return float(tf32_seen != (config["matmul_peak"] == "tf32"))


@contextlib.contextmanager
def reference_precision():
    """f32 products in full f32 while the reference runs, TF32 off for
    cuBLAS and cuDNN whatever the program set; the flags are put back
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def limits(workload: str) -> dict:
    return json.loads((LIMITS / f"{workload}.json").read_text())


def verdict(numbers: dict, bounds: dict):
    """(correct, {name: {"value", "limit"}}): correct when every number
    is finite and at most its limit; a number without a limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = bounds.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value == value and value <= limit
    return ok, checks
