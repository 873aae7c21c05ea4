"""``hash_scatter_roofline.train``: the hash table's gradient scatter (the
kernel ``hash_grad_scatter_levels``) as a share of its roofline over the
traced steps: the sum of each step's least time over the sum of the
kernel's device times.

A step's work is the table gradient of the field samples it composites,
N = the live samples ``train_step`` reports for that step (not the
``field_samples_budget`` rows the compaction pads to), over L levels of
T entries of F features: read once, each sample's L x 8 corner indices
and weights (4 bytes each) and its F L cotangents (4 bytes); written
once, the (L, T, F) f32 gradient; a multiply and an add per corner and
feature. The least time is the larger of the bytes at 3.35 TB/s and the
operations at the f32 peak; the bytes bound it (under 0.4 FLOP a
byte). Moves ``train_step_ms``."""

from ..harness import roofline

KERNEL = "hash_grad_scatter_levels_kernel"


def work(n: int, levels: int, entries: int, features: int):
    """(operations, bytes) of one table gradient."""
    ops = 2 * n * levels * 8 * features
    moved = (n * (levels * 8 * 4 * 2 + features * levels * 4)
             + levels * entries * features * 4)
    return ops, moved


def read(ctx):
    cfg = ctx["cell"].config
    launches = [e for e in ctx["trace"].kernels if KERNEL in e["name"]]
    if not launches:
        return None
    live = [int(n) for n in ctx["runner"].stretch_live[0]]
    least = sum(roofline.least_seconds(*work(
        n, cfg["levels"], 1 << cfg["log2_table"], cfg["features"]))
        for n in live)
    return 100.0 * least / (sum(e["dur"] for e in launches) * 1e-6)
