"""``mfu.render``: the model FLOPs of the traced views over their wall
time, as a share of one H100's published peak at the precision the
configuration's matrix products run in. FLOPs come from the
configuration's widths, 2 in out per linear layer and evaluation: the
full field's forward over each view's composited samples and the
density MLP's forward over its density-pass samples, both counted by the
reference, which renders the views of the first traced stretch again
for the check; their wall time is that stretch's. Moves
``render_rays_per_s``."""

from ..harness import roofline


def flops(layers) -> int:
    return sum(2 * int(i) * int(o) for i, o in layers)


def read(ctx):
    cfg, tr, d = ctx["cell"].config, ctx["trace"], ctx["runner"]
    counts = [d.counts[i] for i in d.traced_views() if i in d.counts]
    if not counts:
        return None
    dens = flops(cfg["linear_layers"]["density"])
    full = dens + flops(cfg["linear_layers"]["color"])
    total = sum(full * live + dens * n_dens for live, n_dens in counts)
    return 100.0 * total / tr.wall_s / roofline.PEAK_FLOPS[cfg["matmul_peak"]]
