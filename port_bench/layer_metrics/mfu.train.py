"""``mfu.train``: the model FLOPs of the window's training steps over the
window's seconds, as a share of one H100's published peak at the
precision the configuration's matrix products run in (``matmul_peak``).

FLOPs come from the configuration's widths, 2 in out per linear layer
and evaluation: forward and backward (three times the forward) over the
live samples each step composites (the program's own count, summed over
the window), and the density MLP's forward over the cells of every grid
update in the window. The cull's density pass is not counted (the
program reports no count of its samples), so the share is a lower bound
of the model's work rate. Moves ``train_step_ms``."""

from ..harness import roofline


def flops(layers) -> int:
    return sum(2 * int(i) * int(o) for i, o in layers)


def read(ctx):
    cfg, win = ctx["cell"].config, ctx["window"]
    c = win["counters"]
    if not c["live_samples"]:
        return None
    dens = flops(cfg["linear_layers"]["density"])
    full = dens + flops(cfg["linear_layers"]["color"])
    cells = 2 * (cfg["grid_resolution"] ** 3 // 4)
    total = 3 * full * c["live_samples"] + dens * cells * c["grid_updates"]
    peak = roofline.PEAK_FLOPS[cfg["matmul_peak"]]
    return 100.0 * total / win["seconds"] / peak
