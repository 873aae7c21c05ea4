"""``density_pass_live.render``: the share of live rows in the density
pass: the rows it evaluates that hold a live slot of the march
(``density_live``) over the rows it evaluates (``density_rows``: the
compacted budget, or every slot of the dense pass), in %, from the
program's counters (``nerfacc_tpu_torch.tracing.snapshot()``) summed
over the traced views. A share, so it does not depend on how many views
the stretches held. None where the program keeps no such counter. Moves
``render_rays_per_s``: a dead row costs the field as much as a live one."""

from ..harness import spans


def read(ctx):
    return spans.live_share(ctx, "density_live", "density_rows")
