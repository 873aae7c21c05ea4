"""``field_rows_live.render``: the share of live rows in the field's
stage-2 query: the rows it evaluates that are composited
(``field_live``) over the rows it evaluates (``field_rows``: the
compacted budget, or every slot of the dense query), in %, from the
program's counters (``nerfacc_tpu_torch.tracing.snapshot()``) summed
over the traced views. A share, so it does not depend on how many views
the stretches held. None where the program keeps no such counter. Moves
``render_rays_per_s``: a dead row costs the field as much as a live one."""

from ..harness import spans


def read(ctx):
    return spans.live_share(ctx, "field_live", "field_rows")
