"""``march_ms.render``: device milliseconds per view in the march: the
operations launched inside the program's ``nerfacc.march`` spans (the
t-range, the probes, the ray compaction, the grouped march with K5 and
its exact re-check), over the traced views recorded with the host's
operations; each operation is attributed by ``harness/spans.py``. None
where the program has no such span. Moves ``render_rays_per_s``."""

from ..harness import spans


def read(ctx):
    return spans.stage_ms(ctx, "march")
