"""``composite_ms.render``: device milliseconds per view in the composite:
the operations launched inside the program's ``nerfacc.composite`` spans
(the weights, the accumulation along rays, the background), over the
traced views recorded with the host's operations; each operation is
attributed by ``harness/spans.py``. None where the program has no such
span. Moves ``render_rays_per_s``."""

from ..harness import spans


def read(ctx):
    return spans.stage_ms(ctx, "composite")
