"""``composite_ms.train``: device milliseconds per training step in the
composite: the operations launched inside the program's
``nerfacc.composite`` spans (the weights, the accumulation along rays,
the background), over the traced steps recorded with the host's
operations; each operation is attributed by ``harness/spans.py``. None
where the program has no such span. Moves ``train_step_ms``."""

from ..harness import spans


def read(ctx):
    return spans.stage_ms(ctx, "composite")
