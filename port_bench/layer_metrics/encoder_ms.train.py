"""``encoder_ms.train``: device milliseconds per training step in the
encoders' forward: the operations launched inside the program's
``nerfacc.encoder`` spans (each encoder's forward, on the density pass,
the field's query and the grid update; its backward runs under
``nerfacc.backward``), over the traced steps recorded with the host's
operations; each operation is attributed by ``harness/spans.py``. None
where the program has no such span. Moves ``train_step_ms``."""

from ..harness import spans


def read(ctx):
    return spans.stage_ms(ctx, "encoder")
