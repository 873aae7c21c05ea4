"""``optimizer_ms.train``: device milliseconds per training step in the
optimizer: the operations launched inside the program's
``nerfacc.optimizer`` spans (``zero_grad`` and Adam's ``step``), over
the traced steps recorded with the host's operations; each operation is
attributed by ``harness/spans.py``. None where the program has no such
span. Moves ``train_step_ms``."""

from ..harness import spans


def read(ctx):
    return spans.stage_ms(ctx, "optimizer")
