"""``backward_ms.train``: device milliseconds per training step in the
backward: the operations launched while the program's
``nerfacc.backward`` span is open (``loss.backward()``; autograd's own
thread launches them, and they go to the span open on the main thread),
over the traced steps recorded with the host's operations; each
operation is attributed by ``harness/spans.py``. None where the program
has no such span. Moves ``train_step_ms``."""

from ..harness import spans


def read(ctx):
    return spans.stage_ms(ctx, "backward")
