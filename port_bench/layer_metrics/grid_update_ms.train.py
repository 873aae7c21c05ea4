"""``grid_update_ms.train``: device milliseconds per training step spent
in ``update_grid``: CUDA events recorded around every grid update of the
window, summed, over the window's steps. Moves ``train_step_ms``."""


def read(ctx):
    win = ctx["window"]
    c = win["counters"]
    if not c["grid_updates"]:
        return None
    return c["grid_update_ms"] / win["units"]
