"""``device_idle.train``: the share of the traced steps' wall time (host
clock, synchronised at both ends) in which no operation ran on the
card: one less the union of the device operations' intervals over that
time. Moves ``train_step_ms``."""


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
