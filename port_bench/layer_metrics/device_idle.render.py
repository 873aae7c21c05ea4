"""``device_idle.render``: the share of the traced views' wall time (host
clock, synchronised at both ends) in which no operation ran on the
card. Moves ``render_rays_per_s``."""


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
