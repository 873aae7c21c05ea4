"""``launches_per_view.render``: kernels launched per view, from the
profiler's CUDA activity over the traced views. Moves
``render_rays_per_s``."""


def read(ctx):
    tr = ctx["trace"]
    return len(tr.kernels) / tr.units if tr.kernels else None
