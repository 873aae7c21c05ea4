"""``launches_per_step.train``: kernels launched per training step, from
the profiler's CUDA activity over the traced steps. Moves
``train_step_ms``: each launch costs the host some microseconds."""


def read(ctx):
    tr = ctx["trace"]
    return len(tr.kernels) / tr.units if tr.kernels else None
