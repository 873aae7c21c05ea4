"""``field_gemm_ms.train``: device milliseconds per training step in the
fields' matrix products: the kernels of the traced steps that
``aten::mm`` and ``aten::addmm`` launched (the linear layers, forward
and backward, the grid update's density passes included), by the
profiler's link from each kernel to the operation that launched it.
Moves ``train_step_ms``."""

OPS = ("aten::mm", "aten::addmm")


def read(ctx):
    tr = ctx["host_trace"]
    s = tr.kernel_seconds(lambda e: e["op"] in OPS)
    return 1e3 * s / tr.units if s > 0 else None
