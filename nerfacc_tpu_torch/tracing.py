"""Spans and counters of the port, on only while ``torch.profiler`` records.

``span(name)`` is ``torch.profiler.record_function("nerfacc." + name)``
while a profiler records, and a shared no-op context otherwise: with
tracing off a span costs one flag read. The spans are events of the
profiler's own session, beside the CUDA activity, so the host's spans and
the card's operations share one clock and one trace. Nothing else turns
tracing on. The spans, nested as they run::

    nerfacc.train_step       training.train_step
      nerfacc.render         utils.render_rays
        nerfacc.march        t-range, probes, ray compaction, march_rays
        nerfacc.density_pass the stage-1 density query
          nerfacc.encoder    each encoder's forward, wherever it runs
        nerfacc.cull         visibility, reselect_visible
        nerfacc.field        the stage-2 query, its compaction and expand
        nerfacc.composite    weights, accumulation, background
      nerfacc.loss           compact_mse
      nerfacc.backward       loss.backward()
      nerfacc.optimizer      zero_grad, optimizer.step()
    nerfacc.update_grid      grid.update_grid
    nerfacc.render_image     one view; its chunks are nerfacc.render

Autograd runs the backward of CUDA tensors on a thread of its own, where
no span is open. A device operation launched from a thread with no open
span is attributed to the span open at its launch on the thread that
entered the spans: the backward's kernels to ``nerfacc.backward``.

``count(name, value)`` adds ``value`` to a named total while a profiler
records: a Python int (work fixed by shapes and budgets), a 0-d device
tensor the program has already computed, kept by reference, or a
:class:`Reduction`, a count that needs a reduction of its own, computed
only while a profiler records. Only ``snapshot()`` reads device values,
so counting adds no host synchronisation. The counters: ``rays``,
``rays_hit`` (rays the ray compaction keeps; every ray without it),
``march_live`` (live slots after the march), ``density_rows`` and
``density_live`` (rows the density pass evaluates, the live among them),
``field_rows`` and ``field_live`` (the same for the stage-2 query; live:
composited), ``field_budget_dropped``, ``grid_cells`` (cells a grid
update evaluates), ``march_kernel_rays`` (rays the exact stride-1 march
ran through its CUDA kernel, ``ops.march_select.march_dense``),
``graph_rays`` (rays whose gradient-free stages were replayed from CUDA
graphs, :mod:`nerfacc_tpu_torch.graphs`), ``graph_captures`` and
``graph_fallbacks`` (captures made, and captures that failed so that the
call ran eagerly). The totals belong to the process, like the profiler.

While :mod:`~nerfacc_tpu_torch.graphs` captures a call, it takes the spans
and the counts itself (``recording``): each span's entry and exit ends one
graph and begins the next, and the counts are kept to be made again at
each replay.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Union

import torch

PREFIX = "nerfacc."

_OFF = contextlib.nullcontext()
_ints: Dict[str, int] = {}
_tensors: Dict[str, List[torch.Tensor]] = {}
_recorder = None  # what takes spans and counts while a graph is captured


class Reduction:
    """A count that needs a reduction of its own, ``fn(*args)``: computed
    at most once, and only when a count is made while a profiler
    records."""

    def __init__(self, fn: Callable, *args):
        self.fn, self.args, self.value = fn, args, None

    def __call__(self) -> torch.Tensor:
        if self.value is None:
            self.value = self.fn(*self.args)
        return self.value


@contextlib.contextmanager
def recording(recorder):
    """Send every span and count to ``recorder`` (its ``span(name)`` and
    ``count(name, value)``) for the duration."""
    global _recorder
    outer, _recorder = _recorder, recorder
    try:
        yield recorder
    finally:
        _recorder = outer


def enabled() -> bool:
    """A profiler records: spans and counters are on."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A ``nerfacc.<name>`` span while a profiler records, else a no-op
    context."""
    if _recorder is not None:
        return _recorder.span(name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def count(name: str, value: Union[int, torch.Tensor, Reduction]) -> None:
    """Add ``value`` to the total ``name`` while a profiler records."""
    if _recorder is not None:
        _recorder.count(name, value)
        return
    if not torch.autograd._profiler_enabled():
        return
    if isinstance(value, Reduction):
        value = value()
    if isinstance(value, torch.Tensor):
        _tensors.setdefault(name, []).append(value)
    else:
        _ints[name] = _ints.get(name, 0) + int(value)


def snapshot() -> Dict[str, int]:
    """The totals as ints (the one place that reads device values)."""
    out = dict(_ints)
    for name, values in _tensors.items():
        dev = values[0].device
        total = torch.stack([v.to(dev, torch.int64) for v in values]).sum()
        out[name] = out.get(name, 0) + int(total)
    return out


def reset() -> None:
    """Clear every total."""
    _ints.clear()
    _tensors.clear()
