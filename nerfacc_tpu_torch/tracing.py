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
records: a Python int (work fixed by shapes and budgets) or a 0-d device
tensor the program has already computed, kept by reference. Only
``snapshot()`` reads device values, so counting adds no host
synchronisation. Where a count needs a reduction of its own, the site
computes it only under ``enabled()``. The counters: ``rays``,
``rays_hit`` (rays the ray compaction keeps; every ray without it),
``march_live`` (live slots after the march), ``density_rows`` and
``density_live`` (rows the density pass evaluates, the live among them),
``field_rows`` and ``field_live`` (the same for the stage-2 query; live:
composited), ``field_budget_dropped``, ``grid_cells`` (cells a grid
update evaluates), ``march_kernel_rays`` (rays the exact stride-1 march
ran through its CUDA kernel, ``ops.march_select.march_dense``). The totals belong to the process, like the profiler.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Union

import torch

PREFIX = "nerfacc."

_OFF = contextlib.nullcontext()
_ints: Dict[str, int] = {}
_tensors: Dict[str, List[torch.Tensor]] = {}


def enabled() -> bool:
    """A profiler records: spans and counters are on."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A ``nerfacc.<name>`` span while a profiler records, else a no-op
    context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` to the total ``name`` while a profiler records."""
    if not torch.autograd._profiler_enabled():
        return
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
