"""CUDA-graph replay of ``render_rays``' gradient-free stages.

On the card most stages of a render are short kernels launched one at a
time from Python: a training step's march, density pass and cull, and
every stage of a view's chunk. The host's launches then set the pace, not
the card. :func:`run` captures such a function once per key into CUDA
graphs and replays them after:

- One graph a span. Each ``tracing.span`` entry and exit ends one graph
  and begins the next, and a replay enters each span again around its
  graph, so a profiler finds each replayed kernel in the span it was
  launched in, as on the eager path. The graphs of one capture share one
  memory pool and replay in the order they were captured.
- Each replay copies the call's inputs into the capture's own tensors. The
  outputs are handed out as copies, so a later replay never changes what
  an earlier call returned. The field's parameters and buffers are read
  where they are: an optimizer's in-place update is seen, and a tensor
  replaced by another is a new key.
- The key is what the call shows: the function, the field, the inputs'
  structure, shapes, dtypes and devices, every other argument's value,
  grad mode, the field's tensors' addresses, the plain attributes of its
  modules (its mode, an encoder's ``gather_mode``) and the matmul
  precision flags. A new batch or a new grid of the same shapes is the
  same key. Each field keeps at most ``ENTRIES`` keys a function; the
  oldest goes. The key cannot see a function of the stages rebound in its
  module: :func:`forget` drops the captures after such a change.
- A capture counts what the eager path counts. While a profiler records a
  replay, the recorded counts are made again: an int as it was, a tensor
  count from a copy of its replayed value, a
  :class:`~nerfacc_tpu_torch.tracing.Reduction` anew on the replayed
  outputs. No capture is made while a profiler records.
- A call runs eagerly where it cannot be captured: tensors off the card or
  on several devices, inference mode or an inference tensor among the
  inputs, an argument that cannot be hashed into the key (a NumPy array),
  a field that is not a module, an input that takes a gradient while grad
  mode is on, a stream that is already capturing, a profiler recording at
  a new key. A call whose first run synchronises with the host, or whose
  capture the runtime refuses, runs eagerly from then on for its key;
  ``stats`` counts captures and such fallbacks.

The first call at a key runs the function on its inputs on the capture
stream, under ``torch.cuda.set_sync_debug_mode("error")``, and hands out
what that run computed; then it captures the function on the inputs'
copies. Later calls replay. The function
runs under ``torch.no_grad``: it must be free of gradients. Kernels
written by hand are captured through their own wrappers, and each
wrapper's ``launches`` counts what ran on the card: the first run's
launches as they happen, none for the capture, and at each replay the
launches of the captured graphs. A call thus counts what the eager path
counts.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import itertools
import warnings
import weakref
from typing import Callable

import torch

from . import tracing

ENTRIES = 8  # keys kept per field and function

stats = {"captures": 0, "fallbacks": 0}


# ---------------------------------------------------------------- structure

def _flatten(obj, leaves: list):
    """A hashable description of ``obj``, with its tensors appended to
    ``leaves`` and standing as their shape, dtype and device."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("T", tuple(obj.shape), obj.dtype, obj.device)
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(_flatten(x, leaves) for x in obj))
    if isinstance(obj, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in obj.items()))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj), tuple((f.name, _flatten(getattr(obj, f.name),
                                                   leaves))
                                 for f in dataclasses.fields(obj)))
    hash(obj)  # any other value is part of the key
    return ("S", type(obj), obj)


def _unflatten(spec, leaves):
    """``obj`` again from its description and an iterator of tensors."""
    kind, body = spec[0], spec[1:]
    if kind == "T":
        return next(leaves)
    if kind == "S":
        return body[1]
    (items,) = body
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in items}
    if dataclasses.is_dataclass(kind):
        return kind(**{k: _unflatten(v, leaves) for k, v in items})
    values = [_unflatten(v, leaves) for v in items]
    if kind in (tuple, list):
        return kind(values)
    return kind(*values)  # a named tuple


def _device(leaves):
    """The one CUDA device of every tensor, or None."""
    devices = {t.device for t in leaves}
    if len(devices) != 1:
        return None
    (device,) = devices
    return device if device.type == "cuda" else None


def _addresses(field) -> tuple:
    return tuple(t.data_ptr() for t in itertools.chain(field.parameters(),
                                                       field.buffers()))


_PLAIN = (bool, int, float, str, type(None), enum.Enum)


def _attributes(field) -> tuple:
    """The plain attributes of the field's modules: its mode, and the
    settings that choose its path."""
    return tuple((name, k, v) for name, m in field.named_modules()
                 for k, v in vars(m).items()
                 if not k.startswith("_") and isinstance(v, _PLAIN))


def _precision() -> tuple:
    """The flags that choose a matmul's kernel."""
    matmul = torch.backends.cuda.matmul
    return (torch.get_float32_matmul_precision(),
            matmul.allow_fp16_reduced_precision_reduction,
            matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32)


def _launch_counters() -> list:
    """The kernel wrappers, each counting its own launches."""
    from . import ops

    return [f for f in (getattr(ops, n) for n in ops.__all__)
            if hasattr(f, "launches")]


# ---------------------------------------------------------------- runtime

class _CudaRuntime:
    """What a capture takes from the CUDA runtime."""

    def __init__(self):
        self._streams = {}

    def usable(self, device) -> bool:
        return not torch.cuda.is_current_stream_capturing()

    def graph(self):
        return torch.cuda.CUDAGraph()

    def pool(self, device):
        return torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def on_side_stream(self, device):
        """Run on the capture stream of ``device``, after the caller's
        stream's work, and the caller's stream after it."""
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        try:
            with torch.cuda.device(device), torch.cuda.stream(stream):
                yield
        finally:
            caller.wait_stream(stream)

    @contextlib.contextmanager
    def strict(self):
        """Raise at any synchronisation with the host."""
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():  # that the mode is a prototype
            warnings.simplefilter("ignore", UserWarning)
            torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def abandoned(self, device, pool) -> None:
        """After a capture the runtime refused: stop sending the capture
        stream's allocations to ``pool``, and take another stream."""
        end = (getattr(torch._C, "_cuda_endAllocateToPool", None)
               or getattr(torch._C, "_cuda_endAllocateCurrentStreamToPool",
                          None))
        if end is not None:
            with contextlib.suppress(RuntimeError):
                end(device.index, pool)
        self._streams.pop(device, None)


_runtime = _CudaRuntime()


# ---------------------------------------------------------------- capture

class _Mute:
    """Takes the spans and counts of a warm-up, and drops them."""

    def span(self, name):
        return contextlib.nullcontext()

    def count(self, name, value):
        pass


class _Recorder:
    """Captures one graph a span; keeps the events a replay repeats:
    ``("graph", g)``, ``("enter", name)``, ``("exit", name)`` and
    ``("count", name, value)``, each count after its span's graph. Every
    graph it began stays in ``graphs``, the empty ones too: the graphs of a
    shared pool keep it alive, and one freed early would free the pool
    under the others."""

    def __init__(self, pool):
        self.pool = pool
        self.events, self.counts, self.graphs, self.graph = [], [], [], None

    def begin(self) -> None:
        self.graph = _runtime.graph()
        self.graphs.append(self.graph)
        self.graph.capture_begin(pool=self.pool)

    def end(self) -> None:
        graph = self.graph
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        self.graph = None  # only once the capture has ended
        empty = False
        for w in caught:
            if "Graph is empty" in str(w.message):
                empty = True
            else:
                warnings.warn(w.message, w.category)
        if not empty:
            self.events.append(("graph", graph))
        self.events.extend(self.counts)
        self.counts = []

    def abandon(self) -> None:
        graph, self.graph = self.graph, None
        with contextlib.suppress(RuntimeError):
            graph.capture_end()

    @contextlib.contextmanager
    def span(self, name):
        self.end()
        self.events.append(("enter", name))
        self.begin()
        yield
        self.end()
        self.events.append(("exit", name))
        self.begin()

    def count(self, name, value):
        self.counts.append(("count", name, value))


class _Graphed:
    """One key's capture: its input tensors, the events, its outputs, and
    the launches of each kernel wrapper that its graphs hold."""

    def __init__(self, inputs, rec, out_spec, outputs, launches):
        self.inputs = inputs
        self.events, self.graphs = rec.events, rec.graphs
        self.out_spec, self.outputs = out_spec, outputs
        self.launches = launches

    def replay(self, leaves):
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(src)
        profiled = tracing.enabled()
        spans, memo = [], {}
        try:
            for event in self.events:
                if event[0] == "graph":
                    event[1].replay()
                elif not profiled:
                    continue
                elif event[0] == "enter":
                    spans.append(tracing.span(event[1]))
                    spans[-1].__enter__()
                elif event[0] == "exit":
                    spans.pop().__exit__(None, None, None)
                else:
                    tracing.count(event[1], _replayed(event[2], memo))
        finally:
            while spans:
                spans.pop().__exit__(None, None, None)
        for wrapper, n in self.launches:
            wrapper.launches += n
        return _unflatten(self.out_spec, (t.clone() for t in self.outputs))


def _replayed(value, memo: dict):
    """A recorded count's value at a replay."""
    if isinstance(value, tracing.Reduction):
        if id(value) not in memo:
            memo[id(value)] = value.fn(*value.args)
        return memo[id(value)]
    if isinstance(value, torch.Tensor):
        return value.clone()  # the count keeps it; the next replay writes
    return value


def _capture(fn: Callable, field, args, spec, leaves, device):
    """Run ``fn`` on the call's inputs, then capture it on copies of them.
    Returns ``(entry, out)``: a :class:`_Graphed`, or None where the run or
    the capture failed, and what the run computed, or None where it
    failed."""
    inputs = [t.detach().clone() for t in leaves]
    counters = _launch_counters()
    rec = _Recorder(_runtime.pool(device))
    failure, phase, out, warm = None, "first run", None, None
    with _runtime.on_side_stream(device), torch.no_grad():
        try:
            with _runtime.strict(), tracing.recording(_Mute()):
                out = fn(field, *args)
            warm = [c.launches for c in counters]
            phase = "capture"
            with tracing.recording(rec):
                rec.begin()
                captured = fn(field, *_unflatten(spec, iter(inputs)))
                rec.end()
        except RuntimeError as e:  # a synchronisation, the runtime's refusal
            failure = e
        finally:
            if rec.graph is not None:
                rec.abandon()
                _runtime.abandoned(device, rec.pool)
            if warm is not None:  # a capture launches nothing
                ends = [c.launches for c in counters]
                for c, n in zip(counters, warm):
                    c.launches = n
    if failure is not None:
        warnings.warn(f"{fn.__qualname__} runs eagerly for this key: its "
                      f"{phase} raised {failure!r}", RuntimeWarning)
        return None, out
    outputs = []
    out_spec = _flatten(captured, outputs)
    launches = [(c, e - w) for c, w, e in zip(counters, warm, ends) if e > w]
    return _Graphed(inputs, rec, out_spec, outputs, launches), out


# ---------------------------------------------------------------- the cache

_sites: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def forget(field=None) -> None:
    """Drop the captures of ``field``, or of every field. Call it after
    rebinding a function that the stages call in its module (a stand-in,
    the plain twin of a kernel): the key cannot see that, and a replay
    would run what was captured before."""
    if field is None:
        _sites.clear()
    else:
        _sites.pop(field, None)


def run(fn: Callable, field, args: tuple):
    """``fn(field, *args)``, replayed from its CUDA graphs where it can be.

    ``fn`` must compute without gradients, read the field's tensors in
    place and take every other tensor it reads from ``args``, which may nest
    tuples, lists, dicts and dataclasses of tensors and hashable values.
    Returns ``(outputs, replayed)``: what ``fn`` returns (on a replay, as
    copies), and whether the call replayed graphs.
    """
    leaves = []
    try:
        spec = _flatten(args, leaves)
    except TypeError:  # an argument that cannot be part of a key
        return fn(field, *args), False
    device = _device(leaves)
    grad = torch.is_grad_enabled()
    if (device is None or not isinstance(field, torch.nn.Module)
            or torch.is_inference_mode_enabled()
            or any(t.is_inference() for t in leaves)
            or (grad and any(t.requires_grad for t in leaves))
            or not _runtime.usable(device)):
        return fn(field, *args), False
    entries = _sites.setdefault(field, {}).setdefault(
        fn, collections.OrderedDict())
    key = (spec, grad, _attributes(field), _addresses(field), _precision())
    out, captured = None, False
    if key in entries:
        entry = entries[key]
        entries.move_to_end(key)
    elif tracing.enabled():
        return fn(field, *args), False
    else:
        entry, out = _capture(fn, field, args, spec, leaves, device)
        captured = entry is not None
        stats["captures" if captured else "fallbacks"] += 1
        entries[key] = entry
        if len(entries) > ENTRIES:
            entries.popitem(last=False)
    tracing.count("graph_captures", int(captured))
    tracing.count("graph_fallbacks", int(entry is None))
    if out is not None:  # the first run's
        return out, False
    if entry is None:
        return fn(field, *args), False
    return entry.replay(leaves), True
