"""The program's tracing: spans at its layer boundaries, and the card's work
in a torch.profiler trace.

Spans. `span(name, index=None)` marks a layer boundary:
  - with neither a torch.profiler session nor a `recording()` on, it is one
    shared no-op context: two flag checks, nothing allocated;
  - under a running torch.profiler it opens record_function(name), so the
    span lands in the trace on the profiler's own clock (and a trace's idle
    gaps can be named after it);
  - inside `recording()` it also keeps a SpanRecord: its name, its parent
    span, an index (a step, or a frame's key and chunk), its host start and
    end (perf_counter_ns) and, on the card, a pair of timing events
    recorded on the current stream with external=True. Inside a CUDA graph
    capture such an event is an event-record node of the graph, so the
    pair times the span on the device at every replay, with no launch and
    no host sync of its own.
After the caller's own sync, `Records.device_ms()` gives {name: [ms, ...]}
(empty off the card) and `Records.host_ms()` the same for the host clock.

The backward has no host boundary to hang a span on: `backward_span(name)`
gives identity markers for a forward region's inputs and outputs, whose
backward opens the span (the outputs' gradients arrived) and closes it (the
inputs' gradients are complete). Outside `recording()` the markers return
their tensors as they are, so the autograd graph has no node of theirs.

`device_work(prof)` reads the kernels and copies the card ran from a
profile (cli/bench.py --profile, tools/torch_perf_breakdown.py).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

_NULL = contextlib.nullcontext()
_current = None      # the innermost recording's Records, None when off
_enclosing = []      # the values of _current that recording() restores


def _profiler_on() -> bool:
    return torch._C._autograd._profiler_enabled()


@dataclass(eq=False)
class SpanRecord:
    name: str
    parent: Optional[str]
    index: Any
    host_start_ns: int
    host_end_ns: Optional[int] = None
    start: Any = None   # torch.cuda.Event pair on the card
    end: Any = None


@dataclass
class Records:
    """The spans of one recording, in the order they opened."""

    device: torch.device
    spans: list = field(default_factory=list)
    open: list = field(default_factory=list)   # open spans, innermost last

    def _open(self, name, index) -> SpanRecord:
        parent = self.open[-1].name if self.open else None
        rec = SpanRecord(name, parent, index, time.perf_counter_ns())
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            rec.start = torch.cuda.Event(enable_timing=True, external=True)
            rec.end = torch.cuda.Event(enable_timing=True, external=True)
            rec.start.record(stream)
        self.spans.append(rec)
        self.open.append(rec)
        return rec

    def _close(self, rec: SpanRecord):
        if rec.end is not None:
            rec.end.record(torch.cuda.current_stream(self.device))
        rec.host_end_ns = time.perf_counter_ns()
        self.open.remove(rec)

    def _closed(self):
        return [r for r in self.spans if r.host_end_ns is not None]

    def device_ms(self) -> dict:
        """{name: [device ms of each closed span]}, in opening order; empty
        off the card. The caller synchronises first."""
        out = {}
        for r in self._closed():
            if r.start is not None:
                out.setdefault(r.name, []).append(r.start.elapsed_time(r.end))
        return out

    def host_ms(self) -> dict:
        """{name: [host ms of each closed span]}, in opening order."""
        out = {}
        for r in self._closed():
            out.setdefault(r.name, []).append(
                (r.host_end_ns - r.host_start_ns) * 1e-6)
        return out


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def recording(device=None, enabled: bool = True):
    """Keep the spans opened inside (innermost recording only) -> Records.
    device: where the spans' events go (default: the current card, else
    the CPU, which records host times alone). enabled False suspends every
    enclosing recording instead and yields None."""
    global _current
    records = Records(_device(device)) if enabled else None
    _enclosing.append(_current)
    _current = records
    try:
        yield records
    finally:
        _current = _enclosing.pop()


class _Span:
    __slots__ = ("name", "index", "_rf", "_records", "_rec")

    def __init__(self, name, index):
        self.name, self.index = name, index

    def __enter__(self):
        self._rf = None
        if _profiler_on():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._records = _current
        self._rec = None if _current is None else _current._open(self.name,
                                                                 self.index)
        return self._rec

    def __exit__(self, *exc):
        if self._rec is not None:
            self._records._close(self._rec)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, index=None):
    """A context marking one layer boundary (see the module docstring)."""
    if _current is None and not _profiler_on():
        return _NULL
    return _Span(name, index)


class _Edge(torch.autograd.Function):
    """Identity on its tensors; its backward calls `edge` and passes the
    gradients through untouched."""

    @staticmethod
    def forward(ctx, edge, *xs):
        ctx.edge = edge
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.edge()
        return (None, *grads)


class _BackwardSpan:
    def __init__(self, name, records):
        self.name, self.records, self.rec = name, records, None

    def _open(self):
        self.rec = self.records._open(self.name, None)

    def _close(self):
        if self.rec is not None:
            self.records._close(self.rec)
            self.rec = None

    def inputs(self, *xs) -> tuple:
        """The region's inputs: the span closes once their gradients are."""
        return _Edge.apply(self._close, *xs)

    def outputs(self, *xs) -> tuple:
        """The region's outputs: the span opens once their gradients came."""
        return _Edge.apply(self._open, *xs)


class _NoBackwardSpan:
    @staticmethod
    def inputs(*xs) -> tuple:
        return xs

    outputs = inputs


_NO_BACKWARD_SPAN = _NoBackwardSpan()


def backward_span(name: str):
    """Markers of a forward region whose backward is the span `name`:
    `x, y = b.inputs(x, y)` where the region starts, `u, v = b.outputs(u, v)`
    where it ends. Outside `recording()` both return their tensors."""
    if _current is None:
        return _NO_BACKWARD_SPAN
    return _BackwardSpan(name, _current)


def summed(ms: dict) -> dict:
    """{name: the sum of its spans} of a device_ms() or host_ms()."""
    return {k: sum(v) for k, v in ms.items()}


def _device_us(evt) -> float:
    """Self device time of a profiler entry, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_work(prof):
    """[(name, launches, ms)] of every kernel and copy the card ran under
    `prof`, largest total time first; empty when it recorded no device
    time (a CPU run). The device spans of `record_function` annotations
    are left out: they cover kernels that are counted themselves."""
    work = [(e.key, e.count, _device_us(e) / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0 and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]
    return sorted(work, key=lambda w: -w[2])
