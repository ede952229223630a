"""Spans and request records of the port's serving and training loops.

One tracer a process (:data:`TRACER`; the module functions act on it), like
the kernels' launch counters. A span times one region of a tick, a
dispatch or a step, never a model layer or a kernel::

    with trace.span("serve.decode_chunk", n=8, live=48):
        ...

Always on, a span takes two host clock reads (``time.perf_counter_ns``),
its id, the id of the span it opened inside on the same thread (0 at the
top of a thread) and its attributes, and goes into a bounded ring; the
ring counts what it drops. Tracing is on while a ``torch.profiler``
session runs on the span's thread, or everywhere after :func:`enable`.
A span opened while it is on is *profiled*: it also opens a
``torch.profiler.record_function`` range of its name, so that it sits in
the profiler's host timeline on the profiler's clock, and, once CUDA is
initialised, records a CUDA event on the current stream at each end, so
that its device-stream time can be read (:meth:`Span.device_ms`).

The serving engine puts one :class:`RequestRecord` into the same ring for
each request it answers: the request's host timeline.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque

import torch

RING_ENTRIES = 1 << 16
# whether a torch.profiler session runs on this thread
_profiler_enabled = torch.autograd._profiler_enabled


class Span:
    """One timed region: ``name``, ``id``, ``parent`` (0 at the top of its
    thread), ``thread``, host ``t0`` and ``t1`` (``time.perf_counter_ns``),
    ``attrs`` (small values) and ``profiled``. A context manager; it enters
    the ring when it closes."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent", "thread", "t0", "t1", "profiled",
                 "_range", "_events")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.profiled = False
        self._range = self._events = None

    def __enter__(self) -> "Span":
        tr = self.tracer
        local = tr._local
        try:
            stack = local.stack
        except AttributeError:
            stack = local.stack = []
        self.parent = stack[-1].id if stack else 0
        self.id = next(tr._ids)
        self.thread = threading.get_ident()
        stack.append(self)
        if tr.enabled or _profiler_enabled():
            self.profiled = True
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if torch.cuda.is_initialized():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.profiled:
            if self._events is not None:
                self._events[1].record()
            self._range.__exit__(*exc)
            self._range = None
        tr = self.tracer
        tr._local.stack.pop()
        tr.record(self)

    @property
    def end(self) -> int:
        return self.t1

    def device_ms(self) -> float | None:
        """Device-stream ms between the span's two CUDA events (waits for the
        second); None for a span that recorded none."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])


@dataclasses.dataclass(frozen=True, slots=True)
class RequestRecord:
    """One answered request's host timeline (``time.perf_counter_ns``):
    submitted, its pixels on the card, admitted (before its prefill is
    issued), its first token read on the host, answered; its prompt and served tokens;
    ``profiled`` when one of its stamps was taken while tracing was on."""

    id: int
    t_submit: int
    t_on_card: int
    t_admitted: int
    t_first: int
    t_done: int
    prompt_tokens: int
    served_tokens: int
    profiled: bool

    @property
    def end(self) -> int:
        return self.t_done


class Tracer:
    """The ring of closed spans and request records (``entries`` of them;
    ``dropped`` counts those pushed out) and the switch of :func:`enable`."""

    def __init__(self, entries: int = RING_ENTRIES):
        self.ring: deque = deque(maxlen=entries)
        self.dropped = 0
        self.enabled = False
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def on(self) -> bool:
        """Whether a span opened now on this thread is profiled."""
        return self.enabled or _profiler_enabled()

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def record(self, rec) -> None:
        ring = self.ring
        with self._lock:
            if len(ring) == ring.maxlen:
                self.dropped += 1
            ring.append(rec)

    def records(self) -> list:
        with self._lock:
            return list(self.ring)

    def spans(self, name: str | None = None) -> list[Span]:
        return [r for r in self.records()
                if isinstance(r, Span) and (name is None or r.name == name)]

    def requests(self) -> list[RequestRecord]:
        return [r for r in self.records() if isinstance(r, RequestRecord)]

    def kept_since(self, t: int) -> bool:
        """Whether the ring still holds every record that closed at or after
        host time ``t`` (ns)."""
        with self._lock:
            return self.dropped == 0 or bool(self.ring) and self.ring[0].end < t


TRACER = Tracer()


def span(name: str, **attrs) -> Span:
    """A span of the process's tracer (a context manager)."""
    return Span(TRACER, name, attrs)


def on() -> bool:
    """Whether a span opened now on this thread is profiled."""
    return TRACER.on()


def enable() -> None:
    """Profile every span from now on, on every thread, with or without a
    profiler session."""
    TRACER.enabled = True


def disable() -> None:
    """Profile spans only while a profiler session runs on their thread."""
    TRACER.enabled = False


def record(rec) -> None:
    """Put a record (a :class:`RequestRecord`) into the process's ring."""
    TRACER.record(rec)
