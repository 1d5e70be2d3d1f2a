"""Spans of the program's work: the port's one tracing registry.

`span(name)` times a block.  Tracing is on while a torch profiler records
(`torch.autograd.profiler._is_profiler_enabled`) and between `enable()`
and `disable()`; there is no other switch.

  * **Off**, `span` returns one shared no-op context after reading two
    module attributes: no clock, no allocation.
  * **On**, it records an event in memory: its name, start and end from
    `time.perf_counter_ns()`, its parent (the innermost span open in the
    same thread) and its request.  While a profiler records it also opens
    `torch.profiler.record_function(name)`, so the host range sits in the
    device trace beside the kernels and copies it launched, on one clock.

A span's request is the id of the outermost span open in its thread; a
span opened with none open starts a new request, unless it is given one:
a step that runs later than the call it belongs to (`fused`'s deferred
`finish`) passes the id the call took from `request_id()`.

`events()`, `totals()` and `reset()` read and clear the registry.  Events
stay in memory; at most `MAX_EVENTS` are kept, and `dropped()` counts the
rest.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

MAX_EVENTS = 1 << 20


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int        # index in `events()` of the enclosing span, -1 for none
    request: int


class Total(NamedTuple):
    seconds: float     # inclusive: children's time counted in
    calls: int


class _Record:
    __slots__ = ("name", "start", "end", "parent", "request")

    def __init__(self, name, parent, request):
        self.name, self.parent, self.request = name, parent, request
        self.start = self.end = None


_records: list[_Record] = []
_dropped = 0
_forced = False
_lock = threading.Lock()
_local = threading.local()
_requests = itertools.count()


class _Off:
    """The shared context of a span while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("record", "range")

    def __init__(self, name: str, request: int | None):
        global _dropped
        stack = _stack()
        parent = stack[-1] if stack else None
        if request is None:
            request = parent.request if parent is not None else next(_requests)
        rec = _Record(name, parent, request)
        with _lock:
            if len(_records) < MAX_EVENTS:
                _records.append(rec)
            else:
                _dropped += 1
        self.record = rec
        self.range = None

    def __enter__(self):
        _stack().append(self.record)
        if _profiler._is_profiler_enabled:
            self.range = record_function(self.record.name)
            self.range.__enter__()
        self.record.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.record.end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        return False


def span(name: str, request: int | None = None):
    """A context that records the block as span `name` while tracing is on
    (the shared no-op otherwise); `request` overrides the request it would
    take from the spans open in its thread."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, request)


def request_id() -> int | None:
    """The request a span opened now belongs to: the outermost open span's,
    else a new one; None while tracing is off."""
    if not (_forced or _profiler._is_profiler_enabled):
        return None
    stack = _stack()
    return stack[0].request if stack else next(_requests)


def enable() -> None:
    """Record spans with no profiler running, until `disable()`."""
    global _forced
    _forced = True


def disable() -> None:
    global _forced
    _forced = False


def reset() -> None:
    """Forget every event and the count of those dropped."""
    global _records, _dropped
    with _lock:
        _records = []
        _dropped = 0


def dropped() -> int:
    """Events not kept since the last `reset()`, the registry being full."""
    return _dropped


def events() -> list[Event]:
    """The finished spans in the order they opened."""
    with _lock:
        recs = list(_records)
    done = [r for r in recs if r.end is not None]
    index = {id(r): i for i, r in enumerate(done)}
    return [Event(r.name, r.start, r.end,
                  -1 if r.parent is None else index.get(id(r.parent), -1),
                  r.request) for r in done]


def totals(within: str | None = None) -> dict[str, Total]:
    """Inclusive seconds and calls of the finished spans by name; with
    `within`, only spans that have an enclosing span of that name."""
    evs = events()
    inside = [within is None] * len(evs)
    if within is not None:
        for i, e in enumerate(evs):     # parents come before their children
            p = e.parent
            inside[i] = p >= 0 and (evs[p].name == within or inside[p])
    sums: dict[str, list] = defaultdict(lambda: [0, 0])
    for e, keep in zip(evs, inside):
        if keep:
            s = sums[e.name]
            s[0] += e.end_ns - e.start_ns
            s[1] += 1
    return {name: Total(ns * 1e-9, n) for name, (ns, n) in sums.items()}
