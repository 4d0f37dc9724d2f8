"""Spans: where a request's time goes, recorded inside the program.

A span is one named stretch of work: ``with span("serve.upload"): ...``.
Each record holds its name, start and end (ns), the record of the span it
was opened under (its parent), the request it belongs to and the thread
that ran it. Every thread keeps its own stack of open spans; a span opened
on an empty stack opens a new request id, and every span opened under it
shares that id.

Spans are off by default (``enable``). Off, ``span`` costs one check of a
module global and allocates nothing. On, closed records go to a bounded
buffer (the newest ``LIMIT``; ``drain`` hands them over and empties it) and
to running totals per name (``summary``: count and mean ms since
``enable`` turned them on).

Host stamps come from ``time.time_ns()``, the clock of the profiler's
events, so a span and a device trace share one timeline.

``stage(name, like)`` marks a stage of a detection chain. On the CPU it is
a host span. On a card it times the device: inside the capture of a CUDA
graph (``core/graphs.py`` installs a collector with ``collecting``) it
records a timed CUDA event at either end, which the graph keeps as event
nodes, so every replay times its stages again on the device's clock. After
a replay ``replayed`` notes the graph's events; ``settle`` (which
``serve.batching.to_host`` calls after its copy, the replay's one host
read) turns them into records whose ``clock`` is ``"device"``: start and
end in ns of the device's clock since the graph's first mark, the parent
the span open around the replay. Outside a capture on a card a stage
records nothing: the host would time its launches, not its work.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

LIMIT = 1 << 16                   # records kept between two drains

_ON = False
_LOCK = threading.Lock()
_RECORDS: collections.deque = collections.deque(maxlen=LIMIT)
_TOTALS: Dict[str, list] = {}     # name → [count, total ns]
_REQUESTS = itertools.count(1)
_tls = threading.local()          # .stack, .marks (a capture's), .pending


class Record:
    """One closed span. ``clock`` is ``"host"`` (``time.time_ns()``) or
    ``"device"`` (ns since the first mark of the replayed graph)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "thread",
                 "clock")

    def __init__(self, name, start_ns, end_ns, parent, request, thread,
                 clock="host"):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.request, self.thread = parent, request, thread
        self.clock = clock

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def enable(on: bool = True) -> None:
    """Turn spans on or off; turning them on restarts the totals."""
    global _ON
    if on and not _ON:
        with _LOCK:
            _TOTALS.clear()
    _ON = bool(on)


def enabled() -> bool:
    return _ON


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _close(rec: Record) -> None:
    with _LOCK:
        _RECORDS.append(rec)
        total = _TOTALS.setdefault(rec.name, [0, 0])
        total[0] += 1
        total[1] += rec.ns


class _Off:
    """The span of spans that are off: does nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Record:
        stack = _stack()
        parent = stack[-1] if stack else None
        request = parent.request if parent is not None else next(_REQUESTS)
        self.rec = Record(self.name, time.time_ns(), 0, parent, request,
                          threading.get_ident())
        stack.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.time_ns()
        _stack().pop()
        _close(self.rec)
        return False


def span(name: str):
    """A context manager that records ``name`` over its block (module
    docstring); with spans off, one that does nothing."""
    if not _ON:
        return _OFF
    return _Span(name)


def current() -> Optional[Record]:
    """The innermost open span of this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def rename(name: str) -> None:
    """Rename the innermost open span of this thread (a call that turned
    out to capture a graph, say)."""
    if _ON and current() is not None:
        current().name = name


def add(name: str, start_ns: int, end_ns: int) -> None:
    """Record a closed span of this thread's innermost open one, timed by
    the caller (a wait whose end another thread saw)."""
    if not _ON:
        return
    parent = current()
    request = parent.request if parent is not None else next(_REQUESTS)
    _close(Record(name, start_ns, end_ns, parent, request,
                  threading.get_ident()))


class _Mark:
    __slots__ = ("name", "marks", "start")

    def __init__(self, name: str, marks: list):
        self.name, self.marks = name, marks

    def __enter__(self):
        import torch

        self.start = torch.cuda.Event(enable_timing=True, external=True)
        self.start.record()

    def __exit__(self, *exc):
        import torch

        end = torch.cuda.Event(enable_timing=True, external=True)
        end.record()
        self.marks.append((self.name, self.start, end))
        return False


def stage(name: str, like):
    """A stage of a detection chain whose tensors live where ``like`` does:
    a host span on the CPU, a pair of timed events inside a capture on a
    card, nothing otherwise (module docstring)."""
    if not _ON:
        return _OFF
    if like.device.type != "cuda":
        return _Span(name)
    marks = getattr(_tls, "marks", None)
    return _OFF if marks is None else _Mark(name, marks)


@contextlib.contextmanager
def collecting(marks: list):
    """Stages marked on this thread inside the block append (name, start
    event, end event) to ``marks``: the capture of a graph."""
    _tls.marks = marks
    try:
        yield
    finally:
        _tls.marks = None


def replayed(marks: list) -> None:
    """A graph with stage ``marks`` was launched on this thread: its times
    are read by the next ``settle``."""
    if not _ON or not marks:
        return
    parent = current()
    pending = getattr(_tls, "pending", None)
    if pending is None:
        pending = _tls.pending = []
    pending.append((marks, parent, parent.request if parent is not None
                    else next(_REQUESTS)))


def settle() -> None:
    """Read the stage times of the graphs this thread launched since the
    last settle into device records. It waits for each graph's last mark,
    which a host copy of the graph's outputs has already done."""
    if not _ON:
        return
    pending = getattr(_tls, "pending", None)
    if not pending:
        return
    thread = threading.get_ident()
    for marks, parent, request in pending:
        marks[-1][2].synchronize()
        first = marks[0][1]
        for name, a, b in marks:
            start = round(first.elapsed_time(a) * 1e6)
            _close(Record(name, start, start + round(a.elapsed_time(b) * 1e6),
                          parent, request, thread, "device"))
    pending.clear()


def drain() -> List[Record]:
    """Every record closed since the last drain (the newest ``LIMIT``), in
    the order they closed; the buffer is emptied."""
    with _LOCK:
        out = list(_RECORDS)
        _RECORDS.clear()
    return out


def summary() -> Dict[str, dict]:
    """Per name, the count and mean ms of the spans closed since spans were
    turned on."""
    with _LOCK:
        return {name: dict(count=n, mean_ms=total / n / 1e6)
                for name, (n, total) in sorted(_TOTALS.items())}


def self_ns(rec: Record, records: List[Record]) -> int:
    """``rec``'s duration less the part of it that its child spans of the
    same clock (among ``records``) cover."""
    kids = sorted((r.start_ns, r.end_ns) for r in records
                  if r.parent is rec and r.clock == rec.clock)
    covered, edge = 0, rec.start_ns
    for a, b in kids:
        a, b = max(a, edge), min(b, rec.end_ns)
        if b > a:
            covered += b - a
            edge = b
    return rec.ns - covered
