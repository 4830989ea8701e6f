"""Spans and counters of the stream-serving path, kept in memory, off by
default.

``enable()`` starts recording, ``drain() -> (spans, counters)`` hands over
and clears what was recorded, ``disable()`` stops. The serving path calls:

- ``span(name, sid=None)``: a context manager around work on the host.
  Each span recorded is one tuple ``(name, start_ns, end_ns, span_id,
  parent_id, sid, thread_id)``: the parent is the span open around it on
  the same thread (0 for none), and a span given no ``sid`` takes its
  parent's. Off, ``span`` returns one shared object that does nothing.
- ``timed(name, sid=None)``: the same span, but it always reads the clock,
  so that its caller can read ``seconds`` afterwards (a session's
  ``wall_s``, the adaptive block sizer); it is recorded only while on.
- ``count(name, n=1, key=None)``: adds ``n`` to a host integer, or with
  ``key`` to one bin of a histogram (``{key: total}``).
- ``record(name, start_ns, end_ns, sid=None)``: a span whose start was
  taken earlier, such as a session's wait in the admission queue.
- ``session(sid)``: a context manager that records nothing; the spans
  opened inside it without a ``sid`` carry this one (``None``: no session)
  in place of the enclosing span's, for work done on behalf of another
  session or of none.

Times are ``time.perf_counter_ns()``, the clock of the benchmark's own
spans, onto which its device trace maps the device's rows, so program
spans, benchmark spans and device rows share one time line. Off, a span or
a counter costs one global read and one branch and allocates nothing. In
neither state does anything here read the device: every counted quantity
is known on the host from shapes and lengths.
"""
from __future__ import annotations

import itertools
import threading
import time

_on = False
_lock = threading.Lock()  # guards every update of _spans and _counters, and drain
_spans: list = []
_counters: dict = {}
_ids = itertools.count(1)
_local = threading.local()  # .stack: the (span_id, sid) pairs open on this thread


def enable() -> None:
    """Start recording spans and counters."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`drain`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> tuple[list, dict]:
    """Everything recorded since the last drain, cleared here:
    ``(spans, counters)``. Spans are in the order they ended."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    return spans, counters


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span; ``seconds`` is its duration once it has ended."""

    __slots__ = ("name", "sid", "start", "end", "_id", "_parent")

    def __init__(self, name: str, sid=None):
        self.name, self.sid, self._id = name, sid, 0

    def __enter__(self) -> "Span":
        if _on:
            stack = _stack()
            self._parent, parent_sid = stack[-1] if stack else (0, None)
            if self.sid is None:
                self.sid = parent_sid
            self._id = next(_ids)
            stack.append((self._id, self.sid))
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        if self._id:  # entered while on
            _stack().pop()
            row = (self.name, self.start, self.end, self._id, self._parent, self.sid,
                   threading.get_ident())
            with _lock:
                _spans.append(row)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _Off:
    """What ``span`` and ``session`` return while off: enter, exit and keep
    nothing."""

    __slots__ = ("sid",)

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Session:
    """What ``session`` returns while on: an entry on this thread's stack
    that keeps the enclosing span as parent and sets the sid inherited."""

    __slots__ = ("sid",)

    def __init__(self, sid):
        self.sid = sid

    def __enter__(self) -> "_Session":
        stack = _stack()
        stack.append((stack[-1][0] if stack else 0, self.sid))
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        return False


def span(name: str, sid=None):
    """A span around the ``with`` block, recorded while the tracer is on."""
    if not _on:
        return _OFF
    return Span(name, sid)


def timed(name: str, sid=None) -> Span:
    """A span that measures its duration whether the tracer is on or not."""
    return Span(name, sid)


def session(sid):
    """Spans opened inside the ``with`` block without a sid carry ``sid``."""
    if not _on:
        return _OFF
    return _Session(sid)


def record(name: str, start_ns: int, end_ns: int, sid=None) -> None:
    """Record a span that started at ``start_ns``, a child of the span open
    on this thread."""
    if not _on:
        return
    stack = _stack()
    row = (name, start_ns, end_ns, next(_ids), stack[-1][0] if stack else 0, sid,
           threading.get_ident())
    with _lock:
        _spans.append(row)


def count(name: str, n: int = 1, key=None) -> None:
    """Add ``n`` to counter ``name``, or with ``key`` to that bin of it."""
    if not _on:
        return
    with _lock:
        if key is None:
            _counters[name] = _counters.get(name, 0) + n
        else:
            bins = _counters.setdefault(name, {})
            bins[key] = bins.get(key, 0) + n
