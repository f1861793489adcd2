"""The port's one recorder: host spans and named counters, kept in memory.

``span(name, **attrs)`` times a block on ``time.perf_counter``, the host
clock that a device trace is mapped onto, and records ``(name, start, end,
parent, attrs)``; ``parent`` is the index in ``spans()`` of the span that was
open around it (None for a root). ``count(name, n)`` adds to a counter, and
``defer(reduce)`` leaves counts on the device until they are read:
``reduce()`` returns ``{name: n}`` and is called by the next ``counters()``.

Spans are recorded only while recording is on: while a torch profiler
session runs, or inside ``with recording():``. Off, a span costs one call and
one check. Counters are always kept; a caller whose count only makes sense
beside the spans (a share of steps, work per pair) asks ``on()`` first.

Nothing here is a profiler annotation: a profiler's trace holds none of these
names, and a device trace's busy time is not changed by them. The recorder is
one per process and not guarded for threads.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start: float
    end: Optional[float]  # None while the span is open
    parent: Optional[int]
    attrs: dict


_spans: list = []  # [name, start, end, parent, attrs] in the order the spans opened
_open: list = []  # indices into _spans of the spans open now, innermost last
_counters: Dict[str, int] = {}
_deferred: list = []
_recording = 0  # depth of ``recording()`` blocks


def on() -> bool:
    """Whether spans are recorded now."""
    return _recording > 0 or _profiling()


class _Span:
    __slots__ = ("name", "attrs", "row")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.row = [self.name, None, None, _open[-1] if _open else None, self.attrs]
        _open.append(len(_spans))
        _spans.append(self.row)
        self.row[1] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.row[2] = time.perf_counter()
        if _open:  # a reset() inside the span has closed the list already
            _open.pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records the block as a span while recording
    is on, and does nothing otherwise."""
    if not on():
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def defer(reduce: Callable[[], Dict[str, int]]) -> None:
    """Add ``reduce()``'s counts when the counters are next read, so that
    counts held on the device are not copied to the host before then."""
    _deferred.append(reduce)


def counters() -> Dict[str, int]:
    """Every counter, the deferred counts added first."""
    while _deferred:
        for name, n in _deferred.pop(0)().items():
            count(name, n)
    return dict(_counters)


def spans() -> list:
    """Every span recorded, as ``Span`` tuples in the order they opened."""
    return [Span(*row) for row in _spans]


def reset() -> None:
    """Clear the spans, the counters and the deferred counts."""
    _spans.clear()
    _open.clear()
    _counters.clear()
    _deferred.clear()


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1
