"""Spans of the program's own host work, recorded while a ``torch.profiler``
session is open.

A span is a named interval on the host's wall clock in ns
(``time.time_ns()``), the clock ``torch.profiler`` stamps its events with,
so that the device operations of a trace can be set against the program's
spans. Each span records its parent (the innermost span open on the same
thread when it started), its ``call`` (the id of the root of its tree: on
the TTS path one per ``tts_batch`` call) and a few integer attributes.
Names ending in ``_wait`` are the host blocked on the device.

Recording is on exactly while a profiler session is open, as PyTorch's own
process-wide flag says at span entry (``train/profiler.trace`` opens one
for an operator). Otherwise ``span`` hands back one shared no-op context
manager: a span site costs a call and a flag check, and allocates nothing.
Finished spans go to a buffer of ``CAPACITY`` spans; past it the oldest
are dropped, and ``dropped`` counts them.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 18

_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (wall clock), ``id``,
    ``parent`` (an id, or None for a root), ``call`` (the root's id),
    ``attrs`` (name → int, or None) and ``thread`` (its thread's ident)."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "call", "attrs", "thread")

    def __init__(self, name: str, start_ns: int = 0, end_ns: int = 0, id: int = 0,
                 parent: Optional[int] = None, call: int = 0,
                 attrs: Optional[Dict[str, int]] = None, thread: int = 0):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.id, self.parent, self.call = id, parent, call
        self.attrs, self.thread = attrs, thread

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def set(self, key: str, value: int) -> None:
        """Set the attribute ``key`` (known only inside the span)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = int(value)

    def __enter__(self) -> "Span":
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.call = self.id
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.end_ns = time.time_ns()
        _stack().pop()
        with _lock:
            if len(_buffer) == _buffer.maxlen:
                _dropped += 1
            _buffer.append(self)
        return False


class _Off:
    """The span handed out while recording is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value: int) -> None:
        pass


_OFF = _Off()


def span(name: str):
    """A context manager that records a span ``name`` around its block
    while a profiler session is open, and does nothing otherwise; its
    ``set`` gives the span an attribute."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name)


def spans() -> List[Span]:
    """The recorded spans, oldest first (each in the order it ended)."""
    with _lock:
        return list(_buffer)


def dropped() -> int:
    """Spans dropped from the buffer since the last ``clear``."""
    return _dropped


def clear(capacity: int = CAPACITY) -> None:
    """Empty the buffer (now holding ``capacity`` spans) and zero the
    drop count."""
    global _buffer, _dropped
    with _lock:
        _buffer = collections.deque(maxlen=capacity)
        _dropped = 0


def within(found: Iterable[Span], start_ns: int, end_ns: int) -> List[Span]:
    """The spans lying wholly inside [start_ns, end_ns]."""
    return [s for s in found if s.start_ns >= start_ns and s.end_ns <= end_ns]


def self_ns(found: Iterable[Span]) -> Dict[int, int]:
    """Each span's self time: its duration less its children's (the
    children among ``found``), by span id."""
    found = list(found)
    own = {s.id: s.duration_ns for s in found}
    for s in found:
        if s.parent in own:
            own[s.parent] -= s.duration_ns
    return own
