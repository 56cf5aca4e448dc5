"""Spans of the port's phases, on the profiler's clock.

``span(name)`` marks one phase of the work: an epoch, a sampler draw, an
optimizer step, an evaluation and its batches, a ranker's parts, a
serving call.  While ``torch.profiler`` records in the process it opens
``torch.profiler.record_function("cleverrec." + name)``, so the phase
shows in the profiler's trace (``profile.dir``'s Chrome trace among
them), and keeps a ``Record`` of it in a buffer of the newest ``LIMIT``
records, which ``records()`` returns.  Otherwise it costs one flag read
and does nothing; it also does nothing while ``torch.export`` or
``torch.compile`` traces the code, so exported programs hold no span.

A record's start and end are ``time.time_ns()`` readings, the clock of
the profiler's events.  Its parent is the innermost span open on the
same thread when it opened; a span with none is a root, and its id is
the ``root`` that every span below it shares: the request it served.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "cleverrec."
LIMIT = 2 ** 20

_NULL = contextlib.nullcontext()
_buffer: collections.deque = collections.deque(maxlen=LIMIT)
_ids = itertools.count(1)
_local = threading.local()


class Record:
    """One span: ``name`` (without the prefix), ``start_ns`` (when it is
    made) and ``end_ns`` (None while it is open), its ``id``, its
    ``parent``'s id (None for a root) and its ``root``'s id."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "root")

    def __init__(self, name: str, parent: Record | None):
        self.name, self.id, self.end_ns = name, next(_ids), None
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.start_ns = time.time_ns()


class _Span:
    __slots__ = ("_name", "_fn", "_rec")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        # The clock is read outside the profiler's range on both sides:
        # its first entry in a process takes a millisecond after its own
        # start is taken.
        rec = Record(self._name, stack[-1] if stack else None)
        self._fn = torch.profiler.record_function(PREFIX + self._name)
        self._fn.__enter__()
        stack.append(rec)
        _buffer.append(rec)
        self._rec = rec

    def __exit__(self, *exc):
        try:
            return self._fn.__exit__(*exc)
        finally:
            self._rec.end_ns = time.time_ns()
            _local.stack.pop()


def span(name: str):
    """A context manager around the phase ``name``: a profiler range and a
    buffered ``Record`` while the profiler records, else nothing."""
    if not _profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _NULL
    return _Span(name)


def records() -> list[Record]:
    """The buffer's closed spans, in the order they opened."""
    return [r for r in list(_buffer) if r.end_ns is not None]
