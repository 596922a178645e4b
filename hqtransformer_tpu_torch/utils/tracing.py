"""The port's spans and counters.

Spans mark the layer boundaries of the sampling and training paths
(`sample` > `ar.spatial`, `ar.depth` > `ar.draw`, `decode`; `train.step` >
`train.stage1_codes`, `train.forward`, `train.backward`,
`train.optimizer`):

    with tracing.span('ar.depth'):
        ...

or `@tracing.span('name')` on a function. A span records
`SpanRecord(name, start_ns, end_ns, id, parent, call)` into a bounded
in-memory buffer (`spans()`): `parent` is the id of the span open around
it on the same thread (None for a root), `call` the id of its root, so
that every span of one sampler call or one train step shares it. Spans are
intervals on the caller's thread: work another thread does for it (the
autograd engine's backward, the device's kernels) falls inside the span
that waited for it or queued it, not in a span of its own.

A span records only while `recording()` is entered or a `torch.profiler`
profile is recording; otherwise it costs a flag test, with no allocation,
clock read, synchronisation or `record_function`. It never reads a
tensor. Times are `time.time_ns()`, the clock the profiler stamps its
events with, so spans and a profiler trace line up; `chrome_events` gives
them as Chrome-trace events on a trace file's time base.

Counters: `count(name, n)` adds to a process-wide table that is always on,
`counter(name)` reads it. The kernel wrappers count their launches there
(`k1.launches`, `k1.int8_launches`, `k2.launches`, `k2.bisect3_launches`,
`k3.launches`, `gn.launches`: one a GroupNorm's kernel pair), the int8
products theirs (`int8.matmul_launches`, `int8.conv2d_launches`), and the
GroupNorm wrapper the inputs it had to make channels-last
(`gn.layout_copies`).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 16          # the buffer keeps the newest spans


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    call: int


_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count()
_recording = 0               # depth of `recording()` blocks, all threads
_counts: Dict[str, int] = collections.defaultdict(int)


class _Thread(threading.local):
    def __init__(self):
        # the open spans, innermost last: (span, start_ns, id, parent, call)
        self.open: List[tuple] = []


_thread = _Thread()


class Span:
    """One span name; `span(name)` gives the same object every time."""

    __slots__ = ('name',)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> 'Span':
        if _recording or _profiler._is_profiler_enabled:
            stack = _thread.open
            i = next(_ids)
            parent = stack[-1] if stack else None
            stack.append((self, time.time_ns(), i,
                          None if parent is None else parent[2],
                          i if parent is None else parent[4]))
        return self

    def __exit__(self, *exc) -> None:
        stack = _thread.open
        # a span entered while nothing recorded left nothing to close
        if stack and stack[-1][0] is self:
            _, start, i, parent, call = stack.pop()
            _buffer.append(SpanRecord(self.name, start, time.time_ns(), i,
                                      parent, call))

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


_spans: Dict[str, Span] = {}


def span(name: str) -> Span:
    """The span `name`: a context manager, or a decorator of a function."""
    s = _spans.get(name)
    if s is None:
        s = _spans.setdefault(name, Span(name))
    return s


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans record inside this block (with or without a profiler)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> List[SpanRecord]:
    """The recorded spans, the oldest first (the buffer keeps the newest
    MAX_SPANS), each appended as it closed."""
    return list(_buffer)


def clear() -> None:
    """Forget the recorded spans."""
    _buffer.clear()


def count(name: str, n: int = 1) -> None:
    _counts[name] += n


def counter(name: str) -> int:
    return _counts.get(name, 0)


def chrome_events(records: Optional[List[SpanRecord]] = None,
                  base_ns: int = 0) -> List[dict]:
    """`records` (default: every recorded span) as Chrome-trace complete
    events in microseconds after `base_ns` (a profiler trace file's
    `baseTimeNanoseconds`), on a process row of their own, `program
    spans`, with a thread row per call."""
    records = spans() if records is None else records
    pid = 'program spans'
    events = [{'ph': 'M', 'name': 'process_name', 'pid': pid, 'tid': 0,
               'args': {'name': f'{pid} ({os.getpid()})'}}]
    for r in records:
        events.append({'ph': 'X', 'cat': 'program_span', 'name': r.name,
                       'pid': pid, 'tid': r.call,
                       'ts': (r.start_ns - base_ns) / 1e3,
                       'dur': (r.end_ns - r.start_ns) / 1e3,
                       'args': {'id': r.id, 'parent': r.parent,
                                'call': r.call}})
    return events
