"""Spans from the benchmark's own code around calls into the program's
layers: a wrapper on a module attribute or an instance's attribute that
records the call's host-clock duration, synchronising the device at both
ends so the span holds the device work the call queued. Used in the traced
run only. Each span is also a `record_function` range, so it shows in the
device trace.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List

import torch


class Spans:
    """Durations in seconds by span name; `on` switches recording (the
    wrapped calls run unchanged while it is off)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.durations: Dict[str, List[float]] = defaultdict(list)
        self.on = False

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def wrap(self, name: str, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            self._sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            self._sync()
            self.durations[name].append(time.perf_counter() - t0)
            return out
        return spanned


@contextlib.contextmanager
def swapped(owner, attr: str, value) -> Iterator[None]:
    """`owner.attr` set to `value` inside the block, restored after it."""
    original = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, original)


def patched(owner, attr: str, spans: Spans, name: str):
    """`owner.attr` wrapped in a span named `name` inside the block."""
    return swapped(owner, attr, spans.wrap(name, getattr(owner, attr)))
