"""The device's idle time in a traced run's profiled window, put down to the
layer the host was in: the program's own spans (`hqtransformer_tpu_torch/
utils/tracing.py`), which record while the profiler does, on the clock the
profiler stamps its events with.

The window runs from its first host event or span to its last device
interval; its idle intervals are the complement of the merged device
intervals there. Each idle interval is split by overlap among the innermost
program spans open on the host (None where none is), so the parts add up to
the window's idle time. A program without spans (an older checkout) gives
nothing to read.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import Trace

try:
    from hqtransformer_tpu_torch.utils import tracing
except ImportError:          # a program without spans
    tracing = None

Interval = Tuple[int, int]


def window_spans(trace: Trace, spans: Optional[Sequence] = None) -> list:
    """The program's spans (default: every span it recorded) that overlap
    the trace, from its first host event to its last device interval."""
    if spans is None:
        spans = tracing.spans() if tracing is not None else []
    if not trace.device or not trace.host:
        return []
    first = trace.host[0][1]
    last = max(e for _, _, e in trace.device)
    return [s for s in spans if s.end_ns >= first and s.start_ns <= last]


def innermost(spans: Sequence) -> List[Tuple[int, int, Optional[str]]]:
    """Disjoint (start, end, name) pieces of time, each named by the
    innermost span open in it (spans of one thread nest)."""
    # at one instant: closes before opens, an inner span (a later id)
    # closing first and opening last
    bounds = sorted([(s.start_ns, 1, s.id, s) for s in spans] +
                    [(s.end_ns, 0, -s.id, s) for s in spans],
                    key=lambda b: b[:3])
    pieces, stack, t = [], [], None
    for at, opens, _, s in bounds:
        if stack and at > t:
            pieces.append((t, at, stack[-1].name))
        if opens:
            stack.append(s)
        elif s in stack:
            stack.remove(s)
        t = at
    return pieces


def idle_intervals(trace: Trace, start: int) -> List[Interval]:
    """The idle intervals from `start` to the trace's last device
    interval."""
    out, end = [], start
    for _, s, e in trace.device:
        if s > end:
            out.append((end, s))
        end = max(end, e)
    return out


def idle_ms(trace: Optional[Trace], spans: Optional[Sequence] = None
            ) -> Optional[Dict[Optional[str], float]]:
    """Idle milliseconds of the trace's window by the innermost program
    span open over them (None: no span), or None without a trace or
    spans in it."""
    if trace is None:
        return None
    spans = window_spans(trace, spans)
    if not spans:
        return None
    start = min(trace.host[0][1], min(s.start_ns for s in spans))
    pieces = innermost(spans)
    total: Dict[Optional[str], int] = defaultdict(int)
    i = 0
    for g0, g1 in idle_intervals(trace, start):
        t = g0
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            p0, p1, name = pieces[j]
            if p0 > t:
                total[None] += p0 - t
            lo, hi = max(p0, t), min(p1, g1)
            if hi > lo:
                total[name] += hi - lo
                t = hi
            j += 1
        if g1 > t:
            total[None] += g1 - t
    return {k: v / 1e6 for k, v in total.items()}


def per_unit(out, names: Sequence[Optional[str]], per_step: bool = False
             ) -> Optional[float]:
    """The idle ms under the spans `names` (None: under no span) of a
    traced run's profiled window, over its samples, or with `per_step`
    its training steps; None where the window holds no program span."""
    ms = idle_ms(out.trace)
    if ms is None or not out.trace.units:
        return None
    units = out.trace.units
    if per_step:
        if not out.info.get('batch'):
            return None
        units //= out.info['batch']
    return sum(ms.get(n, 0.0) for n in names) / units
