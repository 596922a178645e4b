"""The device trace of a short, steady part of a traced run's window, and
what the per-layer metrics and the result's `breakdown` read from it.

`torch.profiler` records the host's operations and the device's kernels,
copies and sets; `Trace` keeps the device intervals, in order, and the
host operations (for naming idle gaps). Busy time is the union of the
device intervals; the window is the host-clock length of the profiled
part, which ends in a synchronisation.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

N_GAPS = 200          # the longest idle gaps named
MAX_SCAN = 20000      # host operations looked at to name one gap


@dataclass
class Trace:
    """Device intervals (name, start_ns, end_ns) in start order; host
    operations (name, start_ns, end_ns) in start order; the profiled
    part's host-clock length and the samples (or images) it completed."""
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)
    window_s: float = 0.0
    units: int = 0

    def kernels(self, part: str) -> List[Tuple[str, int, int]]:
        """The device intervals whose name contains `part`."""
        return [e for e in self.device if part in e[0]]

    def busy_s(self) -> float:
        """The union of the device intervals, in seconds."""
        busy, end = 0, None
        for _, s, e in self.device:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The idle intervals between the merged device intervals."""
        out, end = [], None
        for _, s, e in self.device:
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def device_ops(self, n: int = 10) -> List[list]:
        """The n device operations that took most time, [name, seconds]."""
        total: Dict[str, int] = defaultdict(int)
        for name, s, e in self.device:
            total[name] += e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The N_GAPS longest idle gaps, each named by the innermost host
        operation running at its midpoint, summed by name: the n largest
        sums, [name, seconds]."""
        starts = [s for _, s, _ in self.host]
        total: Dict[str, int] = defaultdict(int)
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:N_GAPS]
        for g0, g1 in longest:
            mid = (g0 + g1) // 2
            name = 'host outside any operation'
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - MAX_SCAN, -1), -1):
                hname, s, e = self.host[j]
                if e >= mid:
                    name = hname
                    break
            total[name] += g1 - g0
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in ranked]


def _events(prof):
    """The profiler's raw events: the kineto results where this build has
    them, else the function events."""
    results = getattr(prof.profiler, 'kineto_results', None)
    if results is not None:
        for e in results.events():
            yield (e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
                   int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
        return
    for e in prof.events():
        cuda = e.device_type == torch.autograd.DeviceType.CUDA
        yield (e.name, cuda, int(e.time_range.start * 1000),
               int(e.time_range.end * 1000))


def profile(run: Callable[[], int], device: torch.device) -> Trace:
    """Profile `run()`, which returns the units of work it completed; the
    host clock and the profile end in a synchronisation."""
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities,
                                acc_events=True) as prof:
        t0 = time.perf_counter()
        units = run()
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    trace = Trace(window_s=window_s, units=units)
    for name, on_device, s, e in _events(prof):
        if on_device:
            trace.device.append((name, s, e))
        elif not name.startswith(('cuda', 'Activity Buffer')):
            trace.host.append((name, s, e))
    trace.device.sort(key=lambda x: x[1])
    trace.host.sort(key=lambda x: x[1])
    return trace
