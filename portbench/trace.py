"""The traced window: ``torch.profiler`` over the measured window, reduced
to device intervals, host spans and the run's ``breakdown``.

The drivers mark the window and each request with ``span(name)`` (a
``record_function`` only while tracing). Device events are the profiler's
CUDA events (kernels, copies, sets) that overlap the window's span; the spin
kernels that prime the profiler and the mirrors of the host spans are left
out.
"""

from __future__ import annotations

import contextlib
import heapq
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SPAN_PREFIX = "portbench."  # the drivers' host spans; the profiler mirrors them on the device's timeline
WINDOW = SPAN_PREFIX + "window"
PRIME_KERNEL = "spin_kernel"  # the kernel torch.cuda._sleep launches
PRIME_LAUNCHES = 4
PRIME_CYCLES = 5_000_000  # about 2.5 ms a launch on the H100
TOP = 10  # entries of each breakdown list
NAME_CHARS = 120  # a kernel's name is cut to this many characters in the breakdown

_tracing = False


def span(name: str):
    """A named host span in the trace, or nothing when the run is not traced."""
    return torch.profiler.record_function(name) if _tracing else contextlib.nullcontext()


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the block when ``enabled``; yields a holder whose ``prof`` is
    the profiler (None when off). The profiler is primed with spin kernels
    first: a window can miss its first device events."""
    global _tracing
    holder = SimpleNamespace(prof=None)
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIME_LAUNCHES):
            torch.cuda._sleep(PRIME_CYCLES)
        torch.cuda.synchronize()
        _tracing = True
        try:
            yield holder
        finally:
            _tracing = False
            torch.cuda.synchronize()
    holder.prof = prof


class Trace:
    """Device intervals and host spans of the window, in seconds from its
    start."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        t = time.perf_counter()
        events = prof.events()
        win = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
        if not win:
            raise RuntimeError("the trace holds no window span")
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        self.window_s = (w1 - w0) / 1e6
        dev, host = [], []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if b < w0 or a > w1:
                continue
            if e.device_type == DeviceType.CUDA:
                if PRIME_KERNEL not in e.name and not e.name.startswith(SPAN_PREFIX):
                    dev.append((e.name, (max(a, w0) - w0) / 1e6, (min(b, w1) - w0) / 1e6))
            elif e.name != WINDOW:
                host.append((e.name, (a - w0) / 1e6, (b - w0) / 1e6))
        dev.sort(key=lambda x: x[1])
        host.sort(key=lambda x: x[1])
        self.dev_names = [d[0] for d in dev]
        self.dev_start = np.array([d[1] for d in dev])
        self.dev_end = np.array([d[2] for d in dev])
        self.host = host
        self.busy_s, self.gaps = self._union()
        self.read_s = time.perf_counter() - t

    def _union(self) -> Tuple[float, List[Tuple[float, float]]]:
        """Seconds in which some device operation ran, and the idle gaps."""
        busy, gaps, cur_a, cur_b = 0.0, [], None, None
        for a, b in zip(self.dev_start, self.dev_end):
            if cur_b is None:
                if a > 0:
                    gaps.append((0.0, a))
                cur_a, cur_b = a, b
            elif a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is None:
            return 0.0, [(0.0, self.window_s)]
        busy += cur_b - cur_a
        if cur_b < self.window_s:
            gaps.append((cur_b, self.window_s))
        return busy, gaps

    def _host_at(self, times: Sequence[float]) -> List[str]:
        """The innermost host event (the latest begun) that covers each time
        of ``times`` (ascending), by one sweep."""
        out, active, j = [], [], 0
        for t in times:
            while j < len(self.host) and self.host[j][1] <= t:
                heapq.heappush(active, (-self.host[j][1], j))
                j += 1
            while active and self.host[active[0][1]][2] < t:
                heapq.heappop(active)
            out.append(self.host[active[0][1]][0] if active else "no host event")
        return out

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time and the idle time by what
        the host was doing at the middle of each gap."""
        ops: Dict[str, float] = {}
        for name, a, b in zip(self.dev_names, self.dev_start, self.dev_end):
            ops[name[:NAME_CHARS]] = ops.get(name[:NAME_CHARS], 0.0) + (b - a)
        idle: Dict[str, float] = {}
        for (a, b), name in zip(self.gaps, self._host_at([(a + b) / 2 for a, b in self.gaps])):
            idle[name[:NAME_CHARS]] = idle.get(name[:NAME_CHARS], 0.0) + (b - a)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def read(holder) -> Optional[Trace]:
    return None if holder.prof is None else Trace(holder.prof)
