"""The measured window, and with ``--trace 1`` the device's timeline over it.

The window runs under ``torch.profiler`` (host and CUDA activity) with a
``bench.window`` range around it; the events are read in memory (no trace
file). Device activity is the union of the kernel and copy intervals, so
kernels that overlap on two streams count once; the idle gaps are the
holes in that union inside the window, each named by the innermost host
range or operator that was running when it opened.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, List, Tuple

import torch

WINDOW = "bench.window"


def merged(intervals) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def kineto_events(prof):
    """(device [(name, start_ns, end_ns)], host [(name, start_ns, end_ns)])
    of a finished profiler. Ranges of record_function on the device's
    timeline span idle time and are left out."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end))
    return dev, host


def read_timeline(dev, host) -> Dict:
    """busy_s, window_s, the kernels inside the window, the 10 device
    operations that took most time and the 10 longest idle gaps."""
    spans = [(s, e) for name, s, e in host if name == WINDOW]
    if not spans:
        raise RuntimeError(f"the profiler recorded no {WINDOW!r} range")
    lo, hi = spans[0]
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in dev if e > lo and s < hi]
    busy = merged([(s, e) for _, s, e in inside])
    by_name = collections.Counter()
    for n, s, e in inside:
        by_name[n[:160]] += e - s
    gaps, prev = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    host_sorted = sorted((s, e, n) for n, s, e in host if n != WINDOW and e > lo and s < hi)
    starts = [h[0] for h in host_sorted]
    idle = []
    for length, at in gaps[:10]:
        # the innermost host range open at the gap's start
        i = bisect.bisect_right(starts, at)
        name = "host idle"
        for s, e, n in reversed(host_sorted[max(0, i - 5000):i]):
            if e > at:
                name = n[:160]
                break
        idle.append([name, length / 1e9])
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (hi - lo) / 1e9,
        "kernels": inside,
        "device_ops": [[n, t / 1e9] for n, t in by_name.most_common(10)],
        "idle_gaps": idle,
    }


class Window:
    """``with Window(trace, device) as w:`` around the measured work. After
    the block, ``w.seconds`` is its length on the host's clock and, when
    traced, ``w.timeline`` the device's timeline (``read_timeline``)."""

    def __init__(self, trace: bool, device):
        self.trace = trace
        self.device = torch.device(device)
        self.timeline = None
        self._stack = contextlib.ExitStack()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = self._stack.enter_context(profile(activities=acts))
            self._stack.enter_context(record_function(WINDOW))
        self._sync()
        self.start = time.perf_counter()
        return self

    def elapsed(self) -> float:
        """Seconds on the host's clock since the window opened."""
        return time.perf_counter() - self.start

    def close(self) -> float:
        """End the window now (after the device has finished): returns and
        keeps its length in seconds."""
        self._sync()
        self.seconds = time.perf_counter() - self.start
        self._stack.close()
        if self.trace:
            self.timeline = read_timeline(*kineto_events(self.prof))
        return self.seconds

    def __exit__(self, *exc):
        if not hasattr(self, "seconds"):
            if exc[0] is not None:
                self._stack.close()
                return False
            self.close()
        return False


class Spans:
    """Host spans the benchmark records around its calls into the program:
    ``with spans("detect.submit"):`` adds the block's seconds to that
    name's list and, when traced, names the block in the profiler's
    timeline too."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = contextlib.nullcontext()
        if self.trace:
            from torch.profiler import record_function

            ctx = record_function("bench." + name)
        t = time.perf_counter()
        with ctx:
            yield
        self.seconds[name].append(time.perf_counter() - t)
