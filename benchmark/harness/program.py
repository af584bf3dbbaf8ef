"""What the readers of the program's own spans and counters share.

The port's tracer (``utils/metrics`` of the PyTorch package) records spans
while a profiler records, so in a traced run it holds the window's spans,
stamped on the clock of the profiler's events, and its counters. A reader
takes the tracer's ``snapshot()`` in the process that ran the cell; where
the run has no device timeline (``--trace 0``), the program no tracer, or
the tracer no such span or counter, it returns None and raises nothing.
"""

from __future__ import annotations

from statistics import mean
from typing import List, Optional, Tuple

from benchmark.harness.trace import merged


def snapshot(rec: dict) -> Optional[dict]:
    """The tracer's spans and counters, or None (no timeline, no tracer)."""
    if not rec.get("timeline"):
        return None
    try:
        from shape_based_object_detection_torch.utils import metrics
    except ImportError:
        return None
    read = getattr(metrics, "snapshot", None)
    return read() if read is not None else None


def spans(rec: dict, name: str) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) of every span named ``name``; [] where none."""
    snap = snapshot(rec)
    if snap is None:
        return []
    return [(s.start_ns, s.end_ns) for s in snap["spans"] if s.name == name]


def span_ms(rec: dict, name: str) -> Optional[float]:
    """The mean of a program span's durations, in ms."""
    got = spans(rec, name)
    return mean(e - s for s, e in got) / 1e6 if got else None


def idle_in(spans_ns, busy_ns) -> int:
    """Nanoseconds of the union of ``spans_ns`` in which the union of
    ``busy_ns`` (the device's intervals) is not running."""
    busy = merged(busy_ns)
    idle, i = 0, 0
    for s, e in merged(spans_ns):
        covered = 0
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            covered += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
        idle += (e - s) - covered
    return idle


def idle_in_share(rec: dict, name: str) -> Optional[float]:
    """The device's idle time inside the spans named ``name`` as a share
    (%) of the window's idle time (``window_s`` - ``busy_s``)."""
    got = spans(rec, name)
    tl = rec.get("timeline")
    if not got or not tl or tl["window_s"] <= tl["busy_s"]:
        return None
    busy = [(s, e) for _, s, e in tl["kernels"]]
    return idle_in(got, busy) / 1e9 / (tl["window_s"] - tl["busy_s"]) * 100.0


def per_step(rec: dict, counter: str, name: str) -> Optional[float]:
    """A counter that each span named ``name`` adds to at its end, over the
    spans after the first, whose end only takes the counter's mark."""
    snap = snapshot(rec)
    if snap is None or counter not in snap["counters"]:
        return None
    n = sum(1 for s in snap["spans"] if s.name == name)
    return snap["counters"][counter] / (n - 1) if n > 1 else None
