"""What the per-layer readers share: each ``metrics/<name>.py`` reads one
number from a traced run's records with these, or returns None where the
run has nothing to read (no device timeline, no span, no launch)."""

from __future__ import annotations

import re
from statistics import mean
from typing import Optional


def span_ms(rec: dict, name: str) -> Optional[float]:
    """The mean of a benchmark span's durations, in ms."""
    vals = rec.get("spans", {}).get(name)
    return mean(vals) * 1e3 if vals else None


def idle_share(rec: dict) -> Optional[float]:
    """The share of the traced window (%) in which no operation ran on the
    device."""
    tl = rec.get("timeline")
    if not tl or tl["busy_s"] <= 0:
        return None
    return (1.0 - tl["busy_s"] / tl["window_s"]) * 100.0


def mfu(rec: dict) -> Optional[float]:
    """Model FLOPs of the window's images over the seconds in which the
    device was busy (the union of its operations in the trace), as a share
    (%) of the dense peak of the configuration's precision. The host's
    share of the window, which the profiler lengthens, is the idle
    share's, not this one's."""
    tl = rec.get("timeline")
    if not rec.get("images") or not tl or tl["busy_s"] <= 0:
        return None
    return rec["flops_per_image"] * rec["images"] / tl["busy_s"] / rec["peak_flops"] * 100.0


def kernel_roofline(rec: dict, pattern: str, key: str) -> Optional[float]:
    """A kernel's share (%) of its roofline: the mean least time of a call
    (``rec[key]["bound_s"]``) over its device time per call, the time of
    the kernels whose names match ``pattern`` over the calls counted."""
    tl, calls = rec.get("timeline"), rec.get(key, {}).get("calls", 0)
    bounds = rec.get(key, {}).get("bound_s") or []
    if not tl or not calls or not bounds:
        return None
    rx = re.compile(pattern)
    dev_s = sum(e - s for n, s, e in tl["kernels"] if rx.search(n)) / 1e9
    if dev_s <= 0:
        return None
    return mean(bounds) / (dev_s / calls) * 100.0
