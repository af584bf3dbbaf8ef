"""The gradient all-reduce's yardstick: the bytes it moves over the link
between the cards and the link's peak, frozen here so that later changes
to the program cannot move it.

An all-reduce of S bytes over N ranks, as a ring (reduce-scatter then
all-gather), sends and receives 2 (N - 1) / N x S bytes on each card's
link: NCCL's "bus bytes". Its least time is those bytes over the link's
peak in one direction. The peak is that of the four H100 80GB HBM3 cards
that run the four-card cells, joined all to all by NVLink, as ``nvidia-smi
nvlink -s`` read it on them: 18 links a card at 26.562 GB/s each
(``nvidia-smi topo -m`` does not run on that machine).

The device time is that of the NCCL all-reduce kernels in rank 0's trace.
An NCCL kernel starts when its rank has enqueued it and ends when the
slowest rank's data has arrived, so it holds the wait for the slowest
peer too: under skew between the ranks the share reads low, never high.
"""

from __future__ import annotations

import re
from typing import Optional

from benchmark.harness import program

NVLINK_BYTES_PER_S = 18 * 26.562e9  # per card, each way
NCCL_ALLREDUCE = re.compile(r"nccl.*AllReduce")
BYTES_COUNTER = "comm.all_reduce_bytes"


def bus_bytes(nbytes: float, world: int) -> float:
    """The bytes each card's link carries each way in a ring all-reduce of
    ``nbytes`` over ``world`` ranks."""
    return 2.0 * (world - 1) / world * nbytes


def allreduce_bound_s(nbytes: float, world: int) -> float:
    """The least time of all-reducing ``nbytes`` over ``world`` cards."""
    return bus_bytes(nbytes, world) / NVLINK_BYTES_PER_S


def device_s(rec: dict) -> Optional[float]:
    """Seconds of the NCCL all-reduce kernels in the traced window; None
    where the run has no timeline or ran none."""
    tl = rec.get("timeline")
    if not tl:
        return None
    total = sum(e - s for n, s, e in tl["kernels"] if NCCL_ALLREDUCE.search(n)) / 1e9
    return total if total > 0 else None


def device_ms_per_step(rec: dict) -> Optional[float]:
    """Device ms of the NCCL all-reduce kernels per step of the window."""
    total = device_s(rec)
    if total is None or not rec.get("steps"):
        return None
    return total / rec["steps"] * 1e3


def roofline(rec: dict) -> Optional[float]:
    """The all-reduces' least time at the bytes the program counted
    (``comm.all_reduce_bytes``, every all-reduce of the traced window) over
    their device time (%); None where the program counts no bytes."""
    snap = program.snapshot(rec)
    total = device_s(rec)
    if snap is None or total is None or not rec.get("world"):
        return None
    nbytes = snap["counters"].get(BYTES_COUNTER)
    if not nbytes:
        return None
    return allreduce_bound_s(nbytes, rec["world"]) / total * 100.0
