"""Metrics, logging and the tracer (port of the JAX package's
``utils/metrics.py``).

The train step returns a metrics dict (loss terms, grad norm, positives);
``MetricsLogger`` keeps running averages and the images/s of the loop, and
mirrors the scalars to TensorBoard when asked.

The tracer records the program's phases while a ``torch.profiler`` session
records on the calling thread, and at no other time: ``span(name, **ids)``
around a phase at a layer boundary (serving, data, the train step) keeps
its name, start and end on ``time.time_ns()`` (the clock of the profiler's
events), its parent span on the same thread and the ids given (a served
batch's number, a step's ``state.step``), and opens a ``record_function``
range of the same name, so the phase shows on the profiler's timeline.
With no profiler recording, a span costs one check and records nothing;
while a tracer (``torch.export``, fake tensors) runs it records nothing
either, so a traced graph holds no profiler op. An operator who profiles
``train_cli`` or the server with ``torch.profiler`` sees these names in
the trace; ``snapshot()`` returns the spans and the counters to the same
process (the benchmark's per-layer metrics read it).

Counters (``count``) add on the host. While tracing on the card, the train
step adds the caching allocator's new device segments
(``mem.device_allocs``). The tracer keeps the last ``MAX_SPANS`` spans, so a
long profiled run holds a bounded number.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Deque, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from shape_based_object_detection_torch.utils.device import _tracing as _tracer_running


class AverageMeter:
    def __init__(self, window: int = 100):
        self.values = collections.deque(maxlen=window)

    def update(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def avg(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0


def _summary_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise RuntimeError(
            f"--tb-dir needs a TensorBoard writer (torch.utils.tensorboard, "
            f"which needs the tensorboard package): {e}") from e
    return SummaryWriter(logdir)


class MetricsLogger:
    def __init__(self, log_every: int = 50, tensorboard_dir: Optional[str] = None):
        self.log_every = log_every
        self.meters: Dict[str, AverageMeter] = collections.defaultdict(AverageMeter)
        self._t0 = time.perf_counter()
        self._images_since_log = 0
        self._tb = _summary_writer(tensorboard_dir) if tensorboard_dir else None

    def update(self, step: int, metrics: Mapping[str, object],
               batch_size: int = 0) -> Optional[str]:
        """Feed one step's metrics (numbers, or 0-d arrays or tensors);
        returns a log line every ``log_every`` steps."""
        for k, v in metrics.items():
            try:
                self.meters[k].update(float(v))
            except (TypeError, ValueError, RuntimeError):
                continue
        self._images_since_log += batch_size
        if step % self.log_every != 0:
            return None
        dt = time.perf_counter() - self._t0
        ips = self._images_since_log / dt if dt > 0 else 0.0
        parts = [f"step {step}"] + [f"{k}={m.avg:.4f}" for k, m in sorted(self.meters.items())]
        if batch_size:
            parts.append(f"img/s={ips:.1f}")
        if self._tb is not None:
            for k, m in self.meters.items():
                self._tb.add_scalar(k, m.avg, step)
            if batch_size:
                self._tb.add_scalar("images_per_sec", ips, step)
            self._tb.flush()
        self._t0 = time.perf_counter()
        self._images_since_log = 0
        return "  ".join(parts)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


# ---------------------------------------------------------------- the tracer

class Span(NamedTuple):
    """One recorded phase: ``start_ns``/``end_ns`` on ``time.time_ns()``,
    ``parent`` the ``id`` of the span open on the same ``thread`` when it
    began (None at the top), ``ids`` the keywords given to ``span``."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    ids: Dict[str, int]


# The tracer's state is the process's, as the profiler's is: spans are kept
# as plain tuples (a Span's fields) in the order they ended, the newest
# MAX_SPANS of them (a 51 s traced window of the benchmark holds ~2.3k).
MAX_SPANS = 100_000
_spans: Deque[tuple] = collections.deque(maxlen=MAX_SPANS)
_counters: Dict[str, int] = collections.Counter()
_alloc_marks: Dict[torch.device, int] = {}
_span_ids = itertools.count()
_lock = threading.Lock()
_local = threading.local()  # .stack: the ids of this thread's open spans
_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def tracing() -> bool:
    """Whether spans record now: a ``torch.profiler`` session records on
    this thread, and no tracer (``torch.export``, fake tensors) runs."""
    return _profiler_enabled() and not _tracer_running()


class _Span:
    __slots__ = ("name", "ids", "id", "parent", "start", "range")

    def __init__(self, name: str, ids: Dict[str, int]):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_span_ids)
        stack.append(self.id)
        self.range = torch.autograd.profiler.record_function(self.name)
        self.start = time.time_ns()  # before the range opens: the span holds it
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        _spans.append((self.id, self.name, self.start, end, self.parent,
                       threading.get_ident(), self.ids))
        return False


def span(name: str, **ids: int):
    """``with span("train.step", step=n):`` records the block as a span
    and a ``record_function`` range while ``tracing()``; otherwise it is a
    context that does nothing."""
    if not _profiler_enabled() or _tracer_running():
        return _NULL
    return _Span(name, ids)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _lock:
        _counters[name] += n


def count_device_allocs(device: torch.device) -> None:
    """While tracing, on the card: add the device segments that the caching
    allocator created since the last call (``num_device_alloc``) to
    ``mem.device_allocs``. The first call on a device only takes the mark."""
    if device.type != "cuda" or not tracing():
        return
    n = torch.cuda.memory_stats(device).get("num_device_alloc", 0)
    last = _alloc_marks.get(device)
    if last is not None:
        count("mem.device_allocs", n - last)
    _alloc_marks[device] = n


def snapshot() -> Dict[str, object]:
    """``{"spans": [Span, ...], "counters": {name: int}}``: the spans held,
    in the order they ended, and every counter."""
    with _lock:
        return {"spans": [Span(*s) for s in list(_spans)], "counters": dict(_counters)}


def reset() -> None:
    """Clear the spans, the counters and the allocator's marks."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _alloc_marks.clear()
