"""Metrics, logging and timing (port of the JAX package's
``utils/metrics.py``).

The train step returns a metrics dict (loss terms, grad norm, positives);
``MetricsLogger`` keeps running averages and the images/s of the loop, and
mirrors the scalars to TensorBoard when asked. ``benchmark_fn`` times calls
with CUDA events on the card; ``profile_trace`` records a ``torch.profiler``
trace of one call.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch


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


def _cuda_device(out) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``out`` (a tensor or a tuple
    of them), else None."""
    for t in ([out] if isinstance(out, torch.Tensor) else
              out if isinstance(out, (tuple, list)) else ()):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


def benchmark_fn(fn, *args, warmup: int = 3, iters: int = 10) -> Dict[str, float]:
    """Seconds per call of ``fn(*args)`` after ``warmup`` calls: CUDA events
    around ``iters`` back-to-back calls when ``fn`` returns tensors on the
    card, else the host's clock."""
    out = fn(*args)
    for _ in range(warmup - 1):
        out = fn(*args)
    dev = _cuda_device(out)
    if dev is not None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    return {"seconds_per_call": dt, "calls_per_sec": 1.0 / dt}


def profile_trace(fn, *args, logdir: str = "sbd_profile") -> str:
    """Record a ``torch.profiler`` trace (host and, where CUDA is in use,
    the card's activity) of one call of ``fn(*args)`` into
    ``logdir/trace.json`` (Chrome trace format); returns the file's path."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        fn(*args)
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
