"""The port's device rule, the counterpart of the JAX package's
``utils/platform.py``: entry points run on the card unless the caller asks
for the CPU. With no CUDA device and no explicit ``device="cpu"`` they
raise; they never carry on quietly on the CPU."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``); anything else is taken as given.
    Raises when a CUDA device is asked for, or implied, and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run the plain versions on the CPU")
        if dev.index is None:  # "cuda" means the current card, by index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _tracing() -> bool:
    """Whether a tracer (``torch.export``, ``torch.compile``, any fake-tensor
    mode) is running: a tensor made now is the tracer's, not a real one."""
    return (torch.compiler.is_compiling()
            or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None)


@functools.lru_cache(maxsize=64)
def _cached_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once per process: a copy
    from the host to the card waits for the stream it is made on, so a hot
    path takes its constants from here. Callers must not write to it.
    While a tracer runs it is made anew and not cached: a traced tensor
    kept in the cache would reach every eager call after the trace."""
    if _tracing():
        return torch.tensor(values, dtype=dtype, device=device)
    return _cached_constant(values, dtype, device)
