"""The port's device rule, the counterpart of the JAX package's
``utils/platform.py``: entry points run on the card unless the caller asks
for the CPU. With no CUDA device and no explicit ``device="cpu"`` they
raise; they never carry on quietly on the CPU."""

from __future__ import annotations

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
