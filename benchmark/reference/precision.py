"""The precisions the reference computes in.

``float32`` is the reference itself: full float32 with TF32 off in cuDNN
and in matrix products. The controls are the reference one step below the
precision that a configuration states, the step that would tempt a later
change: ``bfloat16`` (the reference under bf16 autocast, forward and
backward) below a float32 configuration that allows TF32, and ``fp8``
(every convolution's input and weight scaled per tensor into e4m3's range
and rounded to it, the product summed in float32 and rounded to bfloat16,
as an fp8 tensor-core convolution computes; in training their gradients
rounded to e5m2 likewise) below a bfloat16 one. ``tf32`` (TF32 on in
cuDNN and in matrix products) is no control but a witness: the reference
in the precision a float32 configuration that allows TF32 runs in.
"""

from __future__ import annotations

import contextlib

import torch

def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` scaled per tensor into the fp8 type's range, rounded to it and
    scaled back."""
    top = torch.finfo(dtype).max
    scale = t.abs().amax().clamp(min=1e-12) / top
    return (t / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """e4m3 forward, e5m2 gradient: fp8 training's two formats."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2)


class Fp8Rounding:
    """An fp8 convolution's rounding: ``__call__`` for its operands (e4m3,
    their gradients e5m2), ``output`` for its result (bfloat16, the
    gradient passing unchanged)."""

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(t)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return y + (y.detach().to(torch.bfloat16).float() - y.detach())


@contextlib.contextmanager
def tf32_allowed(allow: bool):
    """TF32 on or off in cuDNN and in matrix products while the reference runs."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def exact_float32():
    """TF32 off in cuDNN and in matrix products while the reference runs."""
    return tf32_allowed(False)


def setting(precision: str, device):
    """``(context, quant)`` for a forward in ``precision``: the context
    to run it under, and the rounding of each convolution (None: none)."""
    if precision == "float32":
        return exact_float32(), None
    if precision == "tf32":
        return tf32_allowed(True), None
    if precision == "bfloat16":
        return torch.autocast(torch.device(device).type, dtype=torch.bfloat16), None
    if precision == "fp8":
        return exact_float32(), Fp8Rounding()
    raise ValueError(f"unknown reference precision {precision!r}")


def control_precision(model: dict) -> str:
    """The precision one step below the configuration's: fp8 below a
    bfloat16 model, bfloat16 below a float32 one that allows TF32."""
    return "fp8" if model["dtype"] == "bfloat16" else "bfloat16"
