"""Frozen BatchNorm and what follows it in a ResNet, as plain PyTorch.

``batch_norm`` is flax's ``nn.BatchNorm(use_running_average=True)``:
``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32 (``x - mean``
promotes a bf16 x without a cast of its own), rounded to the input's type
once, so a bf16 output is bit-equal to flax's. ``bn_act`` adds the ReLU
after it, ``bn_add_relu`` a bottleneck's end: the rounded BatchNorm plus the
residual (the block's input, or the downsample branch's rounded BatchNorm),
added in the input's type, then the ReLU. These are what runs on the CPU
and under autograd; ``ops/frozen_bn_cuda.py`` computes the same bits in one
kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_SHAPE = (1, -1, 1, 1)  # a per-channel vector over NCHW


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Frozen BatchNorm of (N, C, H, W) ``x`` in flax's order and rounding."""
    mul = torch.rsqrt(var.float() + eps) * weight.float()
    y = (x - mean.float().view(_SHAPE)) * mul.view(_SHAPE) + bias.float().view(_SHAPE)
    return y.to(x.dtype)


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor, eps: float, relu: bool) -> torch.Tensor:
    """``relu(batch_norm(x))``, or ``batch_norm(x)`` without ``relu``."""
    y = batch_norm(x, mean, var, weight, bias, eps)
    return F.relu(y) if relu else y


def bn_add_relu(a: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, eps: float, residual: torch.Tensor,
                d_mean: Optional[torch.Tensor] = None, d_var: Optional[torch.Tensor] = None,
                d_weight: Optional[torch.Tensor] = None, d_bias: Optional[torch.Tensor] = None,
                d_eps: float = 1e-5) -> torch.Tensor:
    """A bottleneck's end: ``relu(batch_norm(a) + r)``, where r is
    ``residual`` itself or, given the downsample BatchNorm's ``d_*``,
    ``batch_norm(residual)`` with them."""
    y = batch_norm(a, mean, var, weight, bias, eps)
    if d_mean is not None:
        residual = batch_norm(residual, d_mean, d_var, d_weight, d_bias, d_eps)
    return F.relu(y + residual)
