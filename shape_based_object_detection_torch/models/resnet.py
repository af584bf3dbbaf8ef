"""ResNet-50/101 backbone (port of the JAX package's ``models/resnet.py``).

Bottleneck ResNet v1 with the stride in each stage's first 3x3, NCHW.
Returns C3, C4, C5 (strides 8, 16, 32) for the FPN. BatchNorm is frozen:
running statistics only, eps 1e-5, as the reference runs it for detection.
Attribute names follow the flax module paths (``layer2_0.conv2``,
``downsample_bn``), so converted JAX weights load with ``strict=True``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


def round_channels(c: int, mult: float) -> int:
    """Channel width under ``width_mult``, as the reference rounds it."""
    return max(8, int(c * mult))


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics: ``(x - mean) * rsqrt(var + eps) *
    weight + bias``, applied as one fused multiply-add per element. The
    state has no ``num_batches_tracked``: nothing here is trained."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        shift = self.bias.float() - self.running_mean.float() * mul
        shape = (1, -1, 1, 1)
        return torch.addcmul(shift.to(x.dtype).view(shape), x,
                             mul.to(x.dtype).view(shape))


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """k x k convolution padded (k - 1) // 2 on each side: the reference's
    explicit ((1, 1), (1, 1)) for 3x3, ((3, 3), (3, 3)) for 7x7, and SAME
    (no padding) for 1x1."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        out_ch = channels * 4
        self.conv1 = conv(cin, channels, 1)
        self.bn1 = FrozenBatchNorm2d(channels)
        self.conv2 = conv(channels, channels, 3, stride)
        self.bn2 = FrozenBatchNorm2d(channels)
        self.conv3 = conv(channels, out_ch, 1)
        self.bn3 = FrozenBatchNorm2d(out_ch)
        if cin != out_ch or stride != 1:
            self.downsample = conv(cin, out_ch, 1, stride)
            self.downsample_bn = FrozenBatchNorm2d(out_ch)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample_bn(self.downsample(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Returns (C3, C4, C5) with strides (8, 16, 32)."""

    def __init__(self, variant: str = "resnet50", width_mult: float = 1.0):
        super().__init__()
        widths = tuple(round_channels(c, width_mult) for c in (64, 128, 256, 512))
        self.conv1 = conv(3, widths[0], 7, stride=2)
        self.bn1 = FrozenBatchNorm2d(widths[0])
        self.stages = []
        cin = widths[0]
        for stage, (n_blocks, ch) in enumerate(zip(STAGE_BLOCKS[variant], widths)):
            names = []
            for blk in range(n_blocks):
                stride = 2 if (blk == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, Bottleneck(cin, ch, stride))
                names.append(name)
                cin = ch * 4
            self.stages.append(names)
        self.out_channels = tuple(w * 4 for w in widths[1:])  # C3, C4, C5

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        taps = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            taps.append(x)
        return taps[1], taps[2], taps[3]
