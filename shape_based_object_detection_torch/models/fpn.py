"""Feature Pyramid Network neck (port of the JAX package's ``models/fpn.py``).

Lateral 1x1 on C3-C5, top-down nearest upsample and add, 3x3 smoothing, then
P6 (3x3/2 on C5) and P7 (ReLU, 3x3/2 on P6). NCHW.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn


def nearest_upsample_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour resize to (h, w) with half-pixel centres, as
    ``jax.image.resize(method="nearest")`` (the reference's path for ragged
    sizes; for an exact 2x both conventions pick the same pixels)."""
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels: int = 256):
        super().__init__()
        c3, c4, c5 = in_channels
        ch = out_channels
        self.lateral_3 = nn.Conv2d(c3, ch, 1)
        self.lateral_4 = nn.Conv2d(c4, ch, 1)
        self.lateral_5 = nn.Conv2d(c5, ch, 1)
        self.smooth_3 = nn.Conv2d(ch, ch, 3, padding=1)
        self.smooth_4 = nn.Conv2d(ch, ch, 3, padding=1)
        self.smooth_5 = nn.Conv2d(ch, ch, 3, padding=1)
        self.p6 = nn.Conv2d(c5, ch, 3, stride=2, padding=1)
        self.p7 = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, c3: torch.Tensor, c4: torch.Tensor,
                c5: torch.Tensor) -> List[torch.Tensor]:
        p5 = self.lateral_5(c5)
        p4 = self.lateral_4(c4) + nearest_upsample_to(p5, *c4.shape[-2:])
        p3 = self.lateral_3(c3) + nearest_upsample_to(p4, *c3.shape[-2:])
        p3, p4, p5 = self.smooth_3(p3), self.smooth_4(p4), self.smooth_5(p5)
        p6 = self.p6(c5)
        p7 = self.p7(F.relu(p6))
        return [p3, p4, p5, p6, p7]
