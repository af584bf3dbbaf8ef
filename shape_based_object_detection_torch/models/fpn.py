"""Feature Pyramid Network neck (port of the JAX package's ``models/fpn.py``).

Lateral 1x1 on C3-C5, top-down nearest upsample and add, 3x3 smoothing, then
P6 (3x3/2 on C5) and P7 (ReLU, 3x3/2 on P6). NCHW. Under a row shard
(``row_shard``) the 3x3 convolutions take their halos from the neighbouring
ranks, and the exact 2x upsample is row-local.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from shape_based_object_detection_torch.parallel.spatial import (
    ROADMAP_UNEVEN, row_conv2d,
)


def nearest_upsample_to(x: torch.Tensor, h: int, w: int, row_shard=None) -> torch.Tensor:
    """Nearest-neighbour resize to (h, w) with half-pixel centres, as
    ``jax.image.resize(method="nearest")`` (the reference's path for ragged
    sizes; for an exact 2x both conventions pick the same pixels). Under a
    row shard only an exact 2x is row-local; any other ratio raises."""
    if row_shard is not None and (h, w) != (2 * x.shape[-2], 2 * x.shape[-1]):
        raise ValueError(f"a row-split upsample of {tuple(x.shape[-2:])} to {(h, w)} is not "
                         f"an exact 2x ({ROADMAP_UNEVEN})")
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


class FPN(nn.Module):
    row_shard = None

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
        shard = self.row_shard
        p5 = self.lateral_5(c5)
        p4 = self.lateral_4(c4) + nearest_upsample_to(p5, *c4.shape[-2:], shard)
        p3 = self.lateral_3(c3) + nearest_upsample_to(p4, *c3.shape[-2:], shard)
        p3, p4, p5 = (row_conv2d(self.smooth_3, p3, shard), row_conv2d(self.smooth_4, p4, shard),
                      row_conv2d(self.smooth_5, p5, shard))
        p6 = row_conv2d(self.p6, c5, shard)
        p7 = row_conv2d(self.p7, F.relu(p6), shard)
        return [p3, p4, p5, p6, p7]
