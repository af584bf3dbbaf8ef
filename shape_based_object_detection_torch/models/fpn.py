"""Feature Pyramid Network neck (port of the JAX package's ``models/fpn.py``).

Lateral 1x1 on C3-C5, top-down nearest upsample and add, 3x3 smoothing, then
P6 (3x3/2 on C5) and P7 (ReLU, 3x3/2 on P6). NCHW. Under a row shard
(``row_shard``) the convolutions fetch the rows their windows read from
the ranks that own them, and so does the upsample, whose fine rows can
need a coarse row of another rank where the rows split unevenly.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from shape_based_object_detection_torch.parallel.spatial import (
    RowConv2d, row_upsample_nearest,
)


def nearest_upsample_to(x: torch.Tensor, h: int, w: int, row_shard=None) -> torch.Tensor:
    """Nearest-neighbour resize to (h, w) with half-pixel centres, as
    ``jax.image.resize(method="nearest")`` (the reference's path for ragged
    sizes; for an exact 2x both conventions pick the same pixels), on this
    rank's rows under a row shard."""
    return row_upsample_nearest(x, h, w, row_shard)


class FPN(nn.Module):
    row_shard = None

    def __init__(self, in_channels, out_channels: int = 256):
        super().__init__()
        c3, c4, c5 = in_channels
        ch = out_channels
        self.lateral_3 = RowConv2d(c3, ch, 1)
        self.lateral_4 = RowConv2d(c4, ch, 1)
        self.lateral_5 = RowConv2d(c5, ch, 1)
        self.smooth_3 = RowConv2d(ch, ch, 3, padding=1)
        self.smooth_4 = RowConv2d(ch, ch, 3, padding=1)
        self.smooth_5 = RowConv2d(ch, ch, 3, padding=1)
        self.p6 = RowConv2d(c5, ch, 3, stride=2, padding=1)
        self.p7 = RowConv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, c3: torch.Tensor, c4: torch.Tensor,
                c5: torch.Tensor) -> List[torch.Tensor]:
        shard = self.row_shard

        def size(t):  # split, a square map's rows are its width's count
            return (t.shape[-1],) * 2 if shard is not None else tuple(t.shape[-2:])

        p5 = self.lateral_5(c5)
        p4 = self.lateral_4(c4) + nearest_upsample_to(p5, *size(c4), shard)
        p3 = self.lateral_3(c3) + nearest_upsample_to(p4, *size(c3), shard)
        p3, p4, p5 = self.smooth_3(p3), self.smooth_4(p4), self.smooth_5(p5)
        p6 = self.p6(c5)
        p7 = self.p7(F.relu(p6))
        return [p3, p4, p5, p6, p7]
