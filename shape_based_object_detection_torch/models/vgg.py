"""VGG-16 SSD trunk (port of the JAX package's ``models/vgg.py``).

SSD's surgery on VGG-16 (Liu et al. 2016 §3), NCHW: conv1_1..conv4_3 with a
ceil-mode pool3 (300 px -> 38x38 at conv4_3), a 3x3 stride-1 pool5, conv6
dilated by 6 and a 1x1 conv7 in place of fc6/fc7. conv4_3 goes through
``L2Norm``, a per-channel scale initialised to 20. Attribute names follow
the flax module paths (``vgg.conv1_1``, ..., ``vgg.conv7``, ``l2norm``), so
converted JAX weights load with ``strict=True``.

Under a row shard (``row_shard``) every convolution (``RowConv2d``) and
pool fetches the rows its window reads from the ranks that own them:
conv6's 13-row window from several ranks where a rank holds fewer rows,
pool3's ceil mode with -inf past the last row, as unsplit. ``L2Norm`` is
per pixel, so row-local.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shape_based_object_detection_torch.models.resnet import round_channels, run_segment
from shape_based_object_detection_torch.parallel.spatial import RowConv2d, row_max_pool2d


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation with a learned scale (SSD's conv4_3):
    ``x / sqrt(sum(x^2) + 1e-10) * weight``, the sum over channels in
    float32. The norm and the scale are cast to ``x``'s type first, as the
    reference does, so a bf16 input stays bf16."""

    def __init__(self, channels: int, init_scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), init_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(x.float().square().sum(1, keepdim=True) + 1e-10)
        return x / norm.to(x.dtype) * self.weight.to(x.dtype).view(1, -1, 1, 1)


def _conv3(cin: int, cout: int) -> RowConv2d:
    return RowConv2d(cin, cout, 3, padding=1)


class VGG16Trunk(nn.Module):
    """Returns (conv4_3 before its L2Norm, conv7). ``remat`` makes stages
    1-2, stage 3, stage 4 and stage 5 with conv6/conv7 four segments of
    rematerialisation, as the reference's; the segments are methods over
    named children, so the state dict does not change."""

    row_shard = None

    def __init__(self, width_mult: float = 1.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        w = lambda c: round_channels(c, width_mult)
        plan = [("conv1_1", 3, w(64)), ("conv1_2", w(64), w(64)),
                ("conv2_1", w(64), w(128)), ("conv2_2", w(128), w(128)),
                ("conv3_1", w(128), w(256)), ("conv3_2", w(256), w(256)),
                ("conv3_3", w(256), w(256)),
                ("conv4_1", w(256), w(512)), ("conv4_2", w(512), w(512)),
                ("conv4_3", w(512), w(512)),
                ("conv5_1", w(512), w(512)), ("conv5_2", w(512), w(512)),
                ("conv5_3", w(512), w(512))]
        for name, cin, cout in plan:
            self.add_module(name, _conv3(cin, cout))
        # the fc6 replacement: 3x3, dilation 6, padding 6; fc7's: 1x1
        self.conv6 = RowConv2d(w(512), w(1024), 3, padding=6, dilation=6)
        self.conv7 = RowConv2d(w(1024), w(1024), 1)

    def _convs(self, x: torch.Tensor, *names: str) -> torch.Tensor:
        for name in names:
            x = F.relu(getattr(self, name)(x))
        return x

    def _pool(self, x, kernel, stride, padding=0, ceil_mode=False):
        return row_max_pool2d(x, kernel, stride, padding, self.row_shard, ceil_mode)

    def _seg12(self, x):
        x = self._pool(self._convs(x, "conv1_1", "conv1_2"), 2, 2)
        return self._pool(self._convs(x, "conv2_1", "conv2_2"), 2, 2)

    def _seg3(self, x):
        x = self._convs(x, "conv3_1", "conv3_2", "conv3_3")
        # pool3 is ceil-mode (75 -> 38 at 300 px), each dimension on its own:
        # the reference pads an odd dimension with -inf at its end
        return self._pool(x, 2, 2, ceil_mode=True)

    def _seg4(self, x):
        return self._convs(x, "conv4_1", "conv4_2", "conv4_3")

    def _seg5(self, x):
        x = self._convs(self._pool(x, 2, 2), "conv5_1", "conv5_2", "conv5_3")
        x = self._pool(x, 3, 1, 1)  # pool5 keeps the size
        return self._convs(x, "conv6", "conv7")

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = run_segment(self._seg12, x, remat=self.remat)
        x = run_segment(self._seg3, x, remat=self.remat)
        conv4_3 = run_segment(self._seg4, x, remat=self.remat)
        return conv4_3, run_segment(self._seg5, conv4_3, remat=self.remat)
