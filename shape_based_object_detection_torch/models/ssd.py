"""SSD-300/512 detector (port of the JAX package's ``models/ssd.py``).

The VGG-16 trunk, the extra feature layers conv8-conv11 (and conv12 at
512 px, a 4x4 tail) and a 3x3 loc and cls head per feature map. Takes
normalized NCHW images and returns ``cls_logits (B, A, C + 1)`` (softmax,
background first) and ``box_offsets (B, A, 4)`` in float32, the priors in
the order of ``ops/anchors.ssd_anchors``: feature map, then row, column and
per-cell prior ([ratios..., the extra sqrt prior]).

``cfg.dtype`` and ``cfg.precision`` act as in ``models/retinanet.py``;
``cfg.remat`` rematerialises the trunk's four segments and the extras as
one more, as the reference's ``nn.remat``.

Under a row shard (``parallel/spatial.set_row_shard``) the forward takes
this rank's rows of the images, as RetinaNet's does: the trunk, the
extras (SSD300's unpadded 3x3 tail, SSD-512's 4x4 pad-1 conv12_2) and the
heads fetch the rows they read, none of SSD's maps (38, 19, 10, 5, 3, 1 at
300 px) needing to split evenly, and each map's head outputs are gathered
over the model group with the padding rows cut.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shape_based_object_detection_torch.config import ModelConfig
from shape_based_object_detection_torch.models.resnet import round_channels, run_segment
from shape_based_object_detection_torch.models.retinanet import conv_precision
from shape_based_object_detection_torch.models.vgg import L2Norm, VGG16Trunk
from shape_based_object_detection_torch.ops.anchors import (
    num_anchors_per_cell, ssd_extra_plan, ssd_feature_sizes,
)
from shape_based_object_detection_torch.parallel.spatial import (
    RowConv2d, check_split_input, gather_rows,
)


class SSDExtras(nn.Module):
    """conv8_1/8_2 .. the tail: a 1x1 then a k x k convolution per block,
    each with its ReLU; returns every block's output."""

    def __init__(self, image_size: int, cin: int, width_mult: float = 1.0):
        super().__init__()
        self.names = []
        for name, c1, c2, stride, pad, kernel in ssd_extra_plan(image_size):
            c1, c2 = round_channels(c1, width_mult), round_channels(c2, width_mult)
            self.add_module(f"{name}_1", RowConv2d(cin, c1, 1))
            self.add_module(f"{name}_2", RowConv2d(c1, c2, kernel, stride, pad))
            self.names.append(name)
            cin = c2
        self.out_channels = [getattr(self, f"{n}_2").out_channels for n in self.names]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for name in self.names:
            x = F.relu(getattr(self, f"{name}_1")(x))
            x = F.relu(getattr(self, f"{name}_2")(x))
            feats.append(x)
        return feats


class SSD(nn.Module):
    row_shard = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        w = lambda c: round_channels(c, cfg.width_mult)
        self.vgg = VGG16Trunk(cfg.width_mult, cfg.remat)
        self.l2norm = L2Norm(w(512))
        self.extras = SSDExtras(cfg.image_size, w(1024), cfg.width_mult)
        channels = [w(512), w(1024)] + self.extras.out_channels
        if len(channels) != len(cfg.anchors.aspect_ratios):
            raise ValueError(f"{len(channels)} feature maps vs "
                             f"{len(cfg.anchors.aspect_ratios)} anchor specs")
        self.num_outputs = cfg.num_classes + 1  # softmax, background at 0
        for i, ch in enumerate(channels):
            a = num_anchors_per_cell(cfg.anchors, i, "ssd")
            self.add_module(f"loc_{i}", RowConv2d(ch, a * 4, 3, padding=1))
            self.add_module(f"cls_{i}", RowConv2d(ch, a * self.num_outputs, 3, padding=1))

    def forward(self, images: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: (B, 3, H, W) normalized float (under a row shard, this
        rank's rows of them). ``train`` is taken for the signature RetinaNet
        has; SSD has no BatchNorm, so it changes nothing."""
        dtype = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        shard = self.row_shard
        check_split_input(images, shard, self.cfg.image_size)
        with conv_precision(self.cfg.precision):
            conv4_3, conv7 = self.vgg(images.to(dtype))
            extras = run_segment(self.extras, conv7, remat=self.cfg.remat)
            feats = [self.l2norm(conv4_3), conv7] + list(extras)
            # NHWC before flattening, so priors line up with the reference's
            cls_out = [getattr(self, f"cls_{i}")(f).permute(0, 2, 3, 1)
                       for i, f in enumerate(feats)]
            box_out = [getattr(self, f"loc_{i}")(f).permute(0, 2, 3, 1)
                       for i, f in enumerate(feats)]
            if shard is not None:  # each map's real rows from every rank, in order
                out = gather_rows(cls_out + box_out, shard)
                cls_out, box_out = out[:len(feats)], out[len(feats):]
            b = images.shape[0]
            cls_logits = torch.cat([t.reshape(b, -1, self.num_outputs) for t in cls_out], 1)
            box_offsets = torch.cat([t.reshape(b, -1, 4) for t in box_out], 1)
        return cls_logits.float(), box_offsets.float()

    def feature_sizes(self) -> Tuple[int, ...]:
        """The side of each feature map the heads read."""
        return ssd_feature_sizes(self.cfg.image_size)
