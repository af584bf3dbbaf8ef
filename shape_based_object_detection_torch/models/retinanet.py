"""RetinaNet detector (port of the JAX package's ``models/retinanet.py``).

ResNet + FPN P3-P7 + shared 4-conv classification and box subnets (Lin et al.
2017 §4). The classification head's final bias starts at -log(99), the prior
probability 0.01. Takes normalized NCHW images and returns
``cls_logits (B, A, K)`` and ``box_offsets (B, A, 4)`` in float32, with the
anchors in the reference's order: level, then row, column, and per-cell
anchor (octave-major, ratio-minor), as ``ops/anchors.retinanet_anchors``.

``cfg.dtype`` sets the convolutions' type ("bfloat16" runs them in bf16 with
bf16 conv weights; BatchNorm stays float32). ``cfg.precision`` maps to cuDNN's
TF32 switch for float32 convolutions: "highest" is true float32 (TF32 off),
"default" lets cuDNN use TF32, the card's counterpart of the reference's
reduced-precision default.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shape_based_object_detection_torch.config import ModelConfig
from shape_based_object_detection_torch.models.fpn import FPN
from shape_based_object_detection_torch.models.resnet import ResNet
from shape_based_object_detection_torch.ops.anchors import num_anchors_per_cell

PRIOR_PROB = 0.01


@contextlib.contextmanager
def conv_precision(precision: str):
    """Set cuDNN's TF32 switch for the duration of a forward."""
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = precision == "default"
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class RetinaNetHead(nn.Module):
    """One shared subnet applied to every pyramid level."""

    def __init__(self, num_outputs: int, num_anchors: int, depth: int = 4,
                 channels: int = 256, final_bias: float = 0.0):
        super().__init__()
        self.num_outputs = num_outputs
        self.depth = depth
        self.final_bias = final_bias
        for i in range(depth):
            self.add_module(f"conv_{i}", nn.Conv2d(channels, channels, 3, padding=1))
        self.predict = nn.Conv2d(channels, num_anchors * num_outputs, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        x = self.predict(x)
        b = x.shape[0]
        # NHWC before flattening, so anchors line up with the reference's
        return x.permute(0, 2, 3, 1).reshape(b, -1, self.num_outputs)


class RetinaNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(cfg.backbone, cfg.width_mult)
        self.fpn = FPN(self.backbone.out_channels, cfg.fpn_channels)
        a = num_anchors_per_cell(cfg.anchors, 0, "retinanet")
        self.cls_head = RetinaNetHead(
            cfg.num_classes, a, cfg.head_depth, cfg.fpn_channels,
            final_bias=-math.log((1.0 - PRIOR_PROB) / PRIOR_PROB))
        self.box_head = RetinaNetHead(4, a, cfg.head_depth, cfg.fpn_channels)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: (B, 3, H, W) normalized float."""
        dtype = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        with conv_precision(self.cfg.precision):
            c3, c4, c5 = self.backbone(images.to(dtype))
            pyramid = self.fpn(c3, c4, c5)
            cls_logits = torch.cat([self.cls_head(p) for p in pyramid], 1)
            box_offsets = torch.cat([self.box_head(p) for p in pyramid], 1)
        return cls_logits.float(), box_offsets.float()
