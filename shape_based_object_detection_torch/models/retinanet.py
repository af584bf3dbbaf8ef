"""RetinaNet detector (port of the JAX package's ``models/retinanet.py``).

ResNet + FPN P3-P7 + shared 4-conv classification and box subnets (Lin et al.
2017 §4). The classification head's final bias starts at -log(99), the prior
probability 0.01. Takes normalized NCHW images and returns
``cls_logits (B, A, K)`` and ``box_offsets (B, A, 4)`` in float32, with the
anchors in the reference's order: level, then row, column, and per-cell
anchor (octave-major, ratio-minor), as ``ops/anchors.retinanet_anchors``.

``cfg.train_bn`` with a call-time ``train=True`` (the training forward)
normalises the backbone's BatchNorm with batch statistics; ``cfg.remat``
rematerialises each bottleneck, the FPN and each per-level head
application, as the reference's ``nn.remat`` segments.

``cfg.dtype`` sets the convolutions' type ("bfloat16" runs them in bf16 with
bf16 conv weights; BatchNorm stays float32). ``cfg.precision`` maps to cuDNN's
TF32 switch for float32 convolutions: "highest" is true float32 (TF32 off),
"default" lets cuDNN use TF32, the card's counterpart of the reference's
reduced-precision default.

Under a row shard (``parallel/spatial.set_row_shard``: the reference's
images split by rows over its "model" mesh axis) the forward takes this
rank's rows of the images (``RowShard.split``), every convolution, the
stem's max-pool and the FPN's upsample fetch the rows they read from the
ranks that own them, and each level's head outputs are gathered over the
model group with the padding rows of an uneven split cut: every rank of
the group returns the whole images' ``cls_logits`` and ``box_offsets``,
as unsplit.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shape_based_object_detection_torch.config import ModelConfig
from shape_based_object_detection_torch.models.fpn import FPN
from shape_based_object_detection_torch.models.resnet import ResNet, run_segment
from shape_based_object_detection_torch.ops.anchors import (
    num_anchors_per_cell, retinanet_feature_sizes,
)
from shape_based_object_detection_torch.parallel.spatial import (
    RowConv2d, check_split_input, gather_rows,
)

PRIOR_PROB = 0.01


# cuDNN's TF32 switch is one flag for the whole process: a forward holds
# this lock from setting it to restoring it, so two threads running models
# of different precision cannot run under each other's setting
_PRECISION_LOCK = threading.RLock()


@contextlib.contextmanager
def conv_precision(precision: str):
    """Set cuDNN's TF32 switch for the duration of a forward (and of a
    backward, where a caller holds it around one), under a process-wide
    re-entrant lock. A recomputation inside a backward pass (remat) runs on
    autograd's own thread while the thread that called backward holds the
    lock; it finds the switch already set and goes on without the lock.
    That is safe only while every backward of a model runs inside this
    context, as ``train._grad_and_update``'s does (checked by
    ``tests/test_torch_server.py``). The check for "inside a backward" is
    PyTorch's private ``_current_graph_task_id``: if a release removes it,
    every forward raises rather than racing."""
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")
    allow = precision == "default"
    if (torch._C._current_graph_task_id() != -1
            and torch.backends.cudnn.allow_tf32 == allow):
        yield
        return
    with _PRECISION_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = allow
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


class RetinaNetHead(nn.Module):
    """One shared subnet applied to every pyramid level; returns the level's
    outputs as an NHWC map (B, H, W, A * num_outputs)."""

    def __init__(self, num_outputs: int, num_anchors: int, depth: int = 4,
                 channels: int = 256, final_bias: float = 0.0):
        super().__init__()
        self.num_outputs = num_outputs
        self.depth = depth
        self.final_bias = final_bias
        for i in range(depth):
            self.add_module(f"conv_{i}", RowConv2d(channels, channels, 3, padding=1))
        self.predict = RowConv2d(channels, num_anchors * num_outputs, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        # NHWC before flattening, so anchors line up with the reference's
        return self.predict(x).permute(0, 2, 3, 1)


class RetinaNet(nn.Module):
    row_shard = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(cfg.backbone, cfg.width_mult, cfg.train_bn, cfg.remat)
        self.fpn = FPN(self.backbone.out_channels, cfg.fpn_channels)
        a = num_anchors_per_cell(cfg.anchors, 0, "retinanet")
        self.cls_head = RetinaNetHead(
            cfg.num_classes, a, cfg.head_depth, cfg.fpn_channels,
            final_bias=-math.log((1.0 - PRIOR_PROB) / PRIOR_PROB))
        self.box_head = RetinaNetHead(4, a, cfg.head_depth, cfg.fpn_channels)

    def forward(self, images: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: (B, 3, H, W) normalized float (under a row shard, this
        rank's rows of them). ``train`` selects batch statistics in
        BatchNorm where ``cfg.train_bn`` allows it."""
        dtype = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        remat, shard = self.cfg.remat, self.row_shard
        check_split_input(images, shard, self.cfg.image_size)
        with conv_precision(self.cfg.precision):
            c3, c4, c5 = self.backbone(images.to(dtype), train)
            pyramid = run_segment(self.fpn, c3, c4, c5, remat=remat)
            cls_out = [run_segment(self.cls_head, p, remat=remat) for p in pyramid]
            box_out = [run_segment(self.box_head, p, remat=remat) for p in pyramid]
            if shard is not None:  # each level's real rows from every rank, in order
                out = gather_rows(cls_out + box_out, shard)
                cls_out, box_out = out[:len(pyramid)], out[len(pyramid):]
            b = images.shape[0]
            cls_logits = torch.cat([t.reshape(b, -1, self.cfg.num_classes) for t in cls_out], 1)
            box_offsets = torch.cat([t.reshape(b, -1, 4) for t in box_out], 1)
        return cls_logits.float(), box_offsets.float()

    def feature_sizes(self) -> Tuple[int, ...]:
        """The side of each pyramid level's map, P3 to P7."""
        return retinanet_feature_sizes(self.cfg.image_size, self.cfg.anchors.strides)

