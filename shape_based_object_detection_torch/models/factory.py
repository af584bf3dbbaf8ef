"""Model construction (port of the JAX package's ``models/factory.py``).

``build_model(cfg)`` returns ``(module, anchors)``: an ``nn.Module`` in eval
mode on the chosen device, initialised from a ``torch.Generator`` with the
reference's distributions (not its bits), and the (A, 4) normalized-cxcywh
anchors on the same device. The anchor count is checked against the head's
output length, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch
from torch import nn

from shape_based_object_detection_torch import config as config_lib
from shape_based_object_detection_torch.config import ModelConfig
from shape_based_object_detection_torch.ops import anchors as anchor_lib
from shape_based_object_detection_torch.utils.device import resolve_device

# flax's lecun_normal draws from a standard normal truncated to [-2, 2] and
# divides the scale by that distribution's std so the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


def build_module(cfg: ModelConfig) -> nn.Module:
    if cfg.family == "retinanet":
        from shape_based_object_detection_torch.models.retinanet import RetinaNet

        return RetinaNet(cfg)
    if cfg.family == "ssd":
        raise NotImplementedError(
            "the SSD family is not ported yet (ROADMAP.md, modules still to "
            "port, item 6)")
    raise ValueError(f"unknown model family {cfg.family!r}")


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialisers: lecun-normal conv kernels and zero
    biases; normal(0.01) kernels in the RetinaNet heads, whose final
    classification bias keeps its prior; BatchNorm scale 1, bias 0, mean 0,
    variance 1 (as constructed)."""
    from shape_based_object_detection_torch.models.retinanet import RetinaNetHead

    heads = [m for m in module.modules() if isinstance(m, RetinaNetHead)]
    head_convs = {id(c) for h in heads for c in h.modules()
                  if isinstance(c, nn.Conv2d)}
    for m in module.modules():
        if not isinstance(m, nn.Conv2d):
            continue
        if id(m) in head_convs:
            m.weight.normal_(0.0, 0.01, generator=generator)
        else:
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        if m.bias is not None:
            m.bias.zero_()
    for h in heads:
        h.predict.bias.fill_(h.final_bias)


def head_output_count(cfg: ModelConfig) -> int:
    """Rows of the head output at ``cfg.image_size``, from a forward on the
    meta device (shapes only, no memory, no arithmetic)."""
    cfg = dataclasses.replace(cfg, dtype="float32")  # shapes do not depend on it
    with torch.device("meta"):
        module = build_module(cfg)
        cls_logits, _ = module(torch.empty(1, 3, cfg.image_size, cfg.image_size))
    return cls_logits.shape[1]


def build_model(
    cfg_or_name: Union[ModelConfig, str],
    device=None,
    generator: torch.Generator | None = None,
) -> Tuple[nn.Module, torch.Tensor]:
    """Returns ``(module, anchors_cxcywh)`` on ``device`` (default: the
    card; raises without one unless ``device="cpu"``). Weights are drawn on
    the CPU from ``generator`` (default: seed 0), so they do not depend on
    the device."""
    cfg = (config_lib.get_config(cfg_or_name).model
           if isinstance(cfg_or_name, str) else cfg_or_name)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    module = build_module(cfg)
    init_weights(module, generator)
    anchors = anchor_lib.anchors_for_model(cfg)
    num_pred = head_output_count(cfg)
    if anchors.shape[0] != num_pred:
        raise ValueError(
            f"anchor/head mismatch: {anchors.shape[0]} anchors vs {num_pred} "
            "predictions")
    module = module.to(dev).eval()
    if cfg.dtype == "bfloat16":
        # convolutions compute in bf16; BatchNorm statistics stay float32,
        # as the reference keeps its parameters
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                m.to(torch.bfloat16)
    if dev.type == "cuda":
        # NHWC activations for cuDNN's tensor-core convolutions; the
        # (B, H, W, 3) input permuted to NCHW already has this layout
        module = module.to(memory_format=torch.channels_last)
    return module, anchors.to(dev)
