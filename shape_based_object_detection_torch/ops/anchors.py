"""Anchor / prior-box generation (port of the JAX package's ``ops/anchors.py``).

The arithmetic is numpy, as in the reference, so the anchors are equal to the
bit; only the return type differs (a float32 CPU tensor, which callers move to
their device). All anchors are normalized cxcywh.

SSD priors follow Liu et al. 2016 §2.2 (SSD-300: 8732, SSD-512: 24564).
RetinaNet anchors follow Lin et al. 2017 §4: P3-P7, 3 octave scales x 3
aspect ratios per cell, octave-major and ratio-minor, the order in which the
heads flatten their outputs.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from shape_based_object_detection_torch.config import AnchorConfig, ModelConfig


def ssd_extra_plan(image_size: int):
    """(name, c1, c2, stride, pad, kernel) per SSD extra block.

    300: 19->10->5->3->1 (last two are 3x3 valid convs).
    512: 32->16->8->4->2->1 (last is a 4x4 pad-1 conv).
    """
    if image_size == 512:
        return [
            ("conv8", 256, 512, 2, 1, 3),
            ("conv9", 128, 256, 2, 1, 3),
            ("conv10", 128, 256, 2, 1, 3),
            ("conv11", 128, 256, 2, 1, 3),
            ("conv12", 128, 256, 1, 1, 4),
        ]
    return [
        ("conv8", 256, 512, 2, 1, 3),
        ("conv9", 128, 256, 2, 1, 3),
        ("conv10", 128, 256, 1, 0, 3),
        ("conv11", 128, 256, 1, 0, 3),
    ]


def ssd_feature_sizes(image_size: int) -> Tuple[int, ...]:
    """Spatial sizes of the SSD detection feature maps for a VGG-16 trunk:
    300 -> (38, 19, 10, 5, 3, 1); 512 -> (64, 32, 16, 8, 4, 2, 1); other
    sizes replay the trunk's and the extras' layer arithmetic."""
    if image_size == 300:
        return (38, 19, 10, 5, 3, 1)
    if image_size == 512:
        return (64, 32, 16, 8, 4, 2, 1)
    f0 = math.ceil(image_size // 2 // 2 / 2)  # conv4_3 (pool3 is ceil-mode)
    f1 = f0 // 2  # conv7 (pool4 floor; pool5 is 3x3 stride 1)
    sizes = [f0, f1]
    cur = f1
    for _name, _c1, _c2, stride, pad, kernel in ssd_extra_plan(image_size):
        cur = (cur + 2 * pad - kernel) // stride + 1
        if cur < 1:
            raise ValueError(
                f"image_size {image_size} is too small for the SSD extras "
                f"tail (a feature map would reach size {cur})")
        sizes.append(cur)
    return tuple(sizes)


def _ssd_level_anchors(fmap: int, scale: float, next_scale: float,
                       ratios: Sequence[float]) -> np.ndarray:
    """Anchors for one SSD level: (fmap * fmap * (len(ratios)+1), 4) cxcywh."""
    whs = [(scale * math.sqrt(r), scale / math.sqrt(r)) for r in ratios]
    whs.append((math.sqrt(scale * next_scale), math.sqrt(scale * next_scale)))
    whs = np.asarray(whs, dtype=np.float32)

    coords = (np.arange(fmap, dtype=np.float32) + 0.5) / fmap
    cy, cx = np.meshgrid(coords, coords, indexing="ij")
    centers = np.stack([cx, cy], axis=-1).reshape(-1, 1, 2)
    centers = np.broadcast_to(centers, (fmap * fmap, len(whs), 2))
    wh = np.broadcast_to(whs[None], (fmap * fmap, len(whs), 2))
    return np.concatenate([centers, wh], axis=-1).reshape(-1, 4)


def ssd_anchors(cfg: AnchorConfig, image_size: int,
                feature_sizes: Sequence[int] | None = None) -> torch.Tensor:
    """All SSD priors, (num_priors, 4) normalized cxcywh, w/h clamped to 1."""
    fmaps = tuple(feature_sizes) if feature_sizes else ssd_feature_sizes(image_size)
    if len(cfg.scales) != len(fmaps) + 1 or len(cfg.aspect_ratios) != len(fmaps):
        raise ValueError(
            f"need {len(fmaps) + 1} scales and {len(fmaps)} ratio sets for "
            f"{len(fmaps)} feature maps, got {len(cfg.scales)} and "
            f"{len(cfg.aspect_ratios)}")
    per_level = [
        _ssd_level_anchors(f, cfg.scales[k], cfg.scales[k + 1], cfg.aspect_ratios[k])
        for k, f in enumerate(fmaps)
    ]
    anchors = np.concatenate(per_level, axis=0)
    anchors[:, 2:] = np.clip(anchors[:, 2:], 0.0, 1.0)
    return torch.from_numpy(anchors)


def retinanet_feature_sizes(image_size: int, strides: Sequence[int]) -> Tuple[int, ...]:
    return tuple(math.ceil(image_size / s) for s in strides)


def retinanet_anchors(cfg: AnchorConfig, image_size: int,
                      feature_sizes: Sequence[int] | None = None) -> torch.Tensor:
    """All RetinaNet anchors, (num_anchors, 4) normalized cxcywh."""
    fmaps = (tuple(feature_sizes) if feature_sizes
             else retinanet_feature_sizes(image_size, cfg.strides))
    levels: List[np.ndarray] = []
    for lvl, fmap in enumerate(fmaps):
        stride, base = cfg.strides[lvl], cfg.sizes[lvl]
        whs = []
        for oct_scale in cfg.octave_scales:
            for r in cfg.aspect_ratios[lvl]:
                size = base * oct_scale
                whs.append((size * math.sqrt(r), size / math.sqrt(r)))
        whs = np.asarray(whs, dtype=np.float32) / image_size

        cs = (np.arange(fmap, dtype=np.float32) + 0.5) * stride / image_size
        cy, cx = np.meshgrid(cs, cs, indexing="ij")
        centers = np.stack([cx, cy], axis=-1).reshape(-1, 1, 2)
        centers = np.broadcast_to(centers, (fmap * fmap, len(whs), 2))
        wh = np.broadcast_to(whs[None], (fmap * fmap, len(whs), 2))
        levels.append(np.concatenate([centers, wh], axis=-1).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(levels, axis=0))


def anchors_for_model(model_cfg: ModelConfig,
                      feature_sizes: Sequence[int] | None = None) -> torch.Tensor:
    """Dispatch on model family; returns (num_anchors, 4) normalized cxcywh."""
    if model_cfg.family == "ssd":
        return ssd_anchors(model_cfg.anchors, model_cfg.image_size, feature_sizes)
    if model_cfg.family == "retinanet":
        return retinanet_anchors(model_cfg.anchors, model_cfg.image_size, feature_sizes)
    raise ValueError(f"unknown family {model_cfg.family!r}")


def num_anchors_per_cell(cfg: AnchorConfig, level: int, family: str) -> int:
    if family == "ssd":
        return len(cfg.aspect_ratios[level]) + 1
    return len(cfg.octave_scales) * len(cfg.aspect_ratios[level])
