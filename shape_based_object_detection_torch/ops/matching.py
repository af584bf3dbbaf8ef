"""Anchor <-> ground-truth assignment (port of the JAX package's
``ops/matching.py``).

The quality of an (anchor, GT) pair is ``(1 - w) * IoU + w * shape_sim``
(``w = cfg.shape_weight``), -1 for a padding GT row. Each anchor takes its
best GT (first maximum), each valid GT may force-claim its best anchor
(lowest anchor index on ties; the later GT wins a claimed anchor), and the
thresholds with their ignore band give the labels: -1 ignore, 0 background,
1..C foreground. Everything is batched over B with static shapes.

``match_batch`` has two routes to the per-anchor and per-GT reductions,
chosen by ``cfg.backend``: the plain version, which builds the dense
(B, A, G) quality matrix (the reference's "jnp" backend), and the CUDA
kernel ``csrc/match_anchors.cu`` (the reference's "pallas" backend), after
which an O(G) epilogue applies the force-match claims. Both give the same
assignments.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from shape_based_object_detection_torch.config import MatchConfig
from shape_based_object_detection_torch.ops import boxes as box_ops

# MatchConfig.backend -> route. "jnp" and "pallas" are the reference's names,
# so its configs load unchanged; "auto" picks by the tensors' device.
_BACKENDS = {"auto": "auto", "cuda": "cuda", "pallas": "cuda", "plain": "plain",
             "jnp": "plain"}


class MatchResult(NamedTuple):
    matched_gt_idx: torch.Tensor  # (B, A) int32, GT index per anchor
    cls_targets: torch.Tensor  # (B, A) int32 in {-1, 0, 1..C}
    reg_targets: torch.Tensor  # (B, A, 4) encoded offsets, 0 where not positive
    positive: torch.Tensor  # (B, A) bool
    quality: torch.Tensor  # (B, A) float32 matched quality (2.0 where claimed)


def _claimed_gt_per_anchor(gt_best_a: torch.Tensor, gt_valid: torch.Tensor,
                           num_anchors: int) -> torch.Tensor:
    """(..., A) int32: the highest-index valid GT that claims each anchor as
    its best, or -1. A max-scatter, so conflicting claims resolve the same
    way in any order; invalid GTs scatter into an extra column that is cut
    off (the reference's ``mode="drop"``)."""
    g_ids = torch.arange(gt_valid.shape[-1], dtype=torch.int32,
                         device=gt_valid.device).expand(gt_valid.shape)
    safe_a = torch.where(gt_valid, gt_best_a.long(), num_anchors)
    claim = torch.full((*gt_valid.shape[:-1], num_anchors + 1), -1,
                       dtype=torch.int32, device=gt_valid.device)
    claim.scatter_reduce_(-1, safe_a, g_ids, "amax")
    return claim[..., :num_anchors]


def _thresholds(best_q, matched_label, cfg: MatchConfig):
    positive = best_q >= cfg.pos_threshold
    ignore = (best_q >= cfg.neg_threshold) & ~positive
    cls_targets = torch.where(positive, matched_label, 0)
    return torch.where(ignore, -1, cls_targets).to(torch.int32), positive


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, G, 4), idx (B, N) -> (B, N, 4)."""
    return table.gather(1, idx.long()[..., None].expand(*idx.shape, 4))


def _assign_from_reductions(
    anchors_cxcywh: torch.Tensor,  # (A, 4)
    gt_boxes_xyxy: torch.Tensor,  # (B, G, 4)
    gt_labels: torch.Tensor,  # (B, G)
    gt_valid: torch.Tensor,  # (B, G) bool
    best_q: torch.Tensor,  # (B, A) max_g quality
    best_g: torch.Tensor,  # (B, A) argmax_g quality
    gt_best_a: torch.Tensor,  # (B, G) argmax_a quality
    cfg: MatchConfig,
    variances,
) -> MatchResult:
    """The plain epilogue: force-match claims, thresholds with the ignore
    band, and the offsets of every anchor's matched GT."""
    num_anchors = anchors_cxcywh.shape[0]
    best_g = best_g.to(torch.int32)
    if cfg.force_match_for_each_gt or cfg.allow_low_quality:
        claim = _claimed_gt_per_anchor(gt_best_a, gt_valid, num_anchors)
        claimed = claim >= 0
        best_g = torch.where(claimed, claim, best_g)
        best_q = torch.where(claimed, 2.0, best_q)
    matched_label = gt_labels.to(torch.int32).gather(1, best_g.long())
    cls_targets, positive = _thresholds(best_q, matched_label, cfg)
    matched = _gather_rows(box_ops.xyxy_to_cxcywh(gt_boxes_xyxy), best_g)
    reg = box_ops.encode_boxes(matched, anchors_cxcywh, variances)
    reg = torch.where(positive[..., None], reg, 0.0)
    return MatchResult(best_g, cls_targets, reg, positive, best_q)


def _quality_matrix(anchors_cxcywh, gt_boxes_xyxy, gt_valid,
                    shape_weight: float, tau: float):
    """(B, A, G) quality of every (anchor, GT) pair, -1 for invalid GTs."""
    anchors_xyxy = box_ops.cxcywh_to_xyxy(anchors_cxcywh)
    quality = box_ops.iou_matrix(anchors_xyxy, gt_boxes_xyxy)
    if shape_weight > 0.0:
        gt_cxcywh = box_ops.xyxy_to_cxcywh(gt_boxes_xyxy)
        sim = box_ops.shape_similarity(anchors_cxcywh, gt_cxcywh, tau)
        quality = (1.0 - shape_weight) * quality + shape_weight * sim
    return torch.where(gt_valid[:, None, :], quality, -1.0)


def _dense_reductions(anchors_cxcywh, gt_boxes_xyxy, gt_valid,
                      shape_weight: float, tau: float):
    """``(best_q, best_g, gt_a)`` of the dense quality matrix: the max and
    first argmax over G per anchor, the first argmax over A per GT.
    ``torch.argmax`` returns the first maximum on every device."""
    quality = _quality_matrix(anchors_cxcywh, gt_boxes_xyxy, gt_valid,
                              shape_weight, tau)
    return (quality.amax(-1), quality.argmax(-1).to(torch.int32),
            quality.argmax(1).to(torch.int32))


def match_reductions_plain(anchors_cxcywh, gt_boxes_xyxy, gt_labels, gt_valid,
                           shape_weight: float = 0.0, tau: float = 1.0,
                           variances=(0.1, 0.2)):
    """The plain version of the kernel (``ops/matching_cuda.py``), with its
    signature and outputs: ``(best_q, best_g, gt_a, label, reg)``, the last
    two the argmax GT's label and offsets before any force-match claim."""
    best_q, best_g, gt_a = _dense_reductions(anchors_cxcywh, gt_boxes_xyxy,
                                             gt_valid, shape_weight, tau)
    label = gt_labels.to(torch.int32).gather(1, best_g.long())
    reg = box_ops.encode_boxes(
        _gather_rows(box_ops.xyxy_to_cxcywh(gt_boxes_xyxy), best_g),
        anchors_cxcywh, variances)
    return best_q, best_g, gt_a, label, reg


def match_anchors(
    anchors_cxcywh: torch.Tensor,  # (A, 4)
    gt_boxes_xyxy: torch.Tensor,  # (G, 4) normalized, padded
    gt_labels: torch.Tensor,  # (G,) in [1, C]
    gt_valid: torch.Tensor,  # (G,) bool
    cfg: MatchConfig,
    variances=(0.1, 0.2),
) -> MatchResult:
    """One image through the plain matcher (the reference semantics)."""
    res = match_batch(anchors_cxcywh, gt_boxes_xyxy[None], gt_labels[None],
                      gt_valid[None], dataclasses.replace(cfg, backend="plain"),
                      variances)
    return MatchResult(*(t[0] for t in res))


def _assemble_kernel_outputs(anchors_cxcywh, gt_boxes_xyxy, gt_labels, gt_valid,
                             best_q, best_g, gt_a, label, reg,
                             cfg: MatchConfig, variances) -> MatchResult:
    """The kernel route's epilogue (``ops/matching.py:161-196`` of the
    reference): the kernel already gave every anchor its argmax GT's label
    and offsets, so the force-match claims patch at most G anchors per
    image with O(G) scatters. Every duplicate scatter index carries the same
    value (the claim's winner), so the order of the writes cannot matter."""
    num_anchors = anchors_cxcywh.shape[0]
    b, g = gt_valid.shape
    if cfg.force_match_for_each_gt or cfg.allow_low_quality:
        safe_a = torch.where(gt_valid, gt_a.long(), num_anchors)  # (B, G)
        claim = _claimed_gt_per_anchor(gt_a, gt_valid, num_anchors)
        claimed = claim >= 0
        best_g = torch.where(claimed, claim, best_g)
        best_q = torch.where(claimed, 2.0, best_q)
        ga = gt_a.long().clamp(0, num_anchors - 1)
        winner = claim.gather(1, ga).clamp(min=0)  # (B, G)
        label_fix = gt_labels.to(torch.int32).gather(1, winner.long())
        pad = label.new_zeros(b, 1)
        label = torch.cat([label, pad], 1).scatter_(1, safe_a, label_fix)
        label = label[:, :num_anchors]
        enc = box_ops.encode_boxes(
            _gather_rows(box_ops.xyxy_to_cxcywh(gt_boxes_xyxy), winner),
            anchors_cxcywh[ga], variances)
        reg = torch.cat([reg, reg.new_zeros(b, 1, 4)], 1).scatter_(
            1, safe_a[..., None].expand(b, g, 4), enc)[:, :num_anchors]
    cls_targets, positive = _thresholds(best_q, label, cfg)
    reg = torch.where(positive[..., None], reg, 0.0)
    return MatchResult(best_g, cls_targets, reg, positive, best_q)


def match_batch(
    anchors_cxcywh: torch.Tensor,  # (A, 4)
    gt_boxes_xyxy: torch.Tensor,  # (B, G, 4)
    gt_labels: torch.Tensor,  # (B, G) int32
    gt_valid: torch.Tensor,  # (B, G) bool
    cfg: MatchConfig,
    variances=(0.1, 0.2),
) -> MatchResult:
    """Batched matcher. ``cfg.backend``: "auto" runs the CUDA kernel for
    CUDA tensors and the plain version for CPU tensors; "cuda" (or the
    reference's "pallas") always the kernel, which raises on CPU tensors;
    "plain" (or "jnp") always the plain version."""
    route = _BACKENDS.get(cfg.backend)
    if route is None:
        raise ValueError(f"unknown match backend {cfg.backend!r}")
    if route == "auto":
        route = "cuda" if gt_boxes_xyxy.is_cuda else "plain"
    if route == "cuda":
        from shape_based_object_detection_torch.ops.matching_cuda import (
            match_reductions_cuda,
        )

        outs = match_reductions_cuda(
            anchors_cxcywh, gt_boxes_xyxy, gt_labels, gt_valid,
            shape_weight=cfg.shape_weight, tau=cfg.shape_tau,
            variances=tuple(variances))
        return _assemble_kernel_outputs(anchors_cxcywh, gt_boxes_xyxy, gt_labels,
                                        gt_valid, *outs, cfg, variances)
    best_q, best_g, gt_a = _dense_reductions(anchors_cxcywh, gt_boxes_xyxy,
                                             gt_valid, cfg.shape_weight,
                                             cfg.shape_tau)
    return _assign_from_reductions(anchors_cxcywh, gt_boxes_xyxy, gt_labels,
                                   gt_valid, best_q, best_g, gt_a, cfg, variances)
