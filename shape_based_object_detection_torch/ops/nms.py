"""Batched class-aware NMS with fixed shapes: the plain PyTorch versions
(port of the JAX package's ``ops/nms.py``).

Greedy NMS runs ``max_detections`` select-and-suppress steps over a fixed
candidate set, every image of the batch in lockstep: one argmax (lowest index
on ties) and one IoU row per step. Class-awareness comes from shifting each
box by ``2.0 * class`` so cross-class IoU is exactly 0. These functions are
what the CPU runs; on the card ``ops/nms_cuda.py`` runs the same steps in one
kernel, and the two agree bit for bit (same float operations, same order).
Soft-NMS runs the same select loop with a Gaussian decay in place of the
suppression, as plain PyTorch on either device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shape_based_object_detection_torch.ops import boxes as box_ops

_NEG_INF = -1e10


def class_offset_boxes(boxes_xyxy: torch.Tensor,
                       classes: torch.Tensor) -> torch.Tensor:
    """Shift each box by ``class_id * 2.0``: boxes live in [0, 1], so
    cross-class IoU becomes exactly 0 and one single-class pass equals
    independent per-class NMS. ``classes`` broadcasts against the boxes'
    leading dims."""
    return boxes_xyxy + classes.to(boxes_xyxy.dtype)[..., None] * 2.0


class NMSResult(NamedTuple):
    indices: torch.Tensor  # (..., max_detections) int32 into the candidate set
    scores: torch.Tensor  # (..., max_detections) float32, 0 where invalid
    valid: torch.Tensor  # (..., max_detections) bool


class Detections(NamedTuple):
    """Fixed-size per-image detection set (the public detect() output)."""

    boxes: torch.Tensor  # (B, max_detections, 4) xyxy
    scores: torch.Tensor  # (B, max_detections)
    labels: torch.Tensor  # (B, max_detections) int32
    valid: torch.Tensor  # (B, max_detections) bool


def _iou_with(first, x0, y0, x1, y1, area):
    """IoU of every candidate with the one at index ``first`` (..., 1), in
    the order of operations the CUDA kernel reproduces."""
    bx0, by0, bx1, by1, barea = (t.gather(-1, first) for t in (x0, y0, x1, y1, area))
    iw = (torch.minimum(x1, bx1) - torch.maximum(x0, bx0)).clamp(min=0.0)
    ih = (torch.minimum(y1, by1) - torch.maximum(y0, by0)).clamp(min=0.0)
    inter = iw * ih
    return inter / (area + barea - inter).clamp(min=1e-8)


def greedy_nms(
    boxes_xyxy: torch.Tensor,  # (..., N, 4)
    scores: torch.Tensor,  # (..., N)
    valid: torch.Tensor,  # (..., N) bool
    iou_threshold: float,
    max_detections: int,
) -> NMSResult:
    """Single-class greedy NMS over fixed-size candidate sets, batched over
    the leading dims. Padding rows (``valid`` False) are never selected and
    suppress nothing. Survivors come in selection order; slots after the
    last one hold index 0, score 0 and ``valid`` False."""
    boxes = boxes_xyxy.float()
    x0, y0, x1, y1 = boxes.unbind(-1)
    area = (x1 - x0).clamp(min=0.0) * (y1 - y0).clamp(min=0.0)
    n = scores.shape[-1]
    iota = torch.arange(n, device=scores.device)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=scores.device)
    live = torch.where(valid, scores.float(), _NEG_INF)

    idx_out, score_out, ok_out = [], [], []
    for _ in range(max_detections):
        best = live.max(-1, keepdim=True).values
        found = best > _NEG_INF / 2
        first = torch.where(live == best, iota, n).min(-1, keepdim=True).values
        iou = _iou_with(first, x0, y0, x1, y1, area)
        live = torch.where(found & (iou >= thr), _NEG_INF, live)
        idx_out.append(torch.where(found, first, 0))
        score_out.append(torch.where(found, best, 0.0))
        ok_out.append(found)
    return NMSResult(indices=torch.cat(idx_out, -1).to(torch.int32),
                     scores=torch.cat(score_out, -1),
                     valid=torch.cat(ok_out, -1))


def nms_mask(boxes_xyxy: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """The (..., N) keep mask of classic NMS: ``greedy_nms`` run to N picks,
    its kept indices marked."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    res = greedy_nms(boxes_xyxy, scores, valid, iou_threshold, scores.shape[-1])
    # a max, not a set: a slot after the last pick holds index 0, not kept
    keep = torch.zeros(scores.shape, dtype=torch.uint8, device=scores.device)
    return keep.scatter_reduce(-1, res.indices.long(), res.valid.to(torch.uint8),
                               "amax").bool()


def gather_detections(boxes_xyxy, classes, res: NMSResult) -> Detections:
    """Detections from an NMS result over (B, N) candidates: the kept
    boxes (unshifted) and classes, gathered by index."""
    idx = res.indices.long()
    out_boxes = boxes_xyxy.gather(1, idx[..., None].expand(*idx.shape, 4))
    out_classes = classes.gather(1, idx)
    return Detections(boxes=out_boxes, scores=res.scores, labels=out_classes,
                      valid=res.valid)


def batched_class_aware_nms(
    boxes_xyxy: torch.Tensor,  # (B, N, 4) in [0, 1]
    scores: torch.Tensor,  # (B, N)
    classes: torch.Tensor,  # (B, N) int32
    valid: torch.Tensor,  # (B, N) bool
    iou_threshold: float,
    max_detections: int,
) -> Detections:
    """Class-aware NMS over a batch of fixed-size candidate sets."""
    res = greedy_nms(class_offset_boxes(boxes_xyxy, classes), scores, valid,
                     iou_threshold, max_detections)
    return gather_detections(boxes_xyxy, classes, res)


def soft_nms(
    boxes_xyxy: torch.Tensor,  # (..., N, 4)
    scores: torch.Tensor,  # (..., N), non-negative
    valid: torch.Tensor,  # (..., N) bool
    sigma: float,
    score_threshold: float,
    max_detections: int,
) -> NMSResult:
    """Gaussian Soft-NMS (Bodla et al. 2017), batched over the leading dims:
    greedy NMS's select loop, but each pick multiplies the score of every
    other positive candidate by ``exp(-iou² / sigma)`` instead of removing
    it. A pick reports its decayed score; picks at or below
    ``score_threshold`` are invalid (score 0) and leave the scores as they
    were. Every slot carries its step's argmax, as the reference's."""
    boxes = boxes_xyxy.float()
    x0, y0, x1, y1 = boxes.unbind(-1)
    area = (x1 - x0).clamp(min=0.0) * (y1 - y0).clamp(min=0.0)
    n = scores.shape[-1]
    iota = torch.arange(n, device=scores.device)
    floor = torch.tensor(max(score_threshold, _NEG_INF / 2), dtype=torch.float32,
                         device=scores.device)
    live = torch.where(valid, scores.float(), _NEG_INF)

    idx_out, score_out, ok_out = [], [], []
    for _ in range(max_detections):
        best = live.max(-1, keepdim=True).values
        found = best > floor
        first = torch.where(live == best, iota, n).min(-1, keepdim=True).values
        iou = _iou_with(first, x0, y0, x1, y1, area)
        decay = torch.exp(box_ops.true_div(-(iou * iou), sigma))
        decayed = torch.where(live > 0, live * decay, live)
        live = torch.where(found, decayed, live)
        live = live.scatter(-1, first, _NEG_INF)  # the pick is consumed
        idx_out.append(first)
        score_out.append(torch.where(found, best, 0.0))
        ok_out.append(found)
    return NMSResult(indices=torch.cat(idx_out, -1).to(torch.int32),
                     scores=torch.cat(score_out, -1),
                     valid=torch.cat(ok_out, -1))


def batched_class_aware_soft_nms(
    boxes_xyxy: torch.Tensor,  # (B, N, 4) in [0, 1]
    scores: torch.Tensor,  # (B, N)
    classes: torch.Tensor,  # (B, N) int32
    valid: torch.Tensor,  # (B, N) bool
    sigma: float,
    score_threshold: float,
    max_detections: int,
) -> Detections:
    """Class-aware Soft-NMS: with the class offset, cross-class IoU is 0 and
    its decay exp(0) = 1."""
    res = soft_nms(class_offset_boxes(boxes_xyxy, classes), scores, valid,
                   sigma, score_threshold, max_detections)
    return gather_detections(boxes_xyxy, classes, res)


def _sort_desc(x: torch.Tensor, k: int):
    """Top-k along the last dim with ties toward the lower index, as
    ``jax.lax.top_k``; ``torch.topk`` promises no tie order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_top_candidates(
    boxes_xyxy: torch.Tensor,  # (..., A, 4) decoded boxes, shared across classes
    class_scores: torch.Tensor,  # (..., A, C) per-class selection scores
    score_threshold: float,
    top_k: int,
    activation=None,
    two_stage: bool | None = None,
):
    """``select_top_candidate_pairs`` with the winners' boxes gathered:
    (boxes (..., k, 4), scores, classes int32, valid). ``detection``
    decodes only the k winners instead (``select_candidates``)."""
    anchor_idx, scores, classes, valid = select_top_candidate_pairs(
        class_scores, score_threshold, top_k, activation, two_stage)
    boxes = boxes_xyxy.gather(-2, anchor_idx[..., None].expand(*anchor_idx.shape, 4))
    return boxes, scores, classes, valid


def select_top_candidate_pairs(
    class_scores: torch.Tensor,  # (..., A, C) per-class selection scores
    score_threshold: float,
    top_k: int,
    activation=None,
    two_stage: bool | None = None,
):
    """Keep the top-k (anchor, class) pairs by score, exactly, batched over
    the leading dims.

    Two stages avoid a top-k over all A*C pairs: the per-anchor best class
    score picks the top-k anchors, and a top-k over only those anchors' pairs
    follows. A pair in the true top-k always has its anchor among the first
    stage's winners, so the result is exact. ``activation`` (e.g. sigmoid) is
    applied to the k winners only. ``two_stage=None`` picks by pair count,
    as the reference does.

    Returns (anchor_idx, scores, classes int32, valid), each (..., k), with
    below-threshold pairs marked invalid.
    """
    a, c = class_scores.shape[-2:]
    if two_stage is None:
        two_stage = a * c >= 2_000_000
    if two_stage:
        k_a = min(top_k, a)
        _, anchor_sel = _sort_desc(class_scores.max(-1).values, k_a)
        sel_scores = class_scores.gather(
            -2, anchor_sel[..., None].expand(*anchor_sel.shape, c))
        k = min(top_k, k_a * c)
        top_scores, top_idx = _sort_desc(sel_scores.flatten(-2), k)
        anchor_idx = anchor_sel.gather(-1, top_idx // c)
    else:
        k = min(top_k, a * c)
        top_scores, top_idx = _sort_desc(class_scores.flatten(-2), k)
        anchor_idx = top_idx // c
    if activation is not None:
        top_scores = activation(top_scores)
    class_idx = (top_idx % c).to(torch.int32)
    return anchor_idx, top_scores, class_idx, top_scores > score_threshold
