"""Batched class-aware NMS with fixed shapes: the plain PyTorch versions
(port of the JAX package's ``ops/nms.py``).

Greedy NMS runs ``max_detections`` select-and-suppress steps over a fixed
candidate set, every image of the batch in lockstep: one argmax (lowest index
on ties) and one IoU row per step. Class-awareness comes from shifting each
box by ``2.0 * class`` so cross-class IoU is exactly 0. These functions are
what the CPU runs; on the card ``ops/nms_cuda.py`` runs the same steps in one
kernel, and the two agree bit for bit (same float operations, same order).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
        bx0, by0, bx1, by1, barea = (
            t.gather(-1, first) for t in (x0, y0, x1, y1, area))
        iw = (torch.minimum(x1, bx1) - torch.maximum(x0, bx0)).clamp(min=0.0)
        ih = (torch.minimum(y1, by1) - torch.maximum(y0, by0)).clamp(min=0.0)
        inter = iw * ih
        iou = inter / (area + barea - inter).clamp(min=1e-8)
        live = torch.where(found & (iou >= thr), _NEG_INF, live)
        idx_out.append(torch.where(found, first, 0))
        score_out.append(torch.where(found, best, 0.0))
        ok_out.append(found)
    return NMSResult(indices=torch.cat(idx_out, -1).to(torch.int32),
                     scores=torch.cat(score_out, -1),
                     valid=torch.cat(ok_out, -1))


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


def _sort_desc(x: torch.Tensor, k: int):
    """Top-k along the last dim with ties toward the lower index, as
    ``jax.lax.top_k``; ``torch.topk`` promises no tie order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
