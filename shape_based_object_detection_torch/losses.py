"""Detection losses (port of the JAX package's ``losses.py``).

- ``multibox_loss`` (SSD): softmax cross-entropy with a background class
  plus SmoothL1 on positives, with hard-negative mining at
  ``neg_pos_ratio``:1 by the double-argsort rank (stable sorts, so ties,
  common among padding anchors, rank as in the reference).
- ``focal_loss`` (RetinaNet): sigmoid focal cross-entropy over every
  non-ignored anchor plus SmoothL1 on positives, both over #positives.

Both take a ``MatchResult`` with labels -1 ignore / 0 background / 1..C
foreground, and return ``(total, metrics)`` with 0-d tensors.

The number of positives that normalises both is the global batch's, as in
the reference's one program over the global batch: under a process group
(``group``) it is summed over the ranks, so each rank's loss is its share
of the global loss and the ranks' gradients sum to the global gradient.
Hard-negative mining counts per image, so it stays local.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from shape_based_object_detection_torch.config import LossConfig
from shape_based_object_detection_torch.ops.matching import MatchResult
from shape_based_object_detection_torch.parallel.mesh import count_bytes

Metrics = Dict[str, torch.Tensor]


def global_count(count: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``count`` (a float 0-d tensor) summed over ``group``'s ranks (as it
    is when there is no group). While tracing, its bytes add to the
    counter ``comm.all_reduce_bytes``, as ``parallel.mesh.all_reduce_``'s."""
    if group is None:
        return count
    count = count.clone()
    count_bytes(count)
    dist.all_reduce(count, group=group)
    return count


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber/SmoothL1 with its transition at ``beta``;
    ``beta <= 0`` is pure L1 (the quadratic branch would divide by 0).
    |x| is written as a select so that its gradient at 0 is +1, as JAX's
    (``torch.abs`` gives 0 there)."""
    ax = torch.where(x >= 0, x, -x)
    if beta <= 0:
        return ax
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def multibox_loss(
    cls_logits: torch.Tensor,  # (B, A, C+1), class 0 = background
    reg_preds: torch.Tensor,  # (B, A, 4)
    match: MatchResult,
    cfg: LossConfig,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[torch.Tensor, Metrics]:
    cls_t, reg_t, pos = match.cls_targets, match.reg_targets, match.positive
    num_pos = pos.sum(1)  # (B,)
    n_pos_global = global_count(num_pos.sum().float(), group)
    n_pos_total = n_pos_global.clamp(min=1)

    loc = smooth_l1(reg_preds - reg_t, cfg.smooth_l1_beta).sum(-1)  # (B, A)
    loc_loss = torch.where(pos, loc, 0.0).sum() / n_pos_total

    safe_t = cls_t.clamp(min=0).long()  # ignore rows get the bg CE, masked later
    logp = F.log_softmax(cls_logits, dim=-1)
    ce = -logp.gather(-1, safe_t[..., None])[..., 0]  # (B, A)

    neg_mask = cls_t == 0
    neg_ce = torch.where(neg_mask, ce.detach(), -torch.inf)
    # rank[i] = position of anchor i in descending-CE order
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    num_neg = torch.minimum((cfg.neg_pos_ratio * num_pos).to(torch.int32),
                            neg_mask.sum(1).to(torch.int32))
    hard_neg = neg_mask & (rank < num_neg[:, None])

    conf_loss = (torch.where(pos, ce, 0.0).sum()
                 + torch.where(hard_neg, ce, 0.0).sum()) / n_pos_total
    total = conf_loss + cfg.box_loss_weight * loc_loss
    return total, {
        "loss": total,
        "loss_cls": conf_loss,
        "loss_box": loc_loss,
        "num_pos": n_pos_global,
    }


def sigmoid_focal_ce(logits: torch.Tensor, targets: torch.Tensor, alpha: float,
                     gamma: float) -> torch.Tensor:
    """Per-element focal binary cross-entropy in the log-sigmoid form of
    ``optax.sigmoid_binary_cross_entropy``."""
    p = torch.sigmoid(logits)
    ce = -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return alpha_t * torch.pow(1.0 - p_t, gamma) * ce


def focal_loss(
    cls_logits: torch.Tensor,  # (B, A, C), sigmoid per class, no background
    reg_preds: torch.Tensor,  # (B, A, 4)
    match: MatchResult,
    cfg: LossConfig,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[torch.Tensor, Metrics]:
    cls_t, reg_t, pos = match.cls_targets, match.reg_targets, match.positive
    num_classes = cls_logits.shape[-1]
    num_pos = global_count(pos.sum().float(), group).clamp(min=1.0)

    # one-hot of label - 1 for foreground rows; background (0) and ignore
    # (-1) rows never equal a class id, so they are all zeros
    classes = torch.arange(1, num_classes + 1, device=cls_t.device)
    onehot = (cls_t[..., None] == classes).to(cls_logits.dtype)
    fl = sigmoid_focal_ce(cls_logits, onehot, cfg.focal_alpha, cfg.focal_gamma)
    cls_loss = torch.where((cls_t >= 0)[..., None], fl, 0.0).sum() / num_pos

    loc = smooth_l1(reg_preds - reg_t, cfg.smooth_l1_beta).sum(-1)
    loc_loss = torch.where(pos, loc, 0.0).sum() / num_pos

    total = cls_loss + cfg.box_loss_weight * loc_loss
    return total, {
        "loss": total,
        "loss_cls": cls_loss,
        "loss_box": loc_loss,
        "num_pos": num_pos,
    }


def detection_loss(cls_logits: torch.Tensor, reg_preds: torch.Tensor,
                   match: MatchResult, cfg: LossConfig,
                   group: Optional[dist.ProcessGroup] = None) -> Tuple[torch.Tensor, Metrics]:
    """Dispatch on ``cfg.kind``: "multibox" (SSD) or "focal" (RetinaNet)."""
    if cfg.kind == "multibox":
        return multibox_loss(cls_logits, reg_preds, match, cfg, group)
    if cfg.kind == "focal":
        return focal_loss(cls_logits, reg_preds, match, cfg, group)
    raise ValueError(f"unknown loss kind {cfg.kind!r}")
