"""The numbers that decide ``correct``.

Detection (served boxes, scores and labels against the float32 reference
on the same images) follows the served picks as teacher forcing does a
served model's tokens. For each image the reference's candidates are its
top (anchor, class) pairs by logit; each served detection, in pick order,
is matched to the reference candidate of its class that it is (within the
box tolerance, the one with the nearest logit; else the nearest box), and:

- ``logit_gap``: the widest gap by which a pick's reference logit lies
  below the best reference candidate still alive (not yet suppressed by the
  earlier picks, with the reference's boxes); a pick that overlaps an
  earlier one of its class beyond the threshold, or a pick missing where
  the reference still had candidates, reads ``MISSING``;
- ``box_gap``: the widest distance between a served box and the nearest
  reference box of its class, any coordinate, as a share of the image's
  longer side;
- ``score_gap``: the widest gap between a served score's logit and the
  matched reference logit.

A served box may lie as far from the reference's as the cell's box limit
allows, so a suppression that such a move could decide either way is
ambiguous: the candidate counts as suppressed, and a pick counts as
overlapping an earlier one only where no such move separates them.

Training compares, for the first three steps: ``loss_gap``, the widest
relative gap of a step's loss; ``grad_gap``, the worst leaf's gap between
the norms of the first gradient as the optimizer takes it (its momentum
after one step), over the larger of the reference leaf's norm and the
median leaf's, and ``grad_gap_median``, the median leaf's; ``update_gap``, the same of the parameters' change over the
three steps, leaving out the leaves whose reference gradient is under a
thousandth of the median leaf's, taken at the median leaf: the worst
leaf's (reported beside it, not held to a limit) swings from seed to seed
with float32's rounding of the warmup's tiny updates (PERF.md).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

MISSING = 1e9


def _area(t: torch.Tensor) -> torch.Tensor:
    return (t[..., 2] - t[..., 0]).clamp(min=0) * (t[..., 3] - t[..., 1]).clamp(min=0)


def _inter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    return _area(torch.cat([lt, rb], -1))


def _moved(box: torch.Tensor, d: float) -> torch.Tensor:
    """The box grown by ``d`` on every side (shrunk where ``d`` < 0)."""
    return box + torch.tensor([-d, -d, d, d], dtype=box.dtype)


def iou_bounds(a: torch.Tensor, b: torch.Tensor, delta: float):
    """The least and the most IoU of ``a`` (4,) with each of ``b`` (n, 4)
    when every coordinate of each box may move by up to ``delta``."""
    inter_hi = _inter(_moved(a, delta), _moved(b, delta))
    small = _area(_moved(a, -delta)), _area(_moved(b, -delta))
    union_lo = torch.maximum(small[0] + small[1] - inter_hi, torch.maximum(small[0], small[1]))
    hi = (inter_hi / union_lo.clamp(min=1e-8)).clamp(max=1.0)
    inter_lo = _inter(_moved(a, -delta), _moved(b, -delta))
    union_hi = _area(_moved(a, delta)) + _area(_moved(b, delta)) - inter_lo
    return inter_lo / union_hi.clamp(min=1e-8), hi


def detection_gaps(boxes, scores, labels, ref_boxes, ref_logits, ref_cls,
                   alive_count: int, hw, iou_thr: float, max_det: int,
                   box_tol: float) -> Dict[str, float]:
    """One image. ``boxes`` (n, 4) pixels, ``scores`` (n,), ``labels`` (n,)
    served in pick order; ``ref_*`` the reference's candidate pool sorted
    by logit, boxes in pixels; its first ``alive_count`` are the
    reference's candidate set. ``box_tol`` (a share of the longer side)
    is how far a served box may lie from the reference's: a suppression
    that moving the boxes that far could decide either way counts as
    made, and a pick counts as overlapping an earlier one only where no
    such move separates them."""
    h, w = hw
    delta = box_tol * max(h, w)
    boxes = torch.as_tensor(boxes, dtype=torch.float64).reshape(-1, 4)
    scores = torch.as_tensor(scores, dtype=torch.float64).reshape(-1)
    labels = torch.as_tensor(labels, dtype=torch.long).reshape(-1)
    rb, rl, rc = ref_boxes.double().cpu(), ref_logits.double().cpu(), ref_cls.long().cpu()
    alive = torch.zeros(len(rl), dtype=torch.bool)
    alive[:alive_count] = True
    out = {"logit_gap": 0.0, "box_gap": 0.0, "score_gap": 0.0}
    picked: List[int] = []
    for k, (b, s, c) in enumerate(zip(boxes, scores, labels)):
        same = rc == c
        if not bool(same.any()):
            out["box_gap"] = out["logit_gap"] = MISSING
            continue
        # the served picks themselves obey the threshold (JSON rounds to 0.01 px)
        served_same = boxes[:k][labels[:k] == c]
        if len(served_same) and float(iou_bounds(b, served_same, 0.01)[0].max()) >= iou_thr:
            out["logit_gap"] = MISSING
        p = min(max(float(s), 1e-7), 1 - 1e-7)
        logit = math.log(p / (1 - p))
        dist = (rb - b).abs().amax(1)
        dist[~same] = math.inf
        out["box_gap"] = max(out["box_gap"], float(dist.min()) / max(h, w))
        # the candidate the pick is: of those within the box tolerance the
        # one whose logit is nearest (two anchors can decode to one box),
        # else the nearest box
        near = dist <= delta
        if bool(near.any()):
            j = int(torch.where(near, (rl - logit).abs(), math.inf).argmin())
        else:
            j = int(dist.argmin())
        out["score_gap"] = max(out["score_gap"], abs(logit - float(rl[j])))
        earlier = [q for q in picked if int(rc[q]) == int(c)]
        if earlier and float(iou_bounds(rb[j], rb[earlier], delta)[0].max()) >= iou_thr:
            out["logit_gap"] = MISSING  # a pick the reference holds suppressed
        live = rl[alive]
        if live.numel():
            out["logit_gap"] = max(out["logit_gap"], float(live.max() - rl[j]))
        alive &= ~((iou_bounds(rb[j], rb, delta)[1] >= iou_thr) & same)
        alive[j] = False
        picked.append(j)
    if len(boxes) < max_det and bool(alive.any()):
        out["logit_gap"] = MISSING  # the reference still had candidates
    return out


def worst(per_image: Sequence[Dict[str, float]]) -> Dict[str, float]:
    keys = per_image[0].keys()
    return {k: max(d[k] for d in per_image) for k in keys}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> List[tuple]:
    """Per leaf in ``keep`` (all when None), (|‖prog‖ - ‖ref‖| over
    max(‖ref‖, the median leaf's ‖ref‖), name), sorted."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(ref[n].double().norm()) for n in names}
    pn = {n: float(prog[n].double().norm()) for n in names}
    median = sorted(rn.values())[len(rn) // 2]
    return sorted((abs(pn[n] - rn[n]) / max(rn[n], median, 1e-30), n) for n in names)


def moved_leaves(ref_grad: Dict[str, torch.Tensor]) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under the optimizer by round-off alone."""
    norms = {n: float(g.double().norm()) for n, g in ref_grad.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {n for n, v in norms.items() if v >= 1e-3 * median}


def head_gap(prog, ref) -> float:
    """The first step's head outputs: the worse of the class logits' and
    the box offsets' ‖prog − ref‖ / ‖ref‖, element by element over the
    batch; MISSING where the shapes differ."""
    gaps = []
    for p, r in zip(prog, ref):
        if p.shape != r.shape:
            return MISSING
        r = r.double()
        gaps.append(float((p.double() - r).norm() / r.norm().clamp(min=1e-30)))
    return max(gaps)


def training_gaps(prog: dict, ref: dict):
    """``prog`` and ``ref`` each hold ``losses`` (3 floats), ``grad`` (the
    momentum after step 1) and ``delta`` (the parameters' change after
    step 3), both {name: tensor}, and ``heads`` (the first step's head
    outputs). Returns the compared numbers, and notes: the worst leaves
    of each, by name."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    grad = leaf_gaps(prog["grad"], ref["grad"])
    update = leaf_gaps(prog["delta"], ref["delta"], moved_leaves(ref["grad"]))
    numbers = {"loss_gap": loss_gap, "grad_gap": grad[-1][0],
               "grad_gap_median": grad[len(grad) // 2][0],
               "update_gap": update[len(update) // 2][0],
               "head_gap": head_gap(prog["heads"], ref["heads"])}
    notes = {"grad_worst": grad[-3:], "update_worst": update[-3:]}
    return numbers, notes
