"""Plain PyTorch detection arithmetic for the reference: anchors, box
coding, anchor matching (with the shape term of the configuration), the
focal and multibox losses, candidate selection, greedy class-aware NMS and
the SGD update. Written from the papers and the configuration's fields,
independent of the program under test."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Anchors (normalized cx, cy, w, h)
# ---------------------------------------------------------------------------


def retinanet_anchors(m: dict) -> torch.Tensor:
    a, size = m["anchors"], m["image_size"]
    out = []
    for lvl, (stride, base) in enumerate(zip(a["strides"], a["sizes"])):
        n = math.ceil(size / stride)
        whs = [(base * o * math.sqrt(r) / size, base * o / math.sqrt(r) / size)
               for o in a["octave_scales"] for r in a["aspect_ratios"][lvl]]
        for i in range(n):
            for j in range(n):
                cx, cy = (j + 0.5) * stride / size, (i + 0.5) * stride / size
                out.extend((cx, cy, w, h) for w, h in whs)
    return torch.tensor(out, dtype=torch.float32)


def ssd_anchors(m: dict) -> torch.Tensor:
    a = m["anchors"]
    fmaps = (64, 32, 16, 8, 4, 2, 1) if m["image_size"] == 512 else None
    if fmaps is None:
        raise ValueError("the reference knows SSD-512's feature maps only")
    out = []
    for k, f in enumerate(fmaps):
        s, s1 = a["scales"][k], a["scales"][k + 1]
        whs = [(s * math.sqrt(r), s / math.sqrt(r)) for r in a["aspect_ratios"][k]]
        whs.append((math.sqrt(s * s1), math.sqrt(s * s1)))
        for i in range(f):
            for j in range(f):
                out.extend(((j + 0.5) / f, (i + 0.5) / f, min(w, 1.0), min(h, 1.0))
                           for w, h in whs)
    return torch.tensor(out, dtype=torch.float32)


def anchors(m: dict) -> torch.Tensor:
    return retinanet_anchors(m) if m["family"] == "retinanet" else ssd_anchors(m)


# ---------------------------------------------------------------------------
# Boxes
# ---------------------------------------------------------------------------


def to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) xyxy -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda t: (t[..., 2] - t[..., 0]).clamp(min=0) * (t[..., 3] - t[..., 1]).clamp(min=0)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-8)


def encode(g: torch.Tensor, a: torch.Tensor, var) -> torch.Tensor:
    a_wh = a[..., 2:].clamp(min=1e-8)
    return torch.cat([(g[..., :2] - a[..., :2]) / (a_wh * var[0]),
                      torch.log(g[..., 2:].clamp(min=1e-8) / a_wh) / var[1]], -1)


def decode(o: torch.Tensor, a: torch.Tensor, var) -> torch.Tensor:
    return torch.cat([a[..., :2] + o[..., :2] * var[0] * a[..., 2:],
                      a[..., 2:] * torch.exp(o[..., 2:] * var[1])], -1)


# ---------------------------------------------------------------------------
# Matching: quality = (1 - w) IoU + w exp(-(|log wa/wg| + |log ha/hg|) / tau)
# ---------------------------------------------------------------------------


def match_image(anc: torch.Tensor, gt: torch.Tensor, labels: torch.Tensor,
                mc: dict, var) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image's valid GTs (G, 4) xyxy and labels (G,) -> class targets
    (A,) in {-1 ignore, 0 background, 1..C} and box targets (A, 4). Each
    anchor takes its best GT (lowest index on ties); each GT claims its
    best anchor (lowest index on ties), a later GT winning a shared one."""
    a_n = anc.shape[0]
    if gt.shape[0] == 0:
        return torch.zeros(a_n, dtype=torch.long, device=anc.device), torch.zeros_like(anc)
    q = iou(to_xyxy(anc), gt)
    w = mc["shape_weight"]
    if w > 0:
        la = torch.log(anc[:, 2:].clamp(min=1e-8))
        lg = torch.log(to_cxcywh(gt)[:, 2:].clamp(min=1e-8))
        d = (la[:, None, :] - lg[None, :, :]).abs().sum(-1)
        q = (1 - w) * q + w * torch.exp(-d / mc["shape_tau"])
    best_q, best_g = q.max(1)
    if mc["force_match_for_each_gt"] or mc["allow_low_quality"]:
        claims = q.argmax(0)  # first maximum over the anchors
        for g in range(gt.shape[0]):
            best_g[claims[g]] = g
            best_q[claims[g]] = 2.0
    cls = labels[best_g].long()
    pos = best_q >= mc["pos_threshold"]
    cls = torch.where(pos, cls, torch.zeros_like(cls))
    cls = torch.where((best_q >= mc["neg_threshold"]) & ~pos, torch.full_like(cls, -1), cls)
    reg = encode(to_cxcywh(gt)[best_g], anc, var)
    return cls, torch.where(pos[:, None], reg, torch.zeros_like(reg))


# ---------------------------------------------------------------------------
# Losses (both normalised by the batch's positives)
# ---------------------------------------------------------------------------


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def focal_loss(cls_logits, box, cls_t, reg_t, lc: dict) -> torch.Tensor:
    pos = cls_t > 0
    n_pos = pos.sum().clamp(min=1).float()
    k = cls_logits.shape[-1]
    onehot = F.one_hot((cls_t - 1).clamp(min=0), k).float() * pos[..., None]
    p = torch.sigmoid(cls_logits)
    ce = F.binary_cross_entropy_with_logits(cls_logits, onehot, reduction="none")
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = lc["focal_alpha"] * onehot + (1 - lc["focal_alpha"]) * (1 - onehot)
    fl = (a_t * (1 - p_t) ** lc["focal_gamma"] * ce).sum(-1)
    cls_loss = fl[cls_t >= 0].sum() / n_pos
    loc = smooth_l1(box - reg_t, lc["smooth_l1_beta"]).sum(-1)[pos].sum() / n_pos
    return cls_loss + lc["box_loss_weight"] * loc


def multibox_loss(cls_logits, box, cls_t, reg_t, lc: dict) -> torch.Tensor:
    pos = cls_t > 0
    n_pos = pos.sum().clamp(min=1).float()
    ce = -F.log_softmax(cls_logits, -1).gather(-1, cls_t.clamp(min=0)[..., None])[..., 0]
    conf = ce[pos].sum()
    for b in range(cls_logits.shape[0]):
        neg = cls_t[b] == 0
        n = int(min(lc["neg_pos_ratio"] * int(pos[b].sum()), int(neg.sum())))
        if n > 0:
            conf = conf + ce[b][neg].topk(n).values.sum()
    loc = smooth_l1(box - reg_t, lc["smooth_l1_beta"]).sum(-1)[pos].sum() / n_pos
    return conf / n_pos + lc["box_loss_weight"] * loc


LOSSES = {"focal": focal_loss, "multibox": multibox_loss}


# ---------------------------------------------------------------------------
# Detection: top-k (anchor, class) candidates, greedy class-aware NMS
# ---------------------------------------------------------------------------


def candidates(cls_logits: torch.Tensor, box: torch.Tensor, anc: torch.Tensor,
               m: dict, k: int):
    """One image's top-``k`` (anchor, class) pairs by selection score:
    (boxes xyxy clipped to [0, 1], logits, scores, classes 0-based)."""
    det = m["detect"]
    if det["use_sigmoid"]:
        sel = cls_logits
    else:
        sel = torch.softmax(cls_logits, -1)[:, 1:]
    c = sel.shape[-1]
    top, idx = sel.flatten().topk(k)
    a_idx, cls = idx // c, idx % c
    boxes = to_xyxy(decode(box[a_idx], anc[a_idx], m["anchors"]["variances"])).clamp(0, 1)
    if det["use_sigmoid"]:
        return boxes, top, torch.sigmoid(top), cls
    return boxes, torch.logit(top.clamp(1e-7, 1 - 1e-7)), top, cls


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, cls: torch.Tensor,
               thr: float, max_det: int) -> torch.Tensor:
    """Indices of the picks of class-aware greedy NMS, in pick order."""
    live = scores.clone()
    ov = iou(boxes, boxes) >= thr
    ov &= cls[:, None] == cls[None, :]
    picks = []
    for _ in range(max_det):
        best = int(live.argmax())
        if live[best] == -math.inf:
            break
        picks.append(best)
        live[ov[best]] = -math.inf
        live[best] = -math.inf
    return torch.tensor(picks, dtype=torch.long)


def to_pixels(boxes: torch.Tensor, h: float, w: float) -> torch.Tensor:
    scale = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(boxes * scale, scale)


# ---------------------------------------------------------------------------
# Optimizer: global-norm clip -> weight decay on conv kernels -> SGD momentum
# under a linear warmup and step decay
# ---------------------------------------------------------------------------


def learning_rate(tc: dict, count: int) -> float:
    lr = tc["base_lr"]
    if tc["warmup_steps"] > 0 and count < tc["warmup_steps"]:
        return lr * count / tc["warmup_steps"]
    for boundary in tc["lr_decay_steps"]:
        if count >= boundary:
            lr *= tc["lr_decay_factor"]
    return lr


def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             trace: Dict[str, torch.Tensor], tc: dict, count: int) -> Dict[str, torch.Tensor]:
    """One update in place; returns the updates as the optimizer applies
    them before the learning rate (the momentum trace)."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    clip = min(1.0, tc["grad_clip_norm"] / float(norm)) if float(norm) > 0 else 1.0
    lr = learning_rate(tc, count)
    for name, g in grads.items():
        g = g * clip
        if params[name].dim() == 4:  # conv kernels decay, biases and norms not
            g = g + tc["weight_decay"] * params[name]
        trace[name] = tc["momentum"] * trace[name] + g
        params[name] -= lr * trace[name]
    return trace


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The loader's shuffle of an epoch: numpy's default_rng(seed + epoch)."""
    idx = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(idx)
    return idx
