"""Box geometry on tensors (port of the JAX package's ``ops/boxes.py``).

``xyxy`` is (x_min, y_min, x_max, y_max), ``cxcywh`` is (cx, cy, w, h), in
[0, 1] image fractions. Every function works over leading batch dims and
keeps the reference's operation order, so float results agree to the last
bits where the elementwise functions themselves agree.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-size -> corner form."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner -> center-size form."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / 2.0, (y0 + y1) / 2.0, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...,) area, clamped at 0 for degenerate boxes."""
    w = (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]).clamp(min=0.0)
    h = (boxes_xyxy[..., 3] - boxes_xyxy[..., 1]).clamp(min=0.0)
    return w * h


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded as a true division. PyTorch's CUDA kernels
    turn a division by a Python number into a product with its reciprocal,
    which can differ in the last bit; a 0-d tensor on ``x``'s device keeps
    the division, so the card and the CPU round alike (``torch.full`` makes
    it on the device: no copy from the host, no synchronisation)."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def pairwise_intersection(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """Intersection areas of every pair: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a_xyxy[..., :, None, :2], b_xyxy[..., None, :, :2])
    rb = torch.minimum(a_xyxy[..., :, None, 2:], b_xyxy[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def iou_matrix(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """Jaccard overlap of every pair: (..., N, 4) x (..., M, 4) -> (..., N, M),
    as ``inter / max(area_a + area_b - inter, 1e-8)``."""
    inter = pairwise_intersection(a_xyxy, b_xyxy)
    area_a = box_area(a_xyxy)[..., :, None]
    area_b = box_area(b_xyxy)[..., None, :]
    union = area_a + area_b - inter
    return inter / union.clamp(min=_EPS)


def encode_boxes(gt_cxcywh: torch.Tensor, anchors_cxcywh: torch.Tensor,
                 variances=(0.1, 0.2)) -> torch.Tensor:
    """GT boxes -> regression offsets against the anchors, (..., 4):
    ``(g - a) / (max(a_wh, eps) * vc)`` and ``log(max(g_wh, eps) /
    max(a_wh, eps)) / vs``."""
    vc, vs = variances
    g_cxcy, g_wh = gt_cxcywh[..., :2], gt_cxcywh[..., 2:]
    a_cxcy, a_wh = anchors_cxcywh[..., :2], anchors_cxcywh[..., 2:]
    a_wh = a_wh.clamp(min=_EPS)
    t_cxcy = (g_cxcy - a_cxcy) / (a_wh * vc)
    t_wh = true_div(torch.log(g_wh.clamp(min=_EPS) / a_wh), vs)
    return torch.cat([t_cxcy, t_wh], dim=-1)


def shape_similarity(a_cxcywh: torch.Tensor, b_cxcywh: torch.Tensor,
                     tau: float = 1.0) -> torch.Tensor:
    """Pairwise shape similarity in (0, 1]: (..., N, 4) x (..., M, 4) ->
    (..., N, M), ``exp(-(|log(w_a/w_b)| + |log(h_a/h_b)|) / tau)`` with the
    logs taken of each box's own extents."""
    log_wh_a = torch.log(a_cxcywh[..., 2:].clamp(min=_EPS))
    log_wh_b = torch.log(b_cxcywh[..., 2:].clamp(min=_EPS))
    diff = (log_wh_a[..., :, None, :] - log_wh_b[..., None, :, :]).abs()
    d = diff[..., 0] + diff[..., 1]
    return torch.exp(true_div(-d, tau))


def decode_boxes(offsets: torch.Tensor, anchors_cxcywh: torch.Tensor,
                 variances=(0.1, 0.2)) -> torch.Tensor:
    """Regression offsets -> boxes in cxcywh, as ``a + (o*vc)*a_wh`` and
    ``a_wh*exp(o*vs)``."""
    vc, vs = variances
    a_cxcy, a_wh = anchors_cxcywh[..., :2], anchors_cxcywh[..., 2:]
    g_cxcy = a_cxcy + offsets[..., :2] * vc * a_wh
    g_wh = a_wh * torch.exp(offsets[..., 2:] * vs)
    return torch.cat([g_cxcy, g_wh], dim=-1)


def clip_boxes(boxes_xyxy: torch.Tensor, lo: float = 0.0,
               hi: float = 1.0) -> torch.Tensor:
    """Clamp corner-form boxes into [lo, hi]."""
    return boxes_xyxy.clamp(lo, hi)


def boxes_to_original(boxes_xyxy_norm: torch.Tensor, orig_h, orig_w,
                      letterboxed: bool = False) -> torch.Tensor:
    """Normalized boxes on the network input -> pixel xyxy in the original
    image, each coordinate clipped to the image. Plain-resize mode scales by
    (W, H); letterbox mode (content in the top-left of the canvas) by
    max(H, W). ``orig_h`` and ``orig_w`` may be numbers or tensors that
    broadcast against the boxes' leading dims."""
    like = dict(dtype=torch.float32, device=boxes_xyxy_norm.device)
    w = torch.as_tensor(orig_w, **like)
    h = torch.as_tensor(orig_h, **like)
    if letterboxed:
        boxes = boxes_xyxy_norm * torch.maximum(h, w)[..., None]
    else:
        boxes = boxes_xyxy_norm * torch.stack([w, h, w, h], dim=-1)
    zero = torch.zeros((), **like)
    return torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), w),
        torch.minimum(torch.maximum(boxes[..., 1], zero), h),
        torch.minimum(torch.maximum(boxes[..., 2], zero), w),
        torch.minimum(torch.maximum(boxes[..., 3], zero), h),
    ], dim=-1)
