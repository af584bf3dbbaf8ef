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
