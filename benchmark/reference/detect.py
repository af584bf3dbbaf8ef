"""The reference's detection: normalise, forward, the top (anchor, class)
candidates of each image with their decoded boxes, and (for a control
standing in the program's place) greedy class-aware NMS over them."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from benchmark.reference import models, ops
from benchmark.reference.precision import setting


def normalize(images_u8: torch.Tensor, data: dict) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32, ImageNet mean and std."""
    mean = torch.tensor(data["mean"], device=images_u8.device)
    std = torch.tensor(data["std"], device=images_u8.device)
    return ((images_u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


@torch.no_grad()
def candidate_pools(params, images_u8: np.ndarray, sizes, cfg: dict, pool: int,
                    precision: str, device, block: int = 8) -> List[Tuple]:
    """Per image: (boxes in original pixels, logits, classes) of its top
    ``pool`` pairs, sorted by logit. Runs in blocks of ``block`` images."""
    m = cfg["model"]
    anc = ops.anchors(m).to(device)
    out = []
    for start in range(0, len(images_u8), block):
        x = normalize(torch.from_numpy(np.ascontiguousarray(images_u8[start:start + block]))
                      .to(device), cfg["data"])
        ctx, quant = setting(precision, device)
        with ctx:
            cls, box = models.forward(params, x, cfg, quant)
        cls, box = cls.float(), box.float()
        for i in range(cls.shape[0]):
            h, w = sizes[start + i]
            boxes, logits, _, classes = ops.candidates(cls[i], box[i], anc, m, pool)
            out.append((ops.to_pixels(boxes, h, w).cpu(), logits.cpu(), classes.cpu()))
    return out


def nms_detections(pool_entry, cfg: dict):
    """The control's served detections of one image: greedy class-aware NMS
    over its top ``pre_nms_top_k`` candidates, in pick order, as (boxes,
    scores, labels)."""
    det = cfg["model"]["detect"]
    boxes, logits, classes = pool_entry
    k = det["pre_nms_top_k"]
    boxes, logits, classes = boxes[:k], logits[:k], classes[:k]
    picks = ops.greedy_nms(boxes.double(), logits.double(), classes,
                           det["nms_iou_threshold"], det["max_detections"])
    return boxes[picks], torch.sigmoid(logits[picks].double()), classes[picks]
