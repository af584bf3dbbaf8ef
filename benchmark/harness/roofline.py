"""Peaks of one NVIDIA H100 SXM and the least time the card could take for
the two hand-written kernels' work, frozen here so that later changes to
the program cannot move the yardstick.

Peaks: NVIDIA's data sheet, dense rates without sparsity, at the full
700 W power limit. The kernel bounds count the work the data needs, whatever
kernel does it: each input byte read once and each output byte written
once, and the float operations of the steps the data needs, against HBM
bandwidth and the non-tensor float32 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}

# float ops per candidate per NMS step: 4 min/max, 2 sub, 2 clamp, 1 mul,
# 2 add/sub, 1 clamp, 1 div, 1 compare (IoU and suppress), 1 argmax compare
NMS_OPS_PER_ELEMENT = 15
# float ops per (image, anchor, valid GT) of the matcher at shape_weight 0:
# 4 min/max, 2 sub, 2 clamp, 1 mul (intersection), 1 add, 1 sub, 1 max,
# 1 div (IoU), 1 compare (argmax over G), 1 compare (argmax over A), 1 select
MATCH_OPS_PER_PAIR = 16
# more per pair at shape_weight > 0: 2 sub (log ratios), 2 abs, 1 add,
# 1 negate, 1 div by tau, 1 exp, 2 mul, 1 add (blend)
MATCH_SHAPE_OPS_PER_PAIR = 11
MATCH_SHAPE_OPS_PER_BOX = 2  # log w, log h of each anchor and valid GT


def peak_flops(model: dict) -> float:
    """The dense tensor-core peak of the precision a model configuration
    states: bf16 for a bfloat16 model, TF32 for a float32 one whose
    convolutions may use it ("default"), else float32."""
    if model["dtype"] == "bfloat16":
        return PEAK_FLOPS["bfloat16"]
    return PEAK_FLOPS["tf32" if model["precision"] == "default" else "float32"]


def nms_bound_s(batch: int, candidates: int, max_det: int, kept) -> float:
    """Greedy NMS over (batch, candidates): one step per kept box, plus the
    step that finds none where fewer than ``max_det`` were kept; reads the
    boxes, scores and valid flags, writes the picks."""
    steps = sum(k + (k < max_det) for k in kept)
    ops = steps * candidates * NMS_OPS_PER_ELEMENT
    nbytes = batch * candidates * (16 + 4 + 1) + batch * max_det * (4 + 4 + 1)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def match_bound_s(batch: int, anchors: int, gt_rows: int, n_valid: int,
                  shape_weight: float) -> float:
    """The anchor matcher over (batch, anchors, gt_rows) with ``n_valid``
    valid GTs in all: every anchor's IoU (and shape term) with every valid
    GT; reads anchors and GTs, writes per-anchor best quality, index,
    label and offsets and per-GT best anchor."""
    ops = anchors * n_valid * MATCH_OPS_PER_PAIR
    if shape_weight > 0:
        ops += (anchors * n_valid * MATCH_SHAPE_OPS_PER_PAIR
                + (anchors + n_valid) * MATCH_SHAPE_OPS_PER_BOX)
    nbytes = (anchors * 16 + batch * gt_rows * (16 + 4 + 1)
              + batch * anchors * (4 + 4 + 4 + 16) + batch * gt_rows * 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)
