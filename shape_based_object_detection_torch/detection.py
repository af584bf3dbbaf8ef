"""End-to-end inference (port of the JAX package's ``detection.py``).

normalize -> backbone/FPN/heads -> exact two-stage top-k candidate selection
-> decode of only the K winners -> class-aware NMS -> fixed-size
``Detections`` with a valid mask. Every step runs on the module's device
and nothing synchronises with the host until the caller reads the result.
On the card the NMS is the CUDA kernel (``ops/nms_cuda.py``); on the CPU it
is the plain version (``ops/nms.py``).
"""

from __future__ import annotations

import torch

from shape_based_object_detection_torch.config import DataConfig, ModelConfig
from shape_based_object_detection_torch.ops import boxes as box_ops
from shape_based_object_detection_torch.ops import nms as nms_lib
from shape_based_object_detection_torch.utils import image as image_lib
from shape_based_object_detection_torch.utils.device import resolve_device

# DetectConfig.nms_backend values -> the port's two NMS routes. "pallas" and
# "scan" are the reference's names, so its configs load unchanged.
_NMS_BACKENDS = {"cuda": "cuda", "pallas": "cuda", "plain": "plain",
                 "scan": "plain"}


def select_candidates(
    cls_logits: torch.Tensor,  # (B, A, K)
    box_offsets: torch.Tensor,  # (B, A, 4)
    anchors_cxcywh: torch.Tensor,  # (A, 4)
    cfg: ModelConfig,
):
    """Exact two-stage top-k candidate selection and deferred decode.
    Returns ``(boxes_xyxy, scores, classes, valid)``, each
    ``(B, pre_nms_top_k, ...)``, with boxes clipped to [0, 1]."""
    det = cfg.detect
    if det.use_sigmoid:
        # sigmoid is monotonic: select on raw logits, activate the K winners
        sel_scores, activation = cls_logits, torch.sigmoid
    else:
        # softmax couples the classes of an anchor: activate before selection
        sel_scores, activation = torch.softmax(cls_logits, dim=-1)[..., 1:], None
    batch = cls_logits.shape[0]
    pairs = box_offsets.shape[1] * sel_scores.shape[-1]
    anchor_idx, cand_scores, cand_classes, cand_valid = (
        nms_lib.select_top_candidate_pairs(
            sel_scores, det.score_threshold, det.pre_nms_top_k,
            activation=activation,
            # the reference's batch-aware choice of strategy
            two_stage=(pairs >= 2_000_000 or batch >= 4)))

    # Decode is row-wise, so decoding the K winners equals decoding all A
    # anchors and gathering, without the (B, A, 4) pass.
    cand_offsets = box_offsets.gather(
        1, anchor_idx[..., None].expand(*anchor_idx.shape, 4))
    cand_anchors = anchors_cxcywh[anchor_idx]
    decoded = box_ops.decode_boxes(cand_offsets, cand_anchors,
                                   cfg.anchors.variances)
    cand_boxes = box_ops.clip_boxes(box_ops.cxcywh_to_xyxy(decoded))
    return cand_boxes, cand_scores, cand_classes, cand_valid


def run_nms(
    cand_boxes: torch.Tensor,  # (B, N, 4) xyxy in [0, 1]
    cand_scores: torch.Tensor,  # (B, N)
    cand_classes: torch.Tensor,  # (B, N) int32
    cand_valid: torch.Tensor,  # (B, N) bool
    cfg: ModelConfig,
    backend: str | None = None,
) -> nms_lib.Detections:
    """Class-aware NMS over a candidate set. ``backend`` (default
    ``cfg.detect.nms_backend``): "auto" runs the CUDA kernel for CUDA
    tensors and the plain version for CPU tensors; "cuda" (or the
    reference's "pallas") always the kernel, which raises on CPU tensors;
    "plain" (or "scan") always the plain version."""
    det = cfg.detect
    if det.soft_nms_sigma > 0:
        raise NotImplementedError(
            "soft-NMS is not ported yet (ROADMAP.md, modules still to port, "
            "item 6)")
    backend = backend or det.nms_backend
    if backend == "auto":
        backend = "cuda" if cand_boxes.is_cuda else "plain"
    if backend == "matrix":
        raise NotImplementedError(
            "the matrix NMS backend is not ported yet (ROADMAP.md, modules "
            "still to port, item 6)")
    if backend not in _NMS_BACKENDS:
        raise ValueError(f"unknown nms_backend {backend!r}")
    args = (cand_boxes, cand_scores, cand_classes, cand_valid,
            det.nms_iou_threshold, det.max_detections)
    if _NMS_BACKENDS[backend] == "cuda":
        from shape_based_object_detection_torch.ops.nms_cuda import (
            batched_class_aware_nms_cuda,
        )

        return batched_class_aware_nms_cuda(*args)
    return nms_lib.batched_class_aware_nms(*args)


def postprocess(cls_logits, box_offsets, anchors_cxcywh,
                cfg: ModelConfig) -> nms_lib.Detections:
    """Decode + score + class-aware NMS. Labels are 0-based foreground ids."""
    cands = select_candidates(cls_logits, box_offsets, anchors_cxcywh, cfg)
    return run_nms(*cands, cfg)


def make_detect_fn(module, anchors_cxcywh: torch.Tensor, cfg: ModelConfig,
                   data_cfg: DataConfig | None = None, device=None):
    """Returns ``detect(images) -> Detections``.

    ``images``: (B, H, W, 3) uint8 (numpy or tensor) with H = W =
    ``cfg.image_size``; normalization runs on the device. ``module`` and
    ``anchors_cxcywh`` come from ``build_model`` on the same ``device``
    (default: the card).
    """
    if cfg.detect.tta_hflip:
        raise NotImplementedError(
            "hflip test-time augmentation is not ported yet (ROADMAP.md, "
            "modules still to port, item 6)")
    dev = resolve_device(device)
    param = next(module.parameters())
    if param.device != dev or anchors_cxcywh.device != dev:
        raise ValueError(
            f"detect on {dev} needs the module and anchors there; they are on "
            f"{param.device} and {anchors_cxcywh.device}")
    mean = data_cfg.mean if data_cfg else image_lib.IMAGENET_MEAN
    std = data_cfg.std if data_cfg else image_lib.IMAGENET_STD

    @torch.inference_mode()
    def detect(images) -> nms_lib.Detections:
        x = torch.as_tensor(images).to(dev, non_blocking=True)
        x = image_lib.normalize_images(x, mean, std).permute(0, 3, 1, 2)
        cls_logits, box_offsets = module(x)
        return postprocess(cls_logits, box_offsets, anchors_cxcywh, cfg)

    return detect
