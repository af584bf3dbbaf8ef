"""IoU-only against shape-aware anchor matching: the assignment statistics
(port of the JAX package's ``tools/matching_analysis.py``).

For a sweep of ``shape_weight`` values, on synthetic ground truth with a
heavy tail of extreme aspect ratios: positives per GT, the share of GTs
with at least one threshold-positive anchor, and the same share among the
extreme-aspect GTs. These are the statistics behind the mAP delta that
``ablate_matching`` measures. The matching runs through ``match_batch`` on
one image, so on the card it is the matching kernel
(``csrc/match_anchors.cu``):

    python -m shape_based_object_detection_torch.tools.matching_analysis --model ssd300
"""

from __future__ import annotations

import argparse
import json

import numpy as np

SHAPE_WEIGHTS = (0.0, 0.1, 0.2, 0.3, 0.5)


def synthetic_gt(num_gt: int, seed: int):
    """``num_gt`` normalized xyxy boxes from ``default_rng(seed)`` with
    log-aspect N(0, 1.2), and which of them are extreme (|log aspect| >
    1.5)."""
    rng = np.random.default_rng(seed)
    cxcy = rng.uniform(0.25, 0.75, (num_gt, 2))
    area = rng.uniform(0.004, 0.04, (num_gt,))
    log_ar = rng.normal(0.0, 1.2, (num_gt,))  # aspect w/h = e^log_ar
    w = np.sqrt(area * np.exp(log_ar))
    h = np.sqrt(area / np.exp(log_ar))
    gt = np.stack([cxcy[:, 0] - w / 2, cxcy[:, 1] - h / 2,
                   cxcy[:, 0] + w / 2, cxcy[:, 1] + h / 2], 1).astype(np.float32)
    return np.clip(gt, 0, 1), np.abs(log_ar) > 1.5


def match_config(shape_weight: float, backend: str = "auto"):
    from shape_based_object_detection_torch.config import MatchConfig

    return MatchConfig(pos_threshold=0.5, neg_threshold=0.4, shape_weight=shape_weight,
                       shape_tau=1.0, force_match_for_each_gt=False, backend=backend)


def match_one(anchors, gt, shape_weight: float, variances, backend: str = "auto"):
    """The MatchResult of one image (batch of one) with every GT valid and
    labelled 1; the tensors where ``anchors`` are."""
    import torch

    from shape_based_object_detection_torch.ops.matching import match_batch

    dev = anchors.device
    boxes = torch.from_numpy(gt)[None].to(dev)
    labels = torch.ones((1, len(gt)), dtype=torch.int32, device=dev)
    valid = torch.ones((1, len(gt)), dtype=torch.bool, device=dev)
    return match_batch(anchors, boxes, labels, valid, match_config(shape_weight, backend),
                       variances)


def analysis_rows(model: str = "retinanet_r50_fpn", num_gt: int = 200, seed: int = 0,
                  device=None):
    """The table as numbers: ``(num_anchors, num_extreme, rows)``, a row per
    shape weight of ``SHAPE_WEIGHTS``: ``(shape_weight, positives per GT,
    percent of GTs with a positive, percent of extreme GTs with one)``."""
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.ops import anchors as anchor_lib
    from shape_based_object_detection_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = config_lib.get_config(model)
    anchors = anchor_lib.anchors_for_model(cfg.model).to(dev)
    gt, extreme = synthetic_gt(num_gt, seed)
    rows = []
    for shape_w in SHAPE_WEIGHTS:
        res = match_one(anchors, gt, shape_w, cfg.model.anchors.variances)
        pos = res.positive[0].cpu().numpy()
        matched = res.matched_gt_idx[0].cpu().numpy()
        counts = np.bincount(matched[pos], minlength=num_gt)
        rows.append((shape_w, float(counts.mean()), float((counts > 0).mean() * 100),
                     float((counts[extreme] > 0).mean() * 100)))
    return anchors.shape[0], int(extreme.sum()), rows


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="retinanet_r50_fpn")
    p.add_argument("--num-gt", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    return p


def main(argv=None):
    from shape_based_object_detection_torch.tools._ablation import device_field

    args = _parser().parse_args(argv)
    num_anchors, num_extreme, rows = analysis_rows(args.model, args.num_gt, args.seed,
                                                   args.device)
    print(f"{args.num_gt} synthetic GT on {num_anchors} {args.model} anchors"
          f" ({num_extreme} with extreme aspect)")
    print(f"{'shape_w':>8} {'pos/gt':>8} {'gt w/ pos':>10} {'extreme w/ pos':>15}")
    for shape_w, per_gt, covered, extreme_covered in rows:
        print(f"{shape_w:>8.1f} {per_gt:>8.2f} {covered:>9.1f}% {extreme_covered:>14.1f}%")
    print(json.dumps({"device": device_field(args.device)}))
    return rows


if __name__ == "__main__":
    main()
