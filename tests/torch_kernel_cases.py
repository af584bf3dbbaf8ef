"""Inputs and checks for the port's CUDA kernels, shared by the card tests
(``tests/test_torch_cuda.py``), the CPU tests of the kernels' formulations
(``tests/test_torch_nms.py``) and ``chip_smoke.py``; and the synthetic
torchvision VGG-16 checkpoint that the checks of ``tools/convert_checkpoint``
convert.

The inputs are numpy arrays made from a seed; the checks hold one kernel
launch against its plain PyTorch version on the same card tensors. Nothing
here imports JAX: ``chip_smoke.py`` imports this module on the card."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shape_based_object_detection_torch import config
from shape_based_object_detection_torch.ops import matching, matching_cuda, nms, nms_cuda


def nms_inputs(rng, b, n, classes=80):
    """Candidates as the detect path gives them: clipped xyxy boxes, some
    clipped to zero width, sigmoid-range scores with forced ties, classes,
    and padding rows at the end."""
    cxcy = rng.uniform(0.0, 1.0, (b, n, 2))
    wh = rng.uniform(0.02, 0.4, (b, n, 2))
    boxes = np.clip(np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1), 0, 1)
    boxes = boxes.astype(np.float32)
    boxes[:, ::41, 2] = boxes[:, ::41, 0]
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    scores[:, 20:60] = scores[:, 5:6]
    cls = rng.integers(0, classes, (b, n)).astype(np.int32)
    valid = np.ones((b, n), bool)
    valid[:, -n // 10:] = False
    return boxes, scores, cls, valid


def match_inputs(rng, b, g, kind):
    """GT batches for the matcher: "ties" is bench_train.py's batch (every
    GT the box [0.2, 0.2, 0.7, 0.7], 8 of G valid); "random" has boxes of
    mixed sizes, invalid rows, image 1 with no valid GT and GT 1 a copy of
    GT 0."""
    if kind == "ties":
        gt = np.tile(np.asarray([0.2, 0.2, 0.7, 0.7], np.float32), (b, g, 1))
        valid = np.zeros((b, g), bool)
        valid[:, :8] = True
    else:
        xy = rng.uniform(0.0, 0.9, (b, g, 2))
        wh = np.exp(rng.uniform(np.log(0.01), np.log(0.8), (b, g, 2)))
        gt = np.clip(np.concatenate([xy, xy + wh], -1), 0, 1).astype(np.float32)
        if g > 1:
            gt[:, 1] = gt[:, 0]
        valid = rng.uniform(size=(b, g)) < 0.7
        valid[1] = False
    labels = rng.integers(1, 81, (b, g)).astype(np.int32)
    return gt, labels, valid


def nms_edge_cases():
    """name -> (boxes, scores, valid, iou_threshold, max_detections), numpy:
    the cases where the kernel's sort -> bitmask -> sweep must still give the
    reference's steps. A pick with IoU(p, p) < t (area below ~t * 1e-8, or
    t > 1) never leaves the live set and fills every remaining slot."""
    rng = np.random.default_rng(11)
    four = (np.array([[[0.1, 0.1, 0.1, 0.5], [0.2, 0.2, 0.6, 0.6],
                       [0.21, 0.2, 0.6, 0.6], [0.7, 0.7, 0.9, 0.9]]], np.float32),
            np.array([[0.5, 0.9, 0.8, 0.3]], np.float32), np.ones((1, 4), bool))
    tiny = tuple(x.copy() for x in four)
    tiny[0][0, 0] = [0.3, 0.3, 0.3 + 1e-4, 0.3 + 1e-5]  # area ~1e-9, not 0
    tiny[1][0, 0] = 0.7
    boxes, scores, _, valid = nms_inputs(rng, 2, 300)
    ties = -scores  # below zero, but for ten tied at 0.25 and forty at +-0
    ties[:, :40] = np.where(np.arange(40) % 3 == 0, -0.0, 0.0)
    ties[:, 42:52] = 0.25
    tie_boxes = boxes.copy()
    tie_boxes[:, ::41, 2] += 0.05  # no zero-area box: no self-IoU fill here
    small = nms_inputs(rng, 2, 20)
    small[0][:, ::41, 2] += 0.05  # no fill: the slots after the picks stay empty
    # already in order, as select_candidates gives them: the kernel skips its sort
    rank = np.argsort(-scores, axis=1, kind="stable")
    in_order = (np.take_along_axis(boxes, rank[..., None], 1),
                np.take_along_axis(scores, rank, 1), valid)
    return {
        "zero_area_fill": (*four, 0.5, 5),
        "area_1e-9_fill": (*tiny, 0.5, 5),
        "threshold_above_1": (boxes, scores, valid, 1.5, 7),
        "signed_zero_ties": (tie_boxes, ties, valid, 0.5, 60),
        "all_invalid": (boxes, scores, np.zeros_like(valid), 0.5, 10),
        "n_below_m": (small[0], small[1], small[3], 0.5, 64),
        "in_order": (*in_order, 0.5, 100),
    }


def nms_large_cases():
    """name -> (boxes, scores, valid, iou_threshold, max_detections), numpy:
    the traps of ``nms_edge_cases`` above the bitmask route's 4096
    candidates per image, where the walk route runs (its sort's keys in
    shared memory up to 16384 and in global scratch above, more kept picks
    than the bitmask route's N)."""
    rng = np.random.default_rng(13)
    # 4000 copies of one box ahead of a zero-area box, shuffled: the first
    # pick removes 63 words, then the zero-area box fills the other slots
    boxes, scores, _, valid = nms_inputs(rng, 1, 4200)
    boxes[0, :4000] = [0.2, 0.2, 0.6, 0.6]
    scores[0, :4000] = np.linspace(0.99, 0.5, 4000, dtype=np.float32)
    boxes[0, 4000] = [0.7, 0.7, 0.7, 0.9]
    scores[0, 4000] = 0.45
    scores[0, 4001:] = rng.uniform(0, 0.4, 199)
    valid[:] = True
    perm = rng.permutation(4200)
    fill = (boxes[:, perm], scores[:, perm], valid[:, perm])
    # -0/+0 and 0.25 ties ahead of negative scores, no zero-area box
    boxes, scores, _, valid = nms_inputs(rng, 2, 5000)
    ties = -scores
    ties[:, :40] = np.where(np.arange(40) % 3 == 0, -0.0, 0.0)
    ties[:, 42:52] = 0.25
    boxes[:, ::41, 2] += 0.05
    # 20 live of 4097, fewer than M: the slots after them stay empty
    few = nms_inputs(rng, 1, 4097)
    few[0][:, ::41, 2] += 0.05
    few[3][:, 20:] = False
    above = nms_inputs(rng, 2, 4097)
    # already in order, as select_candidates gives them: the sort is skipped,
    # its check reading keys in shared memory (8192) and in global scratch
    # (20000)
    in_order = {}
    for n in (8192, 20000):
        b_, s_, c_, v_ = nms_inputs(rng, 1, n)
        rank = np.argsort(-s_, axis=1, kind="stable")
        shifted = b_ + 2.0 * c_[..., None].astype(np.float32)
        in_order[n] = (np.take_along_axis(shifted, rank[..., None], 1),
                       np.take_along_axis(s_, rank, 1), v_)
    # more than 4096 picks, each tested against every later word
    b_, s_, c_, v_ = nms_inputs(rng, 1, 6000)
    many = (b_ + 2.0 * c_[..., None].astype(np.float32), s_, v_)
    return {
        "zero_area_fill": (*fill, 0.5, 10),
        "threshold_above_1": (above[0], above[1], above[3], 1.5, 7),
        "signed_zero_ties": (boxes, ties, valid, 0.5, 60),
        "all_invalid": (above[0], above[1], np.zeros_like(above[3]), 0.5, 10),
        "n_below_m": (few[0], few[1], few[3], 0.5, 64),
        "in_order_8192": (*in_order[8192], 0.5, 100),
        "in_order_20000": (*in_order[20000], 0.5, 100),
        "picks_above_4096": (*many, 0.5, 4500),
    }


def match_edge_cases():
    """name -> (gt, labels, valid, shape_weight), numpy GT batches for the
    matching kernel against the R50-FPN-512 anchors: G = 1; G = 100 with 0,
    1, 7, 50, 99 and 100 valid rows; every row valid; shape_weight 0.3; a
    weight outside [0, 1], where the kernel keeps the padding rows; and
    bench_train.py's batch (all ties)."""
    rng = np.random.default_rng(12)
    g1 = match_inputs(rng, 2, 1, "random")
    g1[2][0] = True
    ragged = match_inputs(rng, 6, 100, "random")
    ragged[2][:] = np.arange(100)[None] < np.array([0, 1, 7, 50, 99, 100])[:, None]
    full = match_inputs(rng, 4, 64, "random")
    full[2][:] = True
    shaped = match_inputs(rng, 4, 100, "random")
    return {
        "g1": (*g1, 0.0),
        "g100_valid_0_to_100": (*ragged, 0.0),
        "all_valid": (*full, 0.0),
        "shape_weight_0.3": (*shaped, 0.3),
        "shape_weight_1.5": (*shaped, 1.5),
        "ties": (*match_inputs(rng, 16, 64, "ties"), 0.0),
    }


def torchvision_vgg16(rng, width: int = 512, fc: int = 4096):
    """A torchvision-layout VGG-16 state dict from ``rng``: ``features.{i}``
    convs at torchvision's layer ids, ``classifier.0`` (fc6) and
    ``classifier.3`` (fc7), with channels ``width / 512`` of the real ones
    (no pretrained file is in the repository)."""
    w = lambda c: c * width // 512
    chans = [(3, w(64)), (w(64), w(64)), (w(64), w(128)), (w(128), w(128)),
             (w(128), w(256)), (w(256), w(256)), (w(256), w(256)), (w(256), w(512)),
             (w(512), w(512)), (w(512), w(512)), (w(512), w(512)), (w(512), w(512)),
             (w(512), w(512))]
    ids = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    normal = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    sd = {}
    for i, (ci, co) in zip(ids, chans):
        sd[f"features.{i}.weight"] = normal(co, ci, 3, 3)
        sd[f"features.{i}.bias"] = normal(co)
    sd["classifier.0.weight"] = normal(fc, w(512) * 49)
    sd["classifier.0.bias"] = normal(fc)
    sd["classifier.3.weight"] = normal(fc, fc)
    sd["classifier.3.bias"] = normal(fc)
    sd["classifier.6.weight"] = normal(1000, fc)  # the classifier, unused
    sd["classifier.6.bias"] = normal(1000)
    return sd


def nms_bit_equal(boxes, scores, valid, t, m):
    """One K1 launch against the plain version on the same card tensors:
    (bit-equal, largest |difference| over idx and score, kept count)."""
    before = nms_cuda.launches
    got = nms_cuda.greedy_nms_cuda(boxes, scores, valid, t, m)
    torch.cuda.synchronize()
    if nms_cuda.launches != before + 1:
        raise RuntimeError("the kernel's launch counter did not advance by one")
    want = nms.greedy_nms(boxes, scores, valid, t, m)
    same = (torch.equal(got.indices, want.indices)
            and torch.equal(got.valid, want.valid)
            and torch.equal(got.scores.view(torch.int32), want.scores.view(torch.int32)))
    worst = max(float((got.scores - want.scores).abs().max()),
                float((got.indices - want.indices).abs().max()))
    return same, worst, int(got.valid.sum())


def match_check(anchors, gt, labels, valid, sw, variances, cfg=None, exact=False):
    """One K2 launch against the plain version on the same card tensors,
    then the MatchResult through both routes under ``cfg`` (default: 0.5 /
    0.4 thresholds with allow_low_quality at shape weight ``sw``). With
    ``exact``, best_q must be bit-equal at any shape weight. Returns
    (passed, worst |difference| over best_q and reg, a line for the log)."""
    if cfg is None:
        cfg = config.MatchConfig(pos_threshold=0.5, neg_threshold=0.4,
                                 allow_low_quality=True, shape_weight=sw)
    tau = cfg.shape_tau
    before = matching_cuda.launches
    got = matching_cuda.match_reductions_cuda(anchors, gt, labels, valid, sw, tau, variances)
    torch.cuda.synchronize()
    if matching_cuda.launches != before + 1:
        raise RuntimeError("the matching kernel's launch counter did not advance by one")
    want = matching.match_reductions_plain(anchors, gt, labels, valid, sw, tau, variances)
    bq_bits = torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    bq_ulp = int((got[0].view(torch.int32) - want[0].view(torch.int32)).abs().max())
    assign = (torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
              and torch.equal(got[2][valid], want[2][valid]))
    reg_err = float((got[4] - want[4]).abs().max())
    q_err = float((got[0] - want[0]).abs().max())
    kern = matching.match_batch(anchors, gt, labels, valid,
                                dataclasses.replace(cfg, backend="cuda"), variances)
    plain = matching.match_batch(anchors, gt, labels, valid,
                                 dataclasses.replace(cfg, backend="plain"), variances)
    result_equal = all(torch.equal(getattr(kern, f), getattr(plain, f)) for f in
                       ("matched_gt_idx", "cls_targets", "positive", "quality"))
    result_reg = float((kern.reg_targets - plain.reg_targets).abs().max())
    line = (f"assignments equal={assign}, best_q bit-equal={bq_bits} (worst {bq_ulp} "
            f"ulp, |err| {q_err:.3e}), reg max |err| {reg_err:.3e}; MatchResult after "
            f"the epilogue equal={result_equal}, reg max |err| {result_reg:.3e}; "
            f"positives {int(kern.positive.sum())}")
    # exp enters best_q only at shape_weight > 0, log enters reg: a few
    # ulp there; everything else to the bit
    passed = (assign and result_equal
              and (bq_bits or (not exact and sw > 0 and bq_ulp <= 4))
              and reg_err <= 1e-5 * max(1.0, float(want[4].abs().max()))
              and result_reg <= 1e-5 * max(1.0, float(plain.reg_targets.abs().max())))
    return passed, max(reg_err, q_err), line
