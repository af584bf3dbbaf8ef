"""The port's ``eval/ap.py`` against the JAX package's on the same records:
``voc_map``, ``coco_map`` and ``Evaluator`` give equal values for every
output key, with crowd and ignore regions, per-image area factors, and
either matcher (the C++ one and the numpy plain version)."""

import math
import types

import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu.eval import ap as ref_ap
from shape_based_object_detection_torch.eval import ap


def _records(lib, seed, n_images=8, n_classes=4):
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for img in range(n_images):
        g = int(rng.integers(1, 7))
        xy = rng.uniform(0.0, 0.7, (g, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.02, 0.3, (g, 2))], 1).astype(np.float32)
        labels = rng.integers(0, n_classes, g)
        crowd = rng.uniform(size=g) < 0.15
        ignore = rng.uniform(size=g) < 0.15
        gts.append(lib.GroundTruthRecord(img, boxes, labels, crowd,
                                         area_factor=float(rng.uniform(2e4, 4e5)),
                                         ignore=ignore))
        d = int(rng.integers(0, 12))
        det = boxes[rng.integers(0, g, d)] + rng.normal(0, 0.03, (d, 4)).astype(np.float32)
        dets.append(lib.DetectionRecord(img, det, rng.uniform(0.05, 1.0, d).astype(np.float32),
                                        np.where(rng.uniform(size=d) < 0.8,
                                                 labels[rng.integers(0, g, d)],
                                                 rng.integers(0, n_classes, d))))
    return dets, gts


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "per_class":
            assert set(got[key]) == set(w)
            for c, v in w.items():
                assert got[key][c] == pytest.approx(v, abs=1e-12, nan_ok=True), (key, c)
        else:
            assert (math.isnan(w) and math.isnan(got[key])) or got[key] == pytest.approx(
                w, abs=1e-12), key


@pytest.mark.parametrize("matcher", ["native", "numpy"])
@pytest.mark.parametrize("seed,area_scale", [(0, 1.0), (1, 512.0), (2, 300.0)])
def test_coco_map_equals_reference(matcher, seed, area_scale):
    got = ap.coco_map(*_records(ap, seed), area_scale=area_scale, matcher=matcher)
    want = ref_ap.coco_map(*_records(ref_ap, seed), area_scale=area_scale)
    assert got["mAP"] > 0
    _assert_same(got, want)


@pytest.mark.parametrize("matcher", ["native", "numpy"])
@pytest.mark.parametrize("seed,iou,eleven", [(3, 0.5, True), (4, 0.5, False), (5, 0.7, True)])
def test_voc_map_equals_reference(matcher, seed, iou, eleven):
    got = ap.voc_map(*_records(ap, seed), iou, eleven, matcher=matcher)
    want = ref_ap.voc_map(*_records(ref_ap, seed), iou, eleven)
    assert got["mAP"] > 0
    _assert_same(got, want)


def _batch(seed, b=4, g=6, m=10, classes=5):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 0.7, (b, g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (b, g, 2))], -1).astype(np.float32)
    valid = rng.uniform(size=(b, g)) < 0.8
    labels = rng.integers(0, classes, (b, g))
    pick = rng.integers(0, g, (b, m))
    det = types.SimpleNamespace(
        boxes=(np.take_along_axis(gt, pick[..., None], 1)
               + rng.normal(0, 0.02, (b, m, 4))).astype(np.float32),
        scores=rng.uniform(0.05, 1.0, (b, m)).astype(np.float32),
        labels=np.take_along_axis(labels, pick, 1),
        valid=rng.uniform(size=(b, m)) < 0.9)
    return det, gt, labels, valid, rng.uniform(size=(b, g)) < 0.2, rng.uniform(1e4, 3e5, b)


@pytest.mark.parametrize("flag", ["gt_crowd", "gt_ignore"])
def test_evaluator_equals_reference(flag):
    """Two batches through ``add_batch`` (the port's as torch tensors, the
    reference's as numpy), with area factors and a flag channel."""
    got, want = ap.Evaluator(area_scale=1.0), ref_ap.Evaluator(area_scale=1.0)
    for seed in (6, 7):
        det, gt, labels, valid, flags, factors = _batch(seed)
        tdet = types.SimpleNamespace(**{k: torch.from_numpy(getattr(det, k))
                                        for k in ("boxes", "scores", "labels", "valid")})
        got.add_batch(tdet, torch.from_numpy(gt), torch.from_numpy(labels),
                      torch.from_numpy(valid), area_factors=factors, **{flag: flags})
        want.add_batch(det, gt, labels, valid, area_factors=factors, **{flag: flags})
    _assert_same(got.coco(), want.coco())
    _assert_same(got.voc(), want.voc())
    numpy_matcher = ap.Evaluator(area_scale=1.0, matcher="numpy")
    numpy_matcher.detections, numpy_matcher.ground_truth = got.detections, got.ground_truth
    _assert_same(numpy_matcher.coco(), want.coco())
    assert got.voc()["mAP"] > 0


def test_unknown_matcher_raises():
    with pytest.raises(ValueError, match="matcher"):
        ap.voc_map(*_records(ap, 8), matcher="gpu")
