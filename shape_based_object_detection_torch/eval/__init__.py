"""Evaluation: first-party COCO-style and VOC-style mAP (numpy, with the
C++ matcher of ``csrc/ap_matcher.cpp``)."""

from shape_based_object_detection_torch.eval.ap import (
    DetectionRecord,
    Evaluator,
    GroundTruthRecord,
    coco_map,
    voc_map,
)
