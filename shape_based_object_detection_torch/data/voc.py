"""PASCAL VOC dataset (component C2, SURVEY.md §2).

Parses the standard VOCdevkit layout (JPEGImages/, Annotations/*.xml,
ImageSets/Main/{split}.txt) with xml.etree — no external deps. Images are
decoded and resized to the static model input size on the host (the only host
image work); boxes come out normalized xyxy with 1-based labels.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
VOC_CLASS_TO_ID = {c: i + 1 for i, c in enumerate(VOC_CLASSES)}  # 1-based


def parse_voc_xml(path: str, keep_difficult: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int],
                             np.ndarray]:
    """Returns (boxes_px xyxy (G,4), labels (G,), (height, width),
    difficult (G,) bool).

    ``keep_difficult=False`` (training) drops difficult objects entirely —
    the family's training convention. ``keep_difficult=True`` (eval) keeps
    them with the flag set, for ignore-region scoring (the official VOC
    protocol: difficult GT counts in neither TP nor FP)."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    h = int(size.find("height").text)
    w = int(size.find("width").text)
    boxes, labels, difficult = [], [], []
    for obj in root.iter("object"):
        diff = obj.find("difficult")
        is_diff = diff is not None and diff.text == "1"
        if not keep_difficult and is_diff:
            continue
        name = obj.find("name").text.strip().lower()
        if name not in VOC_CLASS_TO_ID:
            continue
        bb = obj.find("bndbox")
        # VOC pixel coords are 1-based inclusive
        x0 = float(bb.find("xmin").text) - 1
        y0 = float(bb.find("ymin").text) - 1
        x1 = float(bb.find("xmax").text) - 1
        y1 = float(bb.find("ymax").text) - 1
        boxes.append([x0, y0, x1, y1])
        labels.append(VOC_CLASS_TO_ID[name])
        difficult.append(is_diff)
    return (
        np.asarray(boxes, np.float32).reshape(-1, 4),
        np.asarray(labels, np.int32),
        (h, w),
        np.asarray(difficult, bool),
    )


class VOCDetection:
    """Indexable dataset of (image_u8 (S,S,3), boxes_norm (G,4), labels (G,)).

    ``include_difficult=True`` (eval protocol) keeps difficult objects and
    appends their (G,) bool flag to each sample — routed into the evaluator
    as plain ignore regions (official VOC scoring). Training leaves it False
    so difficult objects never become positives (family convention)."""

    def __init__(self, root: str, split: str = "train", image_size: int = 300,
                 include_difficult: bool = False,
                 ids: Sequence[str] | None = None,
                 letterbox: bool = False, decode_backend: str = "auto"):
        from shape_based_object_detection_torch.utils.image import (
            effective_decode_backend,
        )

        self.root = root
        self.image_size = image_size
        self.include_difficult = include_difficult
        self.letterbox = letterbox
        # resolved ("native"/"pil") so the sample-cache fingerprint keys on
        # the pixels actually produced, not on "auto"
        self.decode_backend = effective_decode_backend(decode_backend)
        if ids is not None:
            self.ids: List[str] = list(ids)
        else:
            split_file = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
            with open(split_file) as f:
                self.ids = [line.strip().split()[0] for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int):
        from shape_based_object_detection_torch.utils.image import (
            boxes_px_to_input_norm, load_resized_image_host,
        )

        img_id = self.ids[i]
        img, _, _ = load_resized_image_host(
            os.path.join(self.root, "JPEGImages", f"{img_id}.jpg"),
            self.image_size, self.letterbox, backend=self.decode_backend)
        # box normalization uses the XML-declared dims (family convention),
        # not the decoded dims
        boxes_px, labels, (h, w), difficult = parse_voc_xml(
            os.path.join(self.root, "Annotations", f"{img_id}.xml"),
            keep_difficult=self.include_difficult,
        )
        boxes = boxes_px_to_input_norm(boxes_px, h, w, self.letterbox)
        if self.include_difficult:
            return img, boxes, labels, difficult
        return img, boxes, labels
