"""COCO dataset via a first-party lightweight JSON reader (component C3,
SURVEY.md §2 — pycocotools is not a dependency: its only roles here are
annotation loading and eval, and both are reimplemented).

Handles the 91->80 contiguous category-id remapping and xywh->xyxy boxes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np


class CocoAnnotations:
    """Parsed instances_*.json: images, per-image annotations, category map."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.images: List[dict] = data["images"]
        self.image_by_id: Dict[int, dict] = {im["id"]: im for im in self.images}
        cats = sorted(data.get("categories", []), key=lambda c: c["id"])
        # contiguous 1-based labels in sorted-category-id order (91 -> 80)
        self.cat_id_to_label = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self.label_to_cat_id = {v: k for k, v in self.cat_id_to_label.items()}
        self.cat_names = {c["id"]: c["name"] for c in cats}
        # crowd annotations are KEPT (flagged): the COCO eval protocol uses
        # them as ignore regions; training filters them out downstream.
        self.anns_by_image: Dict[int, List[dict]] = {}
        for ann in data.get("annotations", []):
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)

    def boxes_for_image(self, image_id: int, include_crowd: bool = False
                        ) -> Tuple[np.ndarray, ...]:
        """Returns (boxes_px xyxy (G,4), labels (G,) contiguous 1-based)
        without crowds, or with ``include_crowd=True`` the 3-tuple
        (boxes, labels, crowd (G,) bool) keeping crowd regions flagged."""
        anns = self.anns_by_image.get(image_id, [])
        boxes, labels, crowd = [], [], []
        for a in anns:
            is_crowd = bool(a.get("iscrowd", 0))
            if is_crowd and not include_crowd:
                continue
            x, y, w, h = a["bbox"]  # COCO xywh
            if w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(self.cat_id_to_label[a["category_id"]])
            crowd.append(is_crowd)
        out = (
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32),
        )
        if include_crowd:
            return out + (np.asarray(crowd, bool),)
        return out


class CocoDetection:
    """Indexable dataset of (image_u8 (S,S,3), boxes_norm (G,4), labels (G,)).

    ``include_crowd=True`` (eval protocol) appends a (G,) bool crowd flag to
    each sample; training leaves it False so crowds never become positives."""

    def __init__(self, root: str, ann_file: str, image_size: int = 512,
                 letterbox: bool = False, include_crowd: bool = False,
                 decode_backend: str = "auto"):
        from shape_based_object_detection_torch.utils.image import (
            effective_decode_backend,
        )

        self.root = root
        self.image_size = image_size
        self.letterbox = letterbox
        self.include_crowd = include_crowd
        # resolved ("native"/"pil") so the sample-cache fingerprint keys on
        # the pixels actually produced, not on "auto"
        self.decode_backend = effective_decode_backend(decode_backend)
        self.coco = CocoAnnotations(ann_file)
        # keep only images that exist on disk (partial mounts are common)
        self.images = [
            im for im in self.coco.images
            if os.path.exists(os.path.join(root, im["file_name"]))
        ]

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int):
        from shape_based_object_detection_torch.utils.image import (
            boxes_px_to_input_norm, load_resized_image_host,
        )

        im = self.images[i]
        img, _, _ = load_resized_image_host(
            os.path.join(self.root, im["file_name"]),
            self.image_size, self.letterbox, backend=self.decode_backend)
        # box normalization uses the annotation-declared dims (pycocotools
        # convention), not the decoded dims
        h, w = im["height"], im["width"]
        ann = self.coco.boxes_for_image(im["id"],
                                        include_crowd=self.include_crowd)
        boxes_px, labels = ann[0], ann[1]
        boxes = boxes_px_to_input_norm(boxes_px, h, w, self.letterbox)
        # (boxes_px_to_input_norm already clips to the canvas)
        if self.include_crowd:
            return img, boxes, labels, ann[2]
        return img, boxes, labels
