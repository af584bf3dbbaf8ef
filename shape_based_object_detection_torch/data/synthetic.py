"""Synthetic detection dataset: generated images with known boxes
(SURVEY.md §4 item 5 — the overfit/integration-test oracle, and a stand-in
when COCO/VOC data is not mounted)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

PALETTE = np.asarray(
    [
        [220, 40, 40],
        [40, 200, 60],
        [50, 80, 230],
        [230, 200, 40],
        [180, 60, 200],
        [40, 210, 210],
    ],
    dtype=np.uint8,
)


def _class_color(cls: int) -> np.ndarray:
    """Distinct uint8 color for any class id: the hand-picked palette for the
    first 6 (kept stable for existing oracle tests), then a deterministic
    golden-ratio hue walk for arbitrarily many classes (VOC 20 / COCO 80)."""
    if cls < len(PALETTE):
        return PALETTE[cls]
    import colorsys

    h = (cls * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 0.9)
    return np.asarray([int(r * 255), int(g * 255), int(b * 255)], np.uint8)


class SyntheticDetection:
    """Images of colored rectangles on noise; label = color index + 1.

    ``aspect_std > 0`` switches box sampling to area + log-normal aspect
    ratio (w/h = e^N(0, aspect_std)), producing a heavy tail of thin and
    elongated objects — the regime where shape-similarity matching (C13)
    differs from plain IoU. The default (0.0) keeps the original
    near-square sampler bit-identical (existing oracle tests depend on it).

    ``color_jitter > 0`` adds a per-instance uniform RGB offset of up to
    ±color_jitter·255 to the class color, so classification can no longer
    key on one exact pixel value — classes with nearby hues genuinely
    confuse, which keeps converged mAP off the 1.0 ceiling and makes
    accuracy deltas (quantization drift, TTA gain) measurable. Default 0.0
    keeps existing oracle images bit-identical.

    Benchmark-diversity knobs (round 5; both default off so every existing
    split is bit-identical):

    ``area_lo``/``area_hi`` override the sampled normalized box AREA range
    (requires ``aspect_std > 0``'s area-parameterized sampler, or activate
    it with aspect_std=1e-6). A small-object-heavy split uses e.g.
    area_lo=0.0005&area_hi=0.0035: at 512px that is ~11–30 px boxes, under
    COCO's small-area stratum (32^2 original px), so APsmall/ARsmall stop
    being NaN-by-construction.

    ``class_aspect > 0`` gives each CLASS a characteristic elongation: class
    c's log-aspect is centered on mu_c, evenly spread over
    [-class_aspect, +class_aspect] across classes (c=0 thinnest/tallest,
    c=C-1 widest), with per-instance noise aspect_std around it. Object
    shape then carries class information — the regime engineered to FAVOR
    shape-similarity matching (C13), the adversarial counterpart of the
    symmetric-blob benchmark where it measured negative.
    """

    def __init__(self, size: int = 300, num_images: int = 64,
                 max_objects: int = 4, num_classes: int = 4, seed: int = 0,
                 aspect_std: float = 0.0, color_jitter: float = 0.0,
                 area_lo: float = 0.0, area_hi: float = 0.0,
                 class_aspect: float = 0.0):
        self.size = size
        self.num_images = num_images
        self.max_objects = max_objects
        self.num_classes = num_classes
        self.seed = seed
        self.aspect_std = aspect_std
        self.color_jitter = color_jitter
        self.area_lo = area_lo
        self.area_hi = area_hi
        self.class_aspect = class_aspect

    def __len__(self) -> int:
        return self.num_images

    def _sample_wh(self, rng, cls: int = 0) -> Tuple[float, float]:
        if (self.aspect_std <= 0 and self.class_aspect <= 0
                and self.area_hi <= 0):
            return rng.uniform(0.15, 0.5), rng.uniform(0.15, 0.5)
        # fixed-ish area, extreme aspect: keep every box >= ~4 px at
        # size>=128 so a matched anchor is geometrically possible
        lo_a = self.area_lo if self.area_lo > 0 else 0.01
        hi_a = self.area_hi if self.area_hi > 0 else 0.06
        area = rng.uniform(lo_a, hi_a)
        mu = 0.0
        if self.class_aspect > 0:
            # class c center spread evenly over [-class_aspect, class_aspect]
            frac = (cls + 0.5) / self.num_classes
            mu = (2.0 * frac - 1.0) * self.class_aspect
        log_ar = float(np.clip(mu + rng.normal(0.0, self.aspect_std), -2.2, 2.2))
        w = float(np.sqrt(area * np.exp(log_ar)))
        h = float(np.sqrt(area / np.exp(log_ar)))
        lo = 4.0 / self.size
        return max(min(w, 0.95), lo), max(min(h, 0.95), lo)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100_003 + i)
        s = self.size
        img = rng.integers(80, 120, size=(s, s, 3), dtype=np.uint8)
        n = int(rng.integers(1, self.max_objects + 1))
        boxes, labels = [], []
        for _ in range(n):
            # class_aspect needs the class BEFORE the shape; every other mode
            # keeps the original draw order so existing splits (and the
            # oracle tests pinned to them) stay bit-identical.
            if self.class_aspect > 0:
                cls = int(rng.integers(0, self.num_classes))
                w, h = self._sample_wh(rng, cls)
            else:
                w, h = self._sample_wh(rng)
            x0 = rng.uniform(0, 1 - w)
            y0 = rng.uniform(0, 1 - h)
            if self.class_aspect <= 0:
                cls = int(rng.integers(0, self.num_classes))
            px = [int(x0 * s), int(y0 * s), int((x0 + w) * s), int((y0 + h) * s)]
            color = _class_color(cls)
            if self.color_jitter > 0:
                j = int(self.color_jitter * 255)
                color = np.clip(color.astype(np.int32)
                                + rng.integers(-j, j + 1, 3), 0, 255
                                ).astype(np.uint8)
            img[px[1] : px[3], px[0] : px[2]] = color
            boxes.append([x0, y0, x0 + w, y0 + h])
            labels.append(cls + 1)
        return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)
