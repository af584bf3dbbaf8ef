"""The cells' inputs, made from the seed.

- ``smooth_images``: pre-resized uint8 images of smooth random content
  (noise at 1/16 of the side, bilinearly upsampled), made on the device in
  one call, with original sizes drawn per side from a range.
- ``synthetic_pool``: training images as the program's synthetic dataset's
  default sampler makes them (a frozen copy: coloured rectangles of side
  0.15-0.5 on noise in [80, 120), 1 to ``max_objects`` per image, the
  class colour from a fixed palette, then a golden-ratio hue walk), with
  the noise made on the device in one call.
"""

from __future__ import annotations

import colorsys
from typing import Tuple

import numpy as np

PALETTE = np.asarray([[220, 40, 40], [40, 200, 60], [50, 80, 230], [230, 200, 40],
                      [180, 60, 200], [40, 210, 210]], np.uint8)


def class_color(cls: int) -> np.ndarray:
    if cls < len(PALETTE):
        return PALETTE[cls]
    r, g, b = colorsys.hsv_to_rgb((cls * 0.61803398875) % 1.0, 0.85, 0.9)
    return np.asarray([int(r * 255), int(g * 255), int(b * 255)], np.uint8)


def smooth_images(seed: int, n: int, size: int, side_range, device) -> Tuple[np.ndarray, list]:
    """(n, size, size, 3) uint8 and n original (h, w) sizes."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    small = torch.rand((n, 3, size // 16 + 1, size // 16 + 1), generator=gen, device=device)
    big = torch.nn.functional.interpolate(small, size=(size, size), mode="bilinear",
                                          align_corners=False)
    imgs = (big * 255).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    rng = np.random.default_rng(seed)
    sizes = [tuple(int(v) for v in rng.integers(side_range[0], side_range[1] + 1, 2))
             for _ in range(n)]
    return imgs.contiguous().cpu().numpy(), sizes


class Pool:
    """An indexable dataset of (image (S, S, 3) uint8, boxes (G, 4)
    normalized xyxy float32, labels (G,) int32 1-based), as the program's
    loader takes it."""

    def __init__(self, images: np.ndarray, boxes: List[np.ndarray], labels: List[np.ndarray]):
        self.images, self.boxes, self.labels = images, boxes, labels

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int):
        return self.images[i], self.boxes[i], self.labels[i]

    def padded(self, idx, max_boxes: int):
        """Rows ``idx`` as (images, boxes (B, G, 4), labels (B, G), valid (B, G))."""
        b = len(idx)
        boxes = np.zeros((b, max_boxes, 4), np.float32)
        labels = np.zeros((b, max_boxes), np.int32)
        valid = np.zeros((b, max_boxes), bool)
        for r, i in enumerate(idx):
            g = min(len(self.boxes[i]), max_boxes)
            boxes[r, :g], labels[r, :g], valid[r, :g] = self.boxes[i][:g], self.labels[i][:g], True
        return self.images[np.asarray(idx)], boxes, labels, valid


def synthetic_pool(seed: int, n: int, size: int, max_objects: int, num_classes: int,
                   device) -> Pool:
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randint(80, 120, (n, size, size, 3), generator=gen, device=device,
                           dtype=torch.uint8).cpu().numpy()
    rng = np.random.default_rng(seed)
    all_boxes, all_labels = [], []
    for i in range(n):
        boxes, labels = [], []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            w, h = rng.uniform(0.15, 0.5), rng.uniform(0.15, 0.5)
            x0, y0 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            cls = int(rng.integers(0, num_classes))
            px = [int(x0 * size), int(y0 * size), int((x0 + w) * size), int((y0 + h) * size)]
            images[i, px[1]:px[3], px[0]:px[2]] = class_color(cls)
            boxes.append([x0, y0, x0 + w, y0 + h])
            labels.append(cls + 1)
        all_boxes.append(np.asarray(boxes, np.float32))
        all_labels.append(np.asarray(labels, np.int32))
    return Pool(images, all_boxes, all_labels)
