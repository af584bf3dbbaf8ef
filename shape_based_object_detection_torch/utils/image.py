"""Image preprocessing (port of the JAX package's ``utils/image.py``).

``normalize_images`` runs on the device inside detect; the host helpers
resize (PIL, BILINEAR) and map boxes back to the original pixels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from shape_based_object_detection_torch.utils.device import constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(
    images: torch.Tensor,
    mean: Tuple[float, float, float] = IMAGENET_MEAN,
    std: Tuple[float, float, float] = IMAGENET_STD,
) -> torch.Tensor:
    """uint8/float (B, H, W, 3) -> float32 normalized, channels last."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    m = constant(tuple(mean), torch.float32, images.device)
    s = constant(tuple(std), torch.float32, images.device)
    return (x - m) / s


def letterbox_image_host(img: np.ndarray, size: int) -> np.ndarray:
    """Aspect-preserving BILINEAR resize into the top-left of a zero
    (size, size, 3) uint8 canvas (pad bottom/right)."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    resized = np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)
    canvas = np.zeros((size, size, 3), np.uint8)
    canvas[:nh, :nw] = resized
    return canvas


def boxes_norm_to_original_px(boxes_norm: np.ndarray, h: int, w: int,
                              letterbox: bool = False) -> np.ndarray:
    """Normalized network-input boxes -> original pixel xyxy, clipped to the
    image. Letterbox mode scales by max(H, W) (the content fills the
    top-left of the canvas)."""
    if letterbox:
        boxes = boxes_norm * np.float32(max(h, w))
    else:
        boxes = boxes_norm * np.array([w, h, w, h], np.float32)
    return np.stack([
        np.clip(boxes[..., 0], 0, w),
        np.clip(boxes[..., 1], 0, h),
        np.clip(boxes[..., 2], 0, w),
        np.clip(boxes[..., 3], 0, h),
    ], axis=-1)
