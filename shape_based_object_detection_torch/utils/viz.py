"""Detection drawing (the port's copy of the JAX package's
``utils/viz.py``): host-side PIL, never on the device path. Colours are
stable per class id, so a class looks the same in every image."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# well-separated class colours by a golden-angle walk over hue
_GOLDEN = 0.61803398875


def class_color(label: int) -> tuple:
    import colorsys

    h = (label * _GOLDEN) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.75, 0.95)
    return (int(r * 255), int(g * 255), int(b * 255))


def draw_detections(
    image: np.ndarray,  # (H, W, 3) uint8
    boxes: np.ndarray,  # (N, 4) pixel xyxy
    scores: np.ndarray,
    labels: np.ndarray,  # 0-based foreground ids
    class_names: Optional[Sequence[str]] = None,
    min_score: float = 0.0,
    width: int = 2,
) -> np.ndarray:
    """A copy of ``image`` with a labelled box drawn for each detection at
    or above ``min_score``, the best drawn last (on top)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image).convert("RGB")
    draw = ImageDraw.Draw(img)
    for i in np.argsort(scores):
        if scores[i] < min_score:
            continue
        x0, y0, x1, y1 = [float(v) for v in boxes[i]]
        lab = int(labels[i])
        color = class_color(lab)
        draw.rectangle([x0, y0, x1, y1], outline=color, width=width)
        name = (class_names[lab] if class_names and lab < len(class_names)
                else str(lab + 1))
        text = f"{name} {scores[i]:.2f}"
        tw = draw.textlength(text)
        th = 11
        ty = y0 - th - 2 if y0 - th - 2 > 0 else y0 + 1
        draw.rectangle([x0, ty, x0 + tw + 4, ty + th + 2], fill=color)
        draw.text((x0 + 2, ty + 1), text, fill=(0, 0, 0))
    return np.asarray(img)
