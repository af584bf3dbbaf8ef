"""Image preprocessing (port of the JAX package's ``utils/image.py``).

``normalize_images`` runs on the device inside detect and the train step;
the host helpers decode and resize (the first-party JPEG decoder of
``csrc/jpeg_decoder.cpp``, or PIL's BILINEAR) and map boxes between pixels
and the network input's normalized frame.
"""

from __future__ import annotations

import io
import threading
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


def boxes_px_to_input_norm(boxes_px: np.ndarray, h: int, w: int,
                           letterbox: bool = False) -> np.ndarray:
    """Pixel xyxy boxes -> normalized coordinates of the network input:
    divided by (W, H), or by max(H, W) in letterbox mode (the content fills
    the top-left of the canvas). Clipped to the image content: in letterbox
    mode (w, h) / max(h, w), so an annotation never reaches the padding."""
    if letterbox:
        m = np.float32(max(h, w))
        ext = np.array([w, h, w, h], np.float32) / m
        return np.clip(boxes_px / m, 0.0, ext)
    out = boxes_px / np.array([w, h, w, h], np.float32)
    return np.clip(out, 0.0, 1.0)


def decode_image_host(path_or_bytes) -> np.ndarray:
    """Decode a JPEG/PNG file or its bytes with PIL -> (H, W, 3) uint8."""
    from PIL import Image

    if isinstance(path_or_bytes, (bytes, bytearray)):
        img = Image.open(io.BytesIO(path_or_bytes))
    else:
        img = Image.open(path_or_bytes)
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


_auto_lock = threading.Lock()
_auto_backend = None  # what "auto" resolved to, once per process
AUTO_BACKEND_REASON = ""  # why "auto" resolved to PIL, when it did


def effective_decode_backend(backend: str = "auto") -> str:
    """What ``DataConfig.decode_backend`` runs on this host: "native" (the
    decoder of ``csrc/jpeg_decoder.cpp``, built at first use) or "pil".
    "native" raises when the decoder does not build; "pil" is PIL; "auto"
    resolves once per process, to "native" when the decoder builds and else
    to "pil" (``AUTO_BACKEND_REASON`` then holds the build's error). The two
    give slightly different pixels (DCT-domain prescale vs a full decode)."""
    global _auto_backend, AUTO_BACKEND_REASON
    from shape_based_object_detection_torch.utils import native

    if backend == "pil":
        return "pil"
    if backend == "native":
        native.load_image_lib()
        return "native"
    if backend != "auto":
        raise ValueError(f"decode_backend must be auto|native|pil: {backend!r}")
    with _auto_lock:
        if _auto_backend is None:
            # "auto" is the reference's opt-in to PIL where the decoder does
            # not build (no g++ or libjpeg); "native" is the assertion
            try:
                native.load_image_lib()
                _auto_backend = "native"
            except (RuntimeError, OSError) as e:
                lines = str(e).splitlines()
                _auto_backend = "pil"
                AUTO_BACKEND_REASON = "; ".join(
                    [lines[0]] + [x.strip() for x in lines if "error" in x][:1])
        return _auto_backend


def load_resized_image_host(path_or_bytes, size: int, letterbox: bool = False,
                            backend: str = "auto"):
    """Decode and resize on the host -> ((S, S, 3) uint8, original h,
    original w). JPEG data takes the native decoder unless ``backend`` is
    "pil"; PNG and other formats, and bytes the decoder rejects, go through
    PIL and a BILINEAR resize (or ``letterbox_image_host``)."""
    from PIL import Image

    data = None
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    elif backend != "pil":
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if (backend != "pil" and data is not None and data[:2] == b"\xff\xd8"
            and effective_decode_backend(backend) == "native"):
        from shape_based_object_detection_torch.utils.native import (
            decode_jpeg_resize_native,
        )

        r = decode_jpeg_resize_native(data, size, letterbox)
        if r is not None:
            return r
    img = decode_image_host(data if data is not None else path_or_bytes)
    h, w = img.shape[:2]
    if letterbox:
        out = letterbox_image_host(img, size)
    else:
        out = np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR),
                         np.uint8)
    return out, h, w
