"""Batched inference serving (port of the JAX package's ``serving.py``,
float tier).

``Predictor.predict`` splits a request into fixed-size batches, resizes and
pads each on the host, runs detect on the device and unpads the results. The
next chunk is prepared and launched before the previous one is read back, so
host work overlaps the device (PyTorch launches asynchronously on CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from shape_based_object_detection_torch.config import ExperimentConfig
from shape_based_object_detection_torch.detection import make_detect_fn
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.utils.device import resolve_device
from shape_based_object_detection_torch.utils.image import (
    boxes_norm_to_original_px, letterbox_image_host, load_resized_image_host,
)


@dataclasses.dataclass
class Detection:
    boxes: np.ndarray  # (K, 4) pixel xyxy in the original image frame
    scores: np.ndarray  # (K,)
    labels: np.ndarray  # (K,) 0-based foreground class ids


def prepare_batch(images: Sequence, size: int, batch_size: int,
                  letterbox: bool = False,
                  decode_backend: str = "auto") -> Tuple[np.ndarray, list]:
    """Resize (BILINEAR) and zero-pad a request of <= batch_size images to
    the batch shape. Each item is a decoded (H, W, 3) uint8 array, a file
    path or encoded image bytes (decoded and resized on the host by
    ``load_resized_image_host``: JPEGs through the native decoder unless
    ``decode_backend`` is "pil"), or a pre-resized pair ``((size, size, 3)
    uint8, (h, w))``. Returns (batch (B, size, size, 3) uint8, original
    (h, w) sizes)."""
    from PIL import Image

    if len(images) > batch_size:
        raise ValueError(f"{len(images)} images exceed batch_size {batch_size}")
    batch = np.zeros((batch_size, size, size, 3), np.uint8)
    sizes = []
    for i, img in enumerate(images):
        if isinstance(img, tuple):  # (pre-resized array, (h, w))
            resized, (h, w) = img
            resized = np.asarray(resized)
            if resized.shape != (size, size, 3):
                raise ValueError(
                    f"pre-resized item has shape {resized.shape}, expected "
                    f"({size}, {size}, 3)")
            if resized.dtype != np.uint8:
                raise ValueError(
                    f"pre-resized item must be uint8, got {resized.dtype}")
            batch[i] = resized
            sizes.append((int(h), int(w)))
            continue
        if not isinstance(img, np.ndarray):
            batch[i], h, w = load_resized_image_host(img, size, letterbox,
                                                     backend=decode_backend)
            sizes.append((h, w))
            continue
        h, w = img.shape[:2]
        sizes.append((h, w))
        if letterbox:
            batch[i] = letterbox_image_host(img, size)
        else:
            batch[i] = np.asarray(
                Image.fromarray(img).resize((size, size), Image.BILINEAR))
    return batch, sizes


def unpack_detections(det, sizes, min_score: float = 0.0,
                      letterbox: bool = False) -> List[Detection]:
    """Fixed-size Detections -> per-image unpadded pixel-space lists (reads
    the device results back, so it waits for them)."""
    boxes, scores, labels, valid = (t.cpu().numpy() for t in det)
    out = []
    for i, (h, w) in enumerate(sizes):
        keep = valid[i] & (scores[i] >= min_score)
        bx = boxes_norm_to_original_px(boxes[i][keep], h, w, letterbox)
        out.append(Detection(boxes=bx, scores=scores[i][keep],
                             labels=labels[i][keep]))
    return out


class Predictor:
    """detect() as a service: fixed batch, padded, launches overlapped with
    host work. Runs on the card unless ``device="cpu"``."""

    def __init__(self, cfg: ExperimentConfig, state_dict=None,
                 batch_size: int = 8, min_score: float = 0.0,
                 quantize: bool | str = False, device=None,
                 generator: torch.Generator | None = None):
        """``state_dict``: weights to load (strict); None keeps the fresh
        initialisation drawn from ``generator``. Only the float tier is
        ported: any ``quantize`` other than False raises."""
        if quantize is not False:
            raise NotImplementedError(
                "quantized serving tiers are not ported yet (ROADMAP.md, "
                "modules still to port, item 6)")
        self.cfg = cfg
        self.batch_size = batch_size
        self.min_score = min_score
        self.size = cfg.model.image_size
        self.letterbox = cfg.data.letterbox
        self.device = resolve_device(device)
        self.module, self.anchors = build_model(cfg.model, self.device, generator)
        if state_dict is not None:
            self.module.load_state_dict(state_dict, strict=True)
        self._detect = make_detect_fn(self.module, self.anchors, cfg.model,
                                      cfg.data, self.device)

    def _upload(self, batch: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(batch)
        if self.device.type == "cuda":
            x = x.pin_memory()  # lets the copy run asynchronously
        return x.to(self.device, non_blocking=True)

    def predict(self, images: Sequence) -> List[Detection]:
        """Any request size: ceil(len / batch_size) batches, pipelined so
        chunk i+1 is prepared and launched before chunk i is read back."""
        out: List[Detection] = []
        pending: Optional[Tuple] = None
        for i in range(0, len(images), self.batch_size):
            chunk = images[i:i + self.batch_size]
            batch, sizes = prepare_batch(chunk, self.size, self.batch_size,
                                         self.letterbox, self.cfg.data.decode_backend)
            det = self._detect(self._upload(batch))
            if pending is not None:
                out.extend(unpack_detections(*pending, self.min_score,
                                             self.letterbox))
            pending = (det, sizes)
        if pending is not None:
            out.extend(unpack_detections(*pending, self.min_score,
                                         self.letterbox))
        return out
