"""Anchor-matching reductions on the card: the wrapper of the hand-written
CUDA kernel ``csrc/match_anchors.cu``, which replaces the JAX package's
Pallas kernel (``ops/matching_pallas.py``).

One launch computes, for every (image, anchor), the best GT's quality and
index, label and encoded offsets, and for every GT its best anchor, without
the (B, A, G) quality matrix in device memory. The outputs equal
``ops.matching.match_reductions_plain`` on the same inputs: assignments bit
for bit, qualities bit for bit at ``shape_weight == 0``, and within a few ulp
where ``exp``/``log`` enter. CUDA tensors only: a CPU tensor raises (the
plain version is what runs on the CPU, chosen by ``match_batch`` from the
tensors' device). Nothing here falls back. The kernel is built at first use
(``utils/native.py``); importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from shape_based_object_detection_torch.utils import native

# Launches of the kernel since the process started (or the last reset by a
# caller that wants to see whether a run went through it).
launches = 0

# device index -> the most GT rows per image the kernel takes (what fits its
# shared memory), read once per device when the kernel is set up there
_max_gt: dict = {}


def _lib() -> ctypes.CDLL:
    lib = native.load("match_anchors")
    if not getattr(lib, "_sbd_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.match_anchors_launch.argtypes = [p, p, p, p, i, i, i, f, f, f, f, f,
                                             p, p, p, p, p, p, p, p]
        lib.match_anchors_launch.restype = i
        lib.match_anchors_init.argtypes = []
        lib.match_anchors_init.restype = i
        lib._sbd_typed = True
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the anchors on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    t = t.contiguous()
    # the kernel reads boxes as float4: a view at an odd offset is copied
    return t.clone() if t.data_ptr() % 16 else t


def match_reductions_cuda(
    anchors_cxcywh: torch.Tensor,  # (A, 4) float32
    gt_boxes_xyxy: torch.Tensor,  # (B, G, 4) float32
    gt_labels: torch.Tensor,  # (B, G) int32
    gt_valid: torch.Tensor,  # (B, G) bool
    shape_weight: float = 0.0,
    tau: float = 1.0,
    variances=(0.1, 0.2),
):
    """Returns ``(best_q, best_g, gt_a, label, reg)``: (B, A) float32,
    (B, A) int32, (B, G) int32, (B, A) int32, (B, A, 4) float32. Launches on
    the current stream and does not synchronise."""
    global launches
    if not all(t.is_cuda for t in (anchors_cxcywh, gt_boxes_xyxy, gt_labels,
                                   gt_valid)):
        raise ValueError(
            "match_reductions_cuda takes CUDA tensors only; run "
            "ops.matching.match_reductions_plain for tensors on the CPU")
    device = anchors_cxcywh.device
    if gt_boxes_xyxy.dim() != 3:
        raise ValueError(f"gt boxes must be (B, G, 4), got {tuple(gt_boxes_xyxy.shape)}")
    b, g, _ = gt_boxes_xyxy.shape
    a = anchors_cxcywh.shape[0]
    anchors = _check("anchors", anchors_cxcywh, torch.float32, (a, 4), device)
    boxes = _check("gt boxes", gt_boxes_xyxy, torch.float32, (b, g, 4), device)
    labels = _check("gt labels", gt_labels, torch.int32, (b, g), device)
    valid = _check("gt valid", gt_valid, torch.bool, (b, g), device)
    if a < 1 or g < 1 or b < 1:
        raise ValueError(f"need A, G, B >= 1, got A={a}, G={g}, B={b}")
    if not tau > 0.0:
        raise ValueError(f"shape_tau must be > 0, got {tau}")
    lib = _lib()
    with torch.cuda.device(device):
        max_g = _max_gt.get(device.index)
        if max_g is None:
            max_g = lib.match_anchors_init()
            if max_g <= 0:
                raise RuntimeError("setting up the match_anchors kernel failed")
            _max_gt[device.index] = max_g
        if g > max_g:
            raise ValueError(f"{g} GT rows do not fit the kernel's shared memory "
                             f"(at most {max_g})")
        stream = torch.cuda.current_stream(device).cuda_stream
        # the per-GT argmax keys (B, G), then the kernel's finish counter:
        # zeroed in one fill
        keys = torch.zeros(b * g + 1, dtype=torch.int64, device=device)
        best_q = torch.empty((b, a), dtype=torch.float32, device=device)
        best_g = torch.empty((b, a), dtype=torch.int32, device=device)
        gt_a = torch.empty((b, g), dtype=torch.int32, device=device)
        label = torch.empty((b, a), dtype=torch.int32, device=device)
        reg = torch.empty((b, a, 4), dtype=torch.float32, device=device)
        vc, vs = variances
        # (1 - w) is rounded from the double, as the plain version's Python
        # scalar is
        err = lib.match_anchors_launch(
            anchors.data_ptr(), boxes.data_ptr(), labels.data_ptr(),
            valid.data_ptr(), b, a, g, float(shape_weight),
            float(1.0 - shape_weight), float(tau), float(vc), float(vs),
            keys.data_ptr(), keys[b * g:].data_ptr(), best_q.data_ptr(), best_g.data_ptr(),
            gt_a.data_ptr(), label.data_ptr(), reg.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"match_anchors kernel launch failed: CUDA error {err}")
    launches += 1
    return best_q, best_g, gt_a, label, reg
