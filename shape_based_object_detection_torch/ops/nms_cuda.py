"""Greedy NMS on the card: the wrapper of the hand-written CUDA kernel
``csrc/nms_greedy.cu``, which replaces the JAX package's Pallas kernel
(``ops/nms_pallas.py``).

The kernel runs one thread block per image with the image's candidates in
shared memory, and reproduces ``ops/nms.greedy_nms`` bit for bit. These
functions take CUDA tensors only: a CPU tensor raises (the plain version in
``ops/nms.py`` is what runs on the CPU, chosen by the caller from the
tensors' device). Nothing here falls back. The kernel is built at first use
(``utils/native.py``); importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes

import torch

from shape_based_object_detection_torch.ops.nms import (
    Detections, NMSResult, class_offset_boxes, gather_detections,
)
from shape_based_object_detection_torch.utils import native

# Launches of the kernel since the process started (or the last reset by a
# caller that wants to see whether a run went through it).
launches = 0

_max_candidates = None


def _lib() -> ctypes.CDLL:
    lib = native.load("nms_greedy")
    if not getattr(lib, "_sbd_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nms_greedy_launch.argtypes = [p, p, p, i, i, i, ctypes.c_float,
                                          p, p, p, p]
        lib.nms_greedy_launch.restype = i
        lib.nms_greedy_max_candidates.argtypes = []
        lib.nms_greedy_max_candidates.restype = i
        lib._sbd_typed = True
    return lib


def greedy_nms_cuda(
    boxes_xyxy: torch.Tensor,  # (B, N, 4) CUDA
    scores: torch.Tensor,  # (B, N)
    valid: torch.Tensor,  # (B, N) bool
    iou_threshold: float,
    max_detections: int,
) -> NMSResult:
    """Batched single-class greedy NMS in one kernel launch. Returns
    (indices int32, scores float32, valid bool), each (B, max_detections),
    equal to ``ops.nms.greedy_nms`` on the same inputs. Launches on the
    current stream and does not synchronise."""
    global launches, _max_candidates
    if not (boxes_xyxy.is_cuda and scores.is_cuda and valid.is_cuda):
        raise ValueError(
            "greedy_nms_cuda takes CUDA tensors only; run ops.nms.greedy_nms "
            "for tensors on the CPU")
    if boxes_xyxy.dim() != 3 or boxes_xyxy.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, N, 4), got {tuple(boxes_xyxy.shape)}")
    b, n, _ = boxes_xyxy.shape
    if scores.shape != (b, n) or valid.shape != (b, n):
        raise ValueError(
            f"scores {tuple(scores.shape)} and valid {tuple(valid.shape)} must "
            f"be ({b}, {n})")
    if n < 1 or max_detections < 1:
        raise ValueError(f"need N >= 1 and max_detections >= 1, got {n}, "
                         f"{max_detections}")
    lib = _lib()
    device = boxes_xyxy.device
    with torch.cuda.device(device):
        if _max_candidates is None:
            _max_candidates = lib.nms_greedy_max_candidates()
        if n > _max_candidates:
            raise ValueError(
                f"{n} candidates do not fit the kernel's shared memory "
                f"(at most {_max_candidates})")
        # .contiguous() of a fresh float32 tensor is 256-byte aligned, as
        # the kernel's float4 loads need
        boxes = boxes_xyxy.to(torch.float32).contiguous()
        if boxes.data_ptr() % 16:
            boxes = boxes.clone()
        scores_f = scores.to(device=device, dtype=torch.float32).contiguous()
        valid_b = valid.to(device=device, dtype=torch.bool).contiguous()
        idx = torch.empty((b, max_detections), dtype=torch.int32, device=device)
        sc = torch.empty((b, max_detections), dtype=torch.float32, device=device)
        ok = torch.empty((b, max_detections), dtype=torch.bool, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nms_greedy_launch(
            boxes.data_ptr(), scores_f.data_ptr(), valid_b.data_ptr(),
            b, n, max_detections, float(iou_threshold),
            idx.data_ptr(), sc.data_ptr(), ok.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nms_greedy kernel launch failed: CUDA error {err}")
    launches += 1
    return NMSResult(indices=idx, scores=sc, valid=ok)


def batched_class_aware_nms_cuda(
    boxes_xyxy: torch.Tensor,  # (B, N, 4) in [0, 1], CUDA
    scores: torch.Tensor,  # (B, N)
    classes: torch.Tensor,  # (B, N) int32
    valid: torch.Tensor,  # (B, N) bool
    iou_threshold: float,
    max_detections: int,
) -> Detections:
    """Class-aware NMS through the kernel: the class-offset trick, one
    launch, then the gather of the kept boxes and classes."""
    res = greedy_nms_cuda(class_offset_boxes(boxes_xyxy, classes), scores,
                          valid, iou_threshold, max_detections)
    return gather_detections(boxes_xyxy, classes, res)
