"""Greedy NMS on the card: the wrapper of the hand-written CUDA kernel
``csrc/nms_greedy.cu``, which replaces the JAX package's Pallas kernel
(``ops/nms_pallas.py``).

The kernel sorts each image's live candidates and picks by one of two
routes, chosen by N (candidates per image) inside the launch:

- the bitmask route, N <= ``BITMASK_MAX_CANDIDATES``: the sort in static
  shared memory, the IoU bitmask over the whole card, and a sweep with one
  warp per image (three launches);
- the walk route, above: the sort's keys in dynamic shared memory or, past
  16384, in global scratch, then one block per image that tests each word of
  64 sorted candidates against the picks kept so far, which it keeps in
  global scratch (two launches). Its scratch is linear in N, where the
  bitmask is quadratic.

Both reproduce ``ops.nms.greedy_nms`` bit for bit. These functions take CUDA
tensors only: a CPU tensor raises (the plain version in ``ops/nms.py`` is
what runs on the CPU, chosen by the caller from the tensors' device).
Nothing here falls back. The kernel is built at first use
(``utils/native.py``); importing this module needs neither nvcc nor a card.

Importing it also registers the PyTorch op ``sbd::greedy_nms``, which
dispatches by device: the kernel for CUDA tensors, ``ops.nms.greedy_nms``
for the others. A traced program (``torch.export``, ``export.py``) records
the op as one node, so the program runs the kernel wherever it runs on the
card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from shape_based_object_detection_torch.ops.nms import (
    Detections, NMSResult, class_offset_boxes, gather_detections, greedy_nms,
)
from shape_based_object_detection_torch.utils import native

# Launches of the kernel since the process started (or the last reset by a
# caller that wants to see whether a run went through it).
launches = 0

# The most candidates per image of the bitmask route (kMaxN in
# nms_greedy.cu, which decides the route; ``route`` asks it): its sort holds
# one 64-bit key per candidate, padded to a power of two, in 32 KB of static
# shared memory, and at that N the IoU bitmask is N * ceil(N / 64) * 8 bytes
# = 2 MiB per image. Above it the walk route runs.
BITMASK_MAX_CANDIDATES = 4096
# The most candidates per image either route takes (kLargestN): the kernels
# index candidates with int.
LARGEST_N = 1 << 30

_ALIGN = 16  # the kernel reads and writes boxes as float4


def _lib() -> ctypes.CDLL:
    lib = native.load("nms_greedy")
    if not getattr(lib, "_sbd_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nms_greedy_launch.argtypes = [p, p, p, i, i, i, ctypes.c_float,
                                          p, p, p, p, p]
        lib.nms_greedy_launch.restype = i
        lib.nms_greedy_scratch_bytes.argtypes = [i, i, i]
        lib.nms_greedy_scratch_bytes.restype = ctypes.c_size_t
        lib.nms_greedy_route.argtypes = [i]
        lib.nms_greedy_route.restype = i
        lib._sbd_typed = True
    return lib


def route(n: int) -> str:
    """The kernel's route for ``n`` candidates per image, as the launch
    chooses it: "bitmask" or "walk" (builds the kernel)."""
    return ("bitmask", "walk")[_lib().nms_greedy_route(n)]


def scratch_bytes(b: int, n: int, m: int) -> int:
    """Bytes of device scratch one call at (B, N, M) allocates (the kernel's
    own layout; builds the kernel)."""
    return int(_lib().nms_greedy_scratch_bytes(b, n, m))


def greedy_nms_cuda(
    boxes_xyxy: torch.Tensor,  # (B, N, 4) CUDA
    scores: torch.Tensor,  # (B, N)
    valid: torch.Tensor,  # (B, N) bool
    iou_threshold: float,
    max_detections: int,
) -> NMSResult:
    """Batched single-class greedy NMS in one call of the kernel: the
    bitmask route's sort, mask and sweep for N <= ``BITMASK_MAX_CANDIDATES``
    candidates per image, the walk route's sort and walk above, launched
    together. Returns (indices int32, scores float32, valid bool), each (B,
    max_detections), equal to ``ops.nms.greedy_nms`` on the same inputs.
    Launches on the current stream and does not synchronise. Raises on
    malformed input only: not CUDA tensors, shapes that disagree, N or
    max_detections below 1, N above ``LARGEST_N``."""
    global launches
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
    if n > LARGEST_N:
        raise ValueError(f"{n} candidates per image: the kernel indexes at most "
                         f"{LARGEST_N}")
    lib = _lib()
    device = boxes_xyxy.device
    with torch.cuda.device(device):
        # .contiguous() of a fresh float32 tensor is 256-byte aligned, as
        # the kernel's float4 loads need
        boxes = boxes_xyxy.to(torch.float32).contiguous()
        if boxes.data_ptr() % _ALIGN:
            boxes = boxes.clone()
        scores_f = scores.to(device=device, dtype=torch.float32).contiguous()
        valid_b = valid.to(device=device, dtype=torch.bool).contiguous()
        idx = torch.empty((b, max_detections), dtype=torch.int32, device=device)
        sc = torch.empty((b, max_detections), dtype=torch.float32, device=device)
        ok = torch.empty((b, max_detections), dtype=torch.bool, device=device)
        # one buffer, laid out by the kernel: the sorted boxes, order and
        # live counts, then the bitmask route's mask or the walk route's
        # picks and, where they do not fit shared memory, its keys
        scratch = torch.empty(lib.nms_greedy_scratch_bytes(b, n, max_detections),
                              dtype=torch.uint8, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nms_greedy_launch(
            boxes.data_ptr(), scores_f.data_ptr(), valid_b.data_ptr(),
            b, n, max_detections, float(iou_threshold), scratch.data_ptr(),
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


@torch.library.custom_op("sbd::greedy_nms", mutates_args=())
def greedy_nms_op(boxes_xyxy: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float, max_detections: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``sbd::greedy_nms``: (B, N, 4), (B, N), (B, N) bool -> (indices
    int32, scores float32, valid bool), each (B, max_detections). This body
    is the implementation for every device but CUDA: the plain version."""
    return tuple(greedy_nms(boxes_xyxy, scores, valid, iou_threshold, max_detections))


@greedy_nms_op.register_kernel("cuda")
def _greedy_nms_op_cuda(boxes_xyxy, scores, valid, iou_threshold, max_detections):
    return tuple(greedy_nms_cuda(boxes_xyxy, scores, valid, iou_threshold, max_detections))


@greedy_nms_op.register_fake
def _greedy_nms_op_fake(boxes_xyxy, scores, valid, iou_threshold, max_detections):
    shape = (boxes_xyxy.shape[0], max_detections)
    return (boxes_xyxy.new_empty(shape, dtype=torch.int32),
            boxes_xyxy.new_empty(shape, dtype=torch.float32),
            boxes_xyxy.new_empty(shape, dtype=torch.bool))


def batched_class_aware_nms_op(boxes_xyxy, scores, classes, valid, iou_threshold: float,
                               max_detections: int) -> Detections:
    """Class-aware NMS through ``sbd::greedy_nms``: the kernel on the card,
    the plain version elsewhere."""
    res = NMSResult(*torch.ops.sbd.greedy_nms(class_offset_boxes(boxes_xyxy, classes),
                                              scores, valid, iou_threshold, max_detections))
    return gather_detections(boxes_xyxy, classes, res)
