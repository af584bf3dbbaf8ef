"""End-to-end inference (port of the JAX package's ``detection.py``).

normalize -> backbone/FPN/heads -> exact two-stage top-k candidate selection
-> decode of only the K winners -> class-aware NMS -> fixed-size
``Detections`` with a valid mask. Every step runs on the module's device
and nothing synchronises with the host until the caller reads the result.
The NMS is the op ``sbd::greedy_nms`` (``ops/nms_cuda.py``): the CUDA
kernel on the card, the plain version (``ops/nms.py``) on the CPU.
Soft-NMS is the alternative a config may pick.

Test-time augmentation: hflip (one forward on the doubled batch, the two
candidate sets merged by one NMS) and multi-scale (one detect per scale on
shared weights, merged by one NMS), as the reference's float tier.

Under a mesh with a model axis (``make_detect_fn(..., mesh=)``) each rank
of a model group runs the forward on its rows of the images and gets the
whole images' head outputs; candidate selection and NMS then run on them on
every rank of the group, alike. So do hflip TTA (the flip is of columns,
which every rank holds whole), multi-scale TTA (each scale's images are
resized whole, then split) and the int8 tiers.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from shape_based_object_detection_torch.config import DataConfig, ModelConfig
from shape_based_object_detection_torch.ops import boxes as box_ops
from shape_based_object_detection_torch.ops import nms as nms_lib
from shape_based_object_detection_torch.ops import nms_cuda
from shape_based_object_detection_torch.utils import image as image_lib
from shape_based_object_detection_torch.utils import metrics as trace
from shape_based_object_detection_torch.utils.device import resolve_device

# DetectConfig.nms_backend values -> the greedy NMS routes. "pallas", "scan"
# and "matrix" are the reference's names, so its configs load unchanged. The reference's "matrix" backend is a
# round-based formulation of the same greedy NMS for the TPU's matrix unit;
# here it runs as "auto" does (the kernel on the card is faster, PERF.md).
# One deliberate difference: a zero-area candidate, whose IoU with itself
# is 0, is picked again by greedy NMS but only once by the reference's rounds.
_NMS_BACKENDS = {
    "auto": nms_cuda.batched_class_aware_nms_op, "matrix": nms_cuda.batched_class_aware_nms_op,
    "cuda": nms_cuda.batched_class_aware_nms_cuda, "pallas": nms_cuda.batched_class_aware_nms_cuda,
    "plain": nms_lib.batched_class_aware_nms, "scan": nms_lib.batched_class_aware_nms}


def select_candidates(
    cls_logits: torch.Tensor,  # (B, A, K)
    box_offsets: torch.Tensor,  # (B, A, 4)
    anchors_cxcywh: torch.Tensor,  # (A, 4)
    cfg: ModelConfig,
):
    """Exact two-stage top-k candidate selection and deferred decode.
    Returns ``(boxes_xyxy, scores, classes, valid)``, each
    ``(B, pre_nms_top_k, ...)``, with boxes clipped to [0, 1]."""
    det = cfg.detect
    if det.use_sigmoid:
        # sigmoid is monotonic: select on raw logits, activate the K winners
        sel_scores, activation = cls_logits, torch.sigmoid
    else:
        # softmax couples the classes of an anchor: activate before selection
        sel_scores, activation = torch.softmax(cls_logits, dim=-1)[..., 1:], None
    batch = cls_logits.shape[0]
    pairs = box_offsets.shape[1] * sel_scores.shape[-1]
    anchor_idx, cand_scores, cand_classes, cand_valid = (
        nms_lib.select_top_candidate_pairs(
            sel_scores, det.score_threshold, det.pre_nms_top_k,
            activation=activation,
            # the reference's batch-aware choice of strategy
            two_stage=(pairs >= 2_000_000 or batch >= 4)))

    # Decode is row-wise, so decoding the K winners equals decoding all A
    # anchors and gathering, without the (B, A, 4) pass.
    cand_offsets = box_offsets.gather(
        1, anchor_idx[..., None].expand(*anchor_idx.shape, 4))
    cand_anchors = anchors_cxcywh[anchor_idx]
    decoded = box_ops.decode_boxes(cand_offsets, cand_anchors,
                                   cfg.anchors.variances)
    cand_boxes = box_ops.clip_boxes(box_ops.cxcywh_to_xyxy(decoded))
    return cand_boxes, cand_scores, cand_classes, cand_valid


def run_nms(
    cand_boxes: torch.Tensor,  # (B, N, 4) xyxy in [0, 1]
    cand_scores: torch.Tensor,  # (B, N)
    cand_classes: torch.Tensor,  # (B, N) int32
    cand_valid: torch.Tensor,  # (B, N) bool
    cfg: ModelConfig,
    backend: str | None = None,
) -> nms_lib.Detections:
    """Class-aware NMS over a candidate set, which need not be sorted: every
    backend selects by argmax. ``cfg.detect.soft_nms_sigma > 0`` runs
    Soft-NMS (``ops/nms.py``) whatever the backend. Otherwise ``backend``
    (default ``cfg.detect.nms_backend``): "auto" runs the op
    ``sbd::greedy_nms``, which is the CUDA kernel for CUDA tensors and the
    plain version for CPU tensors; "cuda" (or the reference's "pallas")
    always the kernel, which raises on CPU tensors; "plain" (or "scan")
    always the plain version; the reference's "matrix" as "auto"."""
    det = cfg.detect
    if det.soft_nms_sigma > 0:
        return nms_lib.batched_class_aware_soft_nms(
            cand_boxes, cand_scores, cand_classes, cand_valid,
            sigma=det.soft_nms_sigma, score_threshold=det.score_threshold,
            max_detections=det.max_detections)
    backend = backend or det.nms_backend
    if backend not in _NMS_BACKENDS:
        raise ValueError(f"unknown nms_backend {backend!r}")
    return _NMS_BACKENDS[backend](cand_boxes, cand_scores, cand_classes, cand_valid,
                                  det.nms_iou_threshold, det.max_detections)


def postprocess(cls_logits, box_offsets, anchors_cxcywh,
                cfg: ModelConfig) -> nms_lib.Detections:
    """Decode + score + class-aware NMS. Labels are 0-based foreground ids."""
    with trace.span("detect.select"):
        cands = select_candidates(cls_logits, box_offsets, anchors_cxcywh, cfg)
    with trace.span("detect.nms"):
        return run_nms(*cands, cfg)


def mirror_boxes_x(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """Reflect normalized xyxy boxes across the vertical midline (x -> 1 - x),
    swapping x0 and x1 so x0 <= x1 holds. An involution."""
    x0, y0, x1, y1 = boxes_xyxy.unbind(-1)
    return torch.stack([1.0 - x1, y0, 1.0 - x0, y1], dim=-1)


def tta_hflip_candidates(cls_logits, box_offsets, anchors_cxcywh,
                         cfg: ModelConfig):
    """The merged candidate set of hflip TTA: the first half of the batch is
    the original orientation, the second the flipped copy. Each half goes
    through the exact two-stage selection, the flipped half's boxes are
    mirrored back, and the two sets are concatenated along the candidates
    (2 * pre_nms_top_k per image, unsorted)."""
    b = cls_logits.shape[0] // 2
    bo, so, co, vo = select_candidates(cls_logits[:b], box_offsets[:b],
                                       anchors_cxcywh, cfg)
    bf, sf, cf, vf = select_candidates(cls_logits[b:], box_offsets[b:],
                                       anchors_cxcywh, cfg)
    return (torch.cat([bo, mirror_boxes_x(bf)], 1), torch.cat([so, sf], 1),
            torch.cat([co, cf], 1), torch.cat([vo, vf], 1))


def postprocess_tta_hflip(cls_logits, box_offsets, anchors_cxcywh,
                          cfg: ModelConfig) -> nms_lib.Detections:
    """Merge-postprocess for hflip TTA: one class-aware NMS over the union of
    both halves' candidates (``tta_hflip_candidates``). The output is
    flip-equivariant by construction."""
    with trace.span("detect.select"):
        cands = tta_hflip_candidates(cls_logits, box_offsets, anchors_cxcywh, cfg)
    with trace.span("detect.nms"):
        return run_nms(*cands, cfg)


class DetectProgram(nn.Module):
    """detect as one module: normalize -> backbone/heads -> postprocess
    (``postprocess_tta_hflip`` on the doubled batch ``[x, hflip(x)]`` when
    ``cfg.detect.tta_hflip``). Takes (B, S, S, 3) uint8, or float in [0,
    1], on the module's device; returns ``(boxes, scores, labels, valid)``.
    ``make_detect_fn`` runs it eagerly and ``export.export_detect`` traces
    it: the live and the exported program are one. While a profiler
    records, its phases are spans (``utils/metrics``): ``detect.forward``,
    ``detect.select`` and ``detect.nms``; a traced program holds none."""

    def __init__(self, module: nn.Module, anchors_cxcywh: torch.Tensor, cfg: ModelConfig,
                 data_cfg: DataConfig | None = None, row_shard=None):
        super().__init__()
        self.module = module
        self.row_shard = row_shard
        self.register_buffer("anchors", anchors_cxcywh)
        self.cfg = cfg
        self.mean = tuple(data_cfg.mean if data_cfg else image_lib.IMAGENET_MEAN)
        self.std = tuple(data_cfg.std if data_cfg else image_lib.IMAGENET_STD)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        tta = self.cfg.detect.tta_hflip
        with trace.span("detect.forward"):
            x = image_lib.normalize_images(images, self.mean, self.std)
            if tta:  # one doubled-batch forward; W is dim 2 of NHWC
                x = torch.cat([x, x.flip(2)], 0)
            x = x.permute(0, 3, 1, 2)
            if self.row_shard is not None:
                x = self.row_shard.split(x)
            cls_logits, box_offsets = self.module(x)
        post = postprocess_tta_hflip if tta else postprocess
        return tuple(post(cls_logits, box_offsets, self.anchors, self.cfg))


def module_device(module: nn.Module) -> torch.device:
    """The device of a module's first parameter or buffer."""
    return next(itertools.chain(module.parameters(), module.buffers())).device


def make_detect_fn(module, anchors_cxcywh: torch.Tensor, cfg: ModelConfig,
                   data_cfg: DataConfig | None = None, device=None, mesh=None):
    """Returns ``detect(images) -> Detections``, which runs ``DetectProgram``
    (``detect.program``) eagerly.

    ``images``: (B, H, W, 3) uint8 (numpy or tensor) with H = W =
    ``cfg.image_size``, or float already in [0, 1]; normalization runs on
    the device. ``module`` and ``anchors_cxcywh`` come from ``build_model``
    (or ``quantize.quantize_module``) on the same ``device`` (default: the
    card). With ``cfg.detect.tta_hflip`` one forward runs on the doubled
    batch ``[x, hflip(x)]`` and ``postprocess_tta_hflip`` merges the halves.

    With a ``parallel.Mesh`` whose model axis has more than one rank, every
    rank of a model group passes the same images (its data index's); each
    runs the forward on its rows (``set_row_shard`` on ``module``), and
    each returns the images' detections, hflip TTA and an int8 ``module``
    included. Gathering the data indexes' detections is the caller's
    (``parallel.mesh.all_gather_rows``)."""
    from shape_based_object_detection_torch.parallel.mesh import spatial_image_sharding
    from shape_based_object_detection_torch.parallel.spatial import set_row_shard

    dev = resolve_device(device if mesh is None or device is not None else mesh.device)
    if module_device(module) != dev or anchors_cxcywh.device != dev:
        raise ValueError(
            f"detect on {dev} needs the module and anchors there; they are on "
            f"{module_device(module)} and {anchors_cxcywh.device}")
    shard = None
    if mesh is not None and mesh.model_parallelism > 1:
        shard = spatial_image_sharding(mesh, model=cfg)
        set_row_shard(module, shard)
    program = DetectProgram(module, anchors_cxcywh, cfg, data_cfg, shard)

    @torch.inference_mode()
    def detect(images) -> nms_lib.Detections:
        return nms_lib.Detections(*program(torch.as_tensor(images).to(dev, non_blocking=True)))

    detect.program = program  # what serving captures as a CUDA graph
    return detect


def _build_scale_programs(module, model_cfg: ModelConfig, scales,
                          data_cfg: DataConfig | None, device, quantize="",
                          activation_scales=None, mesh=None):
    """One detect per scale, all on ``module``'s weights, and the cross-scale
    merge. Each scale's module is built on the meta device first (shapes
    only, no arithmetic): a scale whose ``state_dict`` shapes differ from
    ``module``'s (SSD's extras and heads depend on the image size) raises,
    naming it. Another scale's module shares the base module's tensors.

    ``quantize`` ("", "weights", "full") serves every scale in that int8
    tier from one quantized copy of ``module``: its int8 tensors are shared
    as the float ones are. ``activation_scales`` (dict or JSON path) makes
    "full" static; the scales are per tensor, with no spatial extent, so
    scales calibrated at the base size apply at every scale. Under a
    ``mesh`` with a model axis every scale's detect splits its images' rows
    (``make_detect_fn``), whether they split evenly or not.
    Returns ``([(detect, scale), ...], merge)``."""
    from shape_based_object_detection_torch import quantize as quantize_lib
    from shape_based_object_detection_torch.models.factory import build_module
    from shape_based_object_detection_torch.ops import anchors as anchor_lib

    dev = resolve_device(device)
    quantize = quantize_lib.normalize_quantize_mode(quantize)
    if activation_scales is not None and quantize != "full":
        raise ValueError("activation_scales only applies to quantize mode 'full'")
    if isinstance(activation_scales, str):
        activation_scales = quantize_lib.load_activation_scales(activation_scales)
    weights = module.state_dict()
    want = {k: tuple(v.shape) for k, v in weights.items()}
    modules = []
    for s in scales:  # every scale is checked before any is built
        scfg = dataclasses.replace(model_cfg, image_size=s)
        err = (f"multi-scale TTA: scale {s} changes the model's parameter plan "
               f"(family {model_cfg.family!r} is not scale-agnostic: SSD's "
               "extras and heads depend on image_size), so the shared weights "
               "cannot serve it. Use scales that keep the plan, or a RetinaNet "
               "config (ResNet, FPN and shared subnets work at any size).")
        try:
            with torch.device("meta"):
                smodule = build_module(scfg)
        except Exception as e:
            raise ValueError(f"{err} (build error: {e})") from e
        if {k: tuple(v.shape) for k, v in smodule.state_dict().items()} != want:
            raise ValueError(err)
        modules.append((scfg, smodule))
    base = module
    if quantize:
        base = quantize_lib.quantize_module(module, quantize, activation_scales, device=dev)
        weights = base.state_dict()
    per_scale = []
    for scfg, smodule in modules:
        if scfg.image_size == model_cfg.image_size:
            smodule = base
        else:  # the same tensors, in the module built for this scale
            if quantize:
                smodule = quantize_lib._quantized_copy(smodule, quantize, activation_scales)
            smodule.load_state_dict(weights, strict=True, assign=True)
            smodule.eval()
        anchors = anchor_lib.anchors_for_model(scfg).to(dev)
        per_scale.append((make_detect_fn(smodule, anchors, scfg, data_cfg, dev, mesh),
                          scfg.image_size))

    def merge(boxes, scores, classes, valid) -> nms_lib.Detections:
        return run_nms(boxes, scores, classes, valid, model_cfg)

    return per_scale, merge


def _concat(parts, corrections=None) -> Tuple[torch.Tensor, ...]:
    """Per-scale Detections -> one candidate set along the detections."""
    corrections = corrections or [None] * len(parts)
    return (torch.cat([d.boxes if c is None else d.boxes * c
                       for d, c in zip(parts, corrections)], 1),
            torch.cat([d.scores for d in parts], 1),
            torch.cat([d.labels for d in parts], 1),
            torch.cat([d.valid for d in parts], 1))


class MultiScaleBatchDetector:
    """Batched multi-scale TTA for evaluation (``eval_cli --tta-scales``).

    Takes the input pipeline's (B, S, S, 3) uint8 batch at the base size S
    and uploads it once; each other scale resizes the whole canvas on the
    device (``utils.image.resize_images``) ahead of its forward on the
    shared weights. Per-scale detections are in normalized coordinates, so
    one class-aware NMS over their concatenation merges them: S + 1 NMS
    calls per batch. As the resize covers the whole canvas, a letterboxed
    base keeps its content fraction at every scale. For a real dataset
    the non-base scales see base -> scale pixels (two resamples), not
    original -> scale. Composes with hflip TTA through
    ``model_cfg.detect.tta_hflip``, and with the int8 tiers through
    ``quantize`` / ``activation_scales`` (one quantized copy serves every
    scale). Under a ``mesh`` with a model axis every rank of a model group
    passes its data index's images, resized whole on every rank, and each
    scale's forward splits their rows; the merge runs alike on every rank.
    """

    def __init__(self, model_cfg: ModelConfig, module, scales,
                 data_cfg: DataConfig | None = None, device=None,
                 quantize: bool | str = "", activation_scales=None, mesh=None):
        if not scales:
            raise ValueError("scales must name at least one image size")
        self.scales = tuple(int(s) for s in scales)
        self.device = resolve_device(device)
        per_scale, self._merge = _build_scale_programs(
            module, model_cfg, self.scales, data_cfg, self.device, quantize,
            activation_scales, mesh)
        base = model_cfg.image_size
        self._fns = [fn if s == base else self._with_resize(fn, s)
                     for fn, s in per_scale]

    @staticmethod
    def _with_resize(fn, s: int):
        def scaled(images):
            x = images.to(torch.float32)
            if images.dtype == torch.uint8:
                x = x / 255.0  # then normalize_images skips its /255
            return fn(image_lib.resize_images(x, s))

        return scaled

    def scale_detections(self, images) -> list:
        """Each scale's Detections of the batch, before the merge."""
        x = torch.as_tensor(images).to(self.device, non_blocking=True)
        with torch.inference_mode():
            return [fn(x) for fn in self._fns]

    def __call__(self, images) -> nms_lib.Detections:
        parts = self.scale_detections(images)
        if len(parts) == 1:
            return parts[0]
        with torch.inference_mode():
            return self._merge(*_concat(parts))


class MultiScaleDetector:
    """Multi-scale TTA for one image of any size, composable with hflip TTA
    through ``model_cfg.detect.tta_hflip``.

    Each scale resizes the image on the host (PIL BILINEAR, or letterbox)
    and runs its own detect on the shared weights; the per-scale detections
    are in normalized coordinates and one class-aware NMS over their union
    merges them. Every requested scale is checked against the weights as
    ``MultiScaleBatchDetector`` does; ``quantize`` / ``activation_scales``
    select an int8 tier, as there.
    """

    def __init__(self, model_cfg: ModelConfig, module, scales,
                 data_cfg: DataConfig | None = None, device=None,
                 letterbox: bool = False, quantize: bool | str = "",
                 activation_scales=None):
        if not scales:
            raise ValueError("scales must name at least one image size")
        self.scales = tuple(int(s) for s in scales)
        self.letterbox = letterbox
        self.device = resolve_device(device)
        self._per_scale, self._merge = _build_scale_programs(
            module, model_cfg, self.scales, data_cfg, self.device, quantize,
            activation_scales)

    def __call__(self, image_np: np.ndarray) -> Tuple[np.ndarray, ...]:
        """(H, W, 3) uint8 image -> (boxes_px, scores, labels) in original
        pixel coordinates, merged across scales."""
        h, w = image_np.shape[:2]
        parts, corrections = [], []
        for fn, s in self._per_scale:
            if self.letterbox:
                batch = image_lib.letterbox_image_host(image_np, s)[None]
                # the letterbox rounds the content to whole pixels per scale
                # (nw = round(w * s / m)), while the merge and the mapping
                # back use one frame (x * max(h, w)): rescale each scale's
                # boxes to the exact x / m frame, so near-duplicates across
                # scales align for the merge
                m = max(h, w)
                nh, nw = max(1, round(h * s / m)), max(1, round(w * s / m))
                cx, cy = s * w / (nw * m), s * h / (nh * m)
                corrections.append(torch.tensor([cx, cy, cx, cy],
                                                dtype=torch.float32, device=self.device))
            else:
                batch = _resize_host(image_np, s)[None]
                corrections.append(None)
            parts.append(fn(batch))
        with torch.inference_mode():
            det = self._merge(*_concat(parts, corrections))
        return _unpack_one(det, h, w, self.letterbox)


def _resize_host(image_np: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image

    return np.array(Image.fromarray(image_np).resize((size, size), Image.BILINEAR),
                    dtype=np.uint8)


def _unpack_one(det: nms_lib.Detections, h: int, w: int, letterbox: bool):
    valid = det.valid[0].cpu().numpy()
    boxes = box_ops.boxes_to_original(det.boxes[0].cpu(), h, w, letterbox).numpy()
    return (boxes[valid], det.scores[0].cpu().numpy()[valid],
            det.labels[0].cpu().numpy()[valid])


def detect_single_image(detect_fn, image_np: np.ndarray, image_size: int,
                        letterbox: bool = False) -> Tuple[np.ndarray, ...]:
    """(H, W, 3) uint8 image of any size -> (boxes_px, scores, labels) in
    original pixel coordinates: a host resize to ``image_size`` (PIL
    BILINEAR, or letterbox), then ``detect_fn``."""
    h, w = image_np.shape[:2]
    if letterbox:
        batch = image_lib.letterbox_image_host(image_np, image_size)[None]
    else:
        batch = _resize_host(image_np, image_size)[None]
    return _unpack_one(detect_fn(batch), h, w, letterbox)
