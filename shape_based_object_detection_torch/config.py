"""Typed experiment configuration (component C1 in SURVEY.md §2).

The reference uses per-run JSON files + argparse; here every run is described by
frozen dataclasses so configs are hashable (usable as jit static args) and
type-checked. The five named presets correspond to BASELINE.json's graded
configs #1-#5.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor/prior generation hyperparameters (component C11).

    For SSD the fields follow Liu et al. 2016 §2.2 (per-level scales with an
    extra sqrt(s_k * s_{k+1}) prior for ratio 1); for RetinaNet they follow
    Lin et al. 2017 §4 (3 octave scales x 3 aspect ratios per level).
    """

    # Common
    aspect_ratios: Tuple[Tuple[float, ...], ...] = ()
    # SSD-style: per-level scale fractions of image size.
    scales: Tuple[float, ...] = ()
    # RetinaNet-style: per-level base anchor size in pixels and octave scales.
    strides: Tuple[int, ...] = ()
    sizes: Tuple[float, ...] = ()
    octave_scales: Tuple[float, ...] = (1.0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
    # Box encode/decode variances (SSD convention; RetinaNet uses (1, 1)).
    variances: Tuple[float, float] = (0.1, 0.2)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Anchor<->GT assignment (component C13 — the research contribution).

    quality(a, g) = (1 - shape_weight) * IoU(a, g) + shape_weight * shape_sim(a, g)

    where shape_sim = exp(-(|log(w_a/w_g)| + |log(h_a/h_g)|) / shape_tau) measures
    pure aspect/size geometry agreement. shape_weight = 0 recovers plain-IoU
    matching (configs #1/#2/#4); config #3 trains with shape_weight > 0.
    The exact reference formula was unverifiable (SURVEY.md §7); the formula is
    isolated in ops/matching.py behind this config so it can be swapped.
    """

    pos_threshold: float = 0.5
    neg_threshold: float = 0.5  # quality below this -> background
    shape_weight: float = 0.0
    shape_tau: float = 1.0
    force_match_for_each_gt: bool = True
    # torchvision-style alias for the same mechanism (either flag enables it)
    allow_low_quality: bool = False
    # match-reduction backend: "auto" (Pallas kernel on TPU, dense jnp
    # elsewhere), "pallas", or "jnp" — same convention as ModelConfig's NMS
    # backend; both produce identical assignments (tests cross-check)
    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss selection and hyperparameters (components C14/C15)."""

    kind: str = "multibox"  # "multibox" (SSD) | "focal" (RetinaNet)
    neg_pos_ratio: float = 3.0  # hard-negative mining ratio (SSD)
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    box_loss_weight: float = 1.0
    smooth_l1_beta: float = 1.0


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Post-processing (component C16): decode -> threshold -> class-aware NMS."""

    score_threshold: float = 0.05
    nms_iou_threshold: float = 0.45
    pre_nms_top_k: int = 1000  # per image, across all classes
    max_detections: int = 200  # final top-k per image
    use_sigmoid: bool = False  # focal models score with sigmoid, SSD with softmax
    # Historical flag, now a no-op: candidate selection uses an exact
    # two-stage top-k (anchor-max prereduce; see ops/nms.py
    # select_top_candidates) that is faster than approx_max_k was and
    # bit-exact, so there is nothing to approximate away.
    approx_topk: bool = True
    # NMS backend: "auto" (the CUDA kernel for CUDA tensors, the plain
    # version for CPU tensors), "cuda" or "plain"; the reference's "pallas",
    # "scan" and "matrix" load as "cuda", "plain" and "auto"
    # (detection._NMS_BACKENDS).
    nms_backend: str = "auto"
    # Gaussian Soft-NMS (Bodla et al. 2017): > 0 decays overlapping scores by
    # exp(-iou^2/sigma) instead of hard suppression (0 = classic hard NMS).
    soft_nms_sigma: float = 0.0
    # Horizontal-flip test-time augmentation: one fused XLA program runs the
    # forward on [x, hflip(x)] as a doubled batch, mirrors the flipped
    # branch's candidate boxes back, and NMS-merges the union (2x
    # pre_nms_top_k candidates). ~2x forward cost per image; detect() output
    # shapes are unchanged. Applies to every cfg-driven detect path
    # (detect/eval/serving/export/quantized tiers).
    tta_hflip: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture selection (components C6-C10)."""

    name: str = "ssd300"
    family: str = "ssd"  # "ssd" | "retinanet"
    backbone: str = "vgg16"  # "vgg16" | "resnet50" | "resnet101"
    image_size: int = 300
    num_classes: int = 80  # foreground classes (COCO 80 / VOC 20)
    fpn_channels: int = 256
    head_depth: int = 4  # RetinaNet subnets
    width_mult: float = 1.0  # channel scaling for tiny test models
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    detect: DetectConfig = dataclasses.field(default_factory=DetectConfig)
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    # matmul/conv precision: "default" = fast MXU bf16 multiplies (production);
    # "highest" = true fp32 accumulate+multiply (torch-parity mode).
    precision: str = "default"
    # Update backbone BatchNorm statistics during training (config #4
    # from-scratch COCO training). False = frozen running stats, the standard
    # fine-tuning mode; eval/detect always use running stats either way.
    train_bn: bool = False
    # Segment-wise rematerialization: each backbone block and each FPN/head
    # application is wrapped in flax nn.remat, so only segment-boundary
    # activations survive the forward pass and everything inside a segment is
    # recomputed during backward. This is the REAL memory lever — a single
    # jax.checkpoint around the whole forward (TrainConfig.remat's legacy
    # behavior) recomputes everything at once and leaves peak backward memory
    # unchanged. train_cli promotes TrainConfig.remat to this flag.
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline (components C2-C5)."""

    dataset: str = "synthetic"  # "voc" | "coco" | "synthetic"
    root: str = ""
    max_boxes: int = 100  # fixed padding for static shapes
    batch_size: int = 8
    # Aspect-preserving letterbox resize (pad bottom/right) instead of the
    # family-default square resize (BASELINE.json:6 names letterbox in the
    # mandated preprocessing). Applies uniformly to train/eval/serving; box
    # coordinates are normalized to the canvas and mapped back via
    # ops.boxes.boxes_to_original(letterboxed=True).
    letterbox: bool = False
    # Host JPEG decode backend: "auto" uses the first-party fused
    # decode+resize C path (csrc/jpeg_decoder.cpp — libjpeg DCT-domain
    # prescale + streaming triangle resample; measured 1.2x PIL
    # single-thread at 500px sources -> 300, 1.7x at 640px -> 512, 2.3x at
    # 1600px -> 512) when it builds, falling back to PIL; "pil" forces the
    # PIL path (bit-exact with the family's PIL preprocessing); "native"
    # asserts the C path is intended (still PIL for non-JPEG files). The
    # resolved backend participates in the sample-cache fingerprint — the
    # two produce slightly different pixels.
    decode_backend: str = "auto"
    # On-device augmentation toggles (component C4)
    hflip: bool = True
    photometric: bool = True
    expand: bool = True
    random_crop: bool = True
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # Compute dtype for the on-device augmentation pipeline. "bfloat16"
    # halves the HBM traffic of the elementwise photometric chain and runs
    # the warp's row/column contractions at the MXU bf16 rate — use with
    # bf16 models (the augmented batch feeds a bf16 cast anyway); "float32"
    # is the parity/default setting.
    augment_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization loop (component C17)."""

    optimizer: str = "sgd"
    base_lr: float = 1e-3
    momentum: float = 0.9
    # dtype of the SGD momentum accumulator (optax accumulator_dtype).
    # "bfloat16" halves the optimizer state's HBM read+write per step — the
    # backward/update-pass bandwidth lever measured in
    # tools/profile_backward.py; "" keeps optax's default (= param dtype,
    # f32 here). Accuracy note: momentum is a smoothed average, so bf16's
    # 8-bit mantissa costs ~0.4% relative noise on a quantity that is itself
    # decayed 0.9 per step — measured drift on the capstone benchmark is
    # within seed noise (BASELINE.md round-4 backward section).
    momentum_dtype: str = ""
    weight_decay: float = 5e-4
    warmup_steps: int = 500
    total_steps: int = 120_000
    lr_decay_steps: Tuple[int, ...] = (80_000, 100_000)
    lr_decay_factor: float = 0.1
    grad_clip_norm: float = 10.0
    # exponential moving average of params (0 = off). Serving/eval from the
    # EMA weights is the standard detection-training stabilizer; the decay
    # applies per step: ema = d*ema + (1-d)*params.
    ema_decay: float = 0.0
    # accumulate gradients over N micro-batches before each optimizer update
    # (1 = off): config #5's global batch on fewer chips/HBM. LR schedule and
    # decay boundaries count OPTIMIZER steps, not micro-steps.
    grad_accum_steps: int = 1
    # rematerialize the forward in backward (jax.checkpoint): trades FLOPs for
    # HBM — enables 1024px large-batch training (config #5)
    remat: bool = False
    checkpoint_every: int = 1000
    checkpoint_dir: str = "/tmp/sbd_ckpt"
    keep_checkpoints: int = 3
    seed: int = 0
    # (host count is runtime state — jax.process_count() — not config; the
    # per-host Loader shard comes from parallel/mesh.py + Loader(host_id=...))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh for SPMD (SURVEY.md §2 parallelism). DP is the production
    axis; the 'model' axis is kept in the naming so TP is a config change."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallelism: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# Anchor presets
# ---------------------------------------------------------------------------

# SSD-300: 6 feature maps (38, 19, 10, 5, 3, 1); 8732 priors total.
SSD300_ANCHORS = AnchorConfig(
    scales=(0.1, 0.2, 0.375, 0.55, 0.725, 0.9, 1.075),
    aspect_ratios=(
        (1.0, 2.0, 0.5),
        (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
        (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
        (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
        (1.0, 2.0, 0.5),
        (1.0, 2.0, 0.5),
    ),
    variances=(0.1, 0.2),
)

# SSD-512: 7 feature maps (64, 32, 16, 8, 4, 2, 1); 24564 priors total.
SSD512_ANCHORS = AnchorConfig(
    scales=(0.07, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9, 1.05),
    aspect_ratios=(
        (1.0, 2.0, 0.5),
        (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
        (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
        (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
        (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
        (1.0, 2.0, 0.5),
        (1.0, 2.0, 0.5),
    ),
    variances=(0.1, 0.2),
)

# RetinaNet: P3-P7, 9 anchors per location.
RETINANET_ANCHORS = AnchorConfig(
    strides=(8, 16, 32, 64, 128),
    sizes=(32.0, 64.0, 128.0, 256.0, 512.0),
    aspect_ratios=((0.5, 1.0, 2.0),) * 5,
    octave_scales=(1.0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)),
    variances=(1.0, 1.0),
)


# ---------------------------------------------------------------------------
# Model presets
# ---------------------------------------------------------------------------

SSD300 = ModelConfig(
    name="ssd300",
    family="ssd",
    backbone="vgg16",
    image_size=300,
    anchors=SSD300_ANCHORS,
    detect=DetectConfig(score_threshold=0.01, nms_iou_threshold=0.45,
                        pre_nms_top_k=400, max_detections=200,
                        use_sigmoid=False),
)

SSD512 = ModelConfig(
    name="ssd512",
    family="ssd",
    backbone="vgg16",
    image_size=512,
    anchors=SSD512_ANCHORS,
    # approx_topk=False kept from the approx_max_k era: that op inside the
    # bf16 SSD-512 program reproducibly faulted the v5e runtime at batch 8
    # (tools/isolate_ssd512_crash.py). Selection is now exact two-stage
    # top-k everywhere, so the flag is a no-op and the fault is unreachable.
    detect=DetectConfig(score_threshold=0.01, nms_iou_threshold=0.45,
                        pre_nms_top_k=400, max_detections=200,
                        use_sigmoid=False, approx_topk=False),
)

RETINANET_R50_512 = ModelConfig(
    name="retinanet_r50_fpn",
    family="retinanet",
    backbone="resnet50",
    image_size=512,
    anchors=RETINANET_ANCHORS,
    detect=DetectConfig(score_threshold=0.05, nms_iou_threshold=0.5,
                        pre_nms_top_k=1000, max_detections=100,
                        use_sigmoid=True),
)

RETINANET_R101 = ModelConfig(
    name="retinanet_r101_fpn",
    family="retinanet",
    backbone="resnet101",
    image_size=640,
    anchors=RETINANET_ANCHORS,
    detect=DetectConfig(score_threshold=0.05, nms_iou_threshold=0.5,
                        pre_nms_top_k=1000, max_detections=100,
                        use_sigmoid=True),
)


def _preset_1() -> ExperimentConfig:
    """BASELINE config #1: SSD-300 VGG-16 single-image COCO-val inference."""
    return ExperimentConfig(
        model=SSD300,
        data=DataConfig(dataset="coco", batch_size=1),
        loss=LossConfig(kind="multibox"),
    )


def _preset_2() -> ExperimentConfig:
    """BASELINE config #2: RetinaNet R50-FPN 512px batched inference."""
    return ExperimentConfig(
        model=RETINANET_R50_512,
        data=DataConfig(dataset="coco", batch_size=32),
        loss=LossConfig(kind="focal"),
    )


def _preset_3() -> ExperimentConfig:
    """BASELINE config #3: SSD-512 VOC training, shape matching + hard-neg mining.

    shape_weight=0.3 is REFERENCE PARITY, not measured guidance: the at-scale
    ablation (BASELINE.md "Full-size shape-matching ablation", round 4) found
    w=0.3 HURTS on the aspect_std=1.2 synthetic benchmark (-0.0091 +/- 0.0049
    mAP, 5/5 paired seeds) by admitting lower-IoU anchors as positives. The
    preset keeps the reference's hyperparameters so config #3 reproduces the
    reference's behavior; for best accuracy on that benchmark set
    match.shape_weight=0.0 (see the dose-response table in BASELINE.md).
    """
    return ExperimentConfig(
        model=dataclasses.replace(SSD512, num_classes=20),
        data=DataConfig(dataset="voc", batch_size=32),
        match=MatchConfig(pos_threshold=0.5, neg_threshold=0.5,
                          shape_weight=0.3, shape_tau=1.0),
        loss=LossConfig(kind="multibox", neg_pos_ratio=3.0),
        train=TrainConfig(base_lr=1e-3, total_steps=60_000,
                          lr_decay_steps=(40_000, 50_000)),
    )


def _preset_4() -> ExperimentConfig:
    """BASELINE config #4: RetinaNet R101-FPN full COCO training."""
    return ExperimentConfig(
        model=RETINANET_R101,
        data=DataConfig(dataset="coco", batch_size=16),
        match=MatchConfig(pos_threshold=0.5, neg_threshold=0.4,
                          allow_low_quality=True),
        loss=LossConfig(kind="focal"),
        train=TrainConfig(base_lr=0.01, total_steps=90_000,
                          lr_decay_steps=(60_000, 80_000)),
    )


def _preset_5() -> ExperimentConfig:
    """BASELINE config #5: multi-host DP 1024px large-batch COCO training."""
    return ExperimentConfig(
        model=dataclasses.replace(RETINANET_R101, image_size=1024),
        data=DataConfig(dataset="coco", batch_size=256),
        match=MatchConfig(pos_threshold=0.5, neg_threshold=0.4,
                          allow_low_quality=True),
        loss=LossConfig(kind="focal"),
        train=TrainConfig(base_lr=0.04, total_steps=45_000,
                          lr_decay_steps=(30_000, 40_000),
                          remat=True),
    )


def _preset_ssd512_infer() -> ExperimentConfig:
    """COCO 80-class SSD-512 inference (the 'ssd512' model alias — mirrors
    the ssd300 alias; the VOC 20-class trainer stays at
    config3_ssd512_voc_train)."""
    return ExperimentConfig(
        model=SSD512,
        data=DataConfig(dataset="coco", batch_size=1),
        loss=LossConfig(kind="multibox"),
    )


def _preset_tiny(family: str) -> ExperimentConfig:
    """Channel-scaled miniature configs (CPU-testable; same code paths)."""
    return ExperimentConfig(
        model=tiny_test_model(family),
        data=DataConfig(dataset="synthetic", batch_size=2, max_boxes=8),
        train=TrainConfig(base_lr=0.01, warmup_steps=5, total_steps=100,
                          lr_decay_steps=(80,), checkpoint_every=50,
                          weight_decay=0.0),
        match=MatchConfig(pos_threshold=0.4, neg_threshold=0.4),
        loss=LossConfig(kind="multibox" if family == "ssd" else "focal"),
    )


PRESETS = {
    "config1_ssd300_infer": _preset_1,
    "tiny_ssd": lambda: _preset_tiny("ssd"),
    "tiny_retinanet": lambda: _preset_tiny("retinanet"),
    "config2_retinanet_r50_infer": _preset_2,
    "config3_ssd512_voc_train": _preset_3,
    "config4_retinanet_r101_coco_train": _preset_4,
    "config5_multihost_dp_train": _preset_5,
    # model-name aliases (all COCO 80-class; training presets keep their
    # config{N} names — 'ssd512' previously aliased the 20-class VOC trainer,
    # a silent class-count switch vs the SSD512 ModelConfig constant)
    "ssd300": _preset_1,
    "ssd512": _preset_ssd512_infer,
    "retinanet_r50_fpn": _preset_2,
    "retinanet_r101_fpn": _preset_4,
}


def get_config(name: str) -> ExperimentConfig:
    """Look up a named preset (BASELINE configs #1-#5 or model aliases)."""
    if name not in PRESETS:
        raise KeyError(f"unknown config {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()


# ---------------------------------------------------------------------------
# JSON serialization / overrides (the reference's per-run JSON config files)
# ---------------------------------------------------------------------------


def config_to_dict(cfg: ExperimentConfig) -> dict:
    """Plain nested dict (JSON-serializable) of the full experiment config."""
    return dataclasses.asdict(cfg)


def _coerce(value, typ):
    """Recursively rebuild dataclasses and tuples from JSON-decoded values."""
    import typing

    origin = typing.get_origin(typ)
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return _dataclass_from_dict(typ, value)
    if origin is tuple:
        if not isinstance(value, (list, tuple)):
            # Fail at the override/JSON site, not deep inside a trace:
            # 'train.lr_decay_steps=80000' must be '[80000]'.
            raise TypeError(
                f"expected a JSON list for tuple-typed field of type {typ}, "
                f"got {value!r} — write e.g. […] in the override/file")
        args = typing.get_args(typ)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        if args and len(args) == len(value):
            return tuple(_coerce(v, t) for v, t in zip(value, args))
        return tuple(value)
    if isinstance(value, list):  # untyped nesting (e.g. Tuple[Tuple[...]])
        return tuple(_coerce(v, typ) for v in value)
    return value


def _dataclass_from_dict(cls, d: dict):
    import typing

    hints = typing.get_type_hints(cls)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise KeyError(
            f"unknown {cls.__name__} field(s) {sorted(unknown)}; "
            f"valid: {sorted(known)}")
    return cls(**{k: _coerce(v, hints[k]) for k, v in d.items()})


def config_from_dict(d: dict) -> ExperimentConfig:
    """Inverse of :func:`config_to_dict`; unknown keys raise (typo guard)."""
    return _dataclass_from_dict(ExperimentConfig, d)


def save_config_file(cfg: ExperimentConfig, path: str) -> None:
    import json
    import os

    # --dump-config commonly targets the (not yet created) checkpoint dir
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)
        f.write("\n")


def load_config_file(path: str) -> ExperimentConfig:
    import json

    with open(path) as f:
        return config_from_dict(json.load(f))


def apply_overrides(cfg: ExperimentConfig, overrides) -> ExperimentConfig:
    """Apply ``section.key=value`` strings (values parsed as JSON, falling
    back to raw string): e.g. ``model.image_size=512``,
    ``data.letterbox=true``, ``train.lr_decay_steps=[100,200]``."""
    import json

    for item in overrides or ():
        path, _, raw = item.partition("=")
        if not _:
            raise ValueError(f"override {item!r} is not of the form key=value")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        keys = path.strip().split(".")
        d = config_to_dict(cfg)
        node = d
        for k in keys[:-1]:
            if k not in node:
                raise KeyError(f"unknown config section {k!r} in {item!r}")
            node = node[k]
        if keys[-1] not in node:
            raise KeyError(f"unknown config field {path!r}")
        node[keys[-1]] = value
        cfg = config_from_dict(d)
    return cfg


def resolve_config(name_or_path: str, overrides=()) -> ExperimentConfig:
    """CLI entry: a preset name or a path to a JSON config file (the
    reference's per-run JSON config style), plus dotted overrides."""
    import os

    if name_or_path.endswith(".json") or os.path.sep in name_or_path:
        cfg = load_config_file(name_or_path)
    else:
        cfg = get_config(name_or_path)
    return apply_overrides(cfg, overrides)


def tiny_test_model(family: str = "ssd") -> ModelConfig:
    """A channel-scaled miniature model for CPU tests (same code paths)."""
    if family == "ssd":
        return dataclasses.replace(
            SSD300, name="ssd300_tiny", width_mult=0.125, num_classes=4,
            precision="highest",
            detect=dataclasses.replace(SSD300.detect, approx_topk=False),
        )
    return dataclasses.replace(
        RETINANET_R50_512, name="retinanet_tiny", width_mult=0.125,
        image_size=128, fpn_channels=32, head_depth=1, num_classes=4,
        precision="highest",
        detect=dataclasses.replace(RETINANET_R50_512.detect, approx_topk=False),
    )
