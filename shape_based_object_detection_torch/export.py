"""Ahead-of-time export of detect to a standalone artifact (port of the JAX
package's ``export.py``).

``torch.export`` traces the detect program (``detection.DetectProgram``:
normalize -> backbone/heads -> candidate selection -> class-aware NMS) at
one batch shape, with the weights, and in an int8 tier the int8 tensors,
as the program's constants. A serving process runs it with no
model-building code. The NMS is the op ``sbd::greedy_nms``, the int8
product ``sbd::int8_conv2d`` and each frozen BatchNorm with what follows it
``sbd::frozen_bn_act`` or ``sbd::frozen_bn_add_relu``, so a loaded program
runs the CUDA kernels K1 and K3 (and cuBLASLt's int8 GEMM) on the card, and
their plain versions on the CPU. An artifact exported on one device is
moved to the other at load
(``torch.export.passes.move_to_device_pass``): the counterpart of the
reference's multi-platform StableHLO.

The artifact is one ``bytes`` blob, saved as ``*.sbdx``: magic | header
length (8 bytes, little-endian) | header JSON | ``torch.export.save``
payload. Its magic differs from the reference's StableHLO artifact's, and
each package's loader refuses the other's blob.

cuDNN's TF32 switch for float32 convolutions is process-wide and not part
of a traced graph: the header records the model's precision, and
``LoadedModel`` runs the program under it.
"""

from __future__ import annotations

import dataclasses
import io
import json

import torch

from shape_based_object_detection_torch.config import DataConfig, ModelConfig
from shape_based_object_detection_torch.ops.nms import Detections
from shape_based_object_detection_torch.utils.device import resolve_device

MAGIC = b"SBDXPT01"
# the JAX package's StableHLO artifacts
REFERENCE_MAGIC = b"SBDX0001"


def export_detect(module, anchors_cxcywh: torch.Tensor, cfg: ModelConfig,
                  data_cfg: DataConfig | None = None, batch_size: int = 8,
                  device=None, quantize: bool = False, int8_activations: bool = False,
                  activation_scales=None) -> bytes:
    """Export detect for a fixed batch of (batch_size, S, S, 3) uint8 images
    on ``device`` (default: the card; ``module`` and the anchors must be
    there), with its weights. ``quantize=True`` bakes the weight-only int8
    tier in, ``int8_activations=True`` the full tier (dynamic, or static
    with ``activation_scales``: a calibration dict or the path of its JSON).
    Returns the artifact's bytes. The artifact is a program for one device,
    as the reference's: a module split by rows over a model axis exports
    the unsplit program of the same weights (a copy with its row shard
    cleared), equal to the unsplit module's artifact."""
    from shape_based_object_detection_torch.detection import DetectProgram, module_device
    from shape_based_object_detection_torch.parallel import spatial
    from shape_based_object_detection_torch.quantize import (
        load_activation_scales, quantize_module,
    )

    if spatial.row_shard_of(module) is not None:
        module = spatial.copy_module(module, None)
    if int8_activations and not quantize:
        raise ValueError("int8_activations=True requires quantize=True (it is a tier on "
                         "top of int8 weights)")
    if activation_scales is not None and not int8_activations:
        raise ValueError("activation_scales requires int8_activations=True")
    dev = resolve_device(device)
    if module_device(module) != dev or anchors_cxcywh.device != dev:
        raise ValueError(f"export on {dev} needs the module and anchors there; they are "
                         f"on {module_device(module)} and {anchors_cxcywh.device}")
    if isinstance(activation_scales, str):
        activation_scales = load_activation_scales(activation_scales)
    if quantize:
        module = quantize_module(module, "full" if int8_activations else "weights",
                                 activation_scales, device=dev)
    program = DetectProgram(module, anchors_cxcywh, cfg, data_cfg).eval()
    size = cfg.image_size
    example = torch.zeros((batch_size, size, size, 3), dtype=torch.uint8, device=dev)
    with torch.no_grad():
        exported = torch.export.export(program, (example,), strict=False)
    payload = io.BytesIO()
    torch.export.save(exported, payload)
    header = json.dumps({
        "model": cfg.name,
        "image_size": size,
        "batch_size": batch_size,
        # the device it was traced on; load_artifact moves it to the other
        "device": str(dev),
        "platforms": ["cuda", "cpu"],
        "num_classes": cfg.num_classes,
        "dtype": cfg.dtype,
        "precision": cfg.precision,
        "quantized": bool(quantize),
        "int8_activations": bool(quantize and int8_activations),
        "activation_scale_mode": (
            "" if not (quantize and int8_activations)
            else "static" if activation_scales is not None else "dynamic"),
        # serving-side prepare/unpack must match the preprocessing the
        # weights were trained with (ArtifactPredictor reads this)
        "letterbox": bool(data_cfg.letterbox) if data_cfg else False,
        "outputs": ["boxes", "scores", "labels", "valid"],
        "torch_version": torch.__version__,
    }).encode()
    return MAGIC + len(header).to_bytes(8, "little") + header + payload.getvalue()


@dataclasses.dataclass
class LoadedModel:
    """A deserialized detect artifact: callable without any model code."""

    header: dict
    program: torch.export.ExportedProgram
    device: torch.device

    def __post_init__(self):
        self._call = self.program.module()

    def __call__(self, images) -> Detections:
        """images: (batch_size, S, S, 3) uint8, numpy or tensor -> Detections
        on ``device``, computed under the exported model's precision."""
        from shape_based_object_detection_torch.models.retinanet import conv_precision

        x = torch.as_tensor(images).to(self.device, non_blocking=True)
        with torch.inference_mode(), conv_precision(self.header["precision"]):
            return Detections(*self._call(x))


def load_detect(blob: bytes, device=None) -> LoadedModel:
    """Deserialize an ``export_detect`` artifact onto ``device`` (default:
    the card), moving it there when it was exported on another device."""
    # registers sbd::greedy_nms, sbd::int8_conv2d and sbd::frozen_bn_*, which
    # the program calls
    from shape_based_object_detection_torch import quantize  # noqa: F401
    from shape_based_object_detection_torch.ops import frozen_bn_cuda, nms_cuda  # noqa: F401

    if blob[:8] == REFERENCE_MAGIC:
        raise ValueError(
            f"this is an artifact of the JAX package (StableHLO, magic {REFERENCE_MAGIC!r}); "
            f"the port loads its own torch.export artifacts (magic {MAGIC!r}): export the "
            "model with shape_based_object_detection_torch.tools.export_model")
    if blob[:8] != MAGIC:
        raise ValueError(f"not an SBDX artifact of the port (bad magic {blob[:8]!r})")
    hlen = int.from_bytes(blob[8:16], "little")
    if len(blob) < 16 + hlen:
        raise ValueError("truncated SBDX artifact")
    header = json.loads(blob[16:16 + hlen].decode())
    dev = resolve_device(device)
    program = torch.export.load(io.BytesIO(blob[16 + hlen:]))
    if torch.device(header["device"]) != dev:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    return LoadedModel(header=header, program=program, device=dev)


def save_artifact(blob: bytes, path: str) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_artifact(path: str, device=None) -> LoadedModel:
    with open(path, "rb") as f:
        return load_detect(f.read(), device)


def export_from_config(experiment_cfg, state_dict=None, batch_size: int = 8,
                       quantize: bool = False, int8_activations: bool = False,
                       activation_scales=None, dtype: str | None = None,
                       device=None) -> bytes:
    """Build the model of an ExperimentConfig on ``device`` (default: the
    card) and export it. ``state_dict=None`` exports the fresh weights
    (``build_model``'s default seed); ``dtype`` overrides the compute type
    baked in (e.g. "bfloat16")."""
    from shape_based_object_detection_torch.models.factory import build_model

    model_cfg = experiment_cfg.model
    if dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, dtype=dtype)
    dev = resolve_device(device)
    module, anchors = build_model(model_cfg, dev)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
    return export_detect(module, anchors, model_cfg, experiment_cfg.data, batch_size, dev,
                         quantize=quantize, int8_activations=int8_activations,
                         activation_scales=activation_scales)
