"""What the accuracy tools share (``ablate_matching``, ``ablate_tta``,
``ablate_quantize``, ``matching_analysis``): the device they report, the
training loop with its epoch roll-over, a trained module made ready for
the serving paths, and the one scoring loop.

The scoring loop is the only place a tool feeds an Evaluator. Ground-truth
labels are 1-based everywhere in the data layer (0 is the background) and
detection labels are 0-based class ids, so the loop shifts the ground
truth by one, as ``eval_cli`` and ``train_cli`` do. A scorer without the
shift compares every detection against the next class and reports an mAP
near 0 whatever the weights."""

from __future__ import annotations

import subprocess
import time
import types
from typing import Callable, Iterable

import numpy as np
import torch

from shape_based_object_detection_torch.eval import Evaluator
from shape_based_object_detection_torch.utils.device import resolve_device


def device_field(device) -> str:
    """"cpu", or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if not out:
        return f"{torch.cuda.get_device_name(dev)}, power limit not read (no nvidia-smi)"
    return out[dev.index if dev.index < len(out) else 0].strip()


def train_steps(step_fn, state, batches: Callable[[int], Iterable], steps: int,
                log_at: Callable[[int], bool], log: Callable[[int, float], None]):
    """``steps`` calls of ``step_fn`` over ``batches(epoch)``, rolling over to
    the next epoch when one ends. After step ``i`` (1-based) with
    ``log_at(i)`` the loss is read back (a wait for the card) and passed to
    ``log``. Returns ``(state, last loss read, seconds)``."""
    t0 = time.time()
    step, epoch, last_loss = 0, 0, float("nan")
    while step < steps:
        for batch in batches(epoch):
            state, metrics = step_fn(state, batch._asdict())
            step += 1
            if log_at(step):
                last_loss = float(metrics["loss"])
                log(step, last_loss)
            if step >= steps:
                break
        epoch += 1
    if steps and torch.cuda.is_available():
        torch.cuda.synchronize()
    return state, last_loss, time.time() - t0


def preset_config(name: str, batch: int, hflip: bool):
    """``ablate_tta``'s and ``ablate_quantize``'s configuration: the preset
    at ``batch``, the photometric and geometric augmentations off (hflip as
    given), lr 0.02 after 10 warmup steps, score threshold 0.05."""
    import dataclasses

    from shape_based_object_detection_torch import config as config_lib

    cfg = config_lib.get_config(name)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, batch_size=batch, photometric=False,
                                 expand=False, random_crop=False, hflip=hflip),
        train=dataclasses.replace(cfg.train, base_lr=0.02, warmup_steps=10),
        model=dataclasses.replace(cfg.model, detect=dataclasses.replace(
            cfg.model.detect, score_threshold=0.05)),
    )


def train_preset(cfg, steps: int, train_images: int, device, augment: bool, what: str = ""):
    """A fresh model of ``cfg`` (weights from seed 0) trained ``steps`` steps
    on ``train_images`` synthetic images (seed 0), the loss printed every
    100 steps from the first: the trained module (float32 parameters) and
    its anchors."""
    from shape_based_object_detection_torch import train as train_lib
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection
    from shape_based_object_detection_torch.models.factory import build_model

    module, anchors = build_model(cfg.model, device, train=True)
    state = train_lib.create_train_state(module, cfg, device=device)
    step_fn = train_lib.make_train_step(module, anchors, cfg, augment=augment, device=device)
    ds = SyntheticDetection(size=cfg.model.image_size, num_images=train_images,
                            num_classes=cfg.model.num_classes)
    loader = Loader(ds, cfg.data.batch_size, cfg.data.max_boxes, shuffle=True)
    print(f"training {steps} steps on {train_images} synthetic images{what}...", flush=True)
    train_steps(step_fn, state, loader.batches, steps, lambda s: (s - 1) % 100 == 0,
                lambda s, loss: print(f"  step {s - 1}: loss {loss:.4f}", flush=True))
    return module, anchors


def eval_split(cfg, eval_images: int):
    """The held-out synthetic split (seed 1234) and its unshuffled loader."""
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

    ds = SyntheticDetection(size=cfg.model.image_size, num_images=eval_images,
                            num_classes=cfg.model.num_classes, seed=1234)
    return ds, Loader(ds, cfg.data.batch_size, cfg.data.max_boxes, shuffle=False)


def serving_module(model_cfg, trained: torch.nn.Module, device):
    """The trained weights in a module built for inference (a bf16 model's
    convolutions store bf16 weights, as ``eval_cli`` loads a checkpoint),
    and its anchors."""
    from shape_based_object_detection_torch.models.factory import build_model

    module, anchors = build_model(model_cfg, device)
    module.load_state_dict(trained.state_dict(), strict=True)
    return module, anchors


def whole(loader) -> Iterable:
    """A loader's full batches (the ragged tail dropped), as ``(batch,
    n_valid)`` pairs."""
    return ((b, len(b.images)) for b in loader.batches())


def one_by_one(dataset) -> Iterable:
    """Each sample of ``dataset`` as a batch of one with its unpadded ground
    truth, as ``(batch, 1)`` pairs (the images at their own size)."""
    for i in range(len(dataset)):
        img, boxes, labels = dataset[i][:3]
        yield types.SimpleNamespace(images=img[None], boxes=np.asarray(boxes)[None],
                                    labels=np.asarray(labels)[None],
                                    valid=np.ones((1, len(labels)), bool)), 1


def score(detect: Callable, batches: Iterable, area_scale: float) -> Evaluator:
    """Runs ``detect(images)`` on each ``(batch, n_valid)`` of ``batches``
    and feeds its first ``n_valid`` rows, with the batch's ground truth, to
    an Evaluator (COCO area strata in units of ``area_scale`` pixels).
    Returns the Evaluator."""
    ev = Evaluator(area_scale=area_scale)
    for batch, n_valid in batches:
        det = detect(batch.images)
        det = types.SimpleNamespace(**{k: getattr(det, k)[:n_valid]
                                       for k in ("boxes", "scores", "labels", "valid")})
        # GT labels are 1-based (0 = background); detection labels are
        # 0-based class ids
        ev.add_batch(det, batch.boxes[:n_valid], batch.labels[:n_valid] - 1,
                     batch.valid[:n_valid])
    return ev
