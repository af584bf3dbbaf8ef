"""Hflip-TTA accuracy ablation (port of the JAX package's
``tools/ablate_tta.py``): train a detector on synthetic data, then score
the same weights plain and with hflip test-time augmentation, and for
RetinaNet also with multi-scale TTA, with and without hflip.

Training keeps random hflip augmentation on, so flipped inputs are in
distribution for the flipped branch. On the card every training step runs
the matching kernel, every scored batch the NMS kernel (a multi-scale
image: once per scale and once for the merge).

    python -m shape_based_object_detection_torch.tools.ablate_tta --device cpu --steps 400
"""

from __future__ import annotations

import argparse
import dataclasses
import json

SCORE_KEYS = ("coco_mAP", "AP50", "AR100", "voc_mAP")


def multiscale_scales(image_size: int):
    """The base size and 1.25x it, in multiples of 32."""
    return (image_size, max(32, round(image_size * 1.25 / 32) * 32))


def _with_tta(model_cfg, hflip: bool):
    return dataclasses.replace(model_cfg, detect=dataclasses.replace(
        model_cfg.detect, tta_hflip=hflip))


def score_mode(cfg, module, anchors, loader, hflip: bool, device):
    """The Evaluator of detect (``make_detect_fn``, hflip TTA on or off) of
    an inference module over the loader's full batches."""
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.tools._ablation import score, whole

    detect = make_detect_fn(module, anchors, _with_tta(cfg.model, hflip), cfg.data, device)
    return score(detect, whole(loader), cfg.model.image_size)


def score_multiscale(cfg, module, dataset, scales, hflip: bool, device):
    """The Evaluator of ``MultiScaleDetector`` (per image, at ``scales``,
    hflip TTA on or off) over every image of ``dataset``, its detections
    mapped back from pixels to the evaluation frame."""
    import types

    import numpy as np

    from shape_based_object_detection_torch.detection import MultiScaleDetector
    from shape_based_object_detection_torch.tools._ablation import one_by_one, score

    msd = MultiScaleDetector(_with_tta(cfg.model, hflip), module, scales, cfg.data, device)
    s = cfg.model.image_size

    def detect(images):
        boxes_px, scores, labels = msd(images[0])
        n = len(scores)
        return types.SimpleNamespace(
            boxes=(np.asarray(boxes_px, np.float32) / s).reshape(1, n, 4),
            scores=np.asarray(scores, np.float32).reshape(1, n),
            labels=np.asarray(labels, np.int32).reshape(1, n),
            valid=np.ones((1, n), bool))

    return score(detect, one_by_one(dataset), s)


def mode_row(ev) -> dict:
    coco, voc = ev.coco(), ev.voc()
    return {"coco_mAP": round(coco["mAP"], 4), "AP50": round(coco["AP50"], 4),
            "AR100": round(coco["AR100"], 4), "voc_mAP": round(voc["mAP"], 4)}


def score_modes(cfg, trained, dataset, loader, device, each=None) -> dict:
    """Every mode of the ablation on the trained module's weights: name ->
    Evaluator. Plain and hflip TTA; for RetinaNet also multi-scale TTA at
    ``multiscale_scales`` without and with hflip (SSD's extras depend on
    the image size). ``each(name, run)``, where given, scores each mode:
    it calls ``run()`` and returns the Evaluator that gives."""
    from functools import partial

    from shape_based_object_detection_torch.tools._ablation import serving_module

    module, anchors = serving_module(cfg.model, trained, device)
    each = each or (lambda name, run: run())
    runs = {name: partial(score_mode, cfg, module, anchors, loader, hflip, device)
            for name, hflip in (("plain", False), ("hflip-tta", True))}
    if cfg.model.family == "retinanet":
        scales = multiscale_scales(cfg.model.image_size)
        runs[f"ms-tta{list(scales)}"] = partial(score_multiscale, cfg, module, dataset,
                                                scales, False, device)
        runs["ms+hflip-tta"] = partial(score_multiscale, cfg, module, dataset, scales, True,
                                       device)
    modes = {}
    for name, run in runs.items():
        modes[name] = each(name, run)
        print(json.dumps({"mode": name, **mode_row(modes[name])}), flush=True)
    return modes


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="tiny_retinanet")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--train-images", type=int, default=16)
    p.add_argument("--eval-images", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    return p


def main(argv=None):
    from shape_based_object_detection_torch.tools._ablation import (
        device_field, eval_split, preset_config, train_preset,
    )

    args = _parser().parse_args(argv)
    device = device_field(args.device)  # raises without a card unless --device cpu
    cfg = preset_config(args.config, args.batch, hflip=True)
    trained, _ = train_preset(cfg, args.steps, args.train_images, args.device, augment=True,
                              what=" (hflip aug on)")
    dataset, loader = eval_split(cfg, args.eval_images)
    rows = {name: mode_row(ev)
            for name, ev in score_modes(cfg, trained, dataset, loader, args.device).items()}

    print("\n| mode | COCO mAP | AP50 | AR100 | VOC mAP |")
    print("|---|---|---|---|---|")
    for name, r in rows.items():
        print(f"| {name} | {r['coco_mAP']} | {r['AP50']} | {r['AR100']} | {r['voc_mAP']} |")
    base = rows["plain"]["coco_mAP"]
    for name, r in rows.items():
        if name != "plain":
            print(f"{name} coco mAP delta vs plain: {r['coco_mAP'] - base:+.4f}")
    print(json.dumps({"device": device}))
    return rows


if __name__ == "__main__":
    main()
