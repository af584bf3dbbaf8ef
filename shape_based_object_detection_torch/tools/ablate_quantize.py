"""Quantization accuracy-drift ablation (port of the JAX package's
``tools/ablate_quantize.py``): train a detector on synthetic data, then
score the same weights through every serving tier (float, int8 weights,
full int8 with dynamic activation scales, full int8 with calibrated static
scales) and report each tier's mAP and the largest drift from float.

On the card every training step runs the matching kernel and every scored
batch the NMS kernel.

    python -m shape_based_object_detection_torch.tools.ablate_quantize --device cpu --steps 400
"""

from __future__ import annotations

import argparse
import json

# (name, quantize mode, static scales)
TIERS = (("float", "", False), ("weights", "weights", False),
         ("full-dynamic", "full", False), ("full-static", "full", True))


def calibrate(module, loader, calib_batches: int, data_cfg):
    """Static activation scales from the first ``calib_batches`` batches."""
    from shape_based_object_detection_torch.quantize import calibrate_activation_scales

    calib = [b.images for i, b in enumerate(loader.batches()) if i < calib_batches]
    return calibrate_activation_scales(module, calib, data_cfg)


def score_tier(cfg, module, anchors, loader, mode: str, act_scales, device):
    """The Evaluator of one tier (``make_serving_detect``) over the loader's
    full batches."""
    from shape_based_object_detection_torch.quantize import make_serving_detect
    from shape_based_object_detection_torch.tools._ablation import score, whole

    detect, _ = make_serving_detect(module, anchors, cfg.model, cfg.data, mode, device,
                                    activation_scales=act_scales)
    return score(detect, whole(loader), cfg.model.image_size)


def tier_row(ev) -> dict:
    coco, voc = ev.coco(), ev.voc()
    return {"coco_mAP": round(coco["mAP"], 4), "AP50": round(coco["AP50"], 4),
            "voc_mAP": round(voc["mAP"], 4)}


def score_tiers(cfg, trained, loader, calib_batches: int, device, each=None) -> dict:
    """Every tier on the trained module's weights, the static scales
    calibrated on the first ``calib_batches`` batches: name -> Evaluator.
    ``each(name, run)``, where given, scores each tier: it calls ``run()``
    and returns the Evaluator that gives."""
    from functools import partial

    from shape_based_object_detection_torch.tools._ablation import serving_module

    module, anchors = serving_module(cfg.model, trained, device)
    scales = calibrate(module, loader, calib_batches, cfg.data)
    each = each or (lambda name, run: run())
    tiers = {}
    for name, mode, static in TIERS:
        tiers[name] = each(name, partial(score_tier, cfg, module, anchors, loader, mode,
                                         scales if static else None, device))
        print(json.dumps({"tier": name, **tier_row(tiers[name])}), flush=True)
    return tiers


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="tiny_retinanet")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--train-images", type=int, default=16)
    p.add_argument("--eval-images", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--calib-batches", type=int, default=2)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    return p


def main(argv=None):
    from shape_based_object_detection_torch.tools._ablation import (
        device_field, eval_split, preset_config, train_preset,
    )

    args = _parser().parse_args(argv)
    device = device_field(args.device)  # raises without a card unless --device cpu
    cfg = preset_config(args.config, args.batch, hflip=False)
    trained, _ = train_preset(cfg, args.steps, args.train_images, args.device, augment=False)
    _, loader = eval_split(cfg, args.eval_images)
    rows = {name: tier_row(ev) for name, ev in
            score_tiers(cfg, trained, loader, args.calib_batches, args.device).items()}

    print("\n| tier | COCO mAP | AP50 | VOC mAP |")
    print("|---|---|---|---|")
    for name, r in rows.items():
        print(f"| {name} | {r['coco_mAP']} | {r['AP50']} | {r['voc_mAP']} |")
    drift = max(abs(r["coco_mAP"] - rows["float"]["coco_mAP"]) for r in rows.values())
    print(f"\nmax |coco mAP drift| vs float: {drift:.4f}")
    print(json.dumps({"device": device}))
    return rows


if __name__ == "__main__":
    main()
