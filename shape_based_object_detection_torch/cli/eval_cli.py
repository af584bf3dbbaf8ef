"""Evaluation entry point (port of the JAX package's ``cli/eval_cli.py``).

    python -m shape_based_object_detection_torch.cli.eval_cli \\
        --config config3_ssd512_voc_train --checkpoint-dir ckpt --protocol voc

Runs detect over a validation set on the card (``--device cpu`` for the
CPU) and prints first-party COCO AP[.5:.95] or VOC mAP as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import types

import numpy as np

# the serving tiers eval_cli switches on, not ported yet (ROADMAP.md item 6)
UNPORTED = ("--quantize", "--act-scales", "--artifact", "--tta-hflip", "--tta-scales")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="config2_retinanet_r50_infer")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu' for the plain versions")
    p.add_argument("--data-root", default="")
    p.add_argument("--ann-file", default="")
    p.add_argument("--split", default="val")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--protocol", choices=["coco", "voc"], default="coco")
    p.add_argument("--dataset", default="",
                   help="override the preset's dataset kind (voc|coco|synthetic)")
    p.add_argument("--max-batches", type=int, default=0)
    p.add_argument("--per-class", action="store_true",
                   help="include the per-class AP breakdown in the output")
    p.add_argument("--dump-results", default="",
                   help="write detections as COCO results JSON ([{image_id, "
                        "category_id, bbox xywh px, score}]); needs a coco "
                        "dataset")
    p.add_argument("--ema", action="store_true",
                   help="evaluate the checkpoint's EMA weights (a run trained "
                        "with --ema-decay > 0)")
    p.add_argument("--quantize", nargs="?", const="weights", default="",
                   choices=["weights", "full"], help="not ported yet")
    p.add_argument("--act-scales", default="", help="not ported yet")
    p.add_argument("--artifact", default="", help="not ported yet")
    p.add_argument("--tta-hflip", action="store_true", help="not ported yet")
    p.add_argument("--tta-scales", default="", help="not ported yet")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override (JSON-parsed values)")
    return p


def main(argv=None):
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.cli.train_cli import build_dataset, upload
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.eval import Evaluator
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.utils.device import resolve_device
    from shape_based_object_detection_torch.utils.image import boxes_norm_to_original_px

    args = _parser().parse_args(argv)
    for flag in UNPORTED:
        if getattr(args, flag[2:].replace("-", "_")):
            raise NotImplementedError(
                f"{flag} (the int8, exported-artifact and TTA serving tiers) is "
                "not ported yet (ROADMAP.md, modules still to port, item 6)")
    cfg = config_lib.resolve_config(args.config, args.overrides)
    if args.dataset:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                dataset=args.dataset))
    dev = resolve_device(args.device)
    module, anchors = build_model(cfg.model, dev)
    if args.checkpoint_dir:
        from shape_based_object_detection_torch.cli.common import (
            restore_checkpoint_variables,
        )

        module.load_state_dict(restore_checkpoint_variables(
            module, args.checkpoint_dir, ema=args.ema), strict=True)
    elif args.ema:
        raise SystemExit("--ema requires --checkpoint-dir")
    detect = make_detect_fn(module, anchors, cfg.model, cfg.data, dev)

    # COCO: crowd regions ride along as ignore regions, and the area strata
    # (32^2/96^2 px) are in ORIGINAL-image pixels, from each image's size;
    # otherwise the uniform network-input-pixel scale applies
    dataset = build_dataset(cfg, args, include_ignore=True)
    loader = Loader(dataset, cfg.data.batch_size, cfg.data.max_boxes, shuffle=False)
    is_coco_ds = hasattr(dataset, "coco")
    ev = Evaluator(area_scale=1.0 if is_coco_ds else cfg.model.image_size)
    flag_kw = "gt_crowd" if is_coco_ds else "gt_ignore"

    def batch_area_factors(start: int, count: int):
        # the loader is unshuffled: batch rows are dataset rows start..
        if not is_coco_ds:
            return None
        out = np.empty((count,), np.float64)
        for b in range(count):
            im = dataset.images[start + b]
            w, h = float(im["width"]), float(im["height"])
            out[b] = max(w, h) ** 2 if cfg.data.letterbox else w * h
        return out

    coco_results = []
    sample_idx = 0
    # batches_padded covers the ragged tail; padded rows are dropped
    for i, (batch, n_valid) in enumerate(loader.batches_padded()):
        det = detect(upload(batch.images, dev))
        det = types.SimpleNamespace(**{k: getattr(det, k)[:n_valid].cpu().numpy()
                                       for k in ("boxes", "scores", "labels", "valid")})
        # detect's labels are 0-based foreground ids; GT labels are 1-based
        ev.add_batch(det, batch.boxes[:n_valid], batch.labels[:n_valid] - 1,
                     batch.valid[:n_valid],
                     area_factors=batch_area_factors(sample_idx, n_valid),
                     **{flag_kw: batch.crowd[:n_valid]})
        if args.dump_results and is_coco_ds:
            for b in range(n_valid):
                im = dataset.images[sample_idx + b]
                v = det.valid[b]
                boxes_px = boxes_norm_to_original_px(det.boxes[b][v], im["height"],
                                                     im["width"], cfg.data.letterbox)
                for box, score, label in zip(boxes_px, det.scores[b][v], det.labels[b][v]):
                    x0, y0, x1, y1 = (float(t) for t in box)
                    coco_results.append({
                        "image_id": int(im["id"]),
                        "category_id": int(dataset.coco.label_to_cat_id[int(label) + 1]),
                        "bbox": [round(x0, 2), round(y0, 2),
                                 round(x1 - x0, 2), round(y1 - y0, 2)],
                        "score": round(float(score), 5),
                    })
        sample_idx += n_valid
        if args.max_batches and i + 1 >= args.max_batches:
            break
    if args.dump_results:
        with open(args.dump_results, "w") as f:
            json.dump(coco_results, f)
        print(f"wrote {len(coco_results)} results to {args.dump_results}", flush=True)
    metrics = ev.coco() if args.protocol == "coco" else ev.voc()
    if not args.per_class:
        metrics.pop("per_class", None)
    print(json.dumps(metrics, indent=2))


if __name__ == "__main__":
    main()
