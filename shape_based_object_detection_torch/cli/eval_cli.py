"""Evaluation entry point (port of the JAX package's ``cli/eval_cli.py``).

    python -m shape_based_object_detection_torch.cli.eval_cli \\
        --config config3_ssd512_voc_train --checkpoint-dir ckpt --protocol voc

Runs detect over a validation set on the card (``--device cpu`` for the
CPU) and prints first-party COCO AP[.5:.95] or VOC mAP as JSON: in the
float tier, an int8 tier (``--quantize [weights|full] [--act-scales]``,
which measures the quantization's mAP drift), or an exported artifact
(``--artifact``, the export's parity measurement).

Under ``torchrun --nproc_per_node N`` (one process per card) the
evaluation is sharded: each rank detects its rows of every batch of
``data.batch_size`` (an artifact's batch per rank), the ranks gather the
detections and annotations in rank order, and every rank scores the whole
split in the single process's order; rank 0 prints the result and writes
``--dump-results``. With ``--set mesh.model_parallelism=M`` the ranks of a
data index split each image's rows, at any image size, in every tier and
with either TTA; an ``--artifact`` is a program for one device (as the
reference's), so there each rank runs it whole on its data index's
images.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import types

import numpy as np


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
                   choices=["weights", "full"],
                   help="evaluate an int8 tier instead of float: 'weights' (weight-only) "
                        "or 'full' (s8xs8->s32 convolutions, dynamic activation scales)")
    p.add_argument("--act-scales", default="",
                   help="with --quantize full: calibrated activation-scales JSON "
                        "(tools/calibrate_scales.py), the static-scale tier")
    p.add_argument("--artifact", default="",
                   help="evaluate an exported .sbdx artifact instead of checkpoint "
                        "weights (weights, preprocessing and NMS are baked into its "
                        "program; incompatible with --checkpoint-dir/--quantize/--ema/"
                        "--tta-hflip/--tta-scales)")
    p.add_argument("--tta-hflip", action="store_true",
                   help="evaluate with horizontal-flip test-time augmentation "
                        "(one forward on the doubled batch, the mirrored "
                        "candidates merged by one NMS)")
    p.add_argument("--tta-scales", default="",
                   help="evaluate with multi-scale test-time augmentation: "
                        "comma-separated image sizes (e.g. 512,640). Each batch "
                        "is uploaded once at the base size, other scales resize "
                        "it on the device, and one NMS merges the scales. "
                        "Composes with --tta-hflip; RetinaNet configs only "
                        "(SSD's heads depend on the size)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override (JSON-parsed values)")
    return p


def main(argv=None):
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.cli.common import enable_tta_hflip
    from shape_based_object_detection_torch.parallel import initialize_multihost, shutdown

    args = _parser().parse_args(argv)
    cfg = config_lib.resolve_config(args.config, args.overrides)
    if args.artifact:
        # the artifact is one frozen program: a flag that would alter it
        # cannot apply
        for flag, name in ((args.checkpoint_dir, "--checkpoint-dir"),
                           (args.quantize, "--quantize"), (args.act_scales, "--act-scales"),
                           (args.ema, "--ema"), (args.tta_hflip, "--tta-hflip"),
                           (args.tta_scales, "--tta-scales")):
            if flag:
                raise SystemExit(f"--artifact is a frozen program: {name} cannot apply "
                                 "(bake it in at export: tools/export_model.py)")
    elif args.act_scales and args.quantize != "full":
        raise SystemExit("--act-scales requires --quantize full")
    if args.tta_hflip:
        cfg = enable_tta_hflip(cfg)
    if args.dataset:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                dataset=args.dataset))
    # torchrun's environment forms the group; alone, no group forms
    mesh = initialize_multihost(device=args.device, cfg=cfg.mesh)
    try:
        _evaluate(args, cfg, mesh)
    finally:
        shutdown(mesh)


def _evaluate(args, cfg, mesh):
    """The evaluation of ``main`` on ``mesh`` (a rank of a group, or a
    single process)."""
    import torch

    from shape_based_object_detection_torch.cli.common import parse_scales
    from shape_based_object_detection_torch.cli.train_cli import (
        build_dataset, sharded_batches, upload,
    )
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.detection import MultiScaleBatchDetector
    from shape_based_object_detection_torch.eval import Evaluator
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops.boxes import boxes_to_original
    from shape_based_object_detection_torch.parallel.mesh import (
        all_gather_rows, make_mesh_for_batch,
    )
    from shape_based_object_detection_torch.quantize import make_serving_detect

    dev = mesh.device
    if args.artifact:
        from shape_based_object_detection_torch.export import load_artifact

        detect = load_artifact(args.artifact, dev)
        header = detect.header
        # the eval geometry must match the baked program: a mismatch would
        # score wrongly resized pixels
        for key, got in (("image_size", cfg.model.image_size),
                         ("num_classes", cfg.model.num_classes),
                         ("letterbox", cfg.data.letterbox)):
            if header.get(key, got) != got:
                raise SystemExit(f"artifact/config mismatch: header {key}="
                                 f"{header.get(key)!r} but --config resolves to {got!r}")
        # the artifact has one batch shape, each data index's; batches_padded
        # pads the tail to the data indexes' batches together
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, batch_size=header["batch_size"] * mesh.data_size))
    else:
        module, anchors = build_model(cfg.model, dev)
        if args.checkpoint_dir:
            from shape_based_object_detection_torch.cli.common import (
                restore_checkpoint_variables,
            )

            module.load_state_dict(restore_checkpoint_variables(
                module, args.checkpoint_dir, ema=args.ema), strict=True)
        elif args.ema:
            raise SystemExit("--ema requires --checkpoint-dir")
        if args.tta_scales:
            try:
                detect = MultiScaleBatchDetector(
                    cfg.model, module, parse_scales(args.tta_scales), cfg.data, dev,
                    quantize=args.quantize, activation_scales=args.act_scales or None,
                    mesh=mesh)
            except ValueError as e:  # e.g. SSD at a scale that changes its plan
                raise SystemExit(str(e))
        else:  # under a model axis each rank computes its rows of the images
            detect, _ = make_serving_detect(module, anchors, cfg.model, cfg.data,
                                            args.quantize, dev, args.act_scales or None,
                                            mesh)

    # COCO: crowd regions ride along as ignore regions, and the area strata
    # (32^2/96^2 px) are in ORIGINAL-image pixels, from each image's size;
    # otherwise the uniform network-input-pixel scale applies
    dataset = build_dataset(cfg, args, include_ignore=True)
    make_mesh_for_batch(cfg.data.batch_size, mesh, cfg.mesh)  # raises if indivisible
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
    fields = ("boxes", "scores", "labels", "valid")
    for i, (batch, n_valid, gt) in enumerate(sharded_batches(loader, mesh)):
        det = detect(upload(batch.images, dev))
        # the data indexes' detections in order: the whole batch's
        det = all_gather_rows((getattr(det, k) for k in fields), mesh)
        det = types.SimpleNamespace(**{k: d[:n_valid].cpu().numpy()
                                       for k, d in zip(fields, det)})
        boxes, labels, valid, crowd = (a[:n_valid] for a in gt)
        # detect's labels are 0-based foreground ids; GT labels are 1-based
        ev.add_batch(det, boxes, labels - 1, valid,
                     area_factors=batch_area_factors(sample_idx, n_valid),
                     **{flag_kw: crowd})
        if args.dump_results and is_coco_ds and mesh.rank == 0:
            for b in range(n_valid):
                im = dataset.images[sample_idx + b]
                v = det.valid[b]
                boxes_px = boxes_to_original(torch.from_numpy(det.boxes[b][v]), im["height"],
                                             im["width"], cfg.data.letterbox).numpy()
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
    if mesh.rank:
        return  # rank 0 reports
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
