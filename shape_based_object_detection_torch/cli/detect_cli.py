"""Detection on image files (port of the JAX package's ``cli/detect_cli.py``),
on the card (``--device cpu`` for the CPU).

    python -m shape_based_object_detection_torch.cli.detect_cli \\
        --config config1_ssd300_infer --image photo.jpg --checkpoint-dir ckpt

Prints the detections at or above ``--min-score`` as JSON (1-based labels):
a list for one file, a {file name: list} mapping for a directory.
``--quantize [--int8-activations [--act-scales scales.json]]`` serves an
int8 tier; ``--artifact model.sbdx`` runs an exported program instead of
building the model.
"""

from __future__ import annotations

import argparse
import json
import os


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="config1_ssd300_infer")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu' for the plain versions")
    p.add_argument("--image", required=True,
                   help="an image file, or a directory of images (jpg/png/bmp): "
                        "one result entry per file")
    p.add_argument("--save-viz", default="",
                   help="directory for copies of the images with the detections "
                        "drawn (utils/viz.py)")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--min-score", type=float, default=0.3)
    p.add_argument("--quantize", action="store_true",
                   help="serve int8 weights (weight-only int8, dequantized in each "
                        "convolution)")
    p.add_argument("--act-scales", default="",
                   help="with --int8-activations: calibrated activation-scales JSON "
                        "(tools/calibrate_scales.py) for the static-scale int8 tier")
    p.add_argument("--int8-activations", action="store_true",
                   help="with --quantize: run eligible convolutions as s8xs8->s32 "
                        "(dynamic per-image activation scales)")
    p.add_argument("--ema", action="store_true",
                   help="use the checkpoint's EMA weights")
    p.add_argument("--tta-hflip", action="store_true",
                   help="horizontal-flip test-time augmentation: one forward on "
                        "the doubled batch, the mirrored candidates merged by "
                        "one NMS (shortcut for --set model.detect.tta_hflip=true)")
    p.add_argument("--tta-scales", default="",
                   help="comma-separated image sizes for multi-scale test-time "
                        "augmentation (e.g. 512,640): one detect per scale on "
                        "shared weights, merged by one NMS; composes with "
                        "--tta-hflip")
    p.add_argument("--artifact", default="",
                   help="run an exported .sbdx artifact (tools/export_model.py) instead "
                        "of building the model (--config/--checkpoint-dir ignored)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override (JSON-parsed values)")
    return p


def _check_flags(args) -> None:
    """The reference's conflict checks."""
    if args.tta_scales and args.artifact:
        raise SystemExit(
            "--tta-scales cannot modify an exported --artifact (its program "
            "is frozen at one scale); export per-scale artifacts or drop "
            "--artifact")
    if args.artifact and args.tta_hflip:
        raise SystemExit(
            "--tta-hflip cannot modify an exported --artifact; export with "
            "model.detect.tta_hflip=true instead")
    if args.artifact and (args.quantize or args.int8_activations or args.act_scales):
        raise SystemExit(
            "--quantize/--int8-activations/--act-scales cannot modify an "
            "exported --artifact; set them when it is exported instead")
    if args.int8_activations and not args.quantize:
        raise SystemExit("--int8-activations requires --quantize")
    if args.act_scales and not args.int8_activations:
        raise SystemExit("--act-scales requires --int8-activations")


def _build_runner(args):
    """run(image (H, W, 3) uint8) -> (boxes_px, scores, labels), the model
    built once for every file."""
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.cli.common import (
        enable_tta_hflip, parse_scales, restore_checkpoint_variables,
    )
    from shape_based_object_detection_torch.detection import (
        MultiScaleDetector, detect_single_image,
    )
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.quantize import make_serving_detect
    from shape_based_object_detection_torch.serving import ArtifactPredictor
    from shape_based_object_detection_torch.utils.device import resolve_device

    if args.artifact:
        predictor = ArtifactPredictor(args.artifact, device=args.device)

        def run_artifact(img):
            det = predictor.predict([img])[0]
            return det.boxes, det.scores, det.labels

        return run_artifact
    cfg = config_lib.resolve_config(args.config, args.overrides)
    if args.tta_hflip:
        cfg = enable_tta_hflip(cfg)
    dev = resolve_device(args.device)
    module, anchors = build_model(cfg.model, dev)
    if args.checkpoint_dir:
        module.load_state_dict(restore_checkpoint_variables(
            module, args.checkpoint_dir, ema=args.ema), strict=True)
    elif args.ema:
        raise SystemExit("--ema requires --checkpoint-dir")
    mode = "full" if args.int8_activations else "weights" if args.quantize else ""
    if args.tta_scales:
        return MultiScaleDetector(cfg.model, module, parse_scales(args.tta_scales),
                                  cfg.data, dev, letterbox=cfg.data.letterbox,
                                  quantize=mode, activation_scales=args.act_scales or None)
    detect, _ = make_serving_detect(module, anchors, cfg.model, cfg.data, mode, dev,
                                    args.act_scales or None)

    def run(img):
        return detect_single_image(detect, img, cfg.model.image_size,
                                   letterbox=cfg.data.letterbox)

    return run


def main(argv=None):
    from shape_based_object_detection_torch.utils.image import decode_image_host

    args = _parser().parse_args(argv)
    _check_flags(args)
    is_dir = os.path.isdir(args.image)
    if is_dir:
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        paths = sorted(os.path.join(args.image, f) for f in os.listdir(args.image)
                       if f.lower().endswith(exts))
        if not paths:
            raise SystemExit(f"no images found in {args.image}")
    else:
        paths = [args.image]

    run_one = _build_runner(args)
    all_results = {}
    for path in paths:
        img = decode_image_host(path)
        boxes, scores, labels = run_one(img)
        # detect's labels are 0-based foreground ids; the output is 1-based,
        # as the datasets number their classes
        all_results[os.path.basename(path)] = [
            {"box": [round(float(v), 2) for v in b], "score": round(float(s), 4),
             "label": int(l) + 1}
            for b, s, l in zip(boxes, scores, labels) if s >= args.min_score]
        if args.save_viz:
            from PIL import Image

            from shape_based_object_detection_torch.utils.viz import draw_detections

            os.makedirs(args.save_viz, exist_ok=True)
            drawn = draw_detections(img, boxes, scores, labels, min_score=args.min_score)
            name = os.path.splitext(os.path.basename(path))[0] + "_det.png"
            Image.fromarray(drawn).save(os.path.join(args.save_viz, name))
    # one file: a flat list; a directory: the mapping, whatever its count
    print(json.dumps(all_results if is_dir
                     else all_results[os.path.basename(paths[0])], indent=2))


if __name__ == "__main__":
    main()
