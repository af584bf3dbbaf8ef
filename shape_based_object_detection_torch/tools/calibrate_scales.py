"""One-time PTQ calibration for the static-scale int8 serving tier (port of
the JAX package's ``tools/calibrate_scales.py``).

Runs the float forward over N batches of a dataset, records each eligible
convolution's input abs-max (``quantize.calibrate_activation_scales``) and
writes the scales JSON read by ``--quantize full --act-scales`` (eval_cli,
detect_cli, serve_cli, ``tools/export_model``) and ``Predictor(quantize=
"full", activation_scales=...)``. The file's keys are flax module paths, so
it is interchangeable with the JAX package's.

    python -m shape_based_object_detection_torch.tools.calibrate_scales \\
        --config config2_retinanet_r50_infer --checkpoint-dir ckpt \\
        --batches 8 --out scales.json
"""

from __future__ import annotations

import argparse
import dataclasses


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="config2_retinanet_r50_infer")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--data-root", default="")
    p.add_argument("--ann-file", default="")
    p.add_argument("--split", default="val")
    p.add_argument("--dataset", default="", help="override the preset's dataset kind")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--batches", type=int, default=8,
                   help="number of calibration batches (abs-max reduced over all)")
    p.add_argument("--out", required=True)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override (JSON-parsed values)")
    return p


def main(argv=None):
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.cli.train_cli import build_dataset
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.quantize import (
        calibrate_activation_scales, save_activation_scales,
    )

    args = _parser().parse_args(argv)
    cfg = config_lib.resolve_config(args.config, args.overrides)
    if args.dataset:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset=args.dataset))
    module, _ = build_model(cfg.model, args.device)
    if args.checkpoint_dir:
        from shape_based_object_detection_torch.cli.common import restore_checkpoint_variables

        module.load_state_dict(restore_checkpoint_variables(module, args.checkpoint_dir),
                               strict=True)
    dataset = build_dataset(cfg, args)
    loader = Loader(dataset, cfg.data.batch_size, cfg.data.max_boxes, shuffle=False)

    def batches():
        for i, batch in enumerate(loader.batches()):
            if i >= args.batches:
                return
            yield batch.images

    amaxes = calibrate_activation_scales(module, batches(), cfg.data)
    save_activation_scales(args.out, amaxes)
    print(f"wrote {args.out}: {len(amaxes)} conv scales from "
          f"{min(args.batches, len(dataset) // cfg.data.batch_size)} batches of {args.config}")


if __name__ == "__main__":
    main()
