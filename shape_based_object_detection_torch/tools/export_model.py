"""Export a model to a standalone ``.sbdx`` serving artifact (port of the
JAX package's ``tools/export_model.py``).

    python -m shape_based_object_detection_torch.tools.export_model \\
        --config config2_retinanet_r50_infer [--checkpoint-dir ckpt] \\
        --batch-size 16 --dtype bfloat16 --out retinanet_r50.sbdx

The artifact holds the weights and the whole detect program
(``torch.export``); load it with ``export.load_artifact`` or serve it with
``serve_cli --artifact``: no model code, config or checkpoint at serving
time. It is traced on ``--device`` and moved to the other device at load.
"""

from __future__ import annotations

import argparse


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda",
                   help="the device it is traced on: 'cuda' (the default) or 'cpu'")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dtype", default="",
                   help="compute-type override baked into the artifact (e.g. bfloat16)")
    p.add_argument("--quantize", action="store_true",
                   help="bake in int8 weights (weight-only int8; a smaller artifact)")
    p.add_argument("--int8-activations", action="store_true",
                   help="with --quantize: bake in the s8xs8->s32 convolutions "
                        "(dynamic activation scales)")
    p.add_argument("--act-scales", default="",
                   help="with --int8-activations: calibrated activation-scales JSON "
                        "(tools/calibrate_scales.py), baked in as static scales")
    p.add_argument("--ema", action="store_true",
                   help="export the checkpoint's EMA weights")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override baked into the artifact (e.g. "
                        "model.detect.tta_hflip=true; JSON-parsed values)")
    p.add_argument("--out", required=True)
    return p


def main(argv=None):
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch import export as export_lib

    args = _parser().parse_args(argv)
    if args.int8_activations and not args.quantize:
        raise SystemExit("--int8-activations requires --quantize")
    if args.act_scales and not args.int8_activations:
        raise SystemExit("--act-scales requires --int8-activations")
    cfg = config_lib.resolve_config(args.config, args.overrides)
    weights = None
    if args.checkpoint_dir:
        import torch

        from shape_based_object_detection_torch.cli.common import restore_checkpoint_variables
        from shape_based_object_detection_torch.models.factory import build_module

        with torch.device("meta"):  # only its state dict's keys are read
            module = build_module(cfg.model)
        weights = restore_checkpoint_variables(module, args.checkpoint_dir, ema=args.ema)
    elif args.ema:
        raise SystemExit("--ema requires --checkpoint-dir")
    blob = export_lib.export_from_config(
        cfg, weights, batch_size=args.batch_size, quantize=args.quantize,
        int8_activations=args.int8_activations, activation_scales=args.act_scales or None,
        dtype=args.dtype or None, device=args.device)
    export_lib.save_artifact(blob, args.out)
    print(f"wrote {args.out}: {len(blob) / 1e6:.1f} MB, device={args.device}, "
          f"batch={args.batch_size}, quantized={args.quantize}")


if __name__ == "__main__":
    main()
