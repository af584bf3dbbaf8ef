"""HTTP detection serving (port of the JAX package's ``cli/serve_cli.py``):
``server.DetectionServer`` over a checkpoint, in the float or an int8 tier,
or over an exported ``.sbdx`` artifact, with dynamic batching into
bucketed batches, on the card (``--device cpu`` for the CPU).

    python -m shape_based_object_detection_torch.cli.serve_cli \\
        --config config2_retinanet_r50_infer --checkpoint-dir ckpt \\
        --quantize full --act-scales scales.json --batch-size 16 --port 8000
    curl -s -X POST --data-binary @img.jpg 'localhost:8000/detect?min_score=0.3'

It warms every bucket up before it listens, prints the address it serves
on, and stops on SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import signal
import threading


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="config2_retinanet_r50_infer")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu' for the plain versions")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--ema", action="store_true",
                   help="serve the checkpoint's EMA weights")
    p.add_argument("--quantize", nargs="?", const="weights", default="",
                   choices=["weights", "full"],
                   help="serve an int8 tier: 'weights' (weight-only) or 'full' "
                        "(s8xs8->s32 convolutions)")
    p.add_argument("--act-scales", default="",
                   help="with --quantize full: calibrated activation-scales JSON "
                        "(tools/calibrate_scales.py)")
    p.add_argument("--artifact", default="",
                   help="serve an exported .sbdx (tools/export_model.py) instead of "
                        "building the model")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--bucket-sizes", default="auto",
                   help="comma-separated batch buckets (a small batch pads only "
                        "to the smallest bucket that holds it); 'auto' = powers "
                        "of 2 up to --batch-size; 'none' = one fixed batch")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="how long the first request of a batch waits for others")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    p.add_argument("--class-names", default="",
                   help="a text file with one class name per line (0-based "
                        "label order), or 'voc' for the VOC classes")
    p.add_argument("--verbose", action="store_true", help="log one line per request")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override (JSON-parsed values)")
    return p


def _stop(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.server import DetectionServer
    from shape_based_object_detection_torch.serving import (
        ArtifactPredictor, Predictor, default_bucket_sizes,
    )

    args = _parser().parse_args(argv)
    if args.artifact and (args.quantize or args.act_scales):
        raise SystemExit("--quantize/--act-scales cannot modify an exported "
                         "--artifact (they are set when it is exported)")
    names = None
    if args.class_names == "voc":
        from shape_based_object_detection_torch.data.voc import VOC_CLASSES

        names = list(VOC_CLASSES)
    elif args.class_names:
        with open(args.class_names) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    if args.ema and not args.checkpoint_dir:
        raise SystemExit("--ema requires --checkpoint-dir")
    if args.bucket_sizes == "auto":
        buckets = default_bucket_sizes(args.batch_size)
    elif args.bucket_sizes in ("none", ""):
        buckets = None
    else:
        buckets = [int(b) for b in args.bucket_sizes.split(",")]

    if args.artifact:
        pred = ArtifactPredictor(args.artifact, device=args.device)
    else:
        cfg = config_lib.resolve_config(args.config, args.overrides)
        weights = None
        if args.checkpoint_dir:
            import torch

            from shape_based_object_detection_torch.cli.common import (
                restore_checkpoint_variables,
            )
            from shape_based_object_detection_torch.models.factory import build_module

            with torch.device("meta"):  # only its state dict's keys are read
                module = build_module(cfg.model)
            weights = restore_checkpoint_variables(module, args.checkpoint_dir, ema=args.ema)
        pred = Predictor(cfg, weights, batch_size=args.batch_size, device=args.device,
                         bucket_sizes=buckets, quantize=args.quantize,
                         activation_scales=args.act_scales or None)
    print("warming up (one batch per bucket)...", flush=True)
    pred.warmup()
    server = DetectionServer(pred, host=args.host, port=args.port,
                             batch_window_ms=args.batch_window_ms, class_names=names)
    server.verbose = args.verbose
    print(f"serving on http://{args.host}:{server.port}/detect (device "
          f"{pred.device}, batch buckets={pred.bucket_sizes}, "
          f"window={args.batch_window_ms}ms); GET /healthz for readiness", flush=True)
    main_thread = threading.current_thread() is threading.main_thread()
    if main_thread:  # only the main thread may set a signal handler
        previous = signal.signal(signal.SIGTERM, _stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
        server.close()
    print("server stopped", flush=True)


if __name__ == "__main__":
    main()
