"""End-to-end ablation of shape-similarity matching (port of the JAX
package's ``tools/ablate_matching.py``): train the same model twice per
seed, once with plain-IoU matching (``shape_weight`` 0) and once with the
shape-aware quality, on a synthetic split with a heavy tail of thin and
elongated objects, and report the held-out COCO-protocol mAP of both arms
and their paired delta.

The two arms of one seed differ only in MatchConfig: the seed draws the
model's initial weights, the augmentation's draws and the data order, and
nothing else. ``matching_analysis`` gives the assignment statistics behind
the delta. On the card every training step runs the matching kernel and
every scored batch the NMS kernel.

    python -m shape_based_object_detection_torch.tools.ablate_matching --device cpu --steps 40
    python -m shape_based_object_detection_torch.tools.ablate_matching \\
        --model-preset ssd300 --num-classes 20 --steps 6000 --batch 16 --lr 1e-3 \\
        --train-images 4000 --val-images 800 --max-objects 8 --aspect-std 1.2 \\
        --loader device --seeds 5 --arms-file arms.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import Any, Callable, NamedTuple

import numpy as np


def _make_cfg(args, shape_weight: float):
    from shape_based_object_detection_torch import config as config_lib

    if args.model_preset:
        model_cfg = config_lib.get_config(args.model_preset).model
        family = model_cfg.family
    else:
        model_cfg = config_lib.tiny_test_model(args.family)
        family = args.family
    if args.num_classes:
        # an 80-class preset on a synthetic split of a few thousand images
        # leaves too few images per class for either arm to score; 20
        # classes is the density the full-size ablation uses
        model_cfg = dataclasses.replace(model_cfg, num_classes=args.num_classes)
    args.family = family  # the loss kind and the report follow the real family
    warmup = max(20, args.steps // 20)
    decay = max(2 * args.steps // 3, warmup + 1)
    return config_lib.ExperimentConfig(
        model=model_cfg,
        data=dataclasses.replace(
            config_lib.DataConfig(dataset="synthetic", batch_size=args.batch,
                                  max_boxes=args.max_objects),
            photometric=False, expand=False, random_crop=False, hflip=True,
        ),
        train=dataclasses.replace(
            config_lib.TrainConfig(), base_lr=args.lr, warmup_steps=warmup,
            weight_decay=0.0, total_steps=args.steps, lr_decay_steps=(decay,),
        ),
        match=config_lib.MatchConfig(
            pos_threshold=0.5, neg_threshold=0.4, shape_weight=shape_weight,
            shape_tau=args.tau, force_match_for_each_gt=True,
        ),
        loss=config_lib.LossConfig(kind="multibox" if args.family == "ssd" else "focal"),
    )


class Arm(NamedTuple):
    """One arm, built and not yet trained: its config, the model (trained in
    place) and anchors, the train state and step, the training batches of
    an epoch, the validation batches and the device."""
    cfg: Any
    module: Any
    anchors: Any
    state: Any
    step_fn: Callable
    train_batches: Callable
    val_batches: Callable
    device: Any


def _splits(args, cfg):
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

    common = dict(size=cfg.model.image_size, max_objects=args.max_objects,
                  num_classes=cfg.model.num_classes, aspect_std=args.aspect_std,
                  class_aspect=args.class_aspect)
    # seeds 1 and 2: disjoint generator streams
    return (SyntheticDetection(num_images=args.train_images, seed=1, **common),
            SyntheticDetection(num_images=args.val_images, seed=2, **common))


def build_arm(args, shape_weight: float, seed: int = 7) -> Arm:
    """The arm of ``shape_weight`` at ``seed``: the seed draws the initial
    weights, the augmentation and the data order, identically in both arms
    of a seed."""
    import torch

    from shape_based_object_detection_torch import train as train_lib
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = _make_cfg(args, shape_weight)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
    size = cfg.model.image_size
    train_ds, val_ds = _splits(args, cfg)
    module, anchors = build_model(cfg.model, dev,
                                  generator=torch.Generator().manual_seed(seed), train=True)
    state = train_lib.create_train_state(module, cfg, device=dev)
    step_fn = train_lib.make_train_step(module, anchors, cfg, augment=True, device=dev)

    if args.loader == "device":
        # the whole split staged on the card once, batches gathered there;
        # the directory names the split for the reader, and build_cache
        # rebuilds a directory whose source no longer matches
        from shape_based_object_detection_torch.data.cache import (
            DeviceCacheLoader, MemmapDetection, build_cache,
        )

        tag = (f"{size}_{args.train_images}x{args.val_images}"
               f"_a{args.aspect_std:g}_g{args.max_objects}_c{cfg.model.num_classes}"
               + (f"_ca{args.class_aspect:g}" if args.class_aspect else ""))
        train_dir = build_cache(train_ds, os.path.join(args.cache_dir, f"train_{tag}"),
                                cfg.data.max_boxes, workers=1)
        loader = DeviceCacheLoader(MemmapDetection(train_dir), cfg.data.batch_size,
                                   cfg.data.max_boxes, device=dev, seed=seed, shuffle=True)
        train_batches = loader.device_batches
        val_dir = build_cache(val_ds, os.path.join(args.cache_dir, f"val_{tag}"),
                              cfg.data.max_boxes, workers=1)
        val_loader = DeviceCacheLoader(MemmapDetection(val_dir), cfg.data.batch_size,
                                       cfg.data.max_boxes, device=dev, shuffle=False)
    else:
        from shape_based_object_detection_torch.data.pipeline import Loader

        loader = Loader(train_ds, cfg.data.batch_size, cfg.data.max_boxes, seed=seed,
                        shuffle=True)
        train_batches = loader.batches
        val_loader = Loader(val_ds, cfg.data.batch_size, cfg.data.max_boxes, shuffle=False)
    return Arm(cfg, module, anchors, state, step_fn, train_batches,
               val_loader.batches_padded, dev)


def train_arm(args, arm: Arm, shape_weight: float):
    """``args.steps`` steps of the arm: ``(state, last logged loss,
    seconds)``."""
    from shape_based_object_detection_torch.tools._ablation import train_steps

    every = max(args.steps // 10, 1)

    def log(step, loss):
        print(f"  [w={shape_weight:g}] step {step}/{args.steps} loss={loss:.4f}", flush=True)

    return train_steps(arm.step_fn, arm.state, arm.train_batches, args.steps,
                       lambda step: step % every == 0, log)


def score_arm(arm: Arm):
    """The COCO metrics of the arm's model (its train state's weights) on
    the held-out split, through ``make_eval_step``."""
    from shape_based_object_detection_torch import train as train_lib
    from shape_based_object_detection_torch.tools._ablation import score

    eval_step = train_lib.make_eval_step(arm.module, arm.anchors, arm.cfg, device=arm.device)
    return score(lambda images: eval_step(arm.state, images), arm.val_batches(),
                 arm.cfg.model.image_size).coco()


def arm_row(args, shape_weight, seed, metrics, last_loss, train_s, device) -> dict:
    def finite_or_none(v):  # strata with no GT are NaN; strict JSON has no NaN
        return float(v) if np.isfinite(v) else None

    return {
        "shape_weight": shape_weight,
        "seed": seed,
        "class_aspect": args.class_aspect,
        **{k: finite_or_none(metrics[k])
           for k in ("mAP", "AP50", "AP75", "APsmall", "APmedium", "APlarge")},
        "final_loss": last_loss,
        "train_s": round(train_s, 1),
        "device": device,
    }


def run_arm(args, shape_weight: float, seed: int = 7) -> dict:
    """Builds, trains and scores one arm: its row of the report."""
    from shape_based_object_detection_torch.tools._ablation import device_field

    arm = build_arm(args, shape_weight, seed)
    _, last_loss, train_s = train_arm(args, arm, shape_weight)
    return arm_row(args, shape_weight, seed, score_arm(arm), last_loss, train_s,
                   device_field(arm.device))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--family", choices=["retinanet", "ssd"], default="retinanet")
    p.add_argument("--model-preset", default=None,
                   help="full-size model preset (e.g. ssd300, retinanet_r50_fpn) instead "
                        "of --family's tiny model: the at-scale ablation")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--shape-weight", type=float, default=0.3,
                   help="shape_weight of the shape-aware arm (config #3's value)")
    p.add_argument("--tau", type=float, default=1.0)
    p.add_argument("--class-aspect", type=float, default=0.0,
                   help="per-class characteristic log-aspect spread (synthetic.py "
                        "class_aspect): the variant where object shape carries the class")
    p.add_argument("--aspect-std", type=float, default=1.2,
                   help="log-aspect stddev of the synthetic objects "
                        "(1.2 => ~22%% of boxes beyond 4.5:1)")
    p.add_argument("--train-images", type=int, default=512)
    p.add_argument("--val-images", type=int, default=128)
    p.add_argument("--max-objects", type=int, default=4)
    p.add_argument("--num-classes", type=int, default=0,
                   help="override the preset's class count (0 = keep); 20 gives the "
                        "full-size ablation's images per class")
    p.add_argument("--loader", choices=["threads", "device"], default="threads",
                   help="device = stage the synthetic splits on the card once and gather "
                        "batches there (same batch membership and schedule, still paired "
                        "per seed across arms)")
    p.add_argument("--cache-dir",
                   default=os.path.join(tempfile.gettempdir(), "ablate_matching_cache"),
                   help="--loader device memmap cache location")
    p.add_argument("--seeds", type=int, default=3,
                   help="independent replicates per arm (seeds 7..7+N-1); the delta "
                        "reported is the paired per-seed mean and std")
    p.add_argument("--arms-file", default="",
                   help="JSONL path: each finished arm is appended, and on restart the "
                        "(seed, shape_weight) arms already recorded are skipped")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    return p


def _load_done(args) -> dict:
    done: dict = {}
    if args.arms_file and os.path.exists(args.arms_file):
        with open(args.arms_file) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    if r.get("class_aspect", 0.0) != args.class_aspect:
                        continue  # an arm of another benchmark variant
                    done[(r["seed"], r["shape_weight"])] = r
        if done:
            print(f"resuming: {len(done)} arm(s) loaded from {args.arms_file}", flush=True)
    return done


def summary(args, seeds, results, device) -> dict:
    """The final JSON: the paired per-seed delta (shape - IoU), each arm's
    mean and std (ddof 1), the arms, and what the run was."""
    iou_maps = np.asarray([r["mAP"] for r in results if r["shape_weight"] == 0.0])
    shape_maps = np.asarray([r["mAP"] for r in results if r["shape_weight"] != 0.0])
    deltas = shape_maps - iou_maps  # paired per seed (same order)
    if max(iou_maps.mean(), shape_maps.mean()) < 0.05:
        print("WARNING: both arms' absolute mAP < 0.05 — the benchmark has no resolving "
              "power at this scale/step count (or the harness is broken); the delta below "
              "measures noise, not the matcher.", file=sys.stderr)

    def std(x):
        return round(float(x.std(ddof=1)), 4) if len(x) > 1 else None

    return {
        "metric": "shape_matching_map_delta_synthetic",
        "value": round(float(deltas.mean()), 4),
        "std": std(deltas),
        "unit": "mAP",
        "iou_mAP_mean": round(float(iou_maps.mean()), 4),
        "iou_mAP_std": std(iou_maps),
        "shape_mAP_mean": round(float(shape_maps.mean()), 4),
        "shape_mAP_std": std(shape_maps),
        "seeds": seeds,
        "arms": results,
        "note": (f"{args.model_preset or ('tiny ' + args.family)}, {args.steps} steps, "
                 f"aspect_std={args.aspect_std}, loader={args.loader} (device sorts indices "
                 "within a batch, so per-sample augmentation draws differ from threads "
                 "runs: deltas are paired within one run, never across loader modes); "
                 "arms paired per seed (identical init/data within a seed); COCO-protocol "
                 "mAP on held-out synthetic val"),
        "device": device,
    }


def main(argv=None):
    from shape_based_object_detection_torch.tools._ablation import device_field

    args = _parser().parse_args(argv)
    device = device_field(args.device)  # raises without a card unless --device cpu
    done = _load_done(args)
    seeds = list(range(7, 7 + args.seeds))
    results = []
    for seed in seeds:
        for w in (0.0, args.shape_weight):
            if (seed, w) in done:
                print(f"--- seed {seed}, shape_weight {w:g} --- (cached)", flush=True)
                results.append(done[(seed, w)])
                continue
            print(f"--- seed {seed}, shape_weight {w:g} ---", flush=True)
            r = run_arm(args, w, seed=seed)
            results.append(r)
            if args.arms_file:
                with open(args.arms_file, "a") as f:
                    f.write(json.dumps(r) + "\n")

    print(f"\n{'seed':>5} {'shape_w':>8} {'mAP':>7} {'AP50':>7} {'AP75':>7} "
          f"{'APsmall':>8} {'APmed':>7} {'APlarge':>8}")
    for r in results:
        row = [r[k] for k in ("mAP", "AP50", "AP75", "APsmall", "APmedium", "APlarge")]
        cells = " ".join(f"{v:>7.4f}" if v is not None else f"{'—':>7}" for v in row)
        print(f"{r['seed']:>5} {r['shape_weight']:>8g} {cells}")
    out = summary(args, seeds, results, device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
