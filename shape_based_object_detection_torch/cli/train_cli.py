"""Training entry point (port of the JAX package's ``cli/train_cli.py``).

    python -m shape_based_object_detection_torch.cli.train_cli \\
        --config config3_ssd512_voc_train --steps 1000 --data-root /data/VOC2007

Runs on the card unless given ``--device cpu``. Checkpoints (the whole
train state) go to ``--checkpoint-dir``; a rerun resumes from the latest
one, at its place in the data schedule. SIGTERM or SIGINT finishes the step
in flight, saves and exits 0.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import os
import signal

import numpy as np
import torch

METRIC_LAG = 4  # steps between a step's launch and the read of its metrics


@contextlib.contextmanager
def preemption_signals():
    """While it is held, SIGTERM and SIGINT (a preemption, an eviction) set
    ``flag["flag"]`` so the loop finishes its step, saves and exits 0; a
    second signal gets the default handler (a hard kill). The previous
    handlers are restored on exit."""
    flag = {"flag": False}

    def on_signal(signum, frame):
        flag["flag"] = True
        signal.signal(signum, signal.SIG_DFL)
        print(f"received signal {signum}: checkpointing and exiting after "
              "the current step (send again to kill)", flush=True)

    previous = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, on_signal)
    except ValueError:
        pass  # called off the main thread: no preemption hook
    try:
        yield flag
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def pack_metrics(metrics):
    """A step's scalar metrics stacked into one tensor and, on the card,
    copied to pinned host memory without a wait: (keys, host tensor, the
    copy's event or None)."""
    keys = sorted(k for k, v in metrics.items() if v.dim() == 0)
    packed = torch.stack([metrics[k].float() for k in keys])
    if not packed.is_cuda:
        return keys, packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return keys, host, ready


def read_metrics(packed) -> dict:
    """The metrics of ``pack_metrics`` as floats: the one read of a step."""
    keys, host, ready = packed
    if ready is not None:
        ready.synchronize()
    return dict(zip(keys, host.tolist()))


def build_dataset(cfg, args, include_ignore: bool = False):
    """The dataset ``args.data_root`` names: ``synthetic://<name>[?k=v&...]``
    (any config; the name seeds the split, the query sizes it), a VOC or
    COCO root by ``cfg.data.dataset``, or the default synthetic split.
    ``include_ignore=True`` (the eval protocol) makes VOC and COCO carry
    their difficult/crowd flags; training leaves them out, so neither ever
    becomes a positive."""
    from shape_based_object_detection_torch.data.coco import CocoDetection
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection
    from shape_based_object_detection_torch.data.voc import VOCDetection

    size = cfg.model.image_size
    lb = cfg.data.letterbox
    dec = cfg.data.decode_backend
    if args.data_root.startswith("synthetic://"):
        import zlib
        from urllib.parse import parse_qsl

        name, _, query = args.data_root.removeprefix("synthetic://").partition("?")
        params = dict(parse_qsl(query, strict_parsing=bool(query)))
        known = {"n": int, "max_objects": int, "classes": int,
                 "aspect_std": float, "color_jitter": float,
                 "area_lo": float, "area_hi": float, "class_aspect": float}
        bad = sorted(set(params) - set(known))
        if bad:
            raise SystemExit(
                f"unknown synthetic:// parameter(s) {bad}; known: {sorted(known)}")
        kw = {k: known[k](v) for k, v in params.items()}
        # crc32, not hash(): the split must be the same in every process;
        # seeded by the name only, so n=4000 extends the n=64 split
        seed = zlib.crc32(name.encode()) % (2**31)
        return SyntheticDetection(
            size=size,
            num_images=kw.pop("n", max(64, cfg.data.batch_size * 4)),
            num_classes=kw.pop("classes", cfg.model.num_classes),
            seed=seed, **kw)
    if args.data_root and cfg.data.dataset == "voc":
        return VOCDetection(args.data_root, split=args.split, image_size=size,
                            letterbox=lb, include_difficult=include_ignore,
                            decode_backend=dec)
    if args.data_root and cfg.data.dataset == "coco":
        return CocoDetection(args.data_root, args.ann_file, image_size=size,
                             letterbox=lb, include_crowd=include_ignore,
                             decode_backend=dec)
    return SyntheticDetection(size=size, num_images=max(64, cfg.data.batch_size * 4),
                              num_classes=cfg.model.num_classes)


def upload(array: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host batch on ``dev``: through pinned memory, asynchronously, on
    the card."""
    x = torch.from_numpy(array)
    if dev.type == "cuda":
        x = x.pin_memory()
    return x.to(dev, non_blocking=True)


def evaluate(eval_step, state, loader, cfg, dev, max_batches: int = 0):
    """VOC mAP of ``eval_step`` over ``loader.batches_padded()`` (at most
    ``max_batches`` batches when set), with the dataset's flag channel: COCO
    crowd (crowd IoU) or VOC difficult (plain ignore). Returns the
    Evaluator."""
    import types

    from shape_based_object_detection_torch.eval import Evaluator

    ev = Evaluator(area_scale=cfg.model.image_size)
    flag_kw = "gt_crowd" if cfg.data.dataset == "coco" else "gt_ignore"
    for i, (b, n_valid) in enumerate(loader.batches_padded()):
        det = eval_step(state, upload(b.images, dev))
        det = types.SimpleNamespace(**{k: getattr(det, k)[:n_valid].cpu().numpy()
                                       for k in ("boxes", "scores", "labels", "valid")})
        ev.add_batch(det, b.boxes[:n_valid], b.labels[:n_valid] - 1, b.valid[:n_valid],
                     **{flag_kw: b.crowd[:n_valid]})
        if max_batches and i + 1 >= max_batches:
            break
    return ev


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="config3_ssd512_voc_train")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu' for the plain versions")
    p.add_argument("--data-root", default="")
    p.add_argument("--ann-file", default="")
    p.add_argument("--split", default="train")
    p.add_argument("--steps", type=int, default=0, help="override total steps")
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--tb-dir", default="",
                   help="write TensorBoard scalars (loss terms, img/s)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run VOC-mAP eval every N steps (on --val-root if "
                        "given, else a sample of the train stream)")
    p.add_argument("--val-root", default="",
                   help="validation dataset root: enables val-split eval and "
                        "best-mAP checkpoint tracking (kept under "
                        "<checkpoint-dir>/best)")
    p.add_argument("--val-ann-file", default="")
    p.add_argument("--val-split", default="val")
    p.add_argument("--val-batches", type=int, default=0,
                   help="cap on val batches per eval (0 = the whole split)")
    p.add_argument("--workers", type=int, default=4,
                   help="data-loader threads (0 = serial)")
    p.add_argument("--loader", choices=["threads", "grain", "cache", "device"],
                   default="threads",
                   help="input pipeline; only 'threads' (the thread-pool "
                        "Loader) is ported")
    p.add_argument("--init-params", default="",
                   help="initialize the model from a state-dict file "
                        "(torch.save of module.state_dict()); a resumable "
                        "checkpoint in --checkpoint-dir still takes precedence")
    p.add_argument("--ema-decay", type=float, default=-1.0,
                   help="override TrainConfig.ema_decay (e.g. 0.999; "
                        "eval_cli --ema scores the averaged weights)")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, e.g. --set model.image_size=512 "
                        "(JSON-parsed values)")
    p.add_argument("--dump-config", default="",
                   help="write the fully-resolved experiment config as JSON "
                        "(re-runnable via --config <file>.json) and exit if "
                        "no --steps given")
    return p


def resolve_cli_config(args):
    """The experiment config of the command line: preset or JSON file,
    ``--set`` overrides, then ``--steps``, ``--batch-size``,
    ``--checkpoint-dir`` and ``--ema-decay``; ``train.remat`` promotes to
    ``model.remat`` (segment-wise remat, the effective memory lever)."""
    from shape_based_object_detection_torch import config as config_lib

    cfg = config_lib.resolve_config(args.config, args.overrides)
    train_kw, data_kw = {}, {}
    if args.steps:
        train_kw["total_steps"] = args.steps
    if args.checkpoint_dir:
        train_kw["checkpoint_dir"] = args.checkpoint_dir
    if args.ema_decay >= 0:
        train_kw["ema_decay"] = args.ema_decay
    if args.batch_size:
        data_kw["batch_size"] = args.batch_size
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw),
                              data=dataclasses.replace(cfg.data, **data_kw))
    if cfg.train.remat and not cfg.model.remat:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True))
    return cfg


def main(argv=None):
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch import train as train_lib
    from shape_based_object_detection_torch.checkpoint import (
        BestCheckpointKeeper, CheckpointManager,
    )
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.utils.device import resolve_device
    from shape_based_object_detection_torch.utils.metrics import MetricsLogger

    args = _parser().parse_args(argv)
    if args.loader != "threads":
        raise NotImplementedError(
            f"--loader {args.loader} is not ported yet (ROADMAP.md, modules still "
            "to port, item 3: the cache, device and grain loaders); use the "
            "default --loader threads")
    if args.num_processes > 1:
        raise NotImplementedError(
            "--num-processes > 1 (multi-process data parallelism) is not ported "
            "yet (ROADMAP.md, modules still to port, item 5)")
    cfg = resolve_cli_config(args)
    if args.dump_config:
        config_lib.save_config_file(cfg, args.dump_config)
        print(f"wrote resolved config to {args.dump_config}")
        if not args.steps:
            return

    dev = resolve_device(args.device)
    module, anchors = build_model(cfg.model, dev, train=True)
    if args.init_params:
        module.load_state_dict(torch.load(args.init_params, map_location=dev,
                                          weights_only=True), strict=True)
        print(f"initialized params from {args.init_params}")
    state = train_lib.create_train_state(module, cfg, device=dev)
    train_step = train_lib.make_train_step(module, anchors, cfg, device=dev)

    ckpt = CheckpointManager(cfg.train.checkpoint_dir, cfg.train.keep_checkpoints)
    try:
        restored = ckpt.restore_latest(state)
    except ValueError as e:
        # only the structure mismatch gets the friendly wrapper; read errors
        # propagate as they are, so a recoverable run is not deleted
        if "do not match" not in str(e):
            raise
        raise SystemExit(
            f"checkpoint in {cfg.train.checkpoint_dir!r} does not match the "
            f"--config {args.config!r} model/optimizer structure (it was "
            "likely written by a different config). Use a matching --config "
            "or a fresh --checkpoint-dir.\n"
            f"original error: {type(e).__name__}: {str(e)[:500]}")
    if restored is not None:
        state = restored
        # reconcile the EMA with this run's config: the checkpoint's may
        # disagree with --ema-decay either way
        if cfg.train.ema_decay > 0 and state.ema is None:
            state.ema = {n: p.detach().clone() for n, p in module.named_parameters()}
            print("checkpoint had no EMA weights; starting EMA from the "
                  "restored params")
        elif cfg.train.ema_decay <= 0 and state.ema is not None:
            state.ema = None
            print("checkpoint had EMA weights but ema_decay=0; dropping them "
                  "for this run")
        print(f"restored checkpoint at step {state.step}")

    dataset = build_dataset(cfg, args)
    loader = Loader(dataset, cfg.data.batch_size, cfg.data.max_boxes,
                    seed=cfg.train.seed, workers=args.workers)
    logger = MetricsLogger(log_every=args.log_every, tensorboard_dir=args.tb_dir or None)
    eval_step = (train_lib.make_eval_step(module, anchors, cfg, device=dev)
                 if args.eval_every else None)

    # val-split eval and best-mAP tracking under <checkpoint-dir>/best
    val_loader = best_keeper = None
    if args.eval_every and args.val_root:
        val_args = argparse.Namespace(
            data_root=args.val_root, ann_file=args.val_ann_file or args.ann_file,
            split=args.val_split)
        val_loader = Loader(build_dataset(cfg, val_args, include_ignore=True),
                            cfg.data.batch_size, cfg.data.max_boxes, shuffle=False,
                            workers=args.workers)
        best_keeper = BestCheckpointKeeper(os.path.join(cfg.train.checkpoint_dir, "best"))
    # a train-sample eval gets a Loader of its own: the training loader's
    # producer thread may be mid-epoch
    train_sample_loader = None
    if args.eval_every and val_loader is None:
        train_sample_loader = Loader(dataset, cfg.data.batch_size, cfg.data.max_boxes,
                                     shuffle=False, workers=0)

    def run_eval(state):
        if val_loader is not None:
            ev = evaluate(eval_step, state, val_loader, cfg, dev, args.val_batches)
        else:
            ev = evaluate(eval_step, state, train_sample_loader, cfg, dev, 5)
        return ev.voc()["mAP"]

    with preemption_signals() as preempted:
        step = state.step
        # resume at the restored step's place in the data schedule, not at
        # epoch 0: the consumed part of the epoch is read once and dropped
        spe = loader.steps_per_epoch()
        epoch = step // spe if spe else 0
        skip = step % spe if spe else 0
        if step and (epoch or skip):
            print(f"resuming data schedule at epoch {epoch}, batch {skip}")
        nonfinite_steps = 0
        # lagged metrics: a step's metrics are stacked into one tensor on the
        # device and copied to pinned host memory without a wait; they are read
        # METRIC_LAG steps later, when the copy is long done, so host and card
        # never wait on each other for a log line
        pending: collections.deque = collections.deque()

        def _consume_metrics():
            nonlocal nonfinite_steps
            s, packed = pending.popleft()
            m = read_metrics(packed)
            # 3 non-finite losses in a row: the parameters are inf/NaN
            if not np.isfinite(m["loss"]):
                nonfinite_steps += 1
                if nonfinite_steps >= 3:
                    raise SystemExit(
                        f"loss non-finite for {nonfinite_steps} consecutive "
                        f"steps at step {s} — training has diverged. Resume from "
                        f"the last checkpoint in {cfg.train.checkpoint_dir!r} with "
                        "a lower train.base_lr (or enable train.grad_clip_norm).")
            else:
                nonfinite_steps = 0
            line = logger.update(s, m, batch_size=cfg.data.batch_size)
            if line:
                print(line, flush=True)

        def _drain():
            while pending:
                _consume_metrics()

        def _close():
            for lo in (loader, val_loader, train_sample_loader):
                if lo is not None:
                    lo.close()
            logger.close()

        while step < cfg.train.total_steps:
            batch_iter = loader.device_batches(epoch, device=dev)
            if skip:
                batch_iter = itertools.islice(batch_iter, skip, None)
                skip = 0
            for batch in batch_iter:
                state, metrics = train_step(state, batch._asdict())
                step += 1
                pending.append((step, pack_metrics(metrics)))
                if len(pending) > METRIC_LAG:
                    _consume_metrics()
                if preempted["flag"]:
                    _drain()
                    ckpt.save(state, step)
                    ckpt.close()
                    _close()
                    print(f"preempted: checkpoint saved at step {step}", flush=True)
                    return
                if step % cfg.train.checkpoint_every == 0:
                    ckpt.save(state, step)
                if eval_step is not None and step % args.eval_every == 0:
                    _drain()  # eval waits for the card anyway; keep lines in order
                    val_map = run_eval(state)
                    which = "val" if val_loader is not None else "train-sample"
                    line = f"step {step}  voc-mAP({which})={val_map:.4f}"
                    if best_keeper is not None and best_keeper.maybe_save(state, step, val_map):
                        line += "  [new best]"
                    print(line, flush=True)
                if step >= cfg.train.total_steps:
                    break
            epoch += 1
        _drain()
        ckpt.save(state, step)
        ckpt.close()
        _close()
        print(f"done at step {step}")


if __name__ == "__main__":
    main()
