"""Training entry point (port of the JAX package's ``cli/train_cli.py``).

    python -m shape_based_object_detection_torch.cli.train_cli \\
        --config config3_ssd512_voc_train --steps 1000 --data-root /data/VOC2007

Runs on the card unless given ``--device cpu``. Checkpoints (the whole
train state) go to ``--checkpoint-dir``; a rerun resumes from the latest
one, at its place in the data schedule. SIGTERM or SIGINT finishes the step
in flight, saves and exits 0.

Data-parallel over N processes, one per card (NCCL; gloo with ``--device
cpu``): ``torchrun --nproc_per_node N -m
shape_based_object_detection_torch.cli.train_cli ...``, or N processes
started by hand with ``--num-processes N --process-id i --coordinator
host:port``. ``data.batch_size`` is the global batch; each rank loads its
``batch_size / N`` rows, and the step equals a single process's on the
global batch. Rank 0 logs and writes checkpoints.

``--set mesh.model_parallelism=M`` splits each image's rows over M ranks
(the reference's "model" axis, config #5's 1024 px lever): the N ranks form
N / M data indexes of M ranks each; the ranks of one data index load and
augment the same ``batch_size * M / N`` images, and each computes its rows
of every feature map (``ceil(H / M)`` rows, the last ones padding where
they do not split evenly), with the rows its windows read fetched from the
ranks that own them. Any RetinaNet or SSD preset splits. The step equals a
single process's on the global batch.
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

from shape_based_object_detection_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S, all_gather_arrays, single_process,
)

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


def upload(array, dev: torch.device) -> torch.Tensor:
    """A host batch on ``dev``: through pinned memory, asynchronously, on
    the card. A tensor already there (a device-staged cache's) is used as
    it is."""
    if isinstance(array, torch.Tensor):
        return array.to(dev)
    x = torch.from_numpy(array)
    if dev.type == "cuda":
        x = x.pin_memory()
    return x.to(dev, non_blocking=True)


def sharded_batches(loader, mesh):
    """``loader.batches_padded()`` fed by a data-parallel group: each rank
    loads its rows of every padded batch (``Mesh.rows``); yields ``(batch,
    n_valid, gt)`` where ``gt`` is the whole batch's (boxes, labels, valid,
    crowd), gathered from the ranks in rank order. Alone, the batch's own."""
    rows = mesh.rows(loader.batch_size) if mesh.distributed else None
    for b, n_valid in loader.batches_padded(rows=rows):
        gt = (b.boxes, b.labels, b.valid, b.crowd)
        yield b, n_valid, all_gather_arrays(gt, mesh)


def evaluate(eval_step, state, loader, cfg, dev, max_batches: int = 0, mesh=None):
    """VOC mAP of ``eval_step`` over ``loader.batches_padded()`` (at most
    ``max_batches`` batches when set), with the dataset's flag channel: COCO
    crowd (crowd IoU) or VOC difficult (plain ignore). Returns the
    Evaluator. Under a data-parallel ``mesh`` (with ``eval_step`` made on
    it) each rank runs its rows of each batch and every rank scores the
    whole split in the single process's order: the same records, the same
    metric."""
    import types

    from shape_based_object_detection_torch.eval import Evaluator

    mesh = single_process(dev) if mesh is None else mesh
    ev = Evaluator(area_scale=cfg.model.image_size)
    flag_kw = "gt_crowd" if cfg.data.dataset == "coco" else "gt_ignore"
    for i, (b, n_valid, gt) in enumerate(sharded_batches(loader, mesh)):
        det = eval_step(state, upload(b.images, dev))
        det = types.SimpleNamespace(**{k: getattr(det, k)[:n_valid].cpu().numpy()
                                       for k in ("boxes", "scores", "labels", "valid")})
        boxes, labels, valid, crowd = (a[:n_valid] for a in gt)
        ev.add_batch(det, boxes, labels - 1, valid, **{flag_kw: crowd})
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
                   help="data-loader workers: threads for --loader threads, "
                        "processes for --loader grain, cache-build threads for "
                        "--loader cache|device (0 = serial/in-process)")
    p.add_argument("--loader", choices=["threads", "grain", "cache", "device"],
                   default="threads",
                   help="input pipeline: 'threads' = the thread-pool Loader; "
                        "'grain' = worker processes (torch DataLoader) on "
                        "grain's schedule; 'cache' = decode the dataset once "
                        "into a memmap cache (see --cache-dir), then one "
                        "vectorized gather per batch; 'device' = that cache "
                        "staged on the card, batches gathered there (no "
                        "per-step host-to-card copy; the dataset must fit in "
                        "the card's memory; single process only)")
    p.add_argument("--cache-dir", default="",
                   help="--loader cache|device location (default "
                        "<checkpoint-dir>/data_cache)")
    p.add_argument("--init-params", default="",
                   help="initialize the model from a state-dict file "
                        "(torch.save of module.state_dict()); a resumable "
                        "checkpoint in --checkpoint-dir still takes precedence")
    p.add_argument("--ema-decay", type=float, default=-1.0,
                   help="override TrainConfig.ema_decay (e.g. 0.999; "
                        "eval_cli --ema scores the averaged weights)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="data-parallel processes, one per card (without it, "
                        "torchrun's environment sets the group)")
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--coordinator", default="",
                   help="host:port where process 0 meets the others")
    p.add_argument("--dist-timeout", type=float, default=DEFAULT_TIMEOUT_S,
                   help="seconds a process waits for the others, to form the "
                        "group and in each collective, before it fails")
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


def build_loader(args, cfg, dataset, mesh, batch_size: int):
    """The training loader ``--loader`` names, for this rank's shard (its
    data index's) at its per-index ``batch_size``."""
    kw = dict(seed=cfg.train.seed, host_id=mesh.data_index, num_hosts=mesh.data_size,
              workers=args.workers)
    if args.loader == "grain":
        from shape_based_object_detection_torch.data.grain_pipeline import GrainLoader

        return GrainLoader(dataset, batch_size, cfg.data.max_boxes, **kw)
    if args.loader in ("cache", "device"):
        from shape_based_object_detection_torch.data.cache import (
            CacheLoader, DeviceCacheLoader, MemmapDetection, build_cache,
        )

        cache_dir = cache_root(args, cfg)
        build_cache(dataset, cache_dir, cfg.data.max_boxes, workers=max(1, args.workers))
        if args.loader == "device":
            return DeviceCacheLoader(MemmapDetection(cache_dir), batch_size,
                                     cfg.data.max_boxes, device=mesh.device, **kw)
        return CacheLoader(MemmapDetection(cache_dir), batch_size, cfg.data.max_boxes, **kw)
    from shape_based_object_detection_torch.data.pipeline import Loader

    return Loader(dataset, batch_size, cfg.data.max_boxes, **kw)


def cache_root(args, cfg) -> str:
    return args.cache_dir or os.path.join(cfg.train.checkpoint_dir, "data_cache")


def build_val_loader(args, cfg, mesh):
    """The validation split's loader at the global batch (each rank loads
    its rows of every batch); with ``--loader device`` staged on the card
    too, else the thread Loader."""
    val_args = argparse.Namespace(
        data_root=args.val_root, ann_file=args.val_ann_file or args.ann_file,
        split=args.val_split)
    dataset = build_dataset(cfg, val_args, include_ignore=True)
    if args.loader == "device":
        from shape_based_object_detection_torch.data.cache import (
            DeviceCacheLoader, MemmapDetection, build_cache,
        )

        cache_dir = cache_root(args, cfg) + "_val"
        build_cache(dataset, cache_dir, cfg.data.max_boxes, workers=max(1, args.workers))
        return DeviceCacheLoader(MemmapDetection(cache_dir), cfg.data.batch_size,
                                 cfg.data.max_boxes, device=mesh.device, shuffle=False)
    from shape_based_object_detection_torch.data.pipeline import Loader

    return Loader(dataset, cfg.data.batch_size, cfg.data.max_boxes, shuffle=False,
                  workers=args.workers)


def parameter_checksum(module) -> float:
    """The sum of every parameter in float64: equal on ranks in step."""
    with torch.no_grad():
        return float(sum(p.double().sum() for p in module.parameters()))


def main(argv=None):
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.parallel import initialize_multihost, shutdown

    args = _parser().parse_args(argv)
    cfg = resolve_cli_config(args)
    if args.dump_config:
        config_lib.save_config_file(cfg, args.dump_config)
        print(f"wrote resolved config to {args.dump_config}")
        if not args.steps:
            return
    mesh = initialize_multihost(args.coordinator or None, args.num_processes or None,
                                args.process_id, args.device, args.dist_timeout, cfg.mesh)
    try:
        train(args, cfg, mesh)
    finally:
        shutdown(mesh)


def train(args, cfg, mesh):
    """The training loop of ``main`` on ``mesh`` (this process's place in
    the group, or a single process)."""
    from shape_based_object_detection_torch import train as train_lib
    from shape_based_object_detection_torch.checkpoint import (
        BestCheckpointKeeper, CheckpointManager,
    )
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.parallel.mesh import (
        broadcast_state, make_mesh_for_batch,
    )
    from shape_based_object_detection_torch.utils.metrics import MetricsLogger

    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    dev = mesh.device
    per_index_bs = make_mesh_for_batch(cfg.data.batch_size, mesh, cfg.mesh)
    module, anchors = build_model(cfg.model, dev, train=True)
    if args.init_params:
        module.load_state_dict(torch.load(args.init_params, map_location=dev,
                                          weights_only=True), strict=True)
        say(f"initialized params from {args.init_params}")
    state = train_lib.create_train_state(module, cfg, device=dev)
    train_step = train_lib.make_train_step(module, anchors, cfg, device=dev, mesh=mesh)

    ckpt = CheckpointManager(cfg.train.checkpoint_dir, cfg.train.keep_checkpoints,
                             mesh=mesh)
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
            say("checkpoint had no EMA weights; starting EMA from the "
                "restored params")
        elif cfg.train.ema_decay <= 0 and state.ema is not None:
            state.ema = None
            say("checkpoint had EMA weights but ema_decay=0; dropping them "
                "for this run")
        say(f"restored checkpoint at step {state.step}")
    # every rank starts from rank 0's state
    state = broadcast_state(state, mesh)

    dataset = build_dataset(cfg, args)
    loader = build_loader(args, cfg, dataset, mesh, per_index_bs)
    logger = MetricsLogger(log_every=args.log_every,
                           tensorboard_dir=(args.tb_dir or None) if lead else None)
    eval_step = (train_lib.make_eval_step(module, anchors, cfg, device=dev, mesh=mesh)
                 if args.eval_every else None)

    # val-split eval and best-mAP tracking under <checkpoint-dir>/best
    val_loader = best_keeper = None
    if args.eval_every and args.val_root:
        val_loader = build_val_loader(args, cfg, mesh)
        best_keeper = BestCheckpointKeeper(os.path.join(cfg.train.checkpoint_dir, "best"),
                                           mesh=mesh)
    # a train-sample eval gets a Loader of its own: the training loader's
    # producer thread (or stream) may be mid-epoch
    train_sample_loader = None
    if args.eval_every and val_loader is None:
        train_sample_loader = Loader(dataset, cfg.data.batch_size, cfg.data.max_boxes,
                                     shuffle=False, workers=0)

    def run_eval(state):
        if val_loader is not None:
            ev = evaluate(eval_step, state, val_loader, cfg, dev, args.val_batches, mesh)
        else:
            ev = evaluate(eval_step, state, train_sample_loader, cfg, dev, 5, mesh)
        return ev.voc()["mAP"]

    with preemption_signals() as preempted:
        step = state.step
        # resume at the restored step's place in the data schedule, not at
        # epoch 0: the consumed part of the epoch is read once and dropped
        spe = loader.steps_per_epoch()
        epoch = step // spe if spe else 0
        skip = step % spe if spe else 0
        if step and (epoch or skip):
            say(f"resuming data schedule at epoch {epoch}, batch {skip}")
        if step and not hasattr(loader, "_epoch_indices"):
            # one stream serves every epoch (grain): drop the whole consumed
            # prefix from it, epoch after epoch
            prefix = itertools.chain.from_iterable(loader.batches(e) for e in itertools.count())
            for _ in itertools.islice(prefix, epoch * spe + skip):
                pass
            skip = 0
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
            # 3 non-finite losses in a row: the parameters are inf/NaN (the
            # metrics are the group's, so every rank stops together)
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
                say(line, flush=True)

        def _drain():
            while pending:
                _consume_metrics()

        def _close():
            for lo in (loader, val_loader, train_sample_loader):
                if lo is not None:
                    lo.close()
            logger.close()

        def _finish():
            if mesh.distributed:
                print(f"rank {mesh.rank} of {mesh.world}: parameter checksum "
                      f"{parameter_checksum(module)!r}", flush=True)

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
                    say(f"preempted: checkpoint saved at step {step}", flush=True)
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
                    say(line, flush=True)
                if step >= cfg.train.total_steps:
                    break
            epoch += 1
        _drain()
        ckpt.save(state, step)
        ckpt.close()
        _close()
        _finish()
        say(f"done at step {step}")


if __name__ == "__main__":
    main()
