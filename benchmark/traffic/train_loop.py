"""Training: a pool of synthetic images through the program's
``data/pipeline.Loader`` (thread workers, shuffled per epoch),
``device_batches`` feeding ``train.make_train_step`` (augmentation on the
device, forward, matching, loss, backward, SGD), each step's metrics read
``lag`` steps late, as ``cli/train_cli`` composes them.

Set-up builds one training state and drives it through its first
``warm_steps`` steps on the window's own call and feed; the reference
follows the first three (their losses, the first step's head outputs,
read by a hook on the model while that step runs, the momentum after
step 1, the parameters' change after step 3), and the window continues
the same state and the same batch stream.

Parameters: ``pool_images``, ``max_objects`` (1 to this many objects per
image), ``workers``, ``lag``, ``warm_steps``, ``weights`` (a recipe of
``harness/weights.py``; none is the published initialisers).
"""

from __future__ import annotations

import collections
import itertools

import torch

from benchmark.harness import compare, flops, images, roofline
from benchmark.harness.trace import Spans, Window
from benchmark.harness.weights import make_weights
from benchmark.reference import models as ref_models
from benchmark.reference import ops as ref_ops
from benchmark.reference import train as ref_train

CHECKED_STEPS = 3


def run(ctx) -> dict:
    from shape_based_object_detection_torch import train as train_lib
    from shape_based_object_detection_torch.config import config_from_dict
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching_cuda

    p, dev, exp = ctx.params, ctx.device, ctx.config["experiment"]
    ctx.mark("imports")
    cfg = config_from_dict(exp)
    weights = make_weights(ref_models.param_specs(exp), p.get("weights", {}),
                           ctx.sub_seed("weights"), dev)
    ctx.mark("weights")
    module, anchors = build_model(cfg.model, dev, train=True)
    module.load_state_dict(weights, strict=True)
    ctx.mark("model")
    draw_seed = ctx.sub_seed("augment")
    state = train_lib.create_train_state(
        module, cfg, dev, generator=torch.Generator(device=dev).manual_seed(draw_seed))
    step = train_lib.make_train_step(module, anchors, cfg, augment=True, device=dev)
    ctx.mark("state")
    size, b, g = cfg.model.image_size, cfg.data.batch_size, cfg.data.max_boxes
    pool = images.synthetic_pool(ctx.sub_seed("pool"), p["pool_images"], size,
                                 p["max_objects"], cfg.model.num_classes, dev)
    loader_seed = ctx.sub_seed("loader") % (1 << 31)
    loader = Loader(pool, b, g, seed=loader_seed, shuffle=True, workers=p["workers"])
    ctx.mark("pool")

    def stream():
        for epoch in itertools.count():
            yield from loader.device_batches(epoch, device=dev)

    feed = stream()
    names = [n for n, _ in module.named_parameters()]
    losses, grad, heads = [], None, []

    def first_heads(mod, args, out):  # the first forward's outputs (a rematerialised one repeats it)
        if not heads:
            heads.extend(t.detach().float().clone() for t in out)

    hook = module.register_forward_hook(first_heads)
    for i in range(p["warm_steps"]):
        state, metrics = step(state, next(feed)._asdict())
        losses.append(metrics["loss"])
        if i == 0:
            hook.remove()
            grad = {n: t.clone() for n, t in zip(names, state.opt_state.trace)}
        if i == CHECKED_STEPS - 1:
            delta = {n: t.detach() - weights[n] for n, t in module.named_parameters()}
        ctx.mark(f"step{i}")
    prog = {"losses": [float(x) for x in losses[:CHECKED_STEPS]], "grad": grad, "delta": delta,
            "heads": heads}

    spans = Spans(ctx.trace)
    valid_counts = []
    if ctx.trace:  # the matcher's valid GTs per step, for K2's bound
        match_batch = train_lib.match_batch

        def counted(anchors_, boxes, labels, valid, *args):
            valid_counts.append(valid.sum())
            return match_batch(anchors_, boxes, labels, valid, *args)

        train_lib.match_batch = counted
    pending = collections.deque()
    steps = 0
    launches0 = matching_cuda.launches
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats(dev)
    with Window(ctx.trace, dev) as win:
        ctx.window_opens()
        while win.elapsed() < ctx.seconds:
            with spans("train.loader_wait"):
                batch = next(feed)
            state, metrics = step(state, batch._asdict())
            steps += 1
            pending.append(metrics["loss"])
            if len(pending) > p["lag"]:
                pending.popleft().item()
        seconds = win.close()
    k2_calls = matching_cuda.launches - launches0
    if ctx.trace:
        train_lib.match_batch = match_batch
    peak = torch.cuda.max_memory_allocated(dev) if dev != "cpu" else 0
    feed.close()
    loader.close()
    del state, step, module, metrics, batch, pending
    if dev != "cpu":
        torch.cuda.empty_cache()

    # the reference: epoch 0's first batches, the same draws
    order = ref_ops.epoch_order(len(pool), loader_seed, 0)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in pool.padded(order[k * b:(k + 1) * b], g))
               for k in range(CHECKED_STEPS)]
    ref = ref_train.run_steps(weights, batches, draw_seed, exp, "float32", dev)

    checks, notes = compare.training_gaps(prog, ref)
    records = {
        "spans": dict(spans.seconds),
        "images": steps * b,
        "steps": steps,
        "window_s": seconds,
        "flops_per_image": flops.train_flops(exp["model"]),
        "peak_flops": roofline.peak_flops(exp["model"]),
        "k2": {"calls": k2_calls,
               "bound_s": [roofline.match_bound_s(b, anchors.shape[0], g, int(n),
                                                  cfg.match.shape_weight)
                           for n in valid_counts]},
    }
    return {
        "e2e": {"train_images_per_s": steps * b / seconds,
                "train_peak_gib": peak / 2 ** 30},
        "records": records,
        "timeline": win.timeline,
        "checks": checks,
        "notes": notes,
        "attempted": steps,
        "failed": 0,
        "memory_peak_bytes": int(peak),
    }


def reference_inputs(ctx, exp):
    """The weights, the augmentation's seed and epoch 0's first batches, on
    the device, as a run makes them."""
    p, dev = ctx.params, ctx.device
    m, d = exp["model"], exp["data"]
    weights = make_weights(ref_models.param_specs(exp), p.get("weights", {}),
                           ctx.sub_seed("weights"), dev)
    pool = images.synthetic_pool(ctx.sub_seed("pool"), p["pool_images"], m["image_size"],
                                 p["max_objects"], m["num_classes"], dev)
    b, g = d["batch_size"], d["max_boxes"]
    order = ref_ops.epoch_order(len(pool), ctx.sub_seed("loader") % (1 << 31), 0)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in pool.padded(order[k * b:(k + 1) * b], g))
               for k in range(CHECKED_STEPS)]
    return weights, ctx.sub_seed("augment"), batches


def control(ctx, precision: str) -> dict:
    """The reference's steps in ``precision`` (the control) and with half
    of each batch left out, the mean over the rest (a fault), each held
    against the float32 reference by the cell's numbers."""
    exp, dev = ctx.config["experiment"], ctx.device
    weights, draw_seed, batches = reference_inputs(ctx, exp)
    ref = ref_train.run_steps(weights, batches, draw_seed, exp, "float32", dev)
    low = ref_train.run_steps(weights, batches, draw_seed, exp, precision, dev)
    half = [tuple(t[:t.shape[0] // 2] for t in bt) for bt in batches]
    halved = ref_train.run_steps(weights, half, draw_seed, exp, "float32", dev)
    control, notes = compare.training_gaps(low, ref)
    fault, _ = compare.training_gaps(halved, ref)
    return {**control, **{"half_" + k: v for k, v in fault.items()}, "notes": notes}
