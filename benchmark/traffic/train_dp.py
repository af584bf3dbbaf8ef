"""Data-parallel training, one rank process per card, composed as
``cli/train_cli`` composes it under torchrun: the program's
``parallel.mesh.initialize_multihost`` joins the ranks (NCCL on the card,
gloo on the CPU), every rank makes the weights from the seed and takes rank
0's state (``broadcast_state``), ``data/pipeline.Loader`` shards the pool
by rank (``host_id`` / ``num_hosts``), and ``train.make_train_step(...,
mesh=...)`` steps on each rank's rows of the global batch
``data.batch_size``: augmentation drawn for the global batch, the loss's
positives summed over the group, one all-reduce of the gradients.

As ``train_loop.py`` otherwise: each step's metrics read ``lag`` steps
late, ``warm_steps`` steps of set-up on the window's own call and feed,
the reference following the first three. The ranks agree on the window's
last step: after each step every rank adds whether its own window has run
``--seconds`` to a MAX over a gloo group of the same ranks (on the host,
not waited for), and each stops after the step at which the MAX of ``lag``
steps before reads true.

The group's numbers: ``train_images_per_s`` is the global batch's images
of the window's steps over rank 0's window seconds, ``train_peak_gib`` the
largest rank's peak (a MAX over the group), ``attempted`` rank 0's steps;
the per-layer records are rank 0's, with its own images (one card's mfu)
and the group's size (``world``, for the all-reduce's bus bytes). After
the window every rank leaves the group, and rank 0 alone works out the
reference (``reference/train_blocks.py``) on the global batches in blocks
of ``ref_block`` rows and compares its own rows' heads; the others report
no checks.

Parameters: ``ranks`` (the data-parallel ranks the cell runs on),
``pool_images``, ``max_objects``, ``workers``, ``lag``, ``warm_steps``,
``ref_block``, ``weights`` (as ``train_loop.py``'s).
"""

from __future__ import annotations

import collections
import itertools

import torch

from benchmark.harness import compare, flops, images, roofline
from benchmark.harness.trace import Spans, Window
from benchmark.harness.weights import make_weights
from benchmark.reference import models as ref_models
from benchmark.reference import train_blocks

CHECKED_STEPS = 3


class WindowEnd:
    """Whether the group's window is over, agreed ``lag`` steps late: each
    call adds this rank's own answer to a MAX over ``group`` (gloo, on the
    host, asynchronous) and returns the MAX of ``lag`` calls before, so
    every rank returns true at the same call. Without a group, the rank's
    own answer."""

    def __init__(self, group, lag: int):
        self.group, self.lag = group, lag
        self.pending = collections.deque()

    def __call__(self, own: bool) -> bool:
        import torch.distributed as dist

        if self.group is None:
            return own
        flag = torch.tensor([int(own)])
        work = dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group, async_op=True)
        self.pending.append((flag, work))
        if len(self.pending) <= self.lag:
            return False
        flag, work = self.pending.popleft()
        work.wait()
        return bool(flag.item())

    def close(self) -> None:
        """Wait for the MAXes still open (every rank made the same calls)."""
        while self.pending:
            self.pending.popleft()[1].wait()


def run(ctx) -> dict:
    import torch.distributed as dist

    from shape_based_object_detection_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.initialize_multihost(device=ctx.device)
    try:
        if mesh.data_size != ctx.params["ranks"]:
            raise ValueError(f"the cell runs on {ctx.params['ranks']} ranks; the group has "
                             f"{mesh.data_size}")
        ends = WindowEnd(dist.new_group(backend="gloo") if mesh.distributed else None,
                         ctx.params["lag"])
        out, prog, pool = train(ctx, mesh, ends)
    finally:
        mesh_lib.shutdown(mesh)
    if mesh.rank == 0:
        weights, draw_seed, batches = reference_inputs(ctx, mesh.device, pool)
        per_rank = len(batches[0][0]) // ctx.params["ranks"]
        ref = train_blocks.run_steps(weights, batches, draw_seed, ctx.config["experiment"],
                                     "float32", mesh.device, ctx.params["ref_block"], per_rank)
        prog["heads"] = tuple(t.to(mesh.device) for t in prog["heads"])
        out["checks"], notes = compare.training_gaps(prog, ref)
        out["notes"].update(notes)
    return out


def train(ctx, mesh, ends: WindowEnd):
    """The program's set-up, warm steps and window on this rank: what
    ``run`` returns but the checks, rank 0's readings of its first steps
    (on the host), and the pool."""
    import torch.distributed as dist

    from shape_based_object_detection_torch import train as train_lib
    from shape_based_object_detection_torch.config import config_from_dict
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching_cuda
    from shape_based_object_detection_torch.parallel.mesh import (
        broadcast_state, make_mesh_for_batch,
    )

    p, dev, exp = ctx.params, mesh.device, ctx.config["experiment"]
    lead = mesh.rank == 0
    ctx.mark("imports")
    cfg = config_from_dict(exp)
    weights = make_weights(ref_models.param_specs(exp), p.get("weights", {}),
                           ctx.sub_seed("weights"), dev)
    ctx.mark("weights")
    module, anchors = build_model(cfg.model, dev, train=True)
    module.load_state_dict(weights, strict=True)
    del weights
    ctx.mark("model")
    state = train_lib.create_train_state(
        module, cfg, dev,
        generator=torch.Generator(device=dev).manual_seed(ctx.sub_seed("augment")))
    state = broadcast_state(state, mesh)
    step = train_lib.make_train_step(module, anchors, cfg, augment=True, device=dev, mesh=mesh)
    ctx.mark("state")
    b = make_mesh_for_batch(cfg.data.batch_size, mesh)
    size, g = cfg.model.image_size, cfg.data.max_boxes
    pool = images.synthetic_pool(ctx.sub_seed("pool"), p["pool_images"], size,
                                 p["max_objects"], cfg.model.num_classes, dev)
    loader = Loader(pool, b, g, seed=ctx.sub_seed("loader") % (1 << 31), shuffle=True,
                    host_id=mesh.data_index, num_hosts=mesh.data_size, workers=p["workers"])
    ctx.mark("pool")

    def stream():
        for epoch in itertools.count():
            yield from loader.device_batches(epoch, device=dev)

    feed = stream()
    names = [n for n, _ in module.named_parameters()]
    params0 = {n: t.detach().clone() for n, t in module.named_parameters()} if lead else None
    losses, grad, delta, heads = [], None, None, []

    def first_heads(mod, args, out):  # the first forward's outputs, kept on the host
        if not heads:
            heads.extend(t.detach().to("cpu", torch.float32, copy=True) for t in out)

    hook = module.register_forward_hook(first_heads) if lead else None
    for i in range(p["warm_steps"]):
        state, metrics = step(state, next(feed)._asdict())
        losses.append(metrics["loss"])
        if i == 0 and lead:
            hook.remove()
            grad = {n: t.to("cpu", copy=True) for n, t in zip(names, state.opt_state.trace)}
        if i == CHECKED_STEPS - 1 and lead:
            delta = {n: (t.detach() - params0[n]).cpu() for n, t in module.named_parameters()}
            del params0
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
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with Window(ctx.trace, dev) as win:
        ctx.window_opens()
        while True:
            with spans("train.loader_wait"):
                batch = next(feed)
            state, metrics = step(state, batch._asdict())
            steps += 1
            pending.append(metrics["loss"])
            if len(pending) > p["lag"]:
                pending.popleft().item()
            if ends(win.elapsed() >= ctx.seconds):
                break
        seconds = win.close()
    ends.close()
    k2_calls = matching_cuda.launches - launches0
    if ctx.trace:
        train_lib.match_batch = match_batch
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0],
                        dtype=torch.float64, device=dev)
    own_peak = int(peak.item())
    if mesh.distributed:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    feed.close()
    loader.close()
    del state, step, module, metrics, batch, pending
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    records = {
        "spans": dict(spans.seconds),
        "images": steps * b,
        "steps": steps,
        "world": mesh.world,
        "window_s": seconds,
        "flops_per_image": flops.train_flops(exp["model"]),
        "peak_flops": roofline.peak_flops(exp["model"]),
        "k2": {"calls": k2_calls,
               "bound_s": [roofline.match_bound_s(b, anchors.shape[0], g, int(n),
                                                  cfg.match.shape_weight)
                           for n in valid_counts]},
    }
    out = {
        "e2e": {"train_images_per_s": steps * cfg.data.batch_size / seconds,
                "train_peak_gib": float(peak.item()) / 2 ** 30},
        "records": records,
        "timeline": win.timeline,
        "checks": {},
        "notes": {"rank_peak_gib": own_peak / 2 ** 30, **nccl_notes(win.timeline, steps)},
        "attempted": steps,
        "failed": 0,
        "memory_peak_bytes": own_peak,
    }
    return out, prog, pool


def nccl_notes(timeline, steps: int) -> dict:
    """Of a traced window: device ms per step of each NCCL kernel by name
    (the name carries the algorithm and protocol NCCL chose for a buffer's
    size, so the gradients' all-reduce and the count's part there)."""
    if not timeline or not steps:
        return {}
    per = collections.Counter()
    for name, start, end in timeline["kernels"]:
        if name.startswith("nccl"):
            per[name.split("(")[0]] += (end - start) / 1e6 / steps
    return {"nccl_ms_per_step": dict(per)} if per else {}


def reference_inputs(ctx, device, pool=None):
    """The weights, the augmentation's seed and the first global batches,
    on ``device``, as a run of the cell makes them (from its ``pool`` where
    given)."""
    p, exp = ctx.params, ctx.config["experiment"]
    m, d = exp["model"], exp["data"]
    weights = make_weights(ref_models.param_specs(exp), p.get("weights", {}),
                           ctx.sub_seed("weights"), device)
    if pool is None:
        pool = images.synthetic_pool(ctx.sub_seed("pool"), p["pool_images"], m["image_size"],
                                     p["max_objects"], m["num_classes"], device)
    seed, per_rank = ctx.sub_seed("loader") % (1 << 31), d["batch_size"] // p["ranks"]
    batches = []
    for k in range(CHECKED_STEPS):
        rows = train_blocks.global_rows(len(pool), seed, p["ranks"], per_rank, k)
        batches.append(tuple(torch.from_numpy(a).to(device)
                             for a in pool.padded(rows, d["max_boxes"])))
    return weights, ctx.sub_seed("augment"), batches


def control(ctx, precision: str) -> dict:
    """The reference's steps in ``precision`` (the control) and with the
    second half of every rank's rows left out (a fault), each held against
    the float32 reference by the cell's numbers; on one card."""
    p, exp, dev = ctx.params, ctx.config["experiment"], ctx.device
    weights, draw_seed, batches = reference_inputs(ctx, dev)
    per_rank = exp["data"]["batch_size"] // p["ranks"]

    def steps(batches, precision, per_rank):
        return train_blocks.run_steps(weights, batches, draw_seed, exp, precision, dev,
                                      p["ref_block"], per_rank)

    ref = steps(batches, "float32", per_rank)
    low = steps(batches, precision, per_rank)
    control, notes = compare.training_gaps(low, ref)
    del low
    keep = torch.cat([torch.arange(r * per_rank, r * per_rank + per_rank // 2)
                      for r in range(p["ranks"])])
    half = [tuple(t[keep.to(t.device)] for t in bt) for bt in batches]
    fault, _ = compare.training_gaps(steps(half, "float32", per_rank // 2), ref)
    return {**control, **{"half_" + k: v for k, v in fault.items()}, "notes": notes}
