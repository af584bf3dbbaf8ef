"""Offline batched detection: pre-resized images through
``serving.Predictor`` at one batch size, ``submit`` of batch i+1 before
``poll`` of batch i, as the server's device thread drives it.

Parameters (the cell's ``params``): ``batch``, ``buckets``, ``pool_images``
(distinct images, cycled through), ``side_range`` (the originals' sides),
``weights`` (the recipe of ``harness/weights.py``), ``check_images`` (the
images of the window compared with the reference) and ``ref_pool`` (the
reference candidates each served pick is looked up among).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import compare, flops, images, roofline
from benchmark.harness.trace import Spans, Window
from benchmark.reference import detect as ref_detect
from benchmark.reference import models as ref_models


def run(ctx) -> dict:
    from shape_based_object_detection_torch.config import config_from_dict
    from shape_based_object_detection_torch.ops import nms_cuda
    from shape_based_object_detection_torch.serving import Predictor

    p, dev, exp = ctx.params, ctx.device, ctx.config["experiment"]
    ctx.mark("imports")
    cfg = config_from_dict(exp)
    weights = cell_weights(ctx, exp)
    ctx.mark("weights")
    pred = Predictor(cfg, state_dict=weights, batch_size=p["batch"],
                     bucket_sizes=p["buckets"], min_score=0.0, device=dev)
    ctx.mark("model")
    pool, sizes = images.smooth_images(ctx.sub_seed("images"), p["pool_images"],
                                       cfg.model.image_size, p["side_range"], dev)
    items = [(pool[i], sizes[i]) for i in range(len(pool))]
    b = p["batch"]
    batches = [items[i:i + b] for i in range(0, len(items) - b + 1, b)]
    ctx.mark("pool")
    pred.warmup()
    ctx.mark("warmup")
    pred.submit(batches[0])
    pred.poll()
    ctx.mark("batch0")

    spans = Spans(ctx.trace)
    served = []  # (batch index in the pool, detections)
    launches0 = nms_cuda.launches
    with Window(ctx.trace, dev) as win:
        ctx.window_opens()
        with spans("detect.submit"):
            pred.submit(batches[0])
        i = 0
        while True:
            more = win.elapsed() < ctx.seconds
            if more:
                with spans("detect.submit"):
                    pred.submit(batches[(i + 1) % len(batches)])
            with spans("detect.poll"):
                served.append((i % len(batches), pred.poll()))
            i += 1
            if not more:
                break
        seconds = win.close()
    k1_calls = nms_cuda.launches - launches0
    n_images = len(served) * b
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev != "cpu" else 0
    del pred
    if dev != "cpu":
        torch.cuda.empty_cache()

    det = exp["model"]["detect"]
    records = {
        "spans": dict(spans.seconds),
        "images": n_images,
        "window_s": seconds,
        "flops_per_image": flops.forward_flops(exp["model"]),
        "peak_flops": roofline.peak_flops(exp["model"]),
        "k1": {"calls": k1_calls, "batch": b, "candidates": det["pre_nms_top_k"],
               "max_det": det["max_detections"],
               "bound_s": [roofline.nms_bound_s(b, det["pre_nms_top_k"], det["max_detections"],
                                                [len(d.boxes) for d in dets])
                           for _, dets in served]},
    }

    # the comparison: a sample of the window's images, drawn from the seed
    rng = np.random.default_rng(ctx.sub_seed("check"))
    picks = rng.choice(n_images, size=min(p["check_images"], n_images), replace=False)
    rows = [(served[j // b][0] * b + j % b, served[j // b][1][j % b]) for j in sorted(picks)]
    idx = sorted({r for r, _ in rows})
    ref = dict(zip(idx, ref_detect.candidate_pools(
        weights, pool[idx], [sizes[i] for i in idx], exp, p["ref_pool"], "float32", dev)))
    gaps = []
    for r, d in rows:
        rb, rl, rc = ref[r]
        gaps.append(compare.detection_gaps(
            d.boxes, d.scores, d.labels, rb, rl, rc, det["pre_nms_top_k"], sizes[r],
            det["nms_iou_threshold"], det["max_detections"], ctx.limits["box_gap"]))
    return {
        "e2e": {"detect_images_per_s": n_images / seconds},
        "records": records,
        "timeline": win.timeline,
        "checks": compare.worst(gaps),
        "attempted": n_images,
        "failed": 0,
        "memory_peak_bytes": int(memory_peak),
    }


def cell_weights(ctx, exp):
    from benchmark.harness.weights import make_weights

    return make_weights(ref_models.param_specs(exp), ctx.params["weights"],
                        ctx.sub_seed("weights"), ctx.device)


def control(ctx, precision: str) -> dict:
    """The reference in ``precision`` put in the program's place: its NMS
    picks on the cell's images, held against the float32 reference by the
    cell's numbers."""
    p, dev, exp = ctx.params, ctx.device, ctx.config["experiment"]
    weights = cell_weights(ctx, exp)
    pool, sizes = images.smooth_images(ctx.sub_seed("images"), p["pool_images"],
                                       exp["model"]["image_size"], p["side_range"], dev)
    idx = sorted(np.random.default_rng(ctx.sub_seed("check")).choice(
        len(pool), size=min(p["check_images"], len(pool)), replace=False).tolist())
    return control_gaps(weights, pool[idx], [sizes[i] for i in idx], exp, p["ref_pool"],
                        precision, dev, ctx.limits["box_gap"])


def control_gaps(weights, imgs, sizes, exp, ref_pool, precision, dev, box_tol) -> dict:
    det = exp["model"]["detect"]
    ref = ref_detect.candidate_pools(weights, imgs, sizes, exp, ref_pool, "float32", dev)
    low = ref_detect.candidate_pools(weights, imgs, sizes, exp, ref_pool, precision, dev)
    gaps = []
    for r, c, hw in zip(ref, low, sizes):
        boxes, scores, labels = ref_detect.nms_detections(c, exp)
        gaps.append(compare.detection_gaps(boxes, scores, labels, *r, det["pre_nms_top_k"], hw,
                                           det["nms_iou_threshold"], det["max_detections"],
                                           box_tol))
    return compare.worst(gaps)
