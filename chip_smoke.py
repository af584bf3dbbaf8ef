"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper).

Drives the port's paths at full width with random weights from a seed: the
RetinaNet serving path (R50-FPN at 512 px through ``serving.Predictor``) and
training path (the same model's ``train.make_train_step`` in bf16 at batch
16 with augmentation), then the SSD serving path (SSD300, config #1) and
training path (SSD-512, config #3, shape matching), remat and trainable
BatchNorm, and checks them all:

  1. device and build: the card, its power limit, the CUDA kernels built
     from ``shape_based_object_detection_torch/csrc`` (one nvcc per source,
     all started together; timed);
  2. kernel vs plain: the greedy-NMS kernel (K1) against
     ``ops.nms.greedy_nms`` on the card at (B, N, M) = (16, 1000, 100),
     (16, 400, 200) and (8, 2000, 100), with class-offset boxes, padding
     rows and tied scores, and on the edge cases of ``nms_edge_cases`` in
     ``tests/torch_kernel_cases.py`` (a pick with IoU(p, p) < t filling the remaining slots, t > 1, -0/+0
     ties, no live candidate, N < M); idx, valid and the score bits must be
     equal, one launch each; above its candidate limit the wrapper raises;
  3. forward on the card vs the CPU, float32 with TF32 off, one image, the
     same weights; then detect end to end on both, matched detection by
     detection;
  4. the serving path: a bf16 Predictor at batch 16 answers requests of
     16, 5 and 1 images of differing sizes; K1 must have launched once per
     batch, and run_nms through the kernel must equal the plain version on
     the same candidates; then a 16-image request end to end on the host
     clock, and the host resize alone;
  5. serving timing with CUDA events after warm-up (median and p90): detect
     images/s at batch 16 in bf16 and float32, a stage breakdown, and K1's
     time on the path's candidates (CUDA events between back-to-back wrapper
     calls, and the device time of its kernels under torch.profiler) beside
     its bound and the plain version's time;
  6. the matching kernel (K2) against ``ops.matching.match_reductions_plain``
     at (B, A, G) = (16, 49104, 64) (every GT the same box, 8 of 64 valid:
     all ties), (16, 49104, 100) (random boxes, invalid rows, an image with
     no valid GT, duplicate GTs) and (4, 76725, 100) with shape_weight 0.3,
     and on the edge cases of ``match_edge_cases`` (G = 1, 0 to 100 valid
     rows of 100, every row valid, shape_weight 0.3 and 1.5, all ties);
     assignments bit-equal, the full MatchResult after the epilogue equal;
  7. a train step on the card vs the CPU: full-width R50-FPN-512, float32
     with TF32 off in forward and backward, augment off, batch 2, the same
     weights and batch; two steps (the first runs at warmup lr 0), loss and
     grad_norm within 1e-4 relative, the parameter update within 5e-3 of its
     norm and every parameter within 1e-6;
  8. the training path: a bf16 trainer at batch 16 in the configuration
     ``bench_train.py`` times (config4's training settings, max_boxes 64,
     augmentation on) takes a few steps on a numpy-seeded batch of 1-64
     boxes per image; K2 must launch once per step, the loss stay finite,
     the parameters move from step 2 and stay float32 with their momentum;
  9. training timing with CUDA events: train images/s at b16 bf16, a stage
     breakdown (augment, forward+loss+backward, match_batch, optimizer
     update; forward and forward+loss alone beside them), and K2's time
     (CUDA events and profiler device time, as for K1) beside its bound and
     the plain version's time;
 10. a torch.profiler trace of three train steps: the device's busy time
     per step, hence its idle share, the device time by operator, and the
     host's time to enqueue a step;
 11. K2 on config #3's path: an augmented batch of 32 at (B, A, G) = (32,
     24564, 100), shape_weight 0.3, VOC labels, 1-100 valid boxes per
     image; assignments and best_q bit-equal, the MatchResult under config
     #3's thresholds equal after the epilogue;
 12. the SSD300 forward (COCO, full width) on the card vs the CPU, float32
     with TF32 off, then detect on both, matched detection by detection;
 13. the SSD300 serving path: config #1's Predictor (batch 1) answers
     requests of 1 and 3 images, a bf16 batch-16 Predictor one of 16; K1
     once per batch; K1 against the plain version on the candidates of a
     bf16 b16 detect (bit-equal, one launch), with their count;
 14. SSD300 detect timing at b1 and b16 in float32 and bf16 with a stage
     breakdown, and K1's time at (16, 400, 200) on those candidates;
 15. two float32 SSD-512 train steps of config #3 card vs CPU (TF32 off,
     augment off, batch 2), with phase 7's tolerances;
 16. the SSD-512 trainer as config #3 sets it (float32, b32, augmentation,
     100 boxes, multibox with 3:1 mining, shape_weight 0.3): K2 once per
     step, parameters still at step 1 and moved at step 2; its timing,
     stage breakdown, K2's time and bound there, and its profile;
 17. remat: the SSD-512 b32 step with model.remat on and off, same weights
     and batch: loss and grad_norm within 1e-5, and both peaks of
     torch.cuda.max_memory_allocated;
 18. trainable BatchNorm: two float32 R50-FPN-512 steps with train_bn at b2
     card vs CPU (phase 7's tolerances; the update's held to the CPU's own
     float32 spread; running statistics within 1e-5 + 1e-5*|cpu|),
     and a bf16 b16 step with train_bn and remat whose running statistics
     equal the same step's without remat (updated once).

Prints its results, a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without printing a result when there is no CUDA device or a phase fails.

    python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA's data sheet): HBM bandwidth and non-tensor fp32
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float ops per candidate per NMS step: 4 min/max, 2 sub, 2 clamp, 1 mul,
# 2 add/sub, 1 clamp, 1 div, 1 compare (IoU and suppress), 1 argmax compare
NMS_OPS_PER_ELEMENT = 15
# float ops per (image, anchor, valid GT) of the matcher at shape_weight 0:
# 4 min/max, 2 sub, 2 clamp, 1 mul (intersection), 1 add, 1 sub, 1 max,
# 1 div (IoU), 1 compare (argmax over G), 1 compare (argmax over A), 1 select
MATCH_OPS_PER_PAIR = 16
# more per pair at shape_weight > 0 (ops/boxes.shape_similarity and
# _quality_matrix; the kernel takes each box's two logs once): 2 sub (log
# ratios), 2 abs, 1 add, 1 negate, 1 div by tau, 1 exp, 2 mul, 1 add (blend)
MATCH_SHAPE_OPS_PER_PAIR = 11
MATCH_SHAPE_OPS_PER_BOX = 2  # log w, log h of each anchor and valid GT
KERNELS = ("nms_greedy", "match_anchors")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def cuda_times_ms(fn, iters: int, warmup: int = 3) -> np.ndarray:
    """Device ms of each of ``iters`` back-to-back calls of ``fn`` on the
    current stream, after ``warmup`` calls: one CUDA event between calls."""
    import torch

    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return np.array([a.elapsed_time(b) for a, b in zip(events, events[1:])])


def kernel_name(name: str) -> str:
    """A kernel's name without its namespace and arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]


def device_ms_per_call(fn, calls: int = 50):
    """The profiler's device time per call of ``fn`` over ``calls`` calls:
    for each kernel (or memset) it runs, its mean self device time times its
    launches per call, summed. Returns (ms, {kernel: (launches per call, mean
    ms)}), or (None, {}) when the profiler records nothing on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            count, us = totals.get(kernel_name(e.name), (0, 0.0))
            totals[kernel_name(e.name)] = (count + 1, us + e.self_device_time_total)
    # a launch the profiler missed must not shorten the per-call time
    kernels = {k: (max(1, round(n / calls)), us / n / 1e3) for k, (n, us) in totals.items()}
    if not kernels or sum(us for _, us in totals.values()) <= 0:
        return None, {}
    return sum(n * ms for n, ms in kernels.values()), kernels


def fmt_device(device_ms, kernels) -> str:
    if device_ms is None:
        return "device time not measured (the profiler recorded no kernels)"
    return (f"device {device_ms:.4f} ms per call (torch.profiler over 50 calls: "
            + ", ".join(f"{k} x{n} {ms:.4f} ms" for k, (n, ms) in kernels.items()) + ")")


def spread(times_ms: np.ndarray) -> str:
    """Median, p90 and sample count of a set of times."""
    return (f"median {np.median(times_ms):.4f} ms, p90 "
            f"{np.percentile(times_ms, 90):.4f} ms, n={len(times_ms)}")


def phase_kernel(torch, nms, nms_cuda):
    """Kernel vs plain on the card, bit for bit, at the path's shapes and on
    the edge cases; the candidate limit must raise. Returns the largest
    |difference| seen over idx and score."""
    from tests.torch_kernel_cases import nms_bit_equal, nms_edge_cases, nms_inputs

    rng = np.random.default_rng(0)
    worst = 0.0
    cases = []
    for b, n, m in ((16, 1000, 100), (16, 400, 200), (8, 2000, 100)):
        boxes, scores, cls, valid = (torch.from_numpy(a).cuda()
                                     for a in nms_inputs(rng, b, n))
        cases.append((f"(B, N, M)=({b}, {n}, {m})", nms.class_offset_boxes(boxes, cls),
                      scores, valid, 0.5, m))
    for name, (boxes, scores, valid, t, m) in nms_edge_cases().items():
        cases.append((f"{name} (B, N, M)=({scores.shape[0]}, {scores.shape[1]}, {m}), "
                      f"t={t}", *(torch.from_numpy(a).cuda() for a in (boxes, scores, valid)),
                      t, m))
    for name, boxes, scores, valid, t, m in cases:
        same, err, kept = nms_bit_equal(boxes, scores, valid, t, m)
        worst = max(worst, err)
        log(f"[kernel] nms_greedy {name}: bit-equal={same}, kept={kept}")
        if not same:
            raise RuntimeError(f"nms_greedy differs from the plain version: {name}")
    limit = nms_cuda.MAX_CANDIDATES
    big = torch.zeros(1, limit + 1, 4, device="cuda")
    try:
        nms_cuda.greedy_nms_cuda(big, big[..., 0], big[..., 0] > 0, 0.5, 10)
    except ValueError as e:
        log(f"[kernel] nms_greedy at N = {limit + 1} raises: {e}")
    else:
        raise RuntimeError(f"nms_greedy took {limit + 1} candidates, above its limit")
    return worst


def matched(got, want, scale=1.0):
    """Each valid reference detection has its own counterpart: same label,
    |score difference| <= 1e-3, box IoU >= 0.99 (corners within 1e-4 of
    ``scale`` for a box clipped to zero area). Returns the count matched."""
    boxes_g, scores_g, labels_g = got
    free = list(range(len(scores_g)))
    if len(free) != len(want[1]):
        raise RuntimeError(f"{len(free)} detections vs {len(want[1])} in the reference")
    for box, score, label in zip(*want):
        for j in free:
            g = boxes_g[j]
            lt, rb = np.maximum(g[:2], box[:2]), np.minimum(g[2:], box[2:])
            inter = np.prod(np.clip(rb - lt, 0, None))
            union = np.prod(g[2:] - g[:2]) + np.prod(box[2:] - box[:2]) - inter
            same_box = (inter / max(union, 1e-12) >= 0.99
                        or np.abs(g - box).max() <= 1e-4 * scale)
            if labels_g[j] == label and abs(scores_g[j] - score) <= 1e-3 and same_box:
                free.remove(j)
                break
        else:
            raise RuntimeError(f"reference detection {box, score, label} unmatched")
    return len(want[1])


def phase_forward(torch, config, build_model, make_detect_fn):
    """Full-width R50-512 forward and detect, card vs CPU, float32, TF32 off."""
    cfg = dataclasses.replace(config.get_config("retinanet_r50_fpn").model,
                              precision="highest")

    def widen(module):  # scores away from the 0.01 prior, so detections separate
        module.cls_head.predict.weight.mul_(100.0)

    forward_check(torch, build_model, make_detect_fn, cfg, widen, "R50-FPN-512")


def forward_check(torch, build_model, make_detect_fn, cfg, widen, name):
    """A full-width forward, card vs CPU, float32 with TF32 off, one image,
    the same weights (``widen`` spreads the CPU model's scores first), then
    detect end to end on both, matched detection by detection."""
    cpu_model, cpu_anchors = build_model(cfg, device="cpu",
                                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        widen(cpu_model)
    gpu_model, gpu_anchors = build_model(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    size = cfg.image_size
    image = np.random.default_rng(2).integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    x = torch.from_numpy(image).permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        ref = cpu_model(x)
        out = gpu_model(x.cuda().contiguous(memory_format=torch.channels_last))
    worst = 0.0
    for r, o in zip(ref, out):
        o = o.cpu()
        if not torch.isfinite(o).all():
            raise RuntimeError(f"non-finite {name} forward output on the card")
        err = (o - r).abs()
        worst = max(worst, float(err.max()))
        # float32 on both sides, sums in other orders over tens of layers
        if not bool((err <= 1e-3 + 1e-3 * r.abs()).all()):
            raise RuntimeError(f"card {name} forward differs from the CPU: max |err| "
                               f"{float(err.max())}")
    log(f"[forward] {name} fp32 (TF32 off) card vs CPU: max |err| "
        f"{worst:.3e} (bound 1e-3 + 1e-3*|cpu|), logits range "
        f"[{float(ref[0].min()):.2f}, {float(ref[0].max()):.2f}]")

    want = make_detect_fn(cpu_model, cpu_anchors, cfg, device="cpu")(image)
    got = make_detect_fn(gpu_model, gpu_anchors, cfg, device="cuda")(image)
    v_w, v_g = want.valid[0].numpy(), got.valid[0].cpu().numpy()
    n = matched(tuple(t[0].cpu().numpy()[v_g] for t in got[:3]),
                tuple(t[0].numpy()[v_w] for t in want[:3]))
    if n == 0:
        raise RuntimeError(f"{name} detect found nothing to compare")
    det = cfg.detect
    log(f"[forward] {name} detect card vs CPU (threshold {det.score_threshold}, "
        f"{det.pre_nms_top_k} candidates, {det.max_detections} detections): {n} "
        f"detections matched (label, IoU >= 0.99, |dscore| <= 1e-3)")


def serving_config(config, dtype):
    cfg = config.get_config("retinanet_r50_fpn")
    model = cfg.model
    model = dataclasses.replace(
        model, dtype=dtype,
        detect=dataclasses.replace(model.detect, score_threshold=0.0))
    return dataclasses.replace(cfg, model=model)


def check_answers(requests, answers):
    """One answer per image, each with detections, finite and inside its
    image. Returns the detection counts per image."""
    for req, ans in zip(requests, answers):
        if len(ans) != len(req):
            raise RuntimeError("wrong number of answers")
        for img, det in zip(req, ans):
            h, w = img.shape[:2]
            if len(det.scores) == 0:
                raise RuntimeError("an image got no detections")
            if not (np.isfinite(det.boxes).all() and (det.boxes >= 0).all()
                    and (det.boxes[:, [0, 2]] <= w).all()
                    and (det.boxes[:, [1, 3]] <= h).all()):
                raise RuntimeError("detections outside the image")
    return [[len(d.scores) for d in ans] for ans in answers]


def phase_serving(torch, config, serving, nms_cuda, detection, reset_counts):
    """The main path: a bf16 batch-16 Predictor answering three requests."""
    cfg = serving_config(config, "bfloat16")
    pred = serving.Predictor(cfg, batch_size=16, device="cuda",
                             generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)

    def request(count):
        return [rng.integers(0, 256, (int(rng.integers(200, 900)),
                                      int(rng.integers(200, 900)), 3), dtype=np.uint8)
                for _ in range(count)]

    requests = [request(16), request(5), request(1)]
    reset_counts()
    answers = [pred.predict(r) for r in requests]
    torch.cuda.synchronize()
    launches = nms_cuda.launches
    if launches != len(requests):
        raise RuntimeError(f"the NMS kernel ran {launches} times for "
                           f"{len(requests)} batches")
    counts = check_answers(requests, answers)
    log(f"[serving] bf16 Predictor b16: requests of 16, 5, 1 images answered, "
        f"detections per image {counts}, NMS kernel launches {launches}")

    # the kernel against the plain version on the same candidates
    batch, _ = serving.prepare_batch(requests[0], 512, 16)
    images = torch.from_numpy(batch).cuda()
    with torch.inference_mode():
        x = detection.image_lib.normalize_images(images).permute(0, 3, 1, 2)
        cands = detection.select_candidates(*pred.module(x), pred.anchors, cfg.model)
        got = detection.run_nms(*cands, cfg.model, backend="cuda")
        want = detection.run_nms(*cands, cfg.model, backend="plain")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"[serving] run_nms kernel vs plain on the path's candidates: "
        f"equal={same}, kept per image {got.valid.sum(1).tolist()}")
    if not same:
        raise RuntimeError("run_nms through the kernel differs from the plain version")

    # end to end on the host clock: a request of 16 images (host resize and
    # pad, upload, detect, read back), and the host resize alone
    walls, preps = [], []
    for _ in range(12):
        t = time.perf_counter()
        pred.predict(requests[0])
        walls.append(time.perf_counter() - t)
        t = time.perf_counter()
        serving.prepare_batch(requests[0], 512, 16)
        preps.append(time.perf_counter() - t)
    walls, preps = np.array(walls[2:]) * 1e3, np.array(preps[2:]) * 1e3
    log(f"[timing] Predictor.predict, 16 images of 200-900 px (host clock): "
        f"{spread(walls)}, {16e3 / np.median(walls):.1f} images/s at the median; "
        f"prepare_batch (host resize) {spread(preps)}")
    return launches, {"predict_16_images_median_ms": float(np.median(walls)),
                      "prepare_batch_16_median_ms": float(np.median(preps))}


def phase_timing(torch, config, build_model, make_detect_fn, detection, nms,
                 nms_cuda):
    results = {}
    rng = np.random.default_rng(4)
    images = torch.from_numpy(
        rng.integers(0, 256, (16, 512, 512, 3), dtype=np.uint8)).cuda()
    for dtype in ("bfloat16", "float32"):
        cfg = serving_config(config, dtype).model
        module, anchors = build_model(cfg, device="cuda",
                                      generator=torch.Generator().manual_seed(0))
        detect = make_detect_fn(module, anchors, cfg, device="cuda")
        times = cuda_times_ms(lambda: detect(images), iters=30)
        ms = float(np.median(times))
        results[f"detect_b16_{dtype}_images_per_s"] = 16 * 1000.0 / ms
        log(f"[timing] detect b16 {dtype} (precision 'default', so float32 "
            f"convs may use TF32): {spread(times)} per batch, "
            f"{16 * 1000.0 / ms:.1f} images/s at the median")
        if dtype == "bfloat16":
            parts, cands = detect_stages(torch, detection, module, anchors, cfg, images)
            cfg_bf16 = cfg
            results["detect_b16_bf16_stage_median_ms"] = parts
            log("[timing] detect b16 bf16 stages (median ms): " + ", ".join(
                f"{k} {v:.3f}" for k, v in parts.items()))
        del module, detect

    # the kernel on the main path's own candidates (bf16 model, batch 16)
    results["nms"] = nms_timing(nms, nms_cuda, cands, cfg_bf16.detect,
                                "the path's candidates")
    # the same shape with random scores, which the kernel has to sort (the
    # path's candidates arrive in order and skip the sort)
    from tests.torch_kernel_cases import nms_inputs

    b, n = cands[1].shape
    m, t = cfg_bf16.detect.max_detections, cfg_bf16.detect.nms_iou_threshold
    rb, rs, rc, rv = (torch.from_numpy(x).cuda() for x in nms_inputs(np.random.default_rng(7), b, n))
    rshift = nms.class_offset_boxes(rb, rc)
    log(f"[timing] nms_greedy ({b}, {n}, {m}) on random scores (the sort runs): "
        + fmt_device(*device_ms_per_call(
            lambda: nms_cuda.greedy_nms_cuda(rshift, rs, rv, t, m))))
    return results


def detect_stages(torch, detection, module, anchors, cfg, images):
    """Median device ms of each stage of detect on ``images`` (normalize,
    forward, select_candidates, run_nms), and the candidates."""
    with torch.inference_mode():
        x = detection.image_lib.normalize_images(images).permute(0, 3, 1, 2)
        out = module(x)
        cands = detection.select_candidates(*out, anchors, cfg)
        stages = {
            "normalize": lambda: detection.image_lib.normalize_images(images),
            "forward": lambda: module(x),
            "select_candidates": lambda: detection.select_candidates(*out, anchors, cfg),
            "run_nms": lambda: detection.run_nms(*cands, cfg),
        }
        parts = {k: float(np.median(cuda_times_ms(f, iters=20)))
                 for k, f in stages.items()}
    return parts, cands


def nms_timing(nms, nms_cuda, cands, det, name):
    """K1's time on a detect path's candidates: CUDA events between
    back-to-back wrapper calls, profiler device time, the plain version's
    time and the bound of the steps the data needs."""
    boxes, scores, cls, valid = cands
    b, n = scores.shape
    m, t = det.max_detections, det.nms_iou_threshold
    shifted = nms.class_offset_boxes(boxes, cls)
    k_times = cuda_times_ms(
        lambda: nms_cuda.greedy_nms_cuda(shifted, scores, valid, t, m), iters=200)
    dev_ms, dev_names = device_ms_per_call(
        lambda: nms_cuda.greedy_nms_cuda(shifted, scores, valid, t, m))
    p_times = cuda_times_ms(lambda: nms.greedy_nms(shifted, scores, valid, t, m),
                            iters=5, warmup=1)
    k_ms, p_ms = float(np.median(k_times)), float(np.median(p_times))
    res = nms_cuda.greedy_nms_cuda(shifted, scores, valid, t, m)
    kept = res.valid.sum(1).cpu().numpy()
    # steps the data needs: one per kept box, plus the step that finds none
    steps = int(np.sum(kept + (kept < m)))
    ops = steps * n * NMS_OPS_PER_ELEMENT
    nbytes = b * n * (16 + 4 + 1) + b * m * (4 + 4 + 1)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1000.0
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_FLOPS else "operations"
    log(f"[timing] nms_greedy ({b}, {n}, {m}) on {name} "
        f"({nvidia_smi_line()}): kernel CUDA events between back-to-back calls "
        f"{spread(k_times)}; {fmt_device(dev_ms, dev_names)}; plain "
        f"{spread(p_times)}; bound {bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, "
        f"{ops} ops over {steps} steps), library call: none (no PyTorch op "
        f"computes greedy NMS)")
    return dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_match_kernel(torch, config, anchors_for_model):
    """K2 vs plain on the card at the path's shapes and on the edge cases.
    Returns the worst |difference| over best_q and reg (the assignments must
    be equal)."""
    from tests.torch_kernel_cases import match_check, match_edge_cases, match_inputs

    rng = np.random.default_rng(5)
    r50 = config.get_config("retinanet_r50_fpn").model
    r101 = config.get_config("retinanet_r101_fpn").model
    cases = [(kind, model, *match_inputs(rng, b, g, kind), sw)
             for model, b, g, kind, sw in ((r50, 16, 64, "ties", 0.0),
                                           (r50, 16, 100, "random", 0.0),
                                           (r101, 4, 100, "random", 0.3))]
    cases += [(name, r50, *case) for name, case in match_edge_cases().items()]
    worst = 0.0
    for name, model, gt, labels, valid, sw in cases:
        anchors = anchors_for_model(model).cuda()
        gt, labels, valid = (torch.from_numpy(x).cuda() for x in (gt, labels, valid))
        b, g = valid.shape
        passed, err, line = match_check(anchors, gt, labels, valid, sw,
                                        model.anchors.variances)
        worst = max(worst, err)
        log(f"[kernel] match_anchors {name} (B, A, G)=({b}, {anchors.shape[0]}, {g}), "
            f"{int(valid.sum())} valid GTs, shape_weight {sw}: {line}")
        if not passed:
            raise RuntimeError(f"match_anchors differs from the plain version: {name}")
    return worst


def train_config(config, dtype, batch, precision="default", **train_changes):
    """config4's training settings (focal loss, 0.5/0.4 thresholds with
    allow_low_quality, SGD lr 0.01 with warmup 500 and step decay, weight
    decay 5e-4, clipping at 10) on R50-FPN-512, max_boxes 64, as
    bench_train.py configures it."""
    cfg = config.get_config("config4_retinanet_r101_coco_train")
    model = dataclasses.replace(config.RETINANET_R50_512, dtype=dtype, precision=precision)
    return dataclasses.replace(
        cfg, model=model,
        data=dataclasses.replace(cfg.data, batch_size=batch, max_boxes=64),
        train=dataclasses.replace(cfg.train, **train_changes))


def train_batch(rng, b, size=512, g=64, classes=80):
    """uint8 images and 1 to g valid GT boxes of mixed sizes per image,
    labels 1 to ``classes``."""
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    xy = rng.uniform(0.0, 0.85, (b, g, 2))
    wh = np.exp(rng.uniform(np.log(0.02), np.log(0.8), (b, g, 2)))
    boxes = np.clip(np.concatenate([xy, xy + wh], -1), 0, 1).astype(np.float32)
    counts = rng.integers(1, g + 1, b)
    valid = np.arange(g)[None] < counts[:, None]
    boxes[~valid] = 0.0
    labels = rng.integers(1, classes + 1, (b, g)).astype(np.int32)
    return {"images": images, "boxes": boxes, "labels": labels, "valid": valid}


def phase_train_check(torch, config, train, build_model):
    """Two train steps of full-width R50-FPN-512 in float32 with TF32 off,
    augment off, batch 2: card vs CPU on the same weights and batch."""
    # warmup 1: step 1 runs at lr 0, step 2 at the base lr
    cfg = train_config(config, "float32", 2, precision="highest", warmup_steps=1,
                       lr_decay_steps=(60_000, 80_000))
    train_check(torch, train, build_model, cfg, train_batch(np.random.default_rng(6), 2),
                "R50-FPN-512")


def train_check(torch, train, build_model, cfg, batch, label, seed=7, spread=False):
    """Two train steps card vs CPU on the same weights and batch: loss,
    loss_cls, loss_box, grad_norm and num_pos within 1e-4 relative, the
    parameter update within 5e-3 of its norm and every parameter within
    1e-6. With ``spread`` the CPU also runs the steps on NCHW-contiguous
    images (the step's own are an NCHW view of NHWC memory), which changes
    only the order of float32 sums in its convolutions; the update bounds
    are then at least twice that run's own distance from the first CPU
    run. Returns the CPU and card modules."""
    runs, metrics = {}, {}
    for key, dev in (("cpu", "cpu"), ("cuda", "cuda"), ("cpu_nchw", "cpu"))[
            :3 if spread else 2]:
        module, anchors = build_model(cfg.model, device=dev, train=True,
                                      generator=torch.Generator().manual_seed(seed))
        if key == "cpu_nchw":
            forward = module.forward
            module.forward = lambda images, train=False: forward(images.contiguous(), train)
        state = train.create_train_state(module, cfg, device=dev)
        step = train.make_train_step(module, anchors, cfg, augment=False, device=dev)
        start = {n: p.detach().clone() for n, p in module.named_parameters()}
        t = time.perf_counter()
        metrics[key] = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics[key].append({k: float(v) for k, v in m.items()})
        runs[key] = (module, time.perf_counter() - t, start)
    worst = {}
    for i, (c, g) in enumerate(zip(metrics["cpu"], metrics["cuda"])):
        for key in ("loss", "loss_cls", "loss_box", "grad_norm", "num_pos"):
            rel = abs(g[key] - c[key]) / max(abs(c[key]), 1e-12)
            worst[key] = max(worst.get(key, 0.0), rel)
            if not (np.isfinite(g[key]) and rel <= 1e-4):
                raise RuntimeError(f"train step {i + 1} {key}: card {g[key]} vs CPU {c[key]}")
    cpu, _, start = runs["cpu"]

    def distance(other):
        """(|update - CPU update| / |CPU update|, max |param - CPU param|)"""
        num = den = worst_err = 0.0
        for (name, pc), po in zip(cpu.named_parameters(), other.parameters()):
            po, pc = po.detach().cpu(), pc.detach()
            dc = pc - start[name]
            num += float(((po - start[name]) - dc).square().sum())
            den += float(dc.square().sum())
            worst_err = max(worst_err, float((po - pc).abs().max()))
        if den <= 0:
            raise RuntimeError("the parameters did not move in two steps")
        return (num / den) ** 0.5, worst_err

    update_rel, max_err = distance(runs["cuda"][0])
    bound_u, bound_e, note = 5e-3, 1e-6, ""
    if spread:
        own_u, own_e = distance(runs["cpu_nchw"][0])
        bound_u, bound_e = max(bound_u, 2 * own_u), max(bound_e, 2 * own_e)
        note = (f"; the CPU on NCHW-contiguous images vs the CPU: update {own_u:.2e}, "
                f"max |param err| {own_e:.2e}")
    log(f"[train] {label} fp32 (TF32 off) train step card vs CPU, batch 2, 2 steps: "
        f"loss {metrics['cuda'][-1]['loss']:.6f} vs {metrics['cpu'][-1]['loss']:.6f}, "
        f"grad_norm {metrics['cuda'][-1]['grad_norm']:.6f} vs "
        f"{metrics['cpu'][-1]['grad_norm']:.6f}; worst relative differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (bound 1e-4); parameter update |card - CPU| / |CPU| = {update_rel:.2e} "
        f"(bound {bound_u:.2e}), max |param err| {max_err:.2e} (bound {bound_e:.2e})"
        f"{note}; host seconds: CPU {runs['cpu'][1]:.1f}, card {runs['cuda'][1]:.1f}")
    # the update is lr * (g + wd * p): its small gradient entries are float32
    # sums over up to 2 * 256 * 256 positions in another order, with
    # cancellation, so the update's norm agrees less tightly than grad_norm
    if not (update_rel <= bound_u and max_err <= bound_e):
        raise RuntimeError(f"parameter updates differ card vs CPU: {update_rel}")
    return cpu, runs["cuda"][0]


def phase_training(torch, train, build_model, matching_cuda, nms_cuda, reset_counts,
                   cfg, batch, name):
    """A training path: steps with augmentation through make_train_step on
    a numpy-seeded batch. Returns (state, step, module, anchors, cfg,
    batch, K2 launches)."""
    module, anchors = build_model(cfg.model, device="cuda", train=True,
                                  generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(module, cfg)
    step = train.make_train_step(module, anchors, cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    params = list(module.parameters())
    snaps, losses = [[p.detach().clone() for p in params]], []
    steps = 4
    reset_counts()
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if len(snaps) < 3:
            snaps.append([p.detach().clone() for p in params])
    torch.cuda.synchronize()
    launches = matching_cuda.launches
    if launches != steps:
        raise RuntimeError(f"the matching kernel ran {launches} times in {steps} steps")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training loss: {losses}")
    same_1 = all(torch.equal(a, b) for a, b in zip(snaps[0], snaps[1]))
    moved_2 = max(float((a - b).abs().max()) for a, b in zip(snaps[1], snaps[2]))
    if not same_1 or moved_2 <= 0.0:
        raise RuntimeError("parameters must stay at step 1 (lr 0) and move at step 2")
    dtypes = ({p.dtype for p in params} | {t.dtype for t in state.opt_state.trace})
    if dtypes != {torch.float32}:
        raise RuntimeError(f"weights or momentum are not float32: {dtypes}")
    log(f"[train] {name}, augmentation on, {steps} steps: losses "
        f"{[round(x, 5) for x in losses]}, matching kernel launches {launches}, NMS "
        f"kernel launches {nms_cuda.launches}; parameters unchanged at step 1 (lr 0), "
        f"moved by up to {moved_2:.3e} at step 2; weights and momentum float32")
    return state, step, module, anchors, cfg, batch, launches


def phase_train_timing(torch, train, matching, matching_cuda, state, step, module,
                       anchors, cfg, batch, tag, ties=True):
    """A training path's step time, stage breakdown and K2's time on its
    augmented batch (and, with ``ties``, on bench_train.py's batch).
    ``tag`` names the results (e.g. "train_b16_bf16")."""
    from shape_based_object_detection_torch.data.augment import augment_batch
    from shape_based_object_detection_torch.losses import detection_loss
    from shape_based_object_detection_torch.models.retinanet import conv_precision

    results = {}
    b = batch["images"].shape[0]
    times = cuda_times_ms(lambda: step(state, batch), iters=20)
    ms = float(np.median(times))
    results[f"{tag}_images_per_s"] = b * 1000.0 / ms
    results[f"{tag}_step_median_ms"] = ms
    log(f"[timing] {tag} step (augment, forward, match, loss, backward, "
        f"SGD): {spread(times)} per step, {b * 1000.0 / ms:.1f} images/s at the median")

    images, boxes, labels, valid = (batch[k] for k in ("images", "boxes", "labels", "valid"))
    aug = augment_batch(state.generator, images, boxes, labels, valid, cfg.data,
                        cfg.model.image_size)
    x = aug[0].permute(0, 3, 1, 2)
    variances = cfg.model.anchors.variances
    match = matching.match_batch(anchors, aug[1], aug[2], aug[3], cfg.match, variances)
    params = list(module.parameters())
    opt = train.make_optimizer(cfg.train)
    mask = list(train.decay_mask(module).values())

    def forward(loss=False, backward=False):
        for p in params:
            p.grad = None
        with conv_precision(cfg.model.precision):
            with torch.autocast("cuda", dtype=torch.bfloat16,
                                enabled=cfg.model.dtype == "bfloat16"):
                out = module(x, train=True)
            if loss or backward:
                out, _ = detection_loss(*out, match, cfg.loss)
            if backward:
                out.backward()

    def fwd_bwd():
        forward(backward=True)

    fwd_bwd()
    grads = [p.grad for p in params]
    data = [p.data for p in params]
    stages = {
        "augment": lambda: augment_batch(state.generator, images, boxes, labels, valid,
                                         cfg.data, cfg.model.image_size),
        "forward": forward,
        "forward+loss": lambda: forward(loss=True),
        "forward+loss+backward": fwd_bwd,
        "match_batch": lambda: matching.match_batch(anchors, aug[1], aug[2], aug[3],
                                                    cfg.match, variances),
        "optimizer": lambda: opt.apply(state.opt_state, data, grads, mask),
    }
    parts = {k: float(np.median(cuda_times_ms(f, iters=10))) for k, f in stages.items()}
    results[f"{tag}_stage_median_ms"] = parts
    step_parts = ("augment", "forward+loss+backward", "match_batch", "optimizer")
    log(f"[timing] {tag} stages (median ms; the forward stages record the "
        "autograd graph and take the matches as given): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum of {', '.join(step_parts)} {sum(parts[k] for k in step_parts):.3f} "
        f"vs step {ms:.3f}")

    # K2 on the path's own augmented batch, then on bench_train.py's batch
    from tests.torch_kernel_cases import match_inputs

    entry = None
    cases = [("the path's augmented batch", aug[1:4])]
    if ties:
        cases.append(("bench_train.py's batch (8 of 64 GTs valid, all one box)",
                      [torch.from_numpy(x).cuda()
                       for x in match_inputs(np.random.default_rng(9), 16, 64, "ties")]))
    sw = cfg.match.shape_weight
    for name, (gt, lbl, ok) in cases:
        gt, lbl, ok = gt.contiguous(), lbl.contiguous(), ok.contiguous()
        args = (anchors, gt, lbl, ok, sw, cfg.match.shape_tau, variances)
        k_times = cuda_times_ms(lambda: matching_cuda.match_reductions_cuda(*args), iters=100)
        dev_ms, dev_names = device_ms_per_call(
            lambda: matching_cuda.match_reductions_cuda(*args))
        p_times = cuda_times_ms(lambda: matching.match_reductions_plain(*args), iters=10)
        b, g = ok.shape
        a = anchors.shape[0]
        # the data needs the IoU of every anchor with every valid GT; an
        # invalid row needs no arithmetic (its quality is -1); the shape
        # term adds its per-pair arithmetic and each box's two logs
        n_valid = int(ok.sum())
        ops = a * n_valid * MATCH_OPS_PER_PAIR
        if sw > 0:
            ops += (a * n_valid * MATCH_SHAPE_OPS_PER_PAIR
                    + (a + n_valid) * MATCH_SHAPE_OPS_PER_BOX)
        nbytes = a * 16 + b * g * (16 + 4 + 1) + b * a * (4 + 4 + 4 + 16) + b * g * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1000.0
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_FLOPS else "operations"
        log(f"[timing] match_anchors (B, A, G)=({b}, {a}, {g}) on {name} "
            f"({nvidia_smi_line()}): kernel CUDA events between back-to-back calls "
            f"{spread(k_times)}; {fmt_device(dev_ms, dev_names)}; plain "
            f"{spread(p_times)}; bound {bound_ms:.5f} ms "
            f"({bound_by}: {nbytes} bytes, {ops} ops over {n_valid} valid GTs, "
            f"shape_weight {sw}), library call: none (no PyTorch op computes the "
            f"matching)")
        if entry is None:
            entry = dict(ms=float(np.median(k_times)), device_ms=dev_ms,
                         plain_ms=float(np.median(p_times)), bound_ms=bound_ms,
                         bound_by=bound_by)
    results["match"] = entry
    return results


def phase_train_profile(torch, state, step, batch, step_ms, tag):
    """Where the train step's device time goes: a torch.profiler trace of
    3 steps (kernel time by operator), the device's busy time per step
    against the step's CUDA-event time (the idle share), and the host's
    time to enqueue a step."""
    from torch.profiler import ProfilerActivity, profile

    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, batch)
        enqueue.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy <= 0.0:  # a profiler without CUPTI records no kernels
        log(f"[profile] {tag} step: device busy time not measured (the profiler "
            "recorded no kernels)")
        return {}
    ops = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:10]
    idle = 1.0 - busy / step_ms
    log(f"[profile] {tag} step: device busy {busy:.3f} ms per step (sum of "
        f"{len(kernels) // n} kernels under torch.profiler) vs the step's {step_ms:.3f} ms "
        f"(CUDA events, unprofiled): idle share {idle:.3f}; host enqueue of a step "
        f"(no sync) median {np.median(enqueue):.3f} ms of {len(enqueue)}; device ms per "
        f"step by operator: " + ", ".join(
            f"{e.key} {e.self_device_time_total / 1e3 / n:.3f} ({e.count // n})"
            for e in ops))
    return {f"{tag}_device_busy_ms": busy, f"{tag}_idle_share": idle,
            f"{tag}_host_enqueue_median_ms": float(np.median(enqueue))}


def ssd_train_config(config, batch, **train_changes):
    """Config #3 as the preset sets it (SSD-512 VOC, float32, precision
    "default", b32, 100 boxes, multibox with 3:1 mining, shape_weight 0.3),
    with ``batch`` images and ``train_changes`` to TrainConfig."""
    cfg = config.get_config("config3_ssd512_voc_train")
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch),
        train=dataclasses.replace(cfg.train, **train_changes))


def phase_ssd_match_kernel(torch, config, anchors_for_model, augment_batch):
    """K2 vs plain on config #3's augmented batch: assignments and best_q
    bit-equal at shape_weight 0.3, the MatchResult under config #3's
    thresholds equal. Returns the worst |difference| over best_q and reg."""
    from tests.torch_kernel_cases import match_check

    cfg = ssd_train_config(config, 32)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             train_batch(np.random.default_rng(10), 32, g=100, classes=20).items()}
    gen = torch.Generator(device="cuda").manual_seed(11)
    _, gt, labels, valid = augment_batch(gen, batch["images"], batch["boxes"],
                                         batch["labels"], batch["valid"], cfg.data,
                                         cfg.model.image_size)
    anchors = anchors_for_model(cfg.model).cuda()
    passed, err, line = match_check(anchors, gt.contiguous(), labels.contiguous(),
                                    valid.contiguous(), cfg.match.shape_weight,
                                    cfg.model.anchors.variances, cfg=cfg.match, exact=True)
    log(f"[kernel] match_anchors on config #3's augmented batch (B, A, G)=(32, "
        f"{anchors.shape[0]}, 100), {int(valid.sum())} valid GTs, shape_weight "
        f"{cfg.match.shape_weight}: {line}")
    if not passed:
        raise RuntimeError("match_anchors differs from the plain version on config #3's batch")
    return err


def phase_ssd_forward(torch, config, build_model, make_detect_fn):
    """Full-width SSD300 (COCO) forward and detect, card vs CPU, float32,
    TF32 off, config #1's detect settings."""
    cfg = dataclasses.replace(config.get_config("ssd300").model, precision="highest")

    def widen(module):
        # softmax scores of a fresh model crowd the top-400 cut, closer
        # there than float32's error; twice the kernels open the gap
        for i in range(len(cfg.anchors.aspect_ratios)):
            getattr(module, f"cls_{i}").weight.mul_(2.0)

    forward_check(torch, build_model, make_detect_fn, cfg, widen, "SSD300")


def phase_ssd_serving(torch, config, serving, nms_cuda, reset_counts):
    """The SSD300 serving path: config #1's Predictor (fp32, batch 1) answers
    requests of 1 and 3 images of differing sizes, a bf16 batch-16
    Predictor a request of 16; K1 once per batch. Returns (K1 launches,
    the two Predictors)."""
    cfg = config.get_config("config1_ssd300_infer")
    bf16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    preds = [serving.Predictor(c, batch_size=b, device="cuda",
                               generator=torch.Generator().manual_seed(0))
             for c, b in ((cfg, cfg.data.batch_size), (bf16, 16))]
    rng = np.random.default_rng(12)

    def request(count):
        return [rng.integers(0, 256, (int(rng.integers(200, 700)),
                                      int(rng.integers(200, 700)), 3), dtype=np.uint8)
                for _ in range(count)]

    plan = [(preds[0], request(1)), (preds[0], request(3)), (preds[1], request(16))]
    batches = sum(-(-len(r) // p.batch_size) for p, r in plan)
    reset_counts()
    answers = [p.predict(r) for p, r in plan]
    torch.cuda.synchronize()
    launches = nms_cuda.launches
    if launches != batches:
        raise RuntimeError(f"the NMS kernel ran {launches} times for {batches} batches")
    counts = check_answers([r for _, r in plan], answers)
    log(f"[serving] SSD300: config #1 Predictor (fp32, b1) answered requests of 1 and 3 "
        f"images, a bf16 b16 Predictor one of 16; detections per image {counts}; NMS "
        f"kernel launches {launches} for {batches} batches")
    return launches, preds


def phase_ssd_timing(torch, detection, nms, nms_cuda, preds):
    """SSD300 detect images/s at b1 and b16 in float32 and bf16 (the two
    Predictors' modules), stage breakdowns at b1 fp32 and b16 bf16, K1
    against the plain version on the b16 bf16 candidates, and K1's time
    there."""
    from shape_based_object_detection_torch.detection import make_detect_fn
    from tests.torch_kernel_cases import nms_bit_equal

    results = {}
    rng = np.random.default_rng(13)
    images = torch.from_numpy(rng.integers(0, 256, (16, 300, 300, 3), dtype=np.uint8)).cuda()
    for pred, dtype in zip(preds, ("float32", "bfloat16")):
        model_cfg = pred.cfg.model
        detect = make_detect_fn(pred.module, pred.anchors, model_cfg, device="cuda")
        for b in (1, 16):
            times = cuda_times_ms(lambda: detect(images[:b]), iters=30)
            ms = float(np.median(times))
            results[f"ssd300_detect_b{b}_{dtype}_images_per_s"] = b * 1000.0 / ms
            log(f"[timing] SSD300 detect b{b} {dtype} (precision 'default'): "
                f"{spread(times)} per batch, {b * 1000.0 / ms:.1f} images/s at the median")
        b = 1 if dtype == "float32" else 16
        parts, cands = detect_stages(torch, detection, pred.module, pred.anchors,
                                     model_cfg, images[:b])
        results[f"ssd300_detect_b{b}_{dtype}_stage_median_ms"] = parts
        log(f"[timing] SSD300 detect b{b} {dtype} stages (median ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items()))

    # K1 on the b16 bf16 path's candidates, against the plain version
    boxes, scores, cls, valid = cands
    det = model_cfg.detect
    shifted = nms.class_offset_boxes(boxes, cls)
    same, err, kept = nms_bit_equal(shifted, scores, valid, det.nms_iou_threshold,
                                    det.max_detections)
    log(f"[kernel] nms_greedy on the SSD300 bf16 b16 candidates (B, N, M)="
        f"({scores.shape[0]}, {scores.shape[1]}, {det.max_detections}), threshold "
        f"{det.score_threshold}: {int(valid.sum())} valid candidates, bit-equal={same}, "
        f"kept={kept}")
    if not same:
        raise RuntimeError("nms_greedy differs from the plain version on the SSD300 path")
    results["nms"] = nms_timing(nms, nms_cuda, cands, det, "the SSD300 path's candidates")
    results["nms"]["max_abs_err"] = err
    return results


def step_peak(torch, step, state, batch):
    """One train step: (metrics as floats, max_memory_allocated after
    reset_peak_memory_stats, and that peak above the memory allocated
    before the step), in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, metrics = step(state, batch)
    metrics = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return metrics, peak, peak - base


def phase_remat(torch, train, build_model, module, anchors, cfg, batch):
    """The SSD-512 b32 step with model.remat on and off from the same
    weights, batch and augmentation draws: loss and grad_norm within 1e-5
    relative; the peak device memory of each. ``module`` (remat off) is
    reset to its weights before the step."""
    start = {k: v.clone() for k, v in module.state_dict().items()}
    runs = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=remat))
        if remat:
            module, _ = build_model(c.model, device="cuda", train=True)
        module.load_state_dict(start)
        state = train.create_train_state(module, c)
        runs[remat] = step_peak(torch, train.make_train_step(module, anchors, c), state,
                                batch)
        del state
    (m0, peak0, add0), (m1, peak1, add1) = runs[False], runs[True]
    rel = {k: abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-12) for k in ("loss", "grad_norm")}
    log(f"[remat] SSD-512 b32 fp32 step, model.remat off vs on: loss {m0['loss']:.6f} vs "
        f"{m1['loss']:.6f}, grad_norm {m0['grad_norm']:.6f} vs {m1['grad_norm']:.6f} "
        f"(relative {rel['loss']:.2e}, {rel['grad_norm']:.2e}; bound 1e-5); "
        f"torch.cuda.max_memory_allocated {peak0 / 2**30:.3f} GiB vs {peak1 / 2**30:.3f} "
        f"GiB, of which the step added {add0 / 2**30:.3f} vs {add1 / 2**30:.3f} GiB "
        f"({nvidia_smi_line()})")
    if max(rel.values()) > 1e-5:
        raise RuntimeError(f"remat changed the step: {rel}")
    return {"ssd512_b32_peak_bytes_remat_off": peak0, "ssd512_b32_peak_bytes_remat_on": peak1,
            "ssd512_b32_step_added_bytes_remat_off": add0,
            "ssd512_b32_step_added_bytes_remat_on": add1}


def phase_train_bn(torch, config, train, build_model):
    """Trainable BatchNorm on R50-FPN-512: two fp32 steps at b2 card vs CPU
    (phase 7's tolerances, the update's held to the CPU's own float32
    spread; running statistics within 1e-5 + 1e-5*|cpu|), then a bf16 b16
    step with train_bn and model.remat against the same step without
    remat: the running statistics equal within 1e-6 (updated once)."""
    cfg = train_config(config, "float32", 2, precision="highest", warmup_steps=1,
                       lr_decay_steps=(60_000, 80_000))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, train_bn=True))
    # batch statistics in BatchNorm make the gradient of a fresh model a
    # sum with deep cancellation (BN's backward subtracts the batch mean of
    # the incoming gradient at every layer): float32 alone, in another order
    # of sums, moves the update by a few percent, so the update is held to
    # the CPU's own spread measured in this run
    cpu, gpu = train_check(torch, train, build_model, cfg,
                           train_batch(np.random.default_rng(14), 2), "R50-FPN-512 train_bn",
                           spread=True)
    worst, excess, moved = 0.0, 0.0, 0.0
    cpu_bufs = dict(cpu.named_buffers())
    for name, buf in gpu.named_buffers():
        err = (buf.cpu() - cpu_bufs[name]).abs()
        worst = max(worst, float(err.max()))
        # the statistics' own scale: variances reach a few units
        excess = max(excess, float((err / (1e-5 + 1e-5 * cpu_bufs[name].abs())).max()))
        init = 0.0 if name.endswith("running_mean") else 1.0
        moved = max(moved, float((cpu_bufs[name] - init).abs().max()))
    log(f"[train_bn] running statistics after 2 steps card vs CPU: max |err| "
        f"{worst:.3e}, at most {excess:.2f} of the bound 1e-5 + 1e-5*|cpu|; moved "
        f"from their start by up to {moved:.3e}")
    if excess > 1.0 or moved <= 0.0:
        raise RuntimeError(f"train_bn running statistics: card vs CPU {worst}, moved {moved}")
    del cpu, gpu

    bufs, losses = {}, {}
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in train_batch(np.random.default_rng(15), 16).items()}
    for remat in (False, True):
        c = train_config(config, "bfloat16", 16)
        c = dataclasses.replace(c, model=dataclasses.replace(c.model, train_bn=True,
                                                             remat=remat))
        module, anchors = build_model(c.model, device="cuda", train=True,
                                      generator=torch.Generator().manual_seed(16))
        state = train.create_train_state(module, c)
        _, metrics = train.make_train_step(module, anchors, c)(state, batch)
        losses[remat] = float(metrics["loss"])
        bufs[remat] = {n: b.clone() for n, b in module.named_buffers()}
        del module, state
    diff = max(float((bufs[True][n] - b).abs().max()) for n, b in bufs[False].items())
    log(f"[train_bn] bf16 b16 step with train_bn, model.remat on vs off: losses "
        f"{losses[True]:.6f} vs {losses[False]:.6f}; running statistics max |diff| "
        f"{diff:.3e} (bound 1e-6: updated once, not again in the recomputation)")
    if diff > 1e-6:
        raise RuntimeError(f"remat moved the running statistics differently: {diff}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from shape_based_object_detection_torch import config, detection, serving, train
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching, matching_cuda, nms, nms_cuda
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model
    from shape_based_object_detection_torch.utils import native

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    t = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source
        list(pool.map(native.build, KERNELS))
    for name in KERNELS:
        native.load(name)
    log(f"[build] {', '.join(k + '.cu' for k in KERNELS)} built in parallel and loaded "
        f"in {time.perf_counter() - t:.2f} s")

    def reset_counts():
        """Every kernel's launch count to 0, just before a path is driven."""
        nms_cuda.launches = 0
        matching_cuda.launches = 0

    nms_err = phase_kernel(torch, nms, nms_cuda)
    phase_forward(torch, config, build_model, make_detect_fn)
    nms_launches, e2e = phase_serving(torch, config, serving, nms_cuda, detection,
                                      reset_counts)
    timing = phase_timing(torch, config, build_model, make_detect_fn, detection,
                          nms, nms_cuda)
    match_err = phase_match_kernel(torch, config, anchors_for_model)
    phase_train_check(torch, config, train, build_model)
    trained = phase_training(torch, train, build_model, matching_cuda, nms_cuda,
                             reset_counts, train_config(config, "bfloat16", 16),
                             train_batch(np.random.default_rng(8), 16),
                             "bf16 R50-FPN-512 trainer b16")
    match_launches = trained[-1]
    train_timing = phase_train_timing(torch, train, matching, matching_cuda,
                                      *trained[:-1], tag="train_b16_bf16")
    train_timing.update(phase_train_profile(
        torch, trained[0], trained[1], trained[5],
        train_timing["train_b16_bf16_step_median_ms"], "train_b16_bf16"))
    del trained

    # the SSD family: config #3's matching, then SSD300 serving, then SSD-512
    # training, remat, and trainable BatchNorm on R50-FPN-512
    from shape_based_object_detection_torch.data.augment import augment_batch

    ssd_match_err = phase_ssd_match_kernel(torch, config, anchors_for_model, augment_batch)
    phase_ssd_forward(torch, config, build_model, make_detect_fn)
    ssd_nms_launches, preds = phase_ssd_serving(torch, config, serving, nms_cuda,
                                                reset_counts)
    ssd_timing = phase_ssd_timing(torch, detection, nms, nms_cuda, preds)
    del preds
    ssd_cfg = ssd_train_config(config, 2, warmup_steps=1, lr_decay_steps=(60_000, 80_000))
    ssd_cfg = dataclasses.replace(ssd_cfg, model=dataclasses.replace(
        ssd_cfg.model, precision="highest"))
    train_check(torch, train, build_model, ssd_cfg,
                train_batch(np.random.default_rng(17), 2, g=100, classes=20),
                "SSD-512 (config #3, shape_weight 0.3)")
    ssd_cfg = ssd_train_config(config, 32)
    ssd_trained = phase_training(
        torch, train, build_model, matching_cuda, nms_cuda, reset_counts, ssd_cfg,
        train_batch(np.random.default_rng(18), 32, g=100, classes=20),
        "SSD-512 config #3 trainer (fp32, b32, shape_weight 0.3)")
    ssd_match_launches = ssd_trained[-1]
    ssd_train_timing = phase_train_timing(torch, train, matching, matching_cuda,
                                          *ssd_trained[:-1], tag="ssd512_train_b32_fp32",
                                          ties=False)
    ssd_train_timing.update(phase_train_profile(
        torch, ssd_trained[0], ssd_trained[1], ssd_trained[5],
        ssd_train_timing["ssd512_train_b32_fp32_step_median_ms"], "ssd512_train_b32_fp32"))
    state, _, module, anchors, ssd_cfg, batch, _ = ssd_trained
    del ssd_trained, state
    ssd_train_timing.update(phase_remat(torch, train, build_model, module, anchors,
                                        ssd_cfg, batch))
    del module, batch
    torch.cuda.empty_cache()
    phase_train_bn(torch, config, train, build_model)

    log(json.dumps({**e2e, **{k: v for k, v in timing.items() if k != "nms"},
                    **{k: v for k, v in train_timing.items() if k != "match"},
                    **{k: v for k, v in ssd_timing.items() if k != "nms"},
                    **{k: v for k, v in ssd_train_timing.items() if k != "match"}}))
    ssd_nms = ssd_timing["nms"]
    ssd_match = ssd_train_timing["match"]
    kernels = [{
        "name": "nms_greedy",
        "route": "cuda",
        "source": "shape_based_object_detection_torch/csrc/nms_greedy.cu",
        "replaces": "shape_based_object_detection_tpu/ops/nms_pallas.py:33",
        "launches": nms_launches,  # the serving path's
        "bit_equal": True,  # phase_kernel raises on any differing bit
        "max_abs_err": nms_err,
        **timing["nms"],
        "library_ms": None,
        # the SSD300 serving path's launches, and K1 at (16, 400, 200) there
        "ssd_launches": ssd_nms_launches,
        "ssd_max_abs_err": ssd_nms["max_abs_err"],
        **{f"ssd_{k}": v for k, v in ssd_nms.items() if k != "max_abs_err"},
    }, {
        "name": "match_anchors",
        "route": "cuda",
        "source": "shape_based_object_detection_torch/csrc/match_anchors.cu",
        "replaces": "shape_based_object_detection_tpu/ops/matching_pallas.py:72",
        "launches": match_launches,  # the training path's
        "bit_equal": True,  # assignments; phase_match_kernel raises otherwise
        "max_abs_err": match_err,
        **train_timing["match"],
        "library_ms": None,
        # the SSD-512 trainer's launches, and K2 at (32, 24564, 100) with
        # shape_weight 0.3 there
        "ssd_launches": ssd_match_launches,
        "ssd_max_abs_err": ssd_match_err,
        **{f"ssd_{k}": v for k, v in ssd_match.items()},
    }]
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
