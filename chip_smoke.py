"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper).

Drives the port's serving path (RetinaNet R50-FPN at 512 px, full width,
random weights from a seed) through ``serving.Predictor`` and checks it:

  1. device and build: the card, its power limit, the CUDA kernels built
     from ``shape_based_object_detection_torch/csrc`` (timed);
  2. kernel vs plain: the greedy-NMS kernel against ``ops.nms.greedy_nms``
     on the card at (B, N, M) = (16, 1000, 100), (16, 400, 200) and
     (8, 2000, 100), with class-offset boxes, padding rows and tied scores;
     idx, valid and the score bits must be equal;
  3. forward on the card vs the CPU, float32 with TF32 off, one image, the
     same weights; then detect end to end on both, matched detection by
     detection;
  4. the serving path: a bf16 Predictor at batch 16 answers requests of
     16, 5 and 1 images of differing sizes; the kernel must have launched
     once per batch, and run_nms through the kernel must equal the plain
     version on the same candidates; then a 16-image request end to end
     on the host clock, and the host resize alone;
  5. timing with CUDA events after warm-up (median and p90): detect
     images/s at batch 16 in bf16 and float32, a stage breakdown, and the
     kernel's time beside its bound and the plain version's time.

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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA's data sheet): HBM bandwidth and non-tensor fp32
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float ops per candidate per NMS step: 4 min/max, 2 sub, 2 clamp, 1 mul,
# 2 add/sub, 1 clamp, 1 div, 1 compare (IoU and suppress), 1 argmax compare
NMS_OPS_PER_ELEMENT = 15


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


def spread(times_ms: np.ndarray) -> str:
    """Median, p90 and sample count of a set of times."""
    return (f"median {np.median(times_ms):.4f} ms, p90 "
            f"{np.percentile(times_ms, 90):.4f} ms, n={len(times_ms)}")


def nms_inputs(rng, b, n, classes=80):
    """Candidates as the detect path gives them: clipped xyxy boxes, some
    clipped to zero width, sigmoid-range scores with forced ties, classes,
    and padding rows at the end."""
    cxcy = rng.uniform(0.0, 1.0, (b, n, 2))
    wh = rng.uniform(0.02, 0.4, (b, n, 2))
    boxes = np.clip(np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1), 0, 1)
    boxes = boxes.astype(np.float32)
    boxes[:, ::41, 2] = boxes[:, ::41, 0]
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    scores[:, 20:60] = scores[:, 5:6]
    cls = rng.integers(0, classes, (b, n)).astype(np.int32)
    valid = np.ones((b, n), bool)
    valid[:, -n // 10:] = False
    return boxes, scores, cls, valid


def phase_kernel(torch, nms, nms_cuda):
    """Kernel vs plain on the card, bit for bit. Returns the largest
    |difference| seen over idx and score."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for b, n, m in ((16, 1000, 100), (16, 400, 200), (8, 2000, 100)):
        boxes, scores, cls, valid = (torch.from_numpy(a).cuda()
                                     for a in nms_inputs(rng, b, n))
        shifted = nms.class_offset_boxes(boxes, cls)
        before = nms_cuda.launches
        got = nms_cuda.greedy_nms_cuda(shifted, scores, valid, 0.5, m)
        torch.cuda.synchronize()
        if nms_cuda.launches != before + 1:
            raise RuntimeError("the kernel's launch counter did not advance")
        want = nms.greedy_nms(shifted, scores, valid, 0.5, m)
        same = (torch.equal(got.indices, want.indices)
                and torch.equal(got.valid, want.valid)
                and torch.equal(got.scores.view(torch.int32),
                                want.scores.view(torch.int32)))
        worst = max(worst, float((got.scores - want.scores).abs().max()),
                    float((got.indices - want.indices).abs().max()))
        log(f"[kernel] nms_greedy (B, N, M)=({b}, {n}, {m}): bit-equal={same}, "
            f"kept={int(got.valid.sum())}")
        if not same:
            raise RuntimeError(f"nms_greedy differs from the plain version at "
                               f"({b}, {n}, {m})")
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
    cpu_model, cpu_anchors = build_model(cfg, device="cpu",
                                         generator=torch.Generator().manual_seed(1))
    # spread the scores away from the 0.01 prior so detections separate
    with torch.no_grad():
        cpu_model.cls_head.predict.weight.mul_(100.0)
    gpu_model, gpu_anchors = build_model(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    x = torch.from_numpy(image).permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        ref = cpu_model(x)
        out = gpu_model(x.cuda().contiguous(memory_format=torch.channels_last))
    worst = 0.0
    for r, o in zip(ref, out):
        o = o.cpu()
        if not torch.isfinite(o).all():
            raise RuntimeError("non-finite forward output on the card")
        err = (o - r).abs()
        worst = max(worst, float(err.max()))
        # float32 on both sides, sums in other orders over ~70 layers
        if not bool((err <= 1e-3 + 1e-3 * r.abs()).all()):
            raise RuntimeError(f"card forward differs from the CPU: max |err| "
                               f"{float(err.max())}")
    log(f"[forward] R50-FPN-512 fp32 (TF32 off) card vs CPU: max |err| "
        f"{worst:.3e} (bound 1e-3 + 1e-3*|cpu|), logits range "
        f"[{float(ref[0].min()):.2f}, {float(ref[0].max()):.2f}]")

    det_cfg = dataclasses.replace(cfg, detect=dataclasses.replace(cfg.detect,
                                                                  max_detections=100))
    want = make_detect_fn(cpu_model, cpu_anchors, det_cfg, device="cpu")(image)
    got = make_detect_fn(gpu_model, gpu_anchors, det_cfg, device="cuda")(image)
    v_w, v_g = want.valid[0].numpy(), got.valid[0].cpu().numpy()
    n = matched(tuple(t[0].cpu().numpy()[v_g] for t in got[:3]),
                tuple(t[0].numpy()[v_w] for t in want[:3]))
    if n == 0:
        raise RuntimeError("detect found nothing to compare")
    log(f"[forward] detect card vs CPU: {n} detections matched (label, IoU >= "
        f"0.99, |dscore| <= 1e-3)")


def serving_config(config, dtype):
    cfg = config.get_config("retinanet_r50_fpn")
    model = cfg.model
    model = dataclasses.replace(
        model, dtype=dtype,
        detect=dataclasses.replace(model.detect, score_threshold=0.0))
    return dataclasses.replace(cfg, model=model)


def phase_serving(torch, config, serving, nms_cuda, detection):
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
    nms_cuda.launches = 0
    answers = [pred.predict(r) for r in requests]
    torch.cuda.synchronize()
    launches = nms_cuda.launches
    if launches != len(requests):
        raise RuntimeError(f"the NMS kernel ran {launches} times for "
                           f"{len(requests)} batches")
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
    counts = [[len(d.scores) for d in ans] for ans in answers]
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
            with torch.inference_mode():
                x = detection.image_lib.normalize_images(images).permute(0, 3, 1, 2)
                out = module(x)
                cands = detection.select_candidates(*out, anchors, cfg)
                cfg_bf16 = cfg
                stages = {
                    "normalize": lambda: detection.image_lib.normalize_images(images),
                    "forward": lambda: module(x),
                    "select_candidates": lambda: detection.select_candidates(
                        *out, anchors, cfg),
                    "run_nms": lambda: detection.run_nms(*cands, cfg),
                }
                parts = {k: float(np.median(cuda_times_ms(f, iters=20)))
                         for k, f in stages.items()}
            results["detect_b16_bf16_stage_median_ms"] = parts
            log("[timing] detect b16 bf16 stages (median ms): " + ", ".join(
                f"{k} {v:.3f}" for k, v in parts.items()))
        del module, detect

    # the kernel on the main path's own candidates (bf16 model, batch 16)
    boxes, scores, cls, valid = cands
    b, n = scores.shape
    m, t = cfg_bf16.detect.max_detections, cfg_bf16.detect.nms_iou_threshold
    shifted = nms.class_offset_boxes(boxes, cls)
    k_times = cuda_times_ms(
        lambda: nms_cuda.greedy_nms_cuda(shifted, scores, valid, t, m), iters=200)
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
    log(f"[timing] nms_greedy ({b}, {n}, {m}) on the path's candidates: "
        f"kernel {spread(k_times)}; plain "
        f"{spread(p_times)}; bound {bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, "
        f"{ops} ops over {steps} steps), library call: none (no PyTorch op "
        f"computes greedy NMS)")
    results["nms"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from shape_based_object_detection_torch import config, detection, serving
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import nms, nms_cuda
    from shape_based_object_detection_torch.utils import native

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    t = time.perf_counter()
    native.load("nms_greedy")
    log(f"[build] nms_greedy.cu built and loaded in {time.perf_counter() - t:.2f} s")

    max_abs_err = phase_kernel(torch, nms, nms_cuda)
    phase_forward(torch, config, build_model, make_detect_fn)
    launches, e2e = phase_serving(torch, config, serving, nms_cuda, detection)
    timing = phase_timing(torch, config, build_model, make_detect_fn, detection,
                          nms, nms_cuda)

    log(json.dumps({**e2e, **{k: v for k, v in timing.items() if k != "nms"}}))
    kernel = {
        "name": "nms_greedy",
        "route": "cuda",
        "source": "shape_based_object_detection_torch/csrc/nms_greedy.cu",
        "replaces": "shape_based_object_detection_tpu/ops/nms_pallas.py:33",
        "launches": launches,
        "bit_equal": True,  # phase_kernel raises on any differing bit
        "max_abs_err": max_abs_err,
        **timing["nms"],
        "library_ms": None,
    }
    log(json.dumps({"kernels": [kernel]}))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
