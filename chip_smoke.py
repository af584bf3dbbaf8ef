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
     equal, one launch each; then the walk route above 4096 candidates per
     image at (1, 4097, 100), (4, 8192, 100) and (1, 20000, 100) and on the
     edge cases of ``nms_large_cases`` (the same traps above 4096, sorted
     input with keys in shared and in global memory, more than 4096 picks),
     each with its route, scratch bytes and measured peak allocation, and
     the walk shapes timed;
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

The groups after ``base`` drive the training application (``bn``,
``pipelined``, ``app``, ``ckpt``, ``loader``), the float serving tier
(``serve``) and the int8 tiers with the exported artifact (``int8``):

 19. hflip TTA detect on R50-FPN-512 card vs CPU (float32, TF32 off, b1,
     matched detection by detection); K1 bit-equal to its plain version on
     the hflip merge at (16, 2000, 100), whose candidates arrive unsorted,
     on the 2-scale (512, 640) merge at (16, 200, 100) and on SSD300's hflip
     merge at (1, 800, 200); K1 once per TTA batch and S + 1 times per
     multi-scale batch; the reference's "matrix" backend name runs K1 once;
     soft-NMS (sigma 0.5) card vs CPU within 1e-6; K1 and soft-NMS times on
     (16, 1000, 100) and on the merge;
     R50-FPN-512 hflip TTA at b16 bf16 with pre_nms_top_k 2100 and 5000
     (merges of 4200 and 10000 candidates per image, K1's walk route): K1
     bit-equal on each merge and once per TTA batch, its time, scratch,
     peak allocation and the detect's time; the (16, 1000, 100) serving row timed again;
 20. detect b16 bf16 with and without hflip TTA, and the 2-scale batch
     detector, by CUDA events;
 21. the HTTP server over a bf16 b16 Predictor with buckets 1-16, warmed
     up: 512 PNG/JPEG requests of 200-900 px from 16 client threads in a
     process of their own, every answer equal to Predictor.predict of the
     same batch (0.01 px, 1e-5), K1 once per batch, requests/s, p50/p90/p99
     latency, batch occupancy, the server process's CPU and the share of
     the wall with a batch on the card; a lone request on the b1 bucket;
 22. detect_cli on SSD300 with --tta-hflip --tta-scales 300 --save-viz (K1
     twice), and serve_cli as a subprocess: /healthz, /detect, SIGTERM;
 23. each int8 tier's full-width forward card vs CPU (R50-FPN-512 and
     SSD300, b1, float32 with TF32 off): weight-only within 0.02 / 0.002;
     in the full tiers every int8 convolution of the card's forward
     bit-equal to the CPU's on the card's input, and the whole forward
     within 3x the CPU's own spread under 1e-7 noise at each int8
     convolution's input;
 24. R50-FPN-512 bf16 Predictors (buckets 1 and 16) in the float, weights,
     full-dynamic and full-static tiers (static scales calibrated on 4
     synthetic b16 batches) and SSD300 config #1 Predictors: K1 once per
     batch in every tier; every int8 product of R50 b16 and b1 and of
     SSD300 b1 (the dilated conv6) bit-equal to its plain version on the
     card; detect images/s and device ms per call, weight bytes, and the
     full tiers' stage times (quantize, im2col, _int_mm, epilogue) against
     cuDNN's bf16 convolutions of the same shapes; the 2-scale int8
     detector (K1 3 times);
 25. the bf16 b16 float and full-static R50 programs exported on the card
     and a tiny SSD on the CPU; a fresh process loads each with the port
     alone: detections equal to the live Predictor's, one K1 launch per
     call, the CPU artifact run on the card; meanwhile serve_cli serves the
     static tier (--quantize full --act-scales) and an artifact (--artifact)
     as subprocesses; last, ArtifactPredictor.predict against
     Predictor.predict.

The groups ``data`` and ``dist`` drive the input pipelines and data
parallelism:

 26. config #3's input (SSD-512, b32, 512 px, max_boxes 100): build_cache
     of the 256-image synthetic split (seconds, bytes), CacheLoader's ms per
     batch, the cache staged on the card (bytes, the on-card gather's device
     ms beside its bound, every batch bit-equal to CacheLoader's), the
     thread Loader and GrainLoader at 0, 4 and 8 worker processes on that
     split and on a VOC folder of 256 JPEGs of 500 x 375 written from a
     seed (the decode-bound case), and train_cli on config #3 under
     --loader threads, cache and device (synthetic) and threads and grain
     (JPEGs): ms per step, the card's idle share, K2 once per step; no
     loader worker process may outlive its GrainLoader's close();
 27. an NCCL group of one rank formed from torchrun's environment: the
     data-parallel step bit-equal to the plain step (R50-FPN-512 b16 bf16;
     SSD-512 b32 with train_bn and remat; cuDNN deterministic) with K2 once
     per step, K2 bit-equal on the rank's augmented rows, the sharded eval
     step with K1 once per batch and bit-equal on its candidates;
     train_cli under torch.distributed.run (8 steps, a val eval, a
     checkpoint, its resume to 12) and eval_cli the same way, its records
     equal to eval_cli's without a group; two ranks sharing the card over
     gloo, b2 each, against one process's step on the global b4.

The group ``spatial`` drives the model axis (image rows split across the
ranks of a model group, halo exchanges in every convolution):

 28. config #5's model as the preset sets it (R101-FPN at 1024 px, focal,
     the whole-forward train.remat), float32 with TF32 off and cuDNN
     deterministic, b2: two train steps and a detect (threshold 0) in this
     process, then on 1 data x 2 model gloo ranks sharing the card (NCCL,
     one rank per card, too where the machine has two cards): loss within
     1e-5 relative, grad_norm 1e-4, parameters 2e-5, detections at the
     reference's bounds; each rank's peak memory and step ms beside this
     process's, the halo exchanges of one forward and their bytes; K2 once
     per step and K1 once per detect on every rank;
 29. K1 bit-equal to its plain version on rank 0's candidates (2, 1000,
     100) and K2 on the step's GT against the 196,416 anchors, both timed;
 30. R50-FPN-512 b4 on 2 data x 2 model gloo ranks: the same checks, with
     a data group and a model group of two ranks each.

The group ``tools`` drives the checkpoint tools and the examples:

 31. a config #3 train_cli run (3 steps, a checkpoint each) averaged by
     tools/average_checkpoints, bit-equal to a numpy float32 average of the
     same snapshots; eval_cli (K1 once per batch), export_model
     --checkpoint-dir (its artifact K1 once) and a one-step train_cli
     resume (K2 once) on the average; tools/convert_checkpoint --mode
     vgg_backbone on a full-width synthetic torchvision VGG-16 (138 M
     parameters) and 2 train_cli steps from it with --init-params (K2
     twice); both examples as subprocesses, exiting 0 with their lines.

Every process the run starts ends before it does: the script is the child
subreaper of its descendants (a worker whose parent exits is re-parented to
it), and after the last phase, or a failed one, it stops multiprocessing's
fork server, then whatever else still runs (named in its log), then
multiprocessing's resource tracker, and reaps them all.

Prints its results, a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without printing a result when there is no CUDA device or a phase fails.

    python3 chip_smoke.py
    python3 chip_smoke.py --only serve   # one group, no result line
    python3 chip_smoke.py --only int8    # the int8 tiers and the artifact
    python3 chip_smoke.py --only data,dist   # the loaders, data parallelism
    python3 chip_smoke.py --only spatial     # the model axis
    python3 chip_smoke.py --only tools       # the checkpoint tools, the examples
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
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
HOST_LIBRARIES = ("ap_matcher", "jpeg_decoder")  # the eval and data paths' host C++


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


PR_SET_CHILD_SUBREAPER = 36  # linux/prctl.h


def adopt_orphans() -> None:
    """Make this process the child subreaper of everything it starts: a
    process whose parent exits before it (a worker of multiprocessing's fork
    server, a rank of a killed torchrun) is re-parented to this one, not to
    init, so that ``stop_children`` finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")


def descendants() -> dict:
    """{pid: command line} of every process below this one that has not
    exited (zombies are left out), from /proc."""
    procs = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # it ended meanwhile
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        procs[int(entry)] = (int(ppid), state, cmd or stat[stat.index("("):stat.rindex(")") + 1])
    out, parents = {}, [os.getpid()]
    while parents:
        parent = parents.pop()
        for pid, (ppid, state, cmd) in procs.items():
            if ppid == parent:
                parents.append(pid)
                if state not in "ZX":
                    out[pid] = cmd
    return out


def reap() -> None:
    """Collect the exit status of every child of this process that has
    ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:  # no child left
            return
        if pid == 0:  # children left, none ended
            return


def wait_gone(pids, timeout: float) -> set:
    """Wait up to ``timeout`` s for ``pids`` to end (reaping this process's
    children as they do): those still running."""
    end = time.monotonic() + timeout
    while True:
        reap()
        alive = set(pids) & set(descendants())
        if not alive or time.monotonic() >= end:
            return alive
        time.sleep(0.05)


def terminate(pids, timeout: float) -> None:
    """SIGTERM to ``pids``, SIGKILL to those still running ``timeout`` s
    later."""
    import signal

    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in pids:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        pids = wait_gone(pids, timeout)
        for pid in pids:
            log(f"[procs] pid {pid} still runs {timeout:.0f} s after signal {int(sig)}")
    if pids:
        raise RuntimeError(f"processes {sorted(pids)} outlived SIGKILL")


def loader_workers_left() -> list:
    """pids of multiprocessing's fork-server children still running: the
    worker processes of a GrainLoader that is not closed."""
    from multiprocessing import forkserver

    server = getattr(forkserver._forkserver, "_forkserver_pid", None)
    return sorted(p for p, c in descendants().items()
                  if p != server and "multiprocessing.forkserver import main" in c)


def stop_children(timeout: float = 10.0) -> None:
    """Stop and reap every process below this one that still runs. Anything
    but multiprocessing's fork server and resource tracker (a fork server's
    worker, a subprocess) is named in the log and stopped by SIGTERM, SIGKILL
    after ``timeout`` s; the two helpers then end as they do when this
    process exits: each when the last holder of its pipe (every fork-server
    child holds the server's, so they go first) closes it."""
    import gc
    import signal
    from multiprocessing import forkserver, resource_tracker

    gc.collect()  # queues of dead DataLoaders free their semaphores first
    # a DataLoader left open raises from its SIGCHLD handler when its
    # workers are stopped: the phases are over, so that handler goes
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
    helpers = ((forkserver._forkserver, "_forkserver_pid", "_forkserver_alive_fd"),
               (resource_tracker._resource_tracker, "_pid", "_fd"))
    helper_pids = {getattr(h, pid) for h, pid, _ in helpers} - {None}
    left = {p: c for p, c in descendants().items() if p not in helper_pids}
    for pid, cmd in left.items():
        log(f"[procs] still running after the phases: pid {pid}: {cmd[:300]}")
    terminate(list(left), timeout)
    for helper, pid, fd in helpers:
        if getattr(helper, fd, None) is not None:
            os.close(getattr(helper, fd))
            setattr(helper, fd, None)
    if wait_gone(helper_pids, timeout):
        log("[procs] multiprocessing's helpers did not end when their pipes closed")
    terminate(list(descendants()), timeout)
    for helper, pid, _ in helpers:
        if getattr(helper, pid, None) is not None:
            setattr(helper, pid, None)  # reaped above
    reap()


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


WALK_SHAPES = ((1, 4097, 100), (4, 8192, 100), (1, 20000, 100))


def k1_peak_bytes(torch, nms_cuda, boxes, scores, valid, t, m) -> int:
    """Device memory one K1 call (``greedy_nms_cuda`` on class-offset boxes)
    asks of the caching allocator at its peak, over what was held before
    it: its scratch, its outputs and any input copies, as requested (the
    allocator's "requested_bytes", before its rounding)."""
    key = "requested_bytes.all.peak"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    nms_cuda.greedy_nms_cuda(boxes, scores, valid, t, m)
    torch.cuda.synchronize()
    return int(torch.cuda.memory_stats()[key] - before)


def phase_kernel(torch, nms, nms_cuda):
    """Kernel vs plain on the card, bit for bit, at the path's shapes and on
    the edge cases; then the walk route above 4096 candidates per image at
    WALK_SHAPES and on the edge cases padded above 4096, each shape with its
    route, scratch bytes (the kernel's layout, and the peak allocation
    measured around one call) and times. Returns (the largest |difference|
    seen over idx and score, K1's rows for the walk route)."""
    from tests.torch_kernel_cases import (
        nms_bit_equal, nms_edge_cases, nms_inputs, nms_large_cases,
    )

    rng = np.random.default_rng(0)
    worst = 0.0
    cases = []
    for b, n, m in ((16, 1000, 100), (16, 400, 200), (8, 2000, 100)) + WALK_SHAPES:
        boxes, scores, cls, valid = (torch.from_numpy(a).cuda()
                                     for a in nms_inputs(rng, b, n))
        cases.append((f"(B, N, M)=({b}, {n}, {m})", nms.class_offset_boxes(boxes, cls),
                      scores, valid, 0.5, m))
    for name, (boxes, scores, valid, t, m) in {**nms_edge_cases(), **{
            f"{k} (padded above 4096)": v for k, v in nms_large_cases().items()}}.items():
        cases.append((f"{name} (B, N, M)=({scores.shape[0]}, {scores.shape[1]}, {m}), "
                      f"t={t}", *(torch.from_numpy(a).cuda() for a in (boxes, scores, valid)),
                      t, m))
    for name, boxes, scores, valid, t, m in cases:
        same, err, kept = nms_bit_equal(boxes, scores, valid, t, m)
        worst = max(worst, err)
        b, n = scores.shape
        scratch = nms_cuda.scratch_bytes(b, n, m)
        peak = k1_peak_bytes(torch, nms_cuda, boxes, scores, valid, t, m)
        log(f"[kernel] nms_greedy {name}: route {nms_cuda.route(n)}, scratch {scratch} bytes "
            f"({scratch / (b * n):.1f} per candidate; the bitmask alone would be "
            f"{b * n * -(-n // 64) * 8}), peak allocation of one call {peak} bytes, "
            f"bit-equal={same}, kept={kept}")
        if not same:
            raise RuntimeError(f"nms_greedy differs from the plain version: {name}")
    rows = {}
    for (b, n, m), (_, boxes, scores, valid, t, _) in zip(WALK_SHAPES, cases[3:]):
        det = argparse_ns(max_detections=m, nms_iou_threshold=t)
        no_class = torch.zeros_like(scores, dtype=torch.int32)  # the boxes are shifted
        timing = nms_timing(nms, nms_cuda, (boxes, scores, no_class, valid), det,
                            f"random candidates (route {nms_cuda.route(n)})")
        tag = f"walk_{b}x{n}x{m}"
        rows.update({f"{tag}_{k}": v for k, v in timing.items()})
        rows[f"{tag}_peak_alloc_bytes"] = k1_peak_bytes(torch, nms_cuda, boxes, scores,
                                                        valid, t, m)
    return worst, rows


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
    for name, (gt, lbl, ok) in cases:
        timed = match_timing(torch, matching, matching_cuda, anchors, cfg, name, gt, lbl, ok)
        entry = entry or timed
    results["match"] = entry
    return results


def match_timing(torch, matching, matching_cuda, anchors, cfg, name, gt, lbl, ok):
    """K2's time on one batch of GT: CUDA events between back-to-back wrapper
    calls, profiler device time, the plain version's time and the bound of
    the work this data needs."""
    gt, lbl, ok = gt.contiguous(), lbl.contiguous(), ok.contiguous()
    sw = cfg.match.shape_weight
    variances = cfg.model.anchors.variances
    args = (anchors, gt, lbl, ok, sw, cfg.match.shape_tau, variances)
    k_times = cuda_times_ms(lambda: matching_cuda.match_reductions_cuda(*args), iters=100)
    dev_ms, dev_names = device_ms_per_call(lambda: matching_cuda.match_reductions_cuda(*args))
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
    return dict(ms=float(np.median(k_times)), device_ms=dev_ms,
                plain_ms=float(np.median(p_times)), bound_ms=bound_ms, bound_by=bound_by)


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


# ---------------------------------------------------------------------------
# The training application: the frozen-BatchNorm repair, the pipelined
# step, train_cli and eval_cli on config #3, checkpoints, the Loader
# ---------------------------------------------------------------------------


def frozen_bn_before_repair(self, x, train=False):
    """The frozen BatchNorm branch before the repair: the running statistics
    folded into a scale and shift in float32, both cast to the input's type,
    one multiply-add in that type (bf16 rounds three times, not once)."""
    import torch

    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
    shift = self.bias.float() - self.running_mean.float() * mul
    return torch.addcmul(shift.to(x.dtype).view(shape), x, mul.to(x.dtype).view(shape))


class FrozenBnVariant:
    """``with FrozenBnVariant(resnet, before=True):`` runs every BatchNorm
    with the branch before the repair; ``before=False`` keeps the repaired
    one."""

    def __init__(self, resnet, before: bool):
        self.cls, self.before = resnet.BatchNorm, before
        self.saved = resnet.BatchNorm.forward

    def __enter__(self):
        if self.before:
            self.cls.forward = frozen_bn_before_repair
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.saved


def in_turns(variants, fn, rounds=2):
    """``fn(variant)`` -> list of times, for each variant in turns (a, b, b,
    a, ...) ``rounds`` times; returns {variant: all its times}."""
    times = {v: [] for v in variants}
    for r in range(rounds):
        for v in (variants if r % 2 == 0 else variants[::-1]):
            times[v].extend(fn(v))
    return {v: np.array(t) for v, t in times.items()}


def profile_op_ms(torch, fn, n, names):
    """Device ms per call of ``fn`` (n calls under torch.profiler) of each
    operator in ``names``, and of all kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops = {e.key: e.self_device_time_total / 1e3 / n for e in prof.key_averages()}
    total = sum(e.self_device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    return {k: ops.get(k, 0.0) for k in names}, total


def bn_layer_inputs(torch, resnet, module, run):
    """(BatchNorm, input shape, dtype, memory format) of every BatchNorm
    call in ``run()``."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append((m, args[0].shape, args[0].dtype,
                                     args[0].is_contiguous(memory_format=torch.channels_last))))
        for m in module.modules() if isinstance(m, resnet.BatchNorm)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def bn_alone_ms(torch, resnet, layers, backward, before):
    """Device ms (torch.profiler, the kernels of 5 runs) of every frozen
    BatchNorm call of one forward alone, on random inputs of its shapes;
    with ``backward`` its backward too (grad to the input and to the scale
    and bias). Its ~350 launches would make CUDA events time the host."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = []
    for bn, shape, dtype, cl in layers:
        x = torch.randn(shape, device="cuda", dtype=dtype, generator=gen)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        xs.append((bn, x.requires_grad_(backward)))

    def run():
        for bn, x in xs:
            y = bn(x)
            if backward:  # the gradients of the input, the scale and the bias
                torch.autograd.grad(y, (x, bn.weight, bn.bias), y.detach())

    with FrozenBnVariant(resnet, before), torch.set_grad_enabled(backward):
        return profile_op_ms(torch, run, 5, ())[1]


def phase_bn_repair(torch, config, train, build_model, make_detect_fn):
    """The frozen-BatchNorm repair on the card: the R50-512 backbone's bf16
    forward card vs CPU (both against the CPU's float32 one); then before and
    after the repair in one run, in turns: detect b16 bf16 images/s, the
    bf16 b16 train step, the profiler's aten::mul per step, and the frozen
    BatchNorm calls alone at the step's and detect's shapes."""
    from shape_based_object_detection_torch.models import resnet

    f32 = dataclasses.replace(config.get_config("retinanet_r50_fpn").model,
                              precision="highest")
    bf16 = dataclasses.replace(f32, dtype="bfloat16")
    cpu32, _ = build_model(f32, device="cpu", generator=torch.Generator().manual_seed(1))
    # statistics and affine terms away from identity (a fresh model's
    # BatchNorm is one, and rounds the same before and after the repair)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in cpu32.modules():
            if isinstance(m, resnet.BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    state = cpu32.state_dict()
    image = np.random.default_rng(19).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    x = torch.from_numpy(image).permute(0, 3, 1, 2).float() / 255.0
    outs = {}
    # the backbone's C3-C5: a fresh model's heads (weights of std 0.01 on a
    # prior bias) hide what the backbone computes
    with torch.inference_mode():
        outs["cpu32"] = cpu32.backbone(x)
        del cpu32
        for dev in ("cpu", "cuda"):
            m, _ = build_model(bf16, device=dev)
            m.load_state_dict(state)
            xd = x.to(dev, torch.bfloat16)
            if dev == "cuda":
                xd = xd.contiguous(memory_format=torch.channels_last)
            for before in (False, True):
                with FrozenBnVariant(resnet, before):
                    outs[(dev, before)] = [o.float().cpu() for o in m.backbone(xd)]
            del m
    ref = outs["cpu32"]

    def mean_err(o, r):
        return float(sum((a - b).abs().sum() for a, b in zip(o, r))
                     / sum(b.numel() for b in r))

    card, cpu = outs[("cuda", False)], outs[("cpu", False)]
    e_card, e_cpu = mean_err(card, ref), mean_err(cpu, ref)
    e_card_before, e_cpu_before = mean_err(outs[("cuda", True)], ref), mean_err(
        outs[("cpu", True)], ref)
    card_cpu = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
    finite = all(bool(torch.isfinite(o).all()) for o in card)
    log(f"[bn] R50-512 backbone (C3-C5) in bf16, one 512 px image, the same weights: mean "
        f"|bf16 - CPU float32| card {e_card:.5f}, CPU {e_cpu:.5f} (bound: card <= 2 x CPU "
        f"+ 1e-3); card vs CPU bf16 max |err| {card_cpu:.4f}; with the frozen branch before "
        f"the repair: card {e_card_before:.5f}, CPU {e_cpu_before:.5f}")
    if not (finite and e_card <= 2 * e_cpu + 1e-3):
        raise RuntimeError(f"bf16 forward on the card is off: {e_card} vs CPU {e_cpu}")
    results = {"bn_bf16_forward_mean_err_card": e_card, "bn_bf16_forward_mean_err_cpu": e_cpu,
               "bn_bf16_forward_mean_err_card_before": e_card_before,
               "bn_bf16_forward_mean_err_cpu_before": e_cpu_before}

    # detect b16 bf16 before and after, in turns
    cfg = serving_config(config, "bfloat16").model
    module, anchors = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    detect = make_detect_fn(module, anchors, cfg, device="cuda")
    images = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)).cuda()

    def detect_times(before):
        with FrozenBnVariant(resnet, before):
            return cuda_times_ms(lambda: detect(images), iters=15)

    d = in_turns((False, True), detect_times, rounds=3)
    d_dev = {}
    for before in (False, True):
        with FrozenBnVariant(resnet, before):
            d_dev[before] = profile_op_ms(torch, lambda: detect(images), 5, ())[1]
    with torch.inference_mode():
        xn = (images.float() / 255.0).permute(0, 3, 1, 2)
        layers_det = bn_layer_inputs(torch, resnet, module, lambda: module(xn))
    bn_det = {b: bn_alone_ms(torch, resnet, layers_det, False, b) for b in (False, True)}
    del module, detect
    torch.cuda.empty_cache()

    # the bf16 b16 train step before and after, in turns
    tcfg = train_config(config, "bfloat16", 16)
    module, anchors = build_model(tcfg.model, device="cuda", train=True,
                                  generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(module, tcfg)
    step = train.make_train_step(module, anchors, tcfg)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in train_batch(np.random.default_rng(8), 16).items()}

    def step_times(before):
        with FrozenBnVariant(resnet, before):
            return cuda_times_ms(lambda: step(state, batch), iters=10)

    t = in_turns((False, True), step_times, rounds=3)
    names = ("aten::mul", "aten::add", "aten::sub", "aten::addcmul", "aten::copy_")
    prof = {}
    for before in (False, True):
        with FrozenBnVariant(resnet, before):
            prof[before] = profile_op_ms(torch, lambda: step(state, batch), 3, names)
    x = torch.randn(16, 3, 512, 512, device="cuda").contiguous(memory_format=torch.channels_last)

    def train_forward():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            module(x, train=True)

    layers_train = bn_layer_inputs(torch, resnet, module, train_forward)
    bn_train = {b: bn_alone_ms(torch, resnet, layers_train, True, b) for b in (False, True)}
    del module, state, step, batch
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    for before, label in ((False, "after"), (True, "before")):
        ops, total = prof[before]
        results[f"bn_{label}_detect_b16_bf16_images_per_s"] = 16e3 / float(np.median(d[before]))
        results[f"bn_{label}_detect_b16_bf16_ms"] = float(np.median(d[before]))
        results[f"bn_{label}_detect_b16_bf16_device_ms"] = d_dev[before]
        results[f"bn_{label}_train_b16_bf16_step_ms"] = float(np.median(t[before]))
        results[f"bn_{label}_train_step_aten_mul_ms"] = ops["aten::mul"]
        results[f"bn_{label}_train_step_device_ms"] = total
        results[f"bn_{label}_frozen_bn_train_step_ms"] = bn_train[before]
        results[f"bn_{label}_frozen_bn_detect_b16_ms"] = bn_det[before]
        log(f"[bn] {label} the repair ({smi}): detect b16 bf16 {spread(d[before])}, "
            f"{16e3 / np.median(d[before]):.1f} images/s, device {d_dev[before]:.3f} ms per "
            f"call (torch.profiler); train step b16 bf16 {spread(t[before])}; device ms per "
            f"step (torch.profiler, 3 steps): all kernels {total:.3f}, "
            + ", ".join(f"{k} {v:.3f}" for k, v in ops.items())
            + f"; device ms (torch.profiler) of the {len(layers_train)} frozen BatchNorm calls "
            f"of a step alone, forward and backward, {bn_train[before]:.3f}, and of the "
            f"{len(layers_det)} of a detect b16 forward {bn_det[before]:.3f}")
    results.update(bn_repair_float32_cost(torch, config, train, build_model, make_detect_fn,
                                          resnet))
    return results


def bn_repair_float32_cost(torch, config, train, build_model, make_detect_fn, resnet):
    """The repair's cost in float32, where it makes three float32 passes
    (subtract, multiply, add) for the one addcmul before it: detect b16
    float32 and the float32 b16 train step, before and after in turns, and
    the frozen BatchNorm calls alone at their shapes."""
    results = {}
    cfg = serving_config(config, "float32").model
    module, anchors = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    detect = make_detect_fn(module, anchors, cfg, device="cuda")
    images = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)).cuda()

    def detect_times(before):
        with FrozenBnVariant(resnet, before):
            return cuda_times_ms(lambda: detect(images), iters=15)

    d = in_turns((False, True), detect_times, rounds=3)
    d_dev = {}
    for before in (False, True):
        with FrozenBnVariant(resnet, before):
            d_dev[before] = profile_op_ms(torch, lambda: detect(images), 5, ())[1]
    with torch.inference_mode():
        xn = (images.float() / 255.0).permute(0, 3, 1, 2)
        layers_det = bn_layer_inputs(torch, resnet, module, lambda: module(xn))
    bn_det = {b: bn_alone_ms(torch, resnet, layers_det, False, b) for b in (False, True)}
    del module, detect
    torch.cuda.empty_cache()

    tcfg = train_config(config, "float32", 16)
    module, anchors = build_model(tcfg.model, device="cuda", train=True,
                                  generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(module, tcfg)
    step = train.make_train_step(module, anchors, tcfg)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in train_batch(np.random.default_rng(8), 16).items()}

    def step_times(before):
        with FrozenBnVariant(resnet, before):
            return cuda_times_ms(lambda: step(state, batch), iters=10)

    t = in_turns((False, True), step_times, rounds=3)
    t_dev = {}
    for before in (False, True):
        with FrozenBnVariant(resnet, before):
            t_dev[before] = profile_op_ms(torch, lambda: step(state, batch), 3, ())[1]
    x = torch.randn(16, 3, 512, 512, device="cuda").contiguous(memory_format=torch.channels_last)
    layers_train = bn_layer_inputs(torch, resnet, module, lambda: module(x, train=True))
    bn_train = {b: bn_alone_ms(torch, resnet, layers_train, True, b) for b in (False, True)}
    del module, state, step, batch
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    for before, label in ((False, "after"), (True, "before")):
        results[f"bn_{label}_detect_b16_fp32_images_per_s"] = 16e3 / float(np.median(d[before]))
        results[f"bn_{label}_detect_b16_fp32_ms"] = float(np.median(d[before]))
        results[f"bn_{label}_detect_b16_fp32_device_ms"] = d_dev[before]
        results[f"bn_{label}_train_b16_fp32_step_ms"] = float(np.median(t[before]))
        results[f"bn_{label}_train_b16_fp32_step_device_ms"] = t_dev[before]
        results[f"bn_{label}_frozen_bn_train_step_fp32_ms"] = bn_train[before]
        results[f"bn_{label}_frozen_bn_detect_b16_fp32_ms"] = bn_det[before]
        log(f"[bn] {label} the repair, float32 ({smi}): detect b16 fp32 {spread(d[before])}, "
            f"{16e3 / np.median(d[before]):.1f} images/s, device {d_dev[before]:.3f} ms per "
            f"call (torch.profiler); train step b16 fp32 {spread(t[before])}, device "
            f"{t_dev[before]:.3f} ms per step (torch.profiler, 3 steps); device ms "
            f"(torch.profiler) of the {len(layers_train)} "
            f"frozen BatchNorm calls of a step alone, forward and backward, "
            f"{bn_train[before]:.3f}, and of the {len(layers_det)} of a detect b16 forward "
            f"{bn_det[before]:.3f}")
    return results


def kineto_intervals(torch, prof):
    """The card's activity of a torch.profiler run as (stream, start_ns,
    end_ns) triples, and the host's ranges as (name, start_ns, end_ns). The
    spans of record_function ranges on the card's timeline cover idle gaps
    and are left out."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.device_resource_id(), start, start + dur))
        else:
            host.append((e.name(), start, start + dur))
    return dev, host


def union_length(intervals, lo=None, hi=None):
    """Total length of the union of (start, end) intervals, clipped to
    [lo, hi] when given."""
    spans = sorted((max(s, lo) if lo is not None else s, min(e, hi) if hi is not None else e)
                   for s, e in intervals)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def overlap_share(dev):
    """Of the device time on the streams other than the busiest (the side
    streams), the share that ran while the busiest stream had a kernel."""
    by_stream = {}
    for sid, s, e in dev:
        by_stream.setdefault(sid, []).append((s, e))
    main = max(by_stream, key=lambda k: union_length(by_stream[k]))
    main_spans = sorted(by_stream[main])
    side = [iv for k, v in by_stream.items() if k != main for iv in v]
    side_time = sum(e - s for s, e in side)
    both = 0
    for s, e in side:
        both += union_length([(ms, me) for ms, me in main_spans if me > s and ms < e], s, e)
    return (both / side_time if side_time else 0.0), len(by_stream), len(side), side_time / 1e6


def phase_pipelined(torch, train, build_model, matching_cuda, cfg, batches, tag):
    """The pipelined step against the plain step: the same weights, batches
    and generator seed give the same losses (within 1e-6 relative); step
    times in turns; the share of the side stream's kernels that overlapped
    the main stream's (torch.profiler over 3 steps)."""
    from torch.profiler import ProfilerActivity, profile

    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in batches]
    n = len(batches)
    runs, losses = {}, {}
    for pipelined in (False, True):
        module, anchors = build_model(cfg.model, device="cuda", train=True,
                                      generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(module, cfg)
        before = matching_cuda.launches
        if pipelined:
            prime, pstep = train.make_train_step_pipelined(module, anchors, cfg)
            state, carry = prime(state, batches[0])
            out = []
            for nxt in batches[1:] + batches[:1]:
                state, carry, m = pstep(state, carry, nxt)
                out.append(float(m["loss"]))
            runs[True] = (state, pstep, carry, module)
        else:
            step = train.make_train_step(module, anchors, cfg)
            out = [float(step(state, b)[1]["loss"]) for b in batches]
            runs[False] = (state, step, None, module)
        if matching_cuda.launches - before != n:
            raise RuntimeError(f"K2 ran {matching_cuda.launches - before} times in {n} steps")
        losses[pipelined] = out
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses[True], losses[False]))
    log(f"[pipelined] {tag}, prime + {n} steps: losses {losses[True]}; plain step on the same "
        f"batches and generator {losses[False]}; worst relative difference {rel:.2e} "
        f"(bound 1e-6); K2 launches {n} per run")
    if not rel <= 1e-6:
        raise RuntimeError(f"pipelined losses differ from the plain step's: {rel}")

    holder = {"carry": runs[True][2]}

    def steps(pipelined):
        state, fn, _, _ = runs[pipelined]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        events[0].record()
        for i, e in enumerate(events[1:]):
            if pipelined:
                _, holder["carry"], _ = fn(state, holder["carry"], batches[i % n])
            else:
                fn(state, batches[i % n])
            e.record()
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(events[1:], events[2:])]

    t = in_turns((True, False), steps, rounds=4)
    state, pstep = runs[True][0], runs[True][1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            _, holder["carry"], _ = pstep(state, holder["carry"], batches[i % n])
        torch.cuda.synchronize()
    share, streams, side_n, side_ms = overlap_share(kineto_intervals(torch, prof)[0])
    log(f"[pipelined] {tag}: step time in turns (4 rounds of 4) pipelined {spread(t[True])}, "
        f"plain {spread(t[False])} ({nvidia_smi_line()}); {streams} streams; the side "
        f"stream's {side_n} activities ({side_ms:.3f} ms over 3 steps) ran beside the main "
        f"stream's kernels for {share:.3f} of their time")
    del runs, holder
    torch.cuda.empty_cache()
    return {f"pipelined_{tag}_step_median_ms": float(np.median(t[True])),
            f"pipelined_{tag}_step_p90_ms": float(np.percentile(t[True], 90)),
            f"plain_{tag}_step_median_ms": float(np.median(t[False])),
            f"plain_{tag}_step_p90_ms": float(np.percentile(t[False], 90)),
            f"pipelined_{tag}_side_overlap_share": share,
            f"pipelined_{tag}_loss_max_rel_diff": rel}


class Tee:
    """stdout that is printed with a prefix and kept."""

    def __init__(self, prefix):
        self.prefix, self.lines, self._buf = prefix, [], ""

    def write(self, s):
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append(line)
            sys.__stdout__.write(f"{self.prefix}{line}\n")
        return len(s)

    def flush(self):
        sys.__stdout__.flush()

    @property
    def text(self):
        return "\n".join(self.lines + ([self._buf] if self._buf else []))


def run_cli(main, argv):
    """``main(argv)`` in this process with its stdout shown as [cli] lines;
    returns the text."""
    import contextlib

    tee = Tee("[cli] ")
    with contextlib.redirect_stdout(tee):
        main(argv)
    return tee.text


def argparse_ns(**kw):
    import argparse

    return argparse.Namespace(**kw)


APP_TRAIN = "synthetic://train?n=256&max_objects=8&aspect_std=0.6"
APP_VAL = "synthetic://val?n=64&max_objects=8&aspect_std=0.6"


def cli_loop(torch, train, cli_train, argv, timed, profiled):
    """train_cli ``argv`` in this process, every step stamped on the host
    clock and steps ``profiled[0]`` to ``profiled[1] - 1`` (1-based)
    launched under torch.profiler. Returns (its output, wall s, the median
    ms between the steps ``timed[0]`` to ``timed[1]``, and the card's busy
    ms, window ms and idle share over the profiled steps, on the card's
    own timeline: the host runs up to METRIC_LAG steps ahead). The seconds
    before the first step and after the last are logged."""
    from torch.profiler import ProfilerActivity, profile

    stamps, prof_box = [], {}
    real = train.make_train_step

    def timed_step_factory(*a, **k):
        step = real(*a, **k)

        def timed_step(state, batch):
            i = len(stamps) + 1
            if i == profiled[0]:
                prof_box["p"] = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                prof_box["p"].__enter__()
            if i == profiled[1]:
                prof_box["p"].__exit__(None, None, None)
            stamps.append(time.perf_counter())
            with torch.profiler.record_function("cli_step"):
                return step(state, batch)

        return timed_step

    train.make_train_step = timed_step_factory
    try:
        t0 = time.perf_counter()
        text = run_cli(cli_train.main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train.make_train_step = real
    interval = float(np.median(np.diff(stamps[timed[0] - 1:timed[1]]))) * 1e3
    dev, host = kineto_intervals(torch, prof_box["p"])
    steps_seen = sum(1 for name, _, _ in host if name == "cli_step")
    if steps_seen != profiled[1] - profiled[0] or not dev:
        raise RuntimeError(f"the profiled window holds {steps_seen} steps, {len(dev)} "
                           "device activities")
    lo, hi = min(s for _, s, _ in dev), max(e for _, _, e in dev)
    busy = union_length([(s, e) for _, s, e in dev])
    log(f"[cli] train_cli took {stamps[0] - t0:.2f} s to its first step and "
        f"{t0 + wall - stamps[-1]:.2f} s after its last was launched")
    return text, wall, interval, busy / 1e6, (hi - lo) / 1e6, 1.0 - busy / (hi - lo)


def phase_app(torch, train, cli_train, nms_cuda, matching_cuda, reset_counts, workdir):
    """train_cli on config #3 (SSD-512 b32 float32, shape_weight 0.3) on a
    512 px synthetic split: 24 steps, a val eval every 12 on 2 batches. K2
    once per step, K1 once per eval batch, finite losses; the loop's ms per
    step (host clock), its idle share on the card (torch.profiler over steps
    17-20 launched under torch.profiler, on the card's own timeline) and the
    Loader's ms per batch."""
    steps, every, val_batches, workers = 24, 12, 2, 8
    ckpt = os.path.join(workdir, "app_ckpt")
    argv = ["--config", "config3_ssd512_voc_train", "--data-root", APP_TRAIN,
            "--steps", str(steps), "--eval-every", str(every), "--val-root", APP_VAL,
            "--val-batches", str(val_batches), "--log-every", "4", "--workers", str(workers),
            "--checkpoint-dir", ckpt]
    reset_counts()
    # the loop's step interval on the host clock over steps 5-12 (the eval
    # at step 12 and the profiled steps 17-20 left out)
    text, wall, interval, busy, window, idle = cli_loop(torch, train, cli_train, argv,
                                                        (5, 12), (17, 21))
    k2, k1 = matching_cuda.launches, nms_cuda.launches
    losses = [float(line.split("loss=")[1].split()[0]) for line in text.splitlines()
              if " loss=" in line]
    evals = (steps // every) * val_batches
    maps = [line.split("voc-mAP(val)=")[1].split()[0] for line in text.splitlines()
            if "voc-mAP(val)=" in line]
    if k2 != steps or k1 != evals:
        raise RuntimeError(f"train_cli: K2 ran {k2} times in {steps} steps, K1 {k1} times "
                           f"in {evals} eval batches")
    if not (losses and all(np.isfinite(losses)) and f"done at step {steps}" in text
            and len(maps) == steps // every):
        raise RuntimeError(f"train_cli on config #3 did not finish cleanly: {text[-500:]}")
    saved = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
    log(f"[app] train_cli config #3 (SSD-512 b32 fp32, shape_weight 0.3), {steps} steps, eval "
        f"every {every} on {val_batches} val batches ({nvidia_smi_line()}): wall {wall:.1f} s; "
        f"losses {losses}; K2 launches {k2} (one per step), K1 {k1} (one per eval batch); "
        f"checkpoints {saved}; voc-mAP {maps}")
    log(f"[app] the loop: {interval:.3f} ms per step over steps 5-12 (host clock), "
        f"{32e3 / interval:.1f} images/s; while steps 17-20 were launched under "
        f"torch.profiler the card was busy {busy:.3f} ms of the {window:.3f} "
        f"ms from its first activity to its last: idle share {idle:.3f}")

    # the host Loader alone on the same split, with the same threads
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.data.pipeline import Loader

    cfg = config_lib.get_config("config3_ssd512_voc_train")
    ds = cli_train.build_dataset(cfg, argparse_ns(data_root=APP_TRAIN, split="train",
                                                  ann_file=""))
    loader = Loader(ds, 32, cfg.data.max_boxes, workers=workers)
    it, per = loader.batches(0), []
    next(it)
    for _ in range(5):
        t = time.perf_counter()
        next(it)
        per.append((time.perf_counter() - t) * 1e3)
    loader.close()
    log(f"[app] host Loader, b32 of the 512 px synthetic split, {workers} threads: "
        f"{spread(np.array(per))} per batch (host clock)")
    return ckpt, k1, k2, {"app_step_interval_ms": interval, "app_images_per_s": 32e3 / interval,
                          "app_device_busy_ms": busy,
                          "app_device_window_ms": window, "app_idle_share": idle,
                          "app_wall_s": wall, "app_loader_batch_ms": float(np.median(per))}


def phase_preempt(torch, cli_train, workdir):
    """SIGTERM to a train_cli process on config #3 (b8): it finishes the
    step, saves and exits 0; a rerun here restores that step, resumes the
    data schedule there and runs to its end."""
    import queue
    import signal
    import threading

    ckpt = os.path.join(workdir, "preempt_ckpt")
    common = ["--config", "config3_ssd512_voc_train", "--data-root",
              "synthetic://train?n=256", "--batch-size", "8", "--log-every", "1",
              "--workers", "4", "--checkpoint-dir", ckpt]
    proc = subprocess.Popen([sys.executable, "-m", "shape_based_object_detection_torch.cli."
                             "train_cli", *common, "--steps", "100000"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    lines: "queue.Queue" = queue.Queue()

    def read():
        for x in proc.stdout:
            lines.put(x)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    out, deadline = [], time.time() + 300
    try:
        while time.time() < deadline:
            line = lines.get(timeout=max(1.0, deadline - time.time()))
            if line is None:
                break
            out.append(line.rstrip())
            if line.startswith("step 3 "):
                proc.send_signal(signal.SIGTERM)
                break
        rc = proc.wait(timeout=240)
        while True:
            line = lines.get(timeout=30)
            if line is None:
                break
            out.append(line.rstrip())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    said = [x for x in out if x.startswith("preempted: checkpoint saved at step")]
    if rc != 0 or not said:
        raise RuntimeError(f"preemption: exit {rc}, output {out[-10:]}")
    n = int(said[0].split()[-1])
    text = run_cli(cli_train.main, [*common, "--steps", str(n + 2)])
    want = [f"restored checkpoint at step {n}", f"resuming data schedule at epoch 0, batch {n}",
            f"done at step {n + 2}"]
    ok = all(w in text for w in want)
    log(f"[resume] train_cli subprocess: SIGTERM after 'step 3' -> exit {rc}, '{said[0]}'; "
        f"rerun: {want} all present: {ok} (32 steps per epoch)")
    if not ok:
        raise RuntimeError(f"resume: {text[-500:]}")


def phase_ckpt_round_trip(torch, config, train, build_model, workdir):
    """A checkpoint round trip on the card, SSD-512 (config #3) and
    R50-FPN-512 with train_bn, with a bf16 momentum and an EMA, after 2
    steps: parameters, buffers, momentum, EMA, step and the CUDA generator
    state bit-equal; the save's blocking time, the write's and the size."""
    from shape_based_object_detection_torch.checkpoint import CheckpointManager

    results = {}
    r50 = train_config(config, "float32", 2, ema_decay=0.999, momentum_dtype="bfloat16",
                       warmup_steps=1)
    r50 = dataclasses.replace(r50, model=dataclasses.replace(r50.model, train_bn=True))
    ssd = ssd_train_config(config, 2, ema_decay=0.999, momentum_dtype="bfloat16",
                           warmup_steps=1)
    for tag, cfg, batch in (("ssd512", ssd, train_batch(np.random.default_rng(20), 2, g=100,
                                                        classes=20)),
                            ("r50_train_bn", r50, train_batch(np.random.default_rng(21), 2))):
        module, anchors = build_model(cfg.model, device="cuda", train=True,
                                      generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(module, cfg)
        step = train.make_train_step(module, anchors, cfg)
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        mgr = CheckpointManager(os.path.join(workdir, f"rt_{tag}"), keep=1)
        t = time.perf_counter()
        mgr.save(state)
        block = time.perf_counter() - t
        mgr.wait()
        write = time.perf_counter() - t - block
        t = time.perf_counter()
        mgr.save(state, 3)
        block2 = time.perf_counter() - t
        mgr.wait()
        path = os.path.join(workdir, f"rt_{tag}", "3", "state.pt")
        size = os.path.getsize(path)
        other, _ = build_model(cfg.model, device="cuda", train=True,
                               generator=torch.Generator().manual_seed(5))
        t = time.perf_counter()
        restored = mgr.restore_step(3, train.create_train_state(
            other, cfg, generator=torch.Generator(device="cuda").manual_seed(99)))
        torch.cuda.synchronize()
        restore = time.perf_counter() - t
        same = (all(torch.equal(a, b) for a, b in zip(module.state_dict().values(),
                                                       other.state_dict().values()))
                and all(torch.equal(a, b) for a, b in zip(state.opt_state.trace,
                                                           restored.opt_state.trace))
                and all(torch.equal(state.ema[k], restored.ema[k]) for k in state.ema)
                and restored.step == 3 and restored.opt_state.count == state.opt_state.count
                and torch.equal(restored.generator.get_state(), state.generator.get_state())
                and restored.generator.device.type == "cuda"
                and {m.dtype for m in restored.opt_state.trace} == {torch.bfloat16})
        n_params = len(list(module.parameters()))
        n_bufs = len(list(module.buffers()))
        log(f"[resume] {tag} checkpoint round trip on the card ({n_params} parameters, "
            f"{n_bufs} buffers, bf16 momentum, EMA; step 2; the CUDA generator's state): "
            f"bit-equal={same}; save blocks {block * 1e3:.1f} ms, then {block2 * 1e3:.1f} ms "
            f"when saved again, the write takes {write:.2f} s more on its thread, "
            f"{size / 2**20:.1f} MiB; restore {restore:.2f} s ({nvidia_smi_line()})")
        if not same:
            raise RuntimeError(f"{tag} checkpoint round trip is not bit-equal")
        mgr.close()
        results.update({f"ckpt_{tag}_save_block_ms": block * 1e3,
                        f"ckpt_{tag}_save_again_block_ms": block2 * 1e3,
                        f"ckpt_{tag}_write_s": write, f"ckpt_{tag}_mib": size / 2**20,
                        f"ckpt_{tag}_restore_s": restore})
        del module, other, state, restored
        torch.cuda.empty_cache()
    return results


def jittered_records(ev, seed):
    """Detections made from the Evaluator's ground truth (each box jittered,
    a random score, one label in ten changed), so mAP is far from 0."""
    from shape_based_object_detection_torch.eval import DetectionRecord

    rng = np.random.default_rng(seed)
    dets = []
    for g in ev.ground_truth:
        n = len(g.labels)
        boxes = np.asarray(g.boxes, np.float32) + rng.normal(0, 0.01, (n, 4)).astype(np.float32)
        labels = np.where(rng.uniform(size=n) < 0.1, rng.integers(0, 20, n), g.labels)
        dets.append(DetectionRecord(g.image_id, boxes, rng.uniform(0.1, 1, n).astype(np.float32),
                                    labels))
    return dets


class KeptEvaluators:
    """``with KeptEvaluators(eval_pkg) as made:`` keeps every Evaluator that
    ``eval_pkg.Evaluator`` builds meanwhile in ``made``, so the records a
    CLI fed it stay readable."""

    def __init__(self, eval_pkg):
        self.pkg, self.real, self.made = eval_pkg, eval_pkg.Evaluator, []

    def __enter__(self):
        made = self.made

        class Kept(self.real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        self.pkg.Evaluator = Kept
        return made

    def __exit__(self, *exc):
        self.pkg.Evaluator = self.real


def records_equal(got, want):
    """Whether two Evaluators hold the same records, element by element
    (dtypes included): every detection's box, score and label, every
    ground-truth box, label, ignore and crowd flag and area factor."""
    def same(a, b):
        return (a is None) == (b is None) and (a is None or (
            a.dtype == b.dtype and np.array_equal(a, b)))

    return (got.area_scale == want.area_scale
            and len(got.detections) == len(want.detections) > 0
            and len(got.ground_truth) == len(want.ground_truth)
            and all(d.image_id == e.image_id and all(same(getattr(d, f), getattr(e, f))
                                                     for f in ("boxes", "scores", "labels"))
                    for d, e in zip(got.detections, want.detections))
            and all(g.image_id == h.image_id and g.area_factor == h.area_factor
                    and all(same(getattr(g, f), getattr(h, f))
                            for f in ("boxes", "labels", "crowd", "ignore"))
                    for g, h in zip(got.ground_truth, want.ground_truth)))


def phase_eval(torch, config, train, build_model, cli_train, cli_eval, nms, nms_cuda,
               detection, reset_counts, ckpt):
    """eval_cli on the config #3 checkpoint (VOC and COCO, score threshold
    0) against an in-process Evaluator fed by make_eval_step: the records
    eval_cli fed its Evaluator equal element by element, and the metrics;
    K1 bit-equal on the eval candidates and its time there; the C++ and
    numpy matchers on jittered ground truth; eval_cli on config #2 (R50
    b32, threshold 0)."""
    import json as json_lib

    from shape_based_object_detection_torch import eval as eval_pkg
    from shape_based_object_detection_torch.checkpoint import CheckpointManager
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.eval import coco_map, voc_map
    from tests.torch_kernel_cases import nms_bit_equal

    # threshold 0: a model 24 steps from random weights keeps few
    # detections at the preset's 0.01, and scores mAP near 0 either way
    zero = "model.detect.score_threshold=0.0"
    argv = ["--config", "config3_ssd512_voc_train", "--data-root", APP_VAL,
            "--checkpoint-dir", ckpt, "--per-class", "--set", zero]
    got, launches, fed = {}, {}, {}
    for protocol in ("voc", "coco"):
        reset_counts()
        with KeptEvaluators(eval_pkg) as made:
            text = run_cli(cli_eval.main, [*argv, "--protocol", protocol])
        torch.cuda.synchronize()
        launches[protocol] = nms_cuda.launches
        got[protocol] = json_lib.loads(text[text.index("{"):])
        (fed[protocol],) = made
    cfg = config.resolve_config("config3_ssd512_voc_train", [zero])
    module, anchors = build_model(cfg.model, device="cuda", train=True)
    state = CheckpointManager(ckpt).restore_latest(train.create_train_state(module, cfg))
    ds = cli_train.build_dataset(cfg, argparse_ns(data_root=APP_VAL, split="val", ann_file=""),
                                 include_ignore=True)
    loader = Loader(ds, cfg.data.batch_size, cfg.data.max_boxes, shuffle=False)
    ev = cli_train.evaluate(train.make_eval_step(module, anchors, cfg), state, loader, cfg,
                            torch.device("cuda"))
    want = {"voc": ev.voc(), "coco": ev.coco()}

    def same(a, b):
        return all(k in a and (a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]))
                   for k in b if k != "per_class")

    records = all(records_equal(fed[p], ev) for p in fed)
    equal = records and all(same(got[p], want[p]) for p in got)
    n_dets = sum(len(d.scores) for d in ev.detections)
    batches = -(-len(ds) // cfg.data.batch_size)
    # K1 on the eval path's candidates, bit for bit, and its time there
    b = next(loader.batches_padded())[0]
    with torch.inference_mode():
        x = detection.image_lib.normalize_images(torch.from_numpy(b.images).cuda())
        cands = detection.select_candidates(*module(x.permute(0, 3, 1, 2)), anchors, cfg.model)
    boxes, scores, cls, valid = cands
    det = cfg.model.detect
    shifted = nms.class_offset_boxes(boxes, cls)
    bit, err, kept = nms_bit_equal(shifted, scores, valid, det.nms_iou_threshold,
                                   det.max_detections)
    log(f"[eval] eval_cli on the config #3 checkpoint, score threshold 0: voc mAP "
        f"{got['voc']['mAP']:.6f}, coco mAP {got['coco']['mAP']:.6f} (AP50 "
        f"{got['coco']['AP50']:.6f}); the records it fed its Evaluator ({len(ev.detections)} "
        f"images, {n_dets} detections, {sum(len(g.labels) for g in ev.ground_truth)} GT "
        f"boxes) equal element by element to those make_eval_step feeds one: {records}; "
        f"metrics equal: {equal}; K1 launches {launches} for {batches} batches each")
    log(f"[kernel] nms_greedy on the config #3 eval candidates (B, N, M)=({scores.shape[0]}, "
        f"{scores.shape[1]}, {det.max_detections}): {int(valid.sum())} valid, bit-equal={bit}, "
        f"kept={kept}")
    if not (equal and bit and all(v == batches for v in launches.values())):
        raise RuntimeError(f"eval: equal {equal}, K1 bit-equal {bit}, launches {launches}")
    timing = nms_timing(nms, nms_cuda, cands, det, "config #3's eval candidates")
    timing["max_abs_err"] = err

    # the matchers on jittered ground truth: equal and far from 0
    dets = jittered_records(ev, 22)
    scores_m = {}
    for matcher in ("native", "numpy"):
        t = time.perf_counter()
        scores_m[matcher] = (voc_map(dets, ev.ground_truth, matcher=matcher)["mAP"],
                             coco_map(dets, ev.ground_truth, area_scale=512.0,
                                      matcher=matcher)["mAP"])
        scores_m[matcher] += (time.perf_counter() - t,)
    agree = scores_m["native"][:2] == scores_m["numpy"][:2] and min(scores_m["native"][:2]) > 0
    log(f"[eval] with jittered ground truth as detections ({len(dets)} images): voc mAP "
        f"{scores_m['native'][0]:.6f}, coco mAP {scores_m['native'][1]:.6f}; C++ and numpy "
        f"matchers equal and non-zero: {agree} (voc+coco host seconds: C++ "
        f"{scores_m['native'][2]:.3f}, numpy {scores_m['numpy'][2]:.3f})")
    if not agree:
        raise RuntimeError(f"matchers disagree or score 0: {scores_m}")
    del module, state
    torch.cuda.empty_cache()

    reset_counts()
    text = run_cli(cli_eval.main, ["--config", "config2_retinanet_r50_infer", "--data-root",
                                   "synthetic://val?n=64", "--max-batches", "2", "--protocol",
                                   "voc", "--set", "model.detect.score_threshold=0.0"])
    torch.cuda.synchronize()
    k1_r50 = nms_cuda.launches
    m = json_lib.loads(text[text.index("{"):])
    log(f"[eval] eval_cli config #2 (R50-FPN-512 b32, fresh weights, threshold 0): voc mAP "
        f"{m['mAP']:.6f}, K1 launches {k1_r50} for 2 batches at (32, 1000, 100)")
    if k1_r50 != 2:
        raise RuntimeError(f"eval_cli config #2: K1 ran {k1_r50} times for 2 batches")
    return timing, launches["voc"], k1_r50, {
        "eval_voc_map": got["voc"]["mAP"], "eval_coco_map": got["coco"]["mAP"],
        "eval_jittered_voc_map": scores_m["native"][0],
        "eval_jittered_coco_map": scores_m["native"][1],
        "eval_native_matcher_s": scores_m["native"][2],
        "eval_numpy_matcher_s": scores_m["numpy"][2]}


def phase_loader(torch):
    """Loader.device_batches on the card: batches bit-equal to the host
    batches, staged pinned; one b32 batch's H2D time against the card's
    pinned H2D rate measured here."""
    from shape_based_object_detection_torch.data.pipeline import Loader, pin_batch
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

    loader = Loader(SyntheticDetection(size=512, num_images=96, num_classes=20, max_objects=8),
                    32, 100, seed=1, workers=8)
    host = list(loader.batches(0))
    dev = list(loader.device_batches(0))
    equal = len(host) == len(dev) == 3 and all(
        np.array_equal(a, b.cpu().numpy()) for h, d in zip(host, dev) for a, b in zip(h, d))
    pinned = pin_batch(host[0])
    is_pinned = all(t.is_pinned() for t in pinned)
    nbytes = sum(t.numel() * t.element_size() for t in pinned)
    h2d = cuda_times_ms(lambda: [t.to("cuda", non_blocking=True) for t in pinned], iters=20)
    big = torch.empty(512 * 2**20, dtype=torch.uint8, pin_memory=True)
    rate_ms = float(np.median(cuda_times_ms(lambda: big.to("cuda", non_blocking=True),
                                            iters=5)))
    rate = big.numel() / rate_ms / 1e6  # GB/s
    bound = nbytes / rate / 1e6
    loader.close()
    log(f"[loader] device_batches: 3 b32 batches bit-equal to the host batches: {equal}; "
        f"staged pinned: {is_pinned}; H2D of one batch ({nbytes} bytes, pinned, non_blocking) "
        f"{spread(h2d)}; the card's pinned H2D rate {rate:.2f} GB/s (512 MiB copy, "
        f"{rate_ms:.3f} ms), so a batch's bound is {bound:.3f} ms ({nvidia_smi_line()})")
    if not (equal and is_pinned):
        raise RuntimeError(f"device_batches: equal {equal}, pinned {is_pinned}")
    return {"h2d_b32_ms": float(np.median(h2d)), "h2d_b32_bytes": nbytes,
            "pinned_h2d_gb_per_s": rate, "h2d_b32_bound_ms": bound}


def phase_cli_match_timing(torch, config, matching, matching_cuda, cli_train):
    """K2 on the CLI path's batch, a b32 batch of the train_cli split
    augmented as the step augments it (config #3, shape_weight 0.3): held
    against the plain version (assignments and best_q bit-equal), then
    timed. Returns the timing with the worst |difference| over best_q and
    reg as ``max_abs_err``."""
    from shape_based_object_detection_torch.data.augment import augment_batch
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model
    from tests.torch_kernel_cases import match_check

    cfg = config.get_config("config3_ssd512_voc_train")
    ds = cli_train.build_dataset(cfg, argparse_ns(data_root=APP_TRAIN, split="train",
                                                  ann_file=""))
    b = next(Loader(ds, 32, cfg.data.max_boxes, seed=cfg.train.seed).batches(0))
    gen = torch.Generator(device="cuda").manual_seed(cfg.train.seed)
    _, gt, lbl, ok = augment_batch(gen, *(torch.from_numpy(getattr(b, k)).cuda() for k in
                                          ("images", "boxes", "labels", "valid")),
                                   cfg.data, cfg.model.image_size)
    anchors = anchors_for_model(cfg.model).cuda()
    gt, lbl, ok = gt.contiguous(), lbl.contiguous(), ok.contiguous()
    passed, err, line = match_check(anchors, gt, lbl, ok, cfg.match.shape_weight,
                                    cfg.model.anchors.variances, cfg=cfg.match, exact=True)
    log(f"[kernel] match_anchors on train_cli's augmented batch (B, A, G)=(32, "
        f"{anchors.shape[0]}, {ok.shape[1]}), {int(ok.sum())} valid GTs, shape_weight "
        f"{cfg.match.shape_weight}: {line}")
    if not passed:
        raise RuntimeError("match_anchors differs from the plain version on train_cli's batch")
    timing = match_timing(torch, matching, matching_cuda, anchors, cfg,
                          "train_cli's augmented batch", gt, lbl, ok)
    timing["max_abs_err"] = err
    return timing


def tta_model(torch, config, build_model, dtype, widen=False):
    """R50-FPN-512 at score threshold 0 with hflip TTA on the card (random
    weights from seed 1; ``widen`` spreads the scores as phase_forward
    does), and the config."""
    cfg = serving_config(config, dtype).model
    cfg = dataclasses.replace(cfg, precision="highest" if widen else cfg.precision,
                              detect=dataclasses.replace(cfg.detect, tta_hflip=True))
    module, anchors = build_model(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(1))
    if widen:
        with torch.no_grad():
            module.cls_head.predict.weight.mul_(100.0)
    return module, anchors, cfg


def merge_candidates(torch, detection, module, anchors, cfg, images):
    """The hflip merge's candidates for ``images`` (uint8 on the card):
    both halves' top-k concatenated, as postprocess_tta_hflip sends them."""
    with torch.inference_mode():
        x = detection.image_lib.normalize_images(images)
        out = module(torch.cat([x, x.flip(2)]).permute(0, 3, 1, 2))
        return detection.tta_hflip_candidates(*out, anchors, cfg)


def unsorted_report(torch, scores):
    """How far from score order the candidates arrive: the images not in
    order, and the candidates whose place a stable sort by score changes."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    moved = order != torch.arange(scores.shape[1], device=scores.device)
    return int(moved.any(1).sum()), int(moved.sum())


def k1_on(torch, nms, cands, det, name):
    """K1 against the plain version on one candidate set, bit for bit.
    Returns the largest |difference| over idx and score."""
    from tests.torch_kernel_cases import nms_bit_equal

    boxes, scores, cls, valid = cands
    same, err, kept = nms_bit_equal(nms.class_offset_boxes(boxes, cls), scores, valid,
                                    det.nms_iou_threshold, det.max_detections)
    rows, moved = unsorted_report(torch, scores)
    log(f"[serve] nms_greedy on {name} (B, N, M)=({scores.shape[0]}, {scores.shape[1]}, "
        f"{det.max_detections}): candidates out of score order in {rows} of "
        f"{scores.shape[0]} images ({moved} not in their sorted place), "
        f"{int(valid.sum())} valid, bit-equal={same}, kept={kept}")
    if not same:
        raise RuntimeError(f"nms_greedy differs from the plain version on {name}")
    return err


def matrix_route_is_k1(torch, detection, nms_cuda, cands, cfg, name):
    """The reference's "matrix" backend name on the card: one K1 launch,
    and K1's result."""
    before = nms_cuda.launches
    got = detection.run_nms(*cands, cfg, backend="matrix")
    launched = nms_cuda.launches - before
    want = detection.run_nms(*cands, cfg, backend="cuda")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"[serve] nms_backend=\"matrix\" on {name}: nms_greedy launches {launched}, "
        f"equal to the kernel's result={same}")
    if launched != 1 or not same:
        raise RuntimeError(f"the matrix backend name did not run the kernel on {name}")


def soft_card_vs_cpu(torch, detection, cands, cfg, name):
    """Soft-NMS (sigma 0.5) on the card against its run on the CPU."""
    soft = dataclasses.replace(cfg, detect=dataclasses.replace(cfg.detect, soft_nms_sigma=0.5))
    got = detection.run_nms(*cands, soft)
    want = detection.run_nms(*(t.cpu() for t in cands), soft)
    err = float((got.scores.cpu() - want.scores).abs().max())
    same = all(torch.equal(a.cpu(), b) for a, b in zip((got.valid, got.labels, got.boxes),
                                                       (want.valid, want.labels, want.boxes)))
    log(f"[serve] soft-NMS (sigma 0.5) on {name}, card vs CPU: valid, labels and boxes "
        f"equal={same}, max |score difference| {err:.3e} (bound 1e-6), kept per image "
        f"{got.valid.sum(1).tolist()[:4]}...")
    if not same or err > 1e-6:
        raise RuntimeError(f"soft-NMS on the card differs from the CPU on {name}")
    return soft


def phase_serve_nms(torch, config, build_model, detection, nms, nms_cuda, reset_counts):
    """hflip detect card vs CPU at b1 in float32; K1 on the hflip merges (R50
    at b16, SSD300 at b1), bit-equal to its plain version, and once per TTA
    batch; the "matrix" backend name runs K1, soft-NMS card vs CPU; K1 and
    soft-NMS times on the R50 candidates."""
    from shape_based_object_detection_torch.detection import make_detect_fn

    out, k1 = {}, {}
    cpu_module, cpu_anchors, cfg = tta_model(torch, config, build_model, "float32",
                                             widen=True)
    module, anchors = build_model(cfg, device="cuda")
    module.load_state_dict(cpu_module.state_dict())
    det, size = cfg.detect, cfg.image_size
    rng = np.random.default_rng(21)
    images = torch.from_numpy(rng.integers(0, 256, (16, size, size, 3), dtype=np.uint8)).cuda()

    # hflip TTA on the card against the CPU, float32 with TF32 off, one image
    one = images[:1].cpu().numpy()
    want = make_detect_fn(cpu_module, cpu_anchors, cfg, device="cpu")(one)
    got = make_detect_fn(module, anchors, cfg, device="cuda")(one)
    v_w, v_g = want.valid[0].numpy(), got.valid[0].cpu().numpy()
    n = matched(tuple(t[0].cpu().numpy()[v_g] for t in got[:3]),
                tuple(t[0].numpy()[v_w] for t in want[:3]))
    log(f"[serve] R50-FPN-512 hflip TTA detect card vs CPU (fp32, TF32 off, b1, 2000 "
        f"candidates into the merge): {n} detections matched (label, IoU >= 0.99, "
        f"|dscore| <= 1e-3)")
    del cpu_module

    # K1 on the hflip merge at b16: the two sorted top-1000 sets, unsorted
    cands = merge_candidates(torch, detection, module, anchors, cfg, images)
    k1["tta_max_abs_err"] = k1_on(torch, nms, cands, det, "the R50 hflip merge at b16")
    detect = make_detect_fn(module, anchors, cfg, device="cuda")
    reset_counts()
    detect(images)
    torch.cuda.synchronize()
    k1["tta_launches"] = nms_cuda.launches
    log(f"[serve] hflip TTA detect b16: nms_greedy launches {nms_cuda.launches} for 1 batch")
    if nms_cuda.launches != 1:
        raise RuntimeError("hflip TTA detect did not launch the NMS kernel once")
    timing = nms_timing(nms, nms_cuda, cands, det, "the R50 hflip merge (unsorted)")
    k1.update({f"tta_{k}": v for k, v in timing.items()})

    # the matrix backend name and soft-NMS on the same merge, and on the
    # plain path's (16, 1000, 100) candidates (the merge's first half)
    plain = tuple(t[:, :det.pre_nms_top_k] for t in cands)
    matrix_route_is_k1(torch, detection, nms_cuda, cands, cfg, "the R50 hflip merge at b16")
    soft = soft_card_vs_cpu(torch, detection, cands, cfg, "the R50 hflip merge at b16")
    for name, c in (("(16, 1000, 100)", plain), ("(16, 2000, 100)", cands)):
        times = {
            "k1": cuda_times_ms(lambda: detection.run_nms(*c, cfg, backend="cuda"), iters=50),
            "soft": cuda_times_ms(lambda: detection.run_nms(*c, soft), iters=10, warmup=2),
        }
        med = {k: float(np.median(t)) for k, t in times.items()}
        out.update({f"nms_{k}_{c[1].shape[1]}_median_ms": v for k, v in med.items()})
        log(f"[timing] class-aware NMS on {name} R50 candidates ({nvidia_smi_line()}), "
            f"CUDA events: K1 (run_nms, class offset and gather included) "
            f"{spread(times['k1'])}; soft-NMS (sigma 0.5) {spread(times['soft'])}; "
            f"soft / K1 {med['soft'] / med['k1']:.1f}x")

    del module, detect

    # SSD300 (config #1, float32) hflip TTA at b1: (1, 800, 200)
    ssd = config.get_config("config1_ssd300_infer").model
    ssd = dataclasses.replace(ssd, detect=dataclasses.replace(ssd.detect, tta_hflip=True))
    smodule, sanchors = build_model(ssd, device="cuda", generator=torch.Generator().manual_seed(2))
    simages = torch.from_numpy(rng.integers(0, 256, (1, ssd.image_size, ssd.image_size, 3),
                                            dtype=np.uint8)).cuda()
    scands = merge_candidates(torch, detection, smodule, sanchors, ssd, simages)
    k1["ssd_tta_max_abs_err"] = k1_on(torch, nms, scands, ssd.detect,
                                      "the SSD300 hflip merge at b1")
    timing = nms_timing(nms, nms_cuda, scands, ssd.detect, "the SSD300 hflip merge")
    k1.update({f"ssd_tta_{k}": v for k, v in timing.items()})
    reset_counts()
    make_detect_fn(smodule, sanchors, ssd, device="cuda")(simages)
    torch.cuda.synchronize()
    k1["ssd_tta_launches"] = nms_cuda.launches
    if nms_cuda.launches != 1:
        raise RuntimeError("SSD300 hflip TTA did not launch the NMS kernel once")
    return out, k1


def phase_serve_large_merges(torch, config, build_model, detection, nms, nms_cuda,
                             reset_counts):
    """R50-FPN-512 hflip TTA at b16 in bf16 (random weights from seed 1,
    score threshold 0) with pre_nms_top_k 2100 and 5000: merges of 4200 and
    10000 candidates per image, which run K1's walk route. K1 bit-equal to
    its plain version on each merge and once per TTA batch, its time (CUDA
    events, profiler device time) beside its bound and scratch; then the
    (16, 1000, 100) serving row, the same model's plain detect candidates on
    the bitmask route, timed again in this run."""
    from shape_based_object_detection_torch.detection import make_detect_fn

    out, k1 = {}, {}
    base = serving_config(config, "bfloat16").model
    module, anchors = build_model(base, device="cuda",
                                  generator=torch.Generator().manual_seed(1))
    images = torch.from_numpy(np.random.default_rng(23).integers(
        0, 256, (16, base.image_size, base.image_size, 3), dtype=np.uint8)).cuda()
    for k in (2100, 5000):
        cfg = dataclasses.replace(base, detect=dataclasses.replace(
            base.detect, tta_hflip=True, pre_nms_top_k=k))
        det, tag = cfg.detect, f"tta{2 * k}"
        cands = merge_candidates(torch, detection, module, anchors, cfg, images)
        name = f"the R50 hflip merge at b16 bf16, pre_nms_top_k {k}"
        k1[f"{tag}_max_abs_err"] = k1_on(torch, nms, cands, det, name)
        detect = make_detect_fn(module, anchors, cfg, device="cuda")
        reset_counts()
        detect(images)
        torch.cuda.synchronize()
        k1[f"{tag}_launches"] = nms_cuda.launches
        if nms_cuda.launches != 1:
            raise RuntimeError(f"hflip TTA detect at pre_nms_top_k {k} launched the NMS "
                               f"kernel {nms_cuda.launches} times for 1 batch")
        timing = nms_timing(nms, nms_cuda, cands, det,
                            f"{name} (route {nms_cuda.route(2 * k)})")
        k1.update({f"{tag}_{key}": v for key, v in timing.items()})
        k1[f"{tag}_peak_alloc_bytes"] = k1_peak_bytes(
            torch, nms_cuda, nms.class_offset_boxes(cands[0], cands[2]), cands[1], cands[3],
            det.nms_iou_threshold, det.max_detections)
        times = cuda_times_ms(lambda: detect(images), iters=10)
        out[f"detect_hflip_top{k}_b16_bf16_median_ms"] = float(np.median(times))
        log(f"[timing] hflip TTA detect b16 bf16 at pre_nms_top_k {k} ({2 * k} candidates "
            f"into K1's {nms_cuda.route(2 * k)} route), CUDA events: {spread(times)}; K1 "
            f"launches per batch {k1[f'{tag}_launches']}, scratch "
            f"{nms_cuda.scratch_bytes(16, 2 * k, det.max_detections)} bytes, peak allocation "
            f"of one K1 call {k1[f'{tag}_peak_alloc_bytes']} bytes")
    with torch.inference_mode():
        x = detection.image_lib.normalize_images(images).permute(0, 3, 1, 2)
        cands = detection.select_candidates(*module(x), anchors, base)
    timing = nms_timing(nms, nms_cuda, cands, base.detect,
                        "the serving path's candidates (route bitmask), beside the merges")
    k1.update({f"serve_row_{key}": v for key, v in timing.items()})
    return out, k1


def phase_serve_multiscale(torch, config, build_model, serving, nms, nms_cuda, reset_counts):
    """R50-FPN-512 at b16 (random weights from seed 0): the 2-scale batch
    detector launches K1 S + 1 times per batch, and K1 is bit-equal on its
    merge (float32, whose scores are not tied as bf16's are); then, in the
    serving config (bf16), detect with and without hflip TTA and the
    2-scale detector, timed by CUDA events. Returns (results, K1
    entries)."""
    from shape_based_object_detection_torch.detection import (
        MultiScaleBatchDetector, make_detect_fn,
    )
    from shape_based_object_detection_torch.utils.image import resize_images

    k1 = {}
    cfg = serving_config(config, "float32").model
    det, size = cfg.detect, cfg.image_size
    scales = (size, size * 5 // 4)  # (512, 640)
    # smooth content (32 px noise resized up), as photos are: pixel noise
    # scores higher at 512 px than resized to 640, which leaves the merge
    # in score order
    small = torch.from_numpy(np.random.default_rng(22).integers(
        0, 256, (16, 32, 32, 3), dtype=np.uint8)).cuda()
    images = resize_images(small, size).round().clamp(0, 255).to(torch.uint8)
    module, _ = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    # the 2-scale batch detector: S + 1 launches per batch, K1 on its merge
    ms = MultiScaleBatchDetector(cfg, module, scales, device="cuda")
    reset_counts()
    ms(images)
    torch.cuda.synchronize()
    k1["multiscale_launches"] = nms_cuda.launches
    log(f"[serve] MultiScaleBatchDetector {scales} b16: nms_greedy launches "
        f"{nms_cuda.launches} for 1 batch (2 scales + the merge)")
    if nms_cuda.launches != 3:
        raise RuntimeError("the 2-scale batch detector did not launch the kernel 3 times")
    parts = ms.scale_detections(images)
    ms_cands = tuple(torch.cat([getattr(p, f) for p in parts], 1)
                     for f in ("boxes", "scores", "labels", "valid"))
    k1["multiscale_max_abs_err"] = k1_on(torch, nms, ms_cands, det,
                                         f"the 2-scale merge {scales} at b16")
    timing = nms_timing(nms, nms_cuda, ms_cands, det, "the 2-scale merge")
    k1.update({f"multiscale_{k}": v for k, v in timing.items()})
    del ms, parts, module

    cfg = serving_config(config, "bfloat16").model
    module, anchors = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    tta = dataclasses.replace(cfg, detect=dataclasses.replace(cfg.detect, tta_hflip=True))
    runs = {
        "detect": make_detect_fn(module, anchors, cfg, device="cuda"),
        "detect_tta_hflip": make_detect_fn(module, anchors, tta, device="cuda"),
        "multiscale_2_scales": MultiScaleBatchDetector(cfg, module, scales, device="cuda"),
    }
    out = {}
    for name, fn in runs.items():
        times = cuda_times_ms(lambda: fn(images), iters=20)
        ms = float(np.median(times))
        out[f"serve_{name}_b16_bf16_median_ms"] = ms
        log(f"[timing] {name} b16 bf16 ({nvidia_smi_line()}): {spread(times)} per batch, "
            f"{16e3 / ms:.1f} images/s at the median")
    ratio = out["serve_detect_tta_hflip_b16_bf16_median_ms"] / out["serve_detect_b16_bf16_median_ms"]
    log(f"[timing] hflip TTA / plain detect at b16 bf16: {ratio:.3f}x")
    return out, k1


SERVER_REQUESTS = 512
SERVER_CLIENTS = 16


def encoded_requests(count, seed):
    """``count`` images of 200-900 px, each (h, w) different, PNG and JPEG
    in turns, encoded with PIL, and the decoded pixels the server will
    see."""
    import io

    from PIL import Image

    from shape_based_object_detection_torch.utils.image import decode_image_host

    rng = np.random.default_rng(seed)
    specs, sizes = [], set()
    while len(specs) < count:
        h, w = (int(x) for x in rng.integers(200, 900, 2))
        # smooth content keeps the encoded size near a photo's
        small = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        if (h, w) not in sizes:  # the size names the request in phase_server
            sizes.add((h, w))
            specs.append((len(specs), h, w, small))

    def encode(spec):
        i, h, w, small = spec
        img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, format="PNG" if i % 2 else "JPEG", quality=90, compress_level=1)
        return buf.getvalue()

    with ThreadPoolExecutor(8) as pool:  # PIL's codecs release the GIL
        bodies = list(pool.map(encode, specs))
        return bodies, list(pool.map(decode_image_host, bodies))


def post(port, body, timeout=120):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/detect?min_score=0.0", data=body)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def load_client(port, folder, clients, out):
    """The server phase's load, in a process of its own so that the
    clients share no interpreter with the server: POST every body in
    ``folder`` (by file name) from ``clients`` threads, each sending its
    share one request after another; write the answers, each request's
    latency and the wall time as JSON to ``out``. Run as ``python3 -c
    "import sys, chip_smoke; chip_smoke.load_client(*sys.argv[1:])" PORT
    FOLDER CLIENTS OUT`` from the repo root."""
    names = sorted(os.listdir(folder))
    bodies = []
    for name in names:
        with open(os.path.join(folder, name), "rb") as f:
            bodies.append(f.read())
    n, clients = len(bodies), int(clients)
    answers, latency = [None] * n, [0.0] * n

    def client(c):
        for i in range(c, n, clients):
            t0 = time.perf_counter()
            answers[i] = post(int(port), bodies[i])
            latency[i] = time.perf_counter() - t0

    t = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        list(pool.map(client, range(clients)))
    wall = time.perf_counter() - t
    with open(out, "w") as f:
        json.dump({"answers": answers, "latency_s": latency, "wall_s": wall}, f)


def phase_server(torch, config, serving, nms_cuda, reset_counts, workdir):
    """DetectionServer over a bf16 R50-FPN-512 Predictor (b16, buckets
    1-16, warmed up): 512 encoded images from 16 client threads in another
    process. Every answer equals Predictor.predict of the same decoded
    images in the same batch (boxes within 0.01 px, scores 1e-5: the JSON's
    rounding); K1 once per batch; the server process's CPU time and the
    share of the wall with a batch on the card during the load; then one
    lone request, which rides the b1 bucket."""
    import urllib.request

    from shape_based_object_detection_torch.server import DetectionServer

    cfg = serving_config(config, "bfloat16")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, decode_backend="pil"))
    pred = serving.Predictor(cfg, batch_size=16, device="cuda",
                             bucket_sizes=serving.default_bucket_sizes(16),
                             generator=torch.Generator().manual_seed(0))
    t = time.perf_counter()
    pred.warmup()
    warm_s = time.perf_counter() - t
    n = SERVER_REQUESTS
    bodies, decoded = encoded_requests(n, 23)
    key = {img.shape[:2]: i for i, img in enumerate(decoded)}
    folder = os.path.join(workdir, "requests")
    os.makedirs(folder, exist_ok=True)
    for i, body in enumerate(bodies):
        with open(os.path.join(folder, f"{i:05d}"), "wb") as f:
            f.write(body)
    answers_path = os.path.join(workdir, "answers.json")
    batches, spans, first = [], [], []
    submit = pred.submit

    def recording(items):
        """Which requests rode the batch, and CUDA events around its work."""
        if not first:
            first.extend([time.perf_counter(), time.process_time()])
        batches.append([key[hw] for _, hw in items])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        submit(items)
        end.record()
        spans.append((start, end))

    pred.submit = recording
    server = DetectionServer(pred, port=0, batch_window_ms=5.0, request_timeout_s=120.0)
    server.start()
    try:
        reset_counts()
        client = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.load_client(*sys.argv[1:])",
             str(server.port), folder, str(SERVER_CLIENTS), answers_path],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        torch.cuda.synchronize()
        load_wall, load_cpu = (time.perf_counter() - first[0], time.process_time() - first[1])
        if client.returncode != 0:
            raise RuntimeError(f"the load client failed: {client.stderr[-2000:]}")
        launches = nms_cuda.launches
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        served = list(batches)
        busy_ms = sum(a.elapsed_time(b) for a, b in spans)
        # a lone request: the b1 bucket
        post(server.port, bodies[0])
        torch.cuda.synchronize()
        lone = batches[len(served):]
        lone_launches = nms_cuda.launches - launches
    finally:
        server.close()
        pred.submit = submit
    with open(answers_path) as f:
        load = json.load(f)
    answers = load["answers"]
    if launches != stats["batches"] or len(served) != stats["batches"]:
        raise RuntimeError(f"nms_greedy launched {launches} times for {stats['batches']} "
                           f"served batches")
    if sorted(i for b in served for i in b) != list(range(n)):
        raise RuntimeError("the served batches do not hold every request once")
    if lone != [[0]] or lone_launches != 1 or pred._bucket_for(1) != 1:
        raise RuntimeError(f"the lone request rode {lone}, {lone_launches} launches")
    worst_box = worst_score = 0.0
    for batch in served:
        ref = pred.predict([decoded[i] for i in batch])
        for i, want in zip(batch, ref):
            got = answers[i]["detections"]
            if len(got) != len(want.scores) or not got:
                raise RuntimeError(f"image {i}: {len(got)} detections served, "
                                   f"{len(want.scores)} from predict")
            boxes = np.array([d["box"] for d in got])
            scores = np.array([d["score"] for d in got])
            worst_box = max(worst_box, float(np.abs(boxes - want.boxes).max()))
            worst_score = max(worst_score, float(np.abs(scores - want.scores).max()))
            if [d["label"] for d in got] != want.labels.tolist():
                raise RuntimeError(f"image {i}: labels differ from predict")
    if worst_box > 0.01 or worst_score > 1e-5:
        raise RuntimeError(f"served answers differ from predict: boxes {worst_box}, "
                           f"scores {worst_score}")
    # Predictor.predict alone on the same decoded images, for comparison
    t = time.perf_counter()
    pred.predict(decoded)
    predict_s = time.perf_counter() - t
    lat = np.array(load["latency_s"]) * 1e3
    sizes = sorted(len(b) for b in served)
    out = {"server_requests": n, "server_requests_per_s": n / load["wall_s"],
           **{f"server_p{q}_ms": float(np.percentile(lat, q)) for q in (50, 90, 99)},
           "server_mean_batch_occupancy": stats["mean_batch_occupancy"],
           "server_batches": stats["batches"], "server_warmup_s": warm_s,
           "server_process_cpu_per_wall": load_cpu / load_wall,
           "server_batch_on_card_share": busy_ms / 1e3 / load_wall,
           "predict_images_per_s": n / predict_s}
    log(f"[server] bf16 R50-FPN-512 Predictor b16, buckets {pred.bucket_sizes}, warmup "
        f"{warm_s:.2f} s ({nvidia_smi_line()}): {n} requests (PNG/JPEG, 200-900 px) from "
        f"{SERVER_CLIENTS} client threads in another process in {load['wall_s']:.3f} s = "
        f"{out['server_requests_per_s']:.1f} requests/s, latency p50 "
        f"{out['server_p50_ms']:.1f} ms, p90 {out['server_p90_ms']:.1f} ms, p99 "
        f"{out['server_p99_ms']:.1f} ms; /stats {stats}; batch sizes {sizes}; during the "
        f"load the server process used {out['server_process_cpu_per_wall']:.2f} CPU s per "
        f"s and a batch was on the card {100 * out['server_batch_on_card_share']:.1f} % of "
        f"the wall (CUDA events around each batch); nms_greedy launches {launches} = "
        f"batches; every answer equal to Predictor.predict of the same batch (max |box "
        f"diff| {worst_box:.4f} px, |score diff| {worst_score:.2e}); a lone request rode a "
        f"batch of 1 (bucket {pred._bucket_for(1)}), 1 launch. Predictor.predict of the "
        f"{n} decoded images: {out['predict_images_per_s']:.1f} images/s (host clock)")
    return out, launches


def read_until(lines, prefix, timeout):
    """Lines of a subprocess until one starts with ``prefix``."""
    seen, deadline = [], time.time() + timeout
    while not (seen and seen[-1].startswith(prefix)):
        line = lines.get(timeout=max(1.0, deadline - time.time()))
        if line is None:
            raise RuntimeError(f"the process ended before {prefix!r}: {seen[-10:]}")
        seen.append(line.rstrip())
    return seen


def phase_serve_clis(torch, cli_detect, nms_cuda, reset_counts, workdir):
    """detect_cli on SSD300 (config #1) with hflip and multi-scale TTA and
    --save-viz, in this process; serve_cli as a subprocess on a free port:
    /healthz, one /detect, then SIGTERM."""
    import contextlib
    import io

    from PIL import Image

    path = os.path.join(workdir, "street.png")
    bodies, decoded = encoded_requests(1, 24)
    Image.fromarray(decoded[0]).save(path)
    viz = os.path.join(workdir, "viz")
    reset_counts()
    t = time.perf_counter()
    buf = io.StringIO()  # its 200 detections are not printed
    with contextlib.redirect_stdout(buf):
        cli_detect.main(["--config", "config1_ssd300_infer", "--image", path, "--tta-hflip",
                         "--tta-scales", "300", "--save-viz", viz, "--min-score", "0.0",
                         "--set", "model.detect.score_threshold=0.0"])
    cli_s = time.perf_counter() - t
    torch.cuda.synchronize()
    dets = json.loads(buf.getvalue())
    drawn = np.asarray(Image.open(os.path.join(viz, "street_det.png")))
    launches = nms_cuda.launches
    log(f"[cli] detect_cli SSD300 --tta-hflip --tta-scales 300 --save-viz: {len(dets)} "
        f"detections in {cli_s:.2f} s (model build included), viz {drawn.shape}, "
        f"nms_greedy launches {launches} (the hflip merge and the scale merge)")
    if not dets or drawn.shape != decoded[0].shape or launches != 2:
        raise RuntimeError("detect_cli with TTA did not run as expected")

    ready_s = serve_cli_answers(
        ["--config", "config2_retinanet_r50_infer", "--batch-size", "4",
         "--set", "model.detect.score_threshold=0.0", "--set", "data.decode_backend=pil"],
        bodies[0], "config #2 (b4, buckets 1-4)")
    return {"detect_cli_launches": launches, "serve_cli_ready_s": ready_s}


def serve_cli_answers(args, body, name):
    """serve_cli with ``args`` as a subprocess on a free port: /healthz, one
    /detect of ``body``, then SIGTERM, which must end it with exit 0.
    Returns the seconds it took to be ready."""
    import queue
    import signal
    import threading
    import urllib.request

    proc = subprocess.Popen(
        [sys.executable, "-m", "shape_based_object_detection_torch.cli.serve_cli",
         "--port", "0", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    lines: "queue.Queue" = queue.Queue()

    def read():
        for x in proc.stdout:
            lines.put(x)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    t = time.perf_counter()
    try:
        seen = read_until(lines, "serving on", 300)
        ready_s = time.perf_counter() - t
        port = int(seen[-1].split("http://127.0.0.1:")[1].split("/")[0])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = r.read()
        answer = post(port, body)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        seen += read_until(lines, "server stopped", 30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"[cli] serve_cli {name} subprocess: ready in {ready_s:.1f} s "
        f"('{seen[1] if len(seen) > 1 else seen[0]}'), /healthz {health!r}, /detect "
        f"{len(answer['detections'])} detections for a {answer['width']}x{answer['height']} "
        f"image, SIGTERM -> exit {rc}, '{seen[-1]}'")
    if health != b"ok" or not answer["detections"] or rc != 0:
        raise RuntimeError(f"serve_cli {name} did not serve and stop cleanly")
    return ready_s


# ---------------------------------------------------------------------------
# group int8: the int8 serving tiers and the exported artifact
# ---------------------------------------------------------------------------

# H100 SXM dense int8 tensor-core peak (NVIDIA's data sheet)
INT8_OPS = 1979e12


def smooth_images(torch, seed, b, size):
    """(b, size, size, 3) uint8 on the card: 32 px noise resized up, smooth
    as photos are."""
    from shape_based_object_detection_torch.utils.image import resize_images

    small = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, 32, 32, 3), dtype=np.uint8)).cuda()
    return resize_images(small, size).round().clamp(0, 255).to(torch.uint8)


def widen_heads(torch, module, cls_scale):
    """Head convolutions at variance 1/fan_in (the CPU tests' weights), the
    classification kernels scaled up: scores spread, and the int8 tiers'
    activations in the heads are not near zero."""
    from torch import nn

    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, nn.Conv2d) and name.startswith(("cls_head", "box_head")):
                m.weight.normal_(0.0, (1.0 / m.weight[0].numel()) ** 0.5,
                                 generator=torch.Generator().manual_seed(len(name)))
        for name, m in module.named_modules():
            if isinstance(m, nn.Conv2d) and (name == "cls_head.predict"
                                             or name.startswith("cls_")):
                m.weight.mul_(cls_scale)


INT8_TIERS = (("weights", "weights", None), ("full_dynamic", "full", None),
              ("full_static", "full", "static"))


def int8_inputs(torch, quantize, module, x):
    """{name: (input, output)} of every int8 convolution of ``module`` (its
    int8 modes) in one forward of ``x``."""
    seen, hooks = {}, []
    for name, m in module.named_modules():
        if isinstance(m, quantize.Int8Conv2d) and m.mode != "weights":
            hooks.append(m.register_forward_hook(  # returns None: the output stays
                lambda mod, args, out, name=name: seen.setdefault(name, (args[0], out)) and None))
    try:
        with torch.inference_mode():
            module(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def int8_noisy_forward(torch, quantize, module, x):
    """``module(x)`` on the CPU with every int8 convolution's input
    multiplied by 1 + 1e-7 * N(0, 1) (a fixed seed): last-bit noise in the
    float layers, as another device's rounding gives."""
    gen = torch.Generator().manual_seed(4)

    def perturb(mod, args):
        return (args[0] * (1 + 1e-7 * torch.randn(args[0].shape, generator=gen)),)

    hooks = [m.register_forward_pre_hook(perturb) for m in module.modules()
             if isinstance(m, quantize.Int8Conv2d) and m.mode != "weights"]
    try:
        with torch.inference_mode():
            return module(x)
    finally:
        for h in hooks:
            h.remove()


def phase_int8_forward(torch, config, build_model, quantize):
    """Each int8 tier's full-width forward, card vs CPU, one image, float32
    with TF32 off, the same weights and, in the static tier, the same
    scales: R50-FPN-512 (heads at variance 1/fan_in, as the CPU tests'
    weights) and SSD300 (config #1). The weight-only tier is held to the
    CPU tests' bound for the port against the JAX package (max |err| 0.02,
    mean 0.002). In the full tiers every int8 convolution of the card's
    forward is run on the CPU on the card's own input and must give the
    card's output bit for bit; the whole forward is held to three times the
    CPU's own spread when every int8 convolution's input is perturbed by
    1e-7 relative noise (a float layer whose last bit differs between the
    devices, such as BatchNorm's rsqrt, flips int8 levels downstream, and
    the flips cascade as they do under that perturbation)."""
    from shape_based_object_detection_torch.utils.image import normalize_images

    out = {}
    for name, cfg, cls_scale in (
            ("R50-FPN-512", config.get_config("config2_retinanet_r50_infer").model, 4.0),
            ("SSD300", config.get_config("config1_ssd300_infer").model, 2.0)):
        cfg = dataclasses.replace(cfg, precision="highest")
        cpu_model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        if name.startswith("R50"):
            widen_heads(torch, cpu_model, cls_scale)
        else:
            with torch.no_grad():
                for i in range(len(cfg.anchors.aspect_ratios)):
                    getattr(cpu_model, f"cls_{i}").weight.mul_(cls_scale)
        gpu_model, _ = build_model(cfg, device="cuda")
        gpu_model.load_state_dict(cpu_model.state_dict())
        size = cfg.image_size
        image = np.random.default_rng(2).integers(0, 256, (1, size, size, 3), dtype=np.uint8)
        calib = np.random.default_rng(3).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
        scales = quantize.calibrate_activation_scales(cpu_model, [calib])
        x = normalize_images(torch.from_numpy(image)).permute(0, 3, 1, 2).contiguous()
        tag = name.split("-")[0].lower()
        for tier, mode, static in INT8_TIERS:
            sc = scales if static else None
            qc = quantize.quantize_module(cpu_model, mode, sc, device="cpu")
            qg = quantize.quantize_module(gpu_model, mode, sc, device="cuda")
            xg = x.cuda().contiguous(memory_format=torch.channels_last)
            with torch.inference_mode():
                ref = qc(x)
                got = qg(xg)
            spread_ = int8_noisy_forward(torch, quantize, qc, x) if mode == "full" else None
            worst = max(float((o.cpu() - r).abs().max()) for o, r in zip(got, ref))
            mean = max(float((o.cpu() - r).abs().mean()) for o, r in zip(got, ref))
            if not all(torch.isfinite(o).all() for o in got):
                raise RuntimeError(f"non-finite {name} {tier} forward output on the card")
            rng_ = f"[{float(ref[0].min()):.2f}, {float(ref[0].max()):.2f}]"
            if mode == "weights":
                bound = (0.02, 0.002)
                detail = "bound 0.02, 0.002"
            else:
                s_max = max(float((a - r).abs().max()) for a, r in zip(spread_, ref))
                s_mean = max(float((a - r).abs().mean()) for a, r in zip(spread_, ref))
                bound = (max(3 * s_max, 0.02), max(3 * s_mean, 0.002))
                # every int8 convolution of the card's forward, on the CPU
                # with the card's input
                card = int8_inputs(torch, quantize, qg, xg)
                cpu_mods = dict(qc.named_modules())
                for conv_name, (xin, yout) in card.items():
                    with torch.inference_mode():
                        want = cpu_mods[conv_name](xin.cpu())
                    if not torch.equal(yout.cpu(), want):
                        raise RuntimeError(
                            f"{name} {tier}: int8 convolution {conv_name} on the card differs "
                            f"from the CPU on the same input: max |err| "
                            f"{float((yout.cpu() - want).abs().max())}")
                detail = (f"{len(card)} int8 convolutions bit-equal to the CPU on the card's "
                          f"inputs; the CPU's own spread under 1e-7 noise at each int8 "
                          f"convolution's input max "
                          f"{s_max:.3e}, mean {s_mean:.3e}; bound {bound[0]:.3e}, "
                          f"{bound[1]:.3e}")
                out[f"int8_{tag}_{tier}_cpu_noise_spread_max"] = s_max
            log(f"[int8] {name} {tier} forward card vs CPU (fp32, TF32 off, b1): max |err| "
                f"{worst:.3e}, mean {mean:.3e} ({detail}), logits range {rng_}")
            if worst > bound[0] or mean > bound[1]:
                raise RuntimeError(f"{name} {tier} forward on the card differs from the CPU")
            out[f"int8_{tag}_{tier}_card_vs_cpu_max_abs_err"] = worst
            out[f"int8_{tag}_{tier}_card_vs_cpu_mean_abs_err"] = mean
            del qc, qg
    return out


class Int8Capture:
    """``with Int8Capture(torch, quantize, module) as calls:`` keeps, for
    every s8xs8->s32 product the card computes, the Int8Conv2d, its float
    input, the int8 operands and the card's int32 result."""

    def __init__(self, torch, quantize, module):
        self.torch, self.q, self.module = torch, quantize, module
        self.calls, self.inputs = [], []

    def __enter__(self):
        self.orig = self.q.int8_conv2d_cuda

        def capture(xq, wq, stride, padding, dilation):
            out = self.orig(xq, wq, stride, padding, dilation)
            self.calls.append((xq, wq, list(stride), list(padding), list(dilation), out))
            return out

        self.q.int8_conv2d_cuda = capture
        self.hooks = [m.register_forward_pre_hook(
            lambda mod, args: self.inputs.append((mod, args[0])))
            for m in self.module.modules()
            if isinstance(m, self.q.Int8Conv2d) and m.mode != "weights"]
        return self

    def __exit__(self, *exc):
        self.q.int8_conv2d_cuda = self.orig
        for h in self.hooks:
            h.remove()


def int8_product_check(torch, quantize, detect, module, images, name):
    """One forward of ``detect`` on ``images`` with every int8 product
    captured; each against the plain version on the same operands on the
    card (float64, cuDNN off: exact), bit for bit. Returns (the capture,
    calls per forward, distinct shapes)."""
    with Int8Capture(torch, quantize, module) as cap:
        detect(images)
    torch.cuda.synchronize()
    shapes = set()
    with torch.backends.cudnn.flags(enabled=False):
        for xq, wq, stride, padding, dilation, out in cap.calls:
            want = quantize.int8_conv2d_plain(xq, wq, stride, padding, dilation)
            shapes.add((tuple(xq.shape), tuple(wq.shape), tuple(stride), tuple(dilation)))
            if not torch.equal(out, want):
                raise RuntimeError(
                    f"the int8 product differs from its plain version at {name}: x "
                    f"{tuple(xq.shape)}, w {tuple(wq.shape)}, stride {stride}, padding "
                    f"{padding}, dilation {dilation}: max |err| "
                    f"{int((out.long() - want.long()).abs().max())}")
    if len(cap.calls) != len(cap.inputs) or not cap.calls:
        raise RuntimeError(f"{name}: {len(cap.calls)} products for {len(cap.inputs)} int8 "
                           "convolutions")
    log(f"[int8] product vs plain at {name}: {len(cap.calls)} products per forward, "
        f"{len(shapes)} distinct shapes, all bit-equal (int32)"
        + (", dilated: " + ", ".join(f"x {s[0]} w {s[1]} d {s[3]}" for s in shapes
                                     if s[3] != (1, 1)) if any(s[3] != (1, 1) for s in shapes)
           else ""))
    return cap, len(cap.calls), len(shapes)


def int8_stage_times(torch, quantize, cap, name):
    """Per stage, summed over one forward's int8 convolutions (CUDA events,
    the median of 5 calls each): quantize (abs-max, round, clamp), im2col,
    _int_mm, the epilogue; beside them cuDNN's bf16 convolution of the same
    shapes, and the product's bound at the card's int8 peak."""
    import torch.nn.functional as F

    sums = dict.fromkeys(("quantize_ms", "im2col_ms", "int_mm_ms", "epilogue_ms",
                          "cudnn_bf16_ms", "int_mm_bound_ms"), 0.0)

    def med(fn):
        return float(np.median(cuda_times_ms(fn, iters=5, warmup=2)))

    before = quantize.launches
    for (mod, x), (xq, wq, stride, padding, dilation, acc) in zip(cap.inputs, cap.calls):
        kh, kw = wq.shape[1:3]
        a = quantize.im2col_nhwc(xq, kh, kw, stride, padding, dilation)
        bt = quantize.gemm_weight(wq).t()
        _, ls = mod.quantize_input(x)
        xb = x.to(torch.bfloat16)
        wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        sums["quantize_ms"] += med(lambda: mod.quantize_input(x))
        sums["im2col_ms"] += med(lambda: quantize.im2col_nhwc(xq, kh, kw, stride, padding,
                                                              dilation))
        sums["int_mm_ms"] += med(lambda: torch._int_mm(a, bt))
        sums["epilogue_ms"] += med(lambda: mod.dequantize_output(acc, ls, x.dtype))
        sums["cudnn_bf16_ms"] += med(lambda: F.conv2d(xb, wb, None, stride, padding,
                                                      dilation))
        m, o, k = acc.numel() // acc.shape[-1], wq.shape[0], kh * kw * wq.shape[3]
        sums["int_mm_bound_ms"] += max((m * k + k * o + 4 * m * o) / HBM_BYTES_PER_S,
                                       2.0 * m * k * o / INT8_OPS) * 1e3
    quantize.launches = before
    log(f"[int8] stages at {name}, summed over {len(cap.calls)} convolutions (median of 5 "
        "CUDA-event calls each): " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()))
    return sums


def phase_int8_serving(torch, config, serving, quantize, nms_cuda, reset_counts):
    """R50-FPN-512 bf16 Predictors (buckets 1 and 16, seed 0) in each tier,
    static scales calibrated on 4 synthetic b16 batches; SSD300 config #1
    (fp32, b1) Predictors. K1 once per batch in every tier; the int8
    product bit-equal to its plain version at every full-int8 shape of R50
    b16 and b1 and SSD300 b1; detect images/s and device ms per call; the
    stage times of the full tiers; weight bytes on the card."""
    cfg = serving_config(config, "bfloat16")
    t = time.perf_counter()
    base = serving.Predictor(cfg, batch_size=16, device="cuda", bucket_sizes=(1, 16))
    calib = [smooth_images(torch, 60 + i, 16, 512) for i in range(4)]
    scales = quantize.calibrate_activation_scales(base.module, calib, cfg.data)
    calib_s = time.perf_counter() - t
    log(f"[int8] calibrated {len(scales)} activation scales on 4 synthetic b16 batches "
        f"(R50 bf16; model build included) in {calib_s:.2f} s")
    preds = {"float": base}
    for tier, mode, static in INT8_TIERS:
        preds[tier] = serving.Predictor(cfg, batch_size=16, device="cuda", bucket_sizes=(1, 16),
                                        quantize=mode,
                                        activation_scales=scales if static else None)
    out, k1 = {"int8_calibrate_s": calib_s}, {}
    rng = np.random.default_rng(61)
    requests = [[rng.integers(0, 256, (int(rng.integers(200, 900)), int(rng.integers(200, 900)),
                                       3), dtype=np.uint8) for _ in range(n)] for n in (16, 1)]
    x16 = smooth_images(torch, 62, 16, 512)
    for tier, pred in preds.items():
        reset_counts()
        quantize.launches = 0
        answers = [pred.predict(r) for r in requests]
        torch.cuda.synchronize()
        check_answers(requests, answers)
        k1[f"int8_{tier}_launches"] = nms_cuda.launches
        if nms_cuda.launches != len(requests):
            raise RuntimeError(f"{tier}: K1 ran {nms_cuda.launches} times for "
                               f"{len(requests)} batches")
        wbytes = sum(t.nbytes for t in pred.module.state_dict().values())
        out[f"int8_r50_{tier}_weight_bytes"] = wbytes
        log(f"[int8] R50 bf16 Predictor {tier}: requests of 16 and 1 answered, K1 launches "
            f"{nms_cuda.launches} for 2 batches, int8 products {quantize.launches}, weight "
            f"bytes on the card {wbytes}")
        for b in (16, 1):
            x = x16[:b]
            times = cuda_times_ms(lambda: pred._detect(x), iters=20)
            dev_ms, _ = device_ms_per_call(lambda: pred._detect(x), calls=5)
            ms = float(np.median(times))
            out[f"int8_r50_{tier}_b{b}_median_ms"] = ms
            out[f"int8_r50_{tier}_b{b}_device_ms"] = dev_ms
            log(f"[timing] R50 detect b{b} bf16 {tier}: {spread(times)}, {b * 1e3 / ms:.1f} "
                f"images/s; device {dev_ms if dev_ms is None else round(dev_ms, 4)} ms per call")
    log(f"[int8] tiers served and timed ({time.perf_counter() - t:.1f} s since the group's "
        "Predictors were started)")
    products = {}
    for tier in ("full_dynamic", "full_static"):
        for b in (16, 1):
            pred = preds[tier]
            cap, calls, n_shapes = int8_product_check(
                torch, quantize, pred._detect, pred.module, x16[:b], f"R50 b{b} bf16 {tier}")
            products[f"r50_b{b}_{tier}"] = calls
            if (tier, b) != ("full_static", 1):
                out[f"int8_r50_{tier}_b{b}_stages"] = int8_stage_times(
                    torch, quantize, cap, f"R50 b{b} bf16 {tier}")
            del cap
    log(f"[int8] products checked and staged ({time.perf_counter() - t:.1f} s)")
    # the 2-scale batch detector in the static tier: S + 1 launches per batch
    ms = detection_multiscale(torch, base, scales)
    reset_counts()
    ms(x16)
    torch.cuda.synchronize()
    k1["int8_multiscale_launches"] = nms_cuda.launches
    log(f"[int8] MultiScaleBatchDetector (512, 640) b16 full_static: K1 launches "
        f"{nms_cuda.launches} for 1 batch")
    if nms_cuda.launches != 3:
        raise RuntimeError("the 2-scale int8 detector did not launch K1 3 times")
    times = cuda_times_ms(lambda: ms(x16), iters=10)
    out["int8_multiscale_full_static_b16_median_ms"] = float(np.median(times))
    log(f"[timing] 2-scale (512, 640) b16 bf16 full_static: {spread(times)}")
    del ms

    # SSD300, config #1 (fp32, b1)
    scfg = config.get_config("config1_ssd300_infer")
    s1 = smooth_images(torch, 63, 1, 300)
    for tier, mode in (("float", False), ("weights", "weights"), ("full_dynamic", "full")):
        pred = serving.Predictor(scfg, batch_size=1, device="cuda", quantize=mode)
        reset_counts()
        pred.predict(requests[1])
        torch.cuda.synchronize()
        k1[f"int8_ssd300_{tier}_launches"] = nms_cuda.launches
        if nms_cuda.launches != 1:
            raise RuntimeError(f"SSD300 {tier}: K1 ran {nms_cuda.launches} times for 1 batch")
        if mode == "full":
            _, calls, _ = int8_product_check(torch, quantize, pred._detect, pred.module, s1,
                                             "SSD300 b1 fp32 full_dynamic")
            products["ssd300_b1_full_dynamic"] = calls
            continue
        times = cuda_times_ms(lambda: pred._detect(s1), iters=30)
        dev_ms, _ = device_ms_per_call(lambda: pred._detect(s1), calls=5)
        ms_ = float(np.median(times))
        out[f"int8_ssd300_{tier}_b1_median_ms"] = ms_
        out[f"int8_ssd300_{tier}_b1_device_ms"] = dev_ms
        out[f"int8_ssd300_{tier}_weight_bytes"] = sum(
            t.nbytes for t in pred.module.state_dict().values())
        log(f"[timing] SSD300 detect b1 fp32 {tier}: {spread(times)}, {1e3 / ms_:.1f} images/s; "
            f"device {dev_ms if dev_ms is None else round(dev_ms, 4)} ms per call")
    out["int8_products_per_forward"] = products
    return out, k1, preds, scales


def detection_multiscale(torch, base, scales):
    from shape_based_object_detection_torch.detection import MultiScaleBatchDetector

    cfg = base.cfg.model
    return MultiScaleBatchDetector(cfg, base.module, (512, 640), base.cfg.data, "cuda",
                                   quantize="full", activation_scales=scales)


def artifact_client(folder):
    """Loads each artifact of ``folder`` with the port alone, in a fresh
    process, on the card; runs it once on its batch; writes the detections
    (``<name>_out.npz``), and the load seconds and K1 launches of the call
    (``client.json``). Run as ``python3 -c "import sys, chip_smoke;
    chip_smoke.artifact_client(sys.argv[1])" FOLDER`` from the repo root."""
    import torch

    from shape_based_object_detection_torch.export import load_artifact
    from shape_based_object_detection_torch.ops import nms_cuda

    report = {}
    for name, batch in (("float", "batch16"), ("full_static", "batch16"),
                        ("tiny_cpu", "tiny_batch")):
        t = time.perf_counter()
        model = load_artifact(os.path.join(folder, f"{name}.sbdx"))
        load_s = time.perf_counter() - t
        images = np.load(os.path.join(folder, f"{batch}.npy"))
        nms_cuda.launches = 0
        det = model(images)
        torch.cuda.synchronize()
        report[name] = {"load_s": load_s, "launches": nms_cuda.launches,
                        "exported_on": model.header["device"], "runs_on": str(model.device)}
        np.savez(os.path.join(folder, f"{name}_out.npz"),
                 **{k: getattr(det, k).cpu().numpy() for k in det._fields})
    with open(os.path.join(folder, "client.json"), "w") as f:
        json.dump(report, f)


def int8_export_artifacts(torch, config, export, detection, build_model, preds, scales,
                          workdir):
    """Exports the bf16 b16 float and full-static R50 programs on the card
    and the tiny SSD on the CPU, with the batches and the live detections
    to compare with, and starts ``artifact_client`` on them in a fresh
    process. Returns (numbers, folder, the client, what to compare)."""
    folder = os.path.join(workdir, "artifacts")
    os.makedirs(folder)
    out = {}
    x16 = smooth_images(torch, 64, 16, 512)
    np.save(os.path.join(folder, "batch16.npy"), x16.cpu().numpy())
    base = preds["float"]
    live = {}
    for name, kw in (("float", {}), ("full_static", dict(
            quantize=True, int8_activations=True, activation_scales=scales))):
        t = time.perf_counter()
        blob = export.export_detect(base.module, base.anchors, base.cfg.model, base.cfg.data,
                                    16, "cuda", **kw)
        out[f"artifact_{name}_export_s"] = time.perf_counter() - t
        out[f"artifact_{name}_bytes"] = len(blob)
        export.save_artifact(blob, os.path.join(folder, f"{name}.sbdx"))
        live[name] = preds[name]._detect(x16)
        log(f"[artifact] exported R50 bf16 b16 {name} on the card in "
            f"{out[f'artifact_{name}_export_s']:.2f} s: {len(blob)} bytes")
    tiny = config.resolve_config("tiny_ssd", ["model.detect.score_threshold=0.0"])
    t = time.perf_counter()
    blob = export.export_from_config(tiny, batch_size=1, device="cpu")
    out["artifact_tiny_cpu_export_s"] = time.perf_counter() - t
    export.save_artifact(blob, os.path.join(folder, "tiny_cpu.sbdx"))
    tiny_batch = np.random.default_rng(65).integers(0, 256, (1, 300, 300, 3), dtype=np.uint8)
    np.save(os.path.join(folder, "tiny_batch.npy"), tiny_batch)
    tm, ta = build_model(tiny.model, device="cpu")
    live["tiny_cpu"] = detection.make_detect_fn(tm, ta, tiny.model, tiny.data,
                                                device="cpu")(tiny_batch)
    client = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.artifact_client(sys.argv[1])",
         folder], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return out, folder, client, live


def int8_check_artifacts(client, folder, live):
    """Waits for ``artifact_client`` and holds what it read back: the R50
    detections equal the live Predictor's (labels and valid equal, boxes
    and scores within 1e-5), one K1 launch per call, and the CPU artifact
    on the card matches the CPU's detect."""
    try:
        text, _ = client.communicate(timeout=600)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
    if client.returncode != 0:
        raise RuntimeError(f"artifact client failed:\n{text[-4000:]}")
    with open(os.path.join(folder, "client.json")) as f:
        report = json.load(f)
    out = {}
    for name in ("float", "full_static"):
        got = np.load(os.path.join(folder, f"{name}_out.npz"))
        want = {k: getattr(live[name], k).cpu().numpy() for k in live[name]._fields}
        same = (np.array_equal(got["labels"], want["labels"])
                and np.array_equal(got["valid"], want["valid"]))
        err = max(float(np.abs(got[k] - want[k]).max()) for k in ("boxes", "scores"))
        log(f"[artifact] {name}: reloaded in a fresh process in {report[name]['load_s']:.2f} s "
            f"(exported on {report[name]['exported_on']}, runs on {report[name]['runs_on']}); "
            f"labels and valid equal={same}, boxes and scores max |err| {err:.3e} against the "
            f"live Predictor ({int(want['valid'].sum())} detections); K1 launches "
            f"{report[name]['launches']} for 1 call")
        if not same or err > 1e-5 or report[name]["launches"] != 1:
            raise RuntimeError(f"the reloaded {name} artifact differs from the live Predictor")
        out[f"artifact_{name}_load_s"] = report[name]["load_s"]
        out[f"artifact_{name}_max_abs_err"] = err
    out["launches"] = {name: r["launches"] for name, r in report.items()}
    got, want = np.load(os.path.join(folder, "tiny_cpu_out.npz")), live["tiny_cpu"]
    vg, vw = got["valid"][0], want.valid[0].numpy()
    n = matched(tuple(got[k][0][vg] for k in ("boxes", "scores", "labels")),
                tuple(getattr(want, k)[0].numpy()[vw] for k in ("boxes", "scores", "labels")))
    log(f"[artifact] tiny SSD exported on the CPU, moved to {report['tiny_cpu']['runs_on']} at "
        f"load in {report['tiny_cpu']['load_s']:.2f} s: K1 launches "
        f"{report['tiny_cpu']['launches']}, {n} detections matched the CPU's detect (label, "
        "IoU >= 0.99, |dscore| <= 1e-3)")
    if report["tiny_cpu"]["launches"] != 1 or n == 0:
        raise RuntimeError("the CPU artifact did not run K1 on the card")
    return out


def int8_artifact_predictors(torch, serving, nms_cuda, reset_counts, preds, folder):
    """ArtifactPredictor.predict against Predictor.predict on 16 images of
    200-900 px, in turns (host clock), each artifact once through K1."""
    out = {}
    rng = np.random.default_rng(66)
    request = [rng.integers(0, 256, (int(rng.integers(200, 900)), int(rng.integers(200, 900)),
                                     3), dtype=np.uint8) for _ in range(16)]
    for name in ("float", "full_static"):
        ap = serving.ArtifactPredictor(os.path.join(folder, f"{name}.sbdx"))
        reset_counts()
        ap.predict(request)
        torch.cuda.synchronize()
        if nms_cuda.launches != 1:
            raise RuntimeError(f"ArtifactPredictor {name}: K1 ran {nms_cuda.launches} times")
        walls = {"predictor": [], "artifact": []}
        for order in (("predictor", "artifact"), ("artifact", "predictor")) * 3:
            for who in order:
                p = preds[name] if who == "predictor" else ap
                t = time.perf_counter()
                p.predict(request)
                walls[who].append(time.perf_counter() - t)
        for who, w in walls.items():
            out[f"{who}_{name}_predict_16_images_per_s"] = 16.0 / float(np.median(w))
        log(f"[artifact] {name} predict of 16 images of 200-900 px (host clock, medians of 6 "
            f"in turns): ArtifactPredictor "
            f"{out[f'artifact_{name}_predict_16_images_per_s']:.1f} images/s, Predictor "
            f"{out[f'predictor_{name}_predict_16_images_per_s']:.1f}")
        del ap
    return out


def phase_int8(torch, config, serving, detection, build_model, nms_cuda, reset_counts,
               workdir):
    """Group int8, in order: the tiers' full-width forwards card vs CPU; the
    bf16 Predictors in every tier (K1 gates, the int8 product gates,
    times); the artifacts exported, then read back in a fresh process while
    serve_cli serves the static tier and an artifact (three processes at
    once); last, ArtifactPredictor against Predictor."""
    from shape_based_object_detection_torch import export, quantize

    log(f"[int8] the group's numbers are this card's: {nvidia_smi_line()}")
    t = time.perf_counter()
    out = phase_int8_forward(torch, config, build_model, quantize)
    log(f"[int8] card vs CPU forwards took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    serve_out, k1, preds, scales = phase_int8_serving(torch, config, serving, quantize,
                                                      nms_cuda, reset_counts)
    out.update(serve_out)
    log(f"[int8] Predictors, products and times took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    art_out, folder, client, live = int8_export_artifacts(
        torch, config, export, detection, build_model, preds, scales, workdir)
    out.update(art_out)
    try:
        scales_path = os.path.join(workdir, "scales.json")
        quantize.save_activation_scales(scales_path, scales)
        bodies, _ = encoded_requests(1, 67)
        runs = {  # both at once, beside the artifact client
            "serve_cli_full_static_ready_s": (
                ["--config", "config2_retinanet_r50_infer", "--batch-size", "4", "--quantize",
                 "full", "--act-scales", scales_path, "--set", "model.dtype=\"bfloat16\"",
                 "--set", "model.detect.score_threshold=0.0",
                 "--set", "data.decode_backend=pil"],
                bodies[0], "config #2 bf16 --quantize full --act-scales"),
            "serve_cli_artifact_ready_s": (
                ["--artifact", os.path.join(folder, "full_static.sbdx")], bodies[0],
                "--artifact (R50 bf16 b16 full_static)")}
        with ThreadPoolExecutor(len(runs)) as pool:
            ready = {k: pool.submit(serve_cli_answers, *v) for k, v in runs.items()}
            out.update({k: f.result() for k, f in ready.items()})
    except BaseException:
        client.kill()
        client.wait()
        raise
    checked = int8_check_artifacts(client, folder, live)
    # one K1 launch per call of each loaded artifact
    k1.update({f"int8_artifact_{k}_launches": v for k, v in checked.pop("launches").items()})
    out.update(checked)
    out.update(int8_artifact_predictors(torch, serving, nms_cuda, reset_counts, preds, folder))
    log(f"[int8] artifacts, their client and serve_cli took {time.perf_counter() - t:.1f} s")
    return out, k1


# ---------------------------------------------------------------------------
# The input pipelines (group "data") and data parallelism (group "dist")
# ---------------------------------------------------------------------------

VOC_IMAGES = 256  # JPEGs of 500 x 375, VOC's usual size


def write_voc_folder(root, n, seed):
    """A VOC-layout folder (JPEGImages, Annotations, ImageSets/Main/train.txt)
    of ``n`` JPEGs of 500 x 375 with 1-6 objects each, made from ``seed``
    (smooth content, so each JPEG is of a photograph's size)."""
    from PIL import Image

    from shape_based_object_detection_torch.data.voc import VOC_CLASSES

    rng = np.random.default_rng(seed)
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names, nbytes = [], 0
    for i in range(n):
        name = f"{i:06d}"
        small = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
        path = os.path.join(root, "JPEGImages", f"{name}.jpg")
        Image.fromarray(small).resize((500, 375), Image.BICUBIC).save(path, quality=90)
        nbytes += os.path.getsize(path)
        objs = []
        for _ in range(int(rng.integers(1, 7))):
            x0, y0 = int(rng.integers(0, 400)), int(rng.integers(0, 300))
            x1, y1 = x0 + int(rng.integers(20, 500 - x0)), y0 + int(rng.integers(20, 375 - y0))
            cls = VOC_CLASSES[int(rng.integers(0, len(VOC_CLASSES)))]
            objs.append(f"<object><name>{cls}</name><difficult>0</difficult><bndbox>"
                        f"<xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax>"
                        "</bndbox></object>")
        with open(os.path.join(root, "Annotations", f"{name}.xml"), "w") as f:
            f.write("<annotation><size><width>500</width><height>375</height></size>"
                    + "".join(objs) + "</annotation>")
        names.append(name)
    with open(os.path.join(root, "ImageSets", "Main", "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return nbytes


def loader_rate(make, batches=16, drain=16):
    """A loader's steady supply on the host clock: (seconds to its first
    batch, ms per batch over ``batches`` batches taken after ``drain`` more
    (what worker processes prefetch while they start), seconds to close
    it). Epochs follow one another."""
    import itertools

    t = time.perf_counter()
    loader = make()
    it = itertools.chain.from_iterable(loader.batches(e) for e in itertools.count())
    next(it)
    start = time.perf_counter() - t
    for _ in range(drain):
        next(it)
    per = []
    for _ in range(batches):
        t = time.perf_counter()
        next(it)
        per.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    loader.close()
    return start, np.array(per), time.perf_counter() - t


def host_loaders(torch, cfg, ds, name, workers_list):
    """The thread Loader (8 threads) and GrainLoader at ``workers_list``
    on ``ds`` at b32: ms per batch."""
    from shape_based_object_detection_torch.data.grain_pipeline import GrainLoader
    from shape_based_object_detection_torch.data.pipeline import Loader

    out = {}
    g = cfg.data.max_boxes
    start, per, _ = loader_rate(lambda: Loader(ds, 32, g, seed=1, workers=8), drain=0)
    out[f"{name}_threads8_batch_ms"] = float(np.mean(per))
    log(f"[data] {name}: thread Loader (8 threads) b32 {spread(per)}, mean "
        f"{np.mean(per):.3f} ms per batch (first batch after {start:.2f} s)")
    for w in workers_list:
        start, per, close = loader_rate(lambda: GrainLoader(ds, 32, g, seed=1, workers=w),
                                        drain=2 * w)
        out[f"{name}_grain{w}_batch_ms"] = float(np.mean(per))
        out[f"{name}_grain{w}_start_s"] = start
        left = loader_workers_left()
        log(f"[data] {name}: GrainLoader, {w} worker processes, b32 {spread(per)}, mean "
            f"{np.mean(per):.3f} ms per batch after the {2 * w} batches prefetched while "
            f"the workers started (workers started and first batch in {start:.2f} s; "
            f"closed in {close:.2f} s, worker processes left {len(left)})")
        if left:
            raise RuntimeError(f"GrainLoader.close() left workers {left} running")
    return out


def phase_data(torch, train, cli_train, matching_cuda, reset_counts, workdir):
    """The input pipelines on config #3's input (SSD-512, b32, 512 px,
    max_boxes 100): the cache built from the 512 px synthetic split, its
    bytes and time; CacheLoader's ms per batch; the cache staged on the card
    (bytes there, the gather's device ms, every batch bit-equal to
    CacheLoader's); GrainLoader at 0, 4 and 8 worker processes and the
    thread Loader on the same split and on a VOC folder of 256 JPEGs of
    500 x 375 (the decode-bound case); then train_cli on config #3 under
    each --loader: ms per step, the card's idle share, K2 once per step."""
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.data.cache import (
        CacheLoader, DeviceCacheLoader, MemmapDetection, build_cache,
    )
    from shape_based_object_detection_torch.data.voc import VOCDetection

    cfg = config_lib.get_config("config3_ssd512_voc_train")
    g = cfg.data.max_boxes
    results = {}
    ds = cli_train.build_dataset(cfg, argparse_ns(data_root=APP_TRAIN, split="train",
                                                  ann_file=""))
    cache_dir = os.path.join(workdir, "data_cache")
    t = time.perf_counter()
    build_cache(ds, cache_dir, g, workers=8)
    build_s = time.perf_counter() - t
    cache_bytes = sum(os.path.getsize(os.path.join(cache_dir, f))
                      for f in os.listdir(cache_dir) if f.endswith(".npy"))
    mm = MemmapDetection(cache_dir)
    start, per, _ = loader_rate(lambda: CacheLoader(mm, 32, g, seed=1), drain=0)
    log(f"[data] build_cache of {APP_TRAIN} ({len(ds)} images at 512 px, max_boxes {g}, 8 "
        f"threads): {build_s:.2f} s, {cache_bytes} bytes; CacheLoader b32 {spread(per)}, "
        f"mean {np.mean(per):.3f} ms per batch")
    results.update({"cache_build_s": build_s, "cache_bytes": cache_bytes,
                    "cache_loader_batch_ms": float(np.mean(per))})

    t = time.perf_counter()
    dev = DeviceCacheLoader(mm, 32, g, seed=1)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t
    on_card = sum(v.numel() * v.element_size() for v in dev._dev.values())
    host = CacheLoader(mm, 32, g, seed=1)
    pairs = list(zip(dev.device_batches(0), host.batches(0)))
    equal = len(pairs) == len(ds) // 32 and all(
        np.array_equal(a.cpu().numpy(), b) for d, h in pairs for a, b in zip(d, h))
    chunk = np.sort(dev._epoch_indices(1)[:32])
    gather = cuda_times_ms(lambda: dev._device_batch(chunk), iters=20)
    batch_bytes = sum(v.numel() * v.element_size() for v in pairs[0][0])
    bound = 2 * batch_bytes / HBM_BYTES_PER_S * 1e3  # each byte read once, written once
    log(f"[data] DeviceCacheLoader: {on_card} bytes staged on the card in {stage_s:.2f} s; "
        f"{len(pairs)} b32 batches bit-equal to CacheLoader's: {equal}; the on-card gather "
        f"of a b32 batch ({batch_bytes} bytes, index_select) {spread(gather)} (CUDA events; "
        f"bound {bound:.4f} ms at 3.35 TB/s) ({nvidia_smi_line()})")
    if not equal:
        raise RuntimeError("DeviceCacheLoader's batches differ from CacheLoader's")
    results.update({"device_cache_bytes": on_card, "device_cache_stage_s": stage_s,
                    "device_gather_ms": float(np.median(gather)),
                    "device_gather_bound_ms": bound})
    del dev, pairs
    torch.cuda.empty_cache()

    results.update(host_loaders(torch, cfg, ds, "synthetic", (0, 4, 8)))
    voc_root = os.path.join(workdir, "voc")
    t = time.perf_counter()
    jpeg_bytes = write_voc_folder(voc_root, VOC_IMAGES, 9)
    voc = VOCDetection(voc_root, "train", image_size=512, decode_backend="auto")
    log(f"[data] a VOC folder of {VOC_IMAGES} JPEGs of 500 x 375 ({jpeg_bytes} bytes) "
        f"written in {time.perf_counter() - t:.2f} s; decode backend {voc.decode_backend!r}")
    results.update(host_loaders(torch, cfg, voc, "voc_jpeg", (0, 4, 8)))
    t = time.perf_counter()
    build_cache(voc, os.path.join(workdir, "voc_cache"), g, workers=8)
    results["voc_cache_build_s"] = time.perf_counter() - t
    log(f"[data] build_cache of the VOC folder (8 threads, one decode per image): "
        f"{results['voc_cache_build_s']:.2f} s")

    # train_cli on config #3 under each loader: steps 4-8 timed, 8-11 profiled.
    # One grain run: on the card, a second GrainLoader driven by train_cli in
    # one process waits 5 s per worker to close (PERF.md §7)
    steps = 12
    runs = [("threads", APP_TRAIN), ("cache", APP_TRAIN), ("device", APP_TRAIN),
            ("threads", voc_root), ("grain", voc_root)]
    for loader, root in runs:
        tag = f"{loader}_{'voc_jpeg' if root == voc_root else 'synthetic'}"
        argv = ["--config", "config3_ssd512_voc_train", "--data-root", root,
                "--steps", str(steps), "--log-every", "4", "--workers", "8",
                "--loader", loader, "--cache-dir", os.path.join(workdir, f"cli_cache_{tag}"),
                "--checkpoint-dir", os.path.join(workdir, f"cli_{tag}")]
        reset_counts()
        text, wall, interval, busy, window, idle = cli_loop(torch, train, cli_train, argv,
                                                            (4, 8), (8, 12))
        k2 = matching_cuda.launches
        left = loader_workers_left()
        if k2 != steps or f"done at step {steps}" not in text or left:
            raise RuntimeError(f"train_cli --loader {loader} on {root}: K2 {k2} in {steps} "
                               f"steps, loader workers left running {left}: {text[-300:]}")
        log(f"[data] train_cli config #3 --loader {loader} on {tag.split('_', 1)[1]}: "
            f"{interval:.3f} ms per step over steps 4-8 ({32e3 / interval:.1f} images/s), "
            f"idle share {idle:.3f} over steps 8-11 (busy {busy:.3f} of {window:.3f} ms); "
            f"wall {wall:.1f} s; K2 launches {k2} (one per step); no loader worker left "
            f"running")
        results.update({f"cli_{tag}_step_ms": interval, f"cli_{tag}_idle_share": idle})
    return results


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_equal_to_plain(torch, train, build_model, matching_cuda, mesh, cfg, batch, name):
    """Two steps of the data-parallel step on ``mesh`` and of the plain
    step, from the same weights, batch and generator seed, with cuDNN's
    deterministic algorithms: metrics and state bit-equal. Returns the
    data-parallel step's K2 launches and its ms per step beside the plain
    step's (cuDNN's usual algorithms, CUDA events)."""
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    runs, launches, times = {}, None, {}
    deterministic = torch.backends.cudnn.deterministic
    for m in (None, mesh):
        module, anchors = build_model(cfg.model, device="cuda", train=True,
                                      generator=torch.Generator().manual_seed(3))
        state = train.create_train_state(module, cfg)
        step = train.make_train_step(module, anchors, cfg, mesh=m)
        torch.backends.cudnn.deterministic = True
        try:
            matching_cuda.launches = 0
            metrics = [{k: v.clone() for k, v in step(state, batch)[1].items()}
                       for _ in range(2)]
            torch.cuda.synchronize()
            if m is not None:
                launches = matching_cuda.launches
        finally:
            torch.backends.cudnn.deterministic = deterministic
        runs[m is None] = (metrics, {k: v.clone() for k, v in module.state_dict().items()})
        times[m is None] = cuda_times_ms(lambda: step(state, batch), iters=5, warmup=2)
        del module, state, step
        torch.cuda.empty_cache()
    (dp_m, dp_s), (pl_m, pl_s) = runs[False], runs[True]
    same = (all(torch.equal(a[k], b[k]) for a, b in zip(dp_m, pl_m) for k in b)
            and all(torch.equal(dp_s[k], v) for k, v in pl_s.items()))
    log(f"[dist] {name}: the data-parallel step in an NCCL group of one vs the plain step, 2 "
        f"steps, cuDNN deterministic: metrics and state bit-equal: {same} (loss "
        f"{float(dp_m[-1]['loss']):.6f}); K2 launches {launches} in 2 data-parallel steps; "
        f"step {spread(times[False])} data-parallel, {spread(times[True])} plain "
        f"({nvidia_smi_line()})")
    if not same or launches != 2:
        raise RuntimeError(f"{name}: data-parallel step bit-equal {same}, K2 {launches}")
    return launches, float(np.median(times[False])), float(np.median(times[True]))


def phase_dist_nccl(torch, config, train, build_model, matching_cuda, nms_cuda, nms,
                    detection, reset_counts):
    """An NCCL group of one rank on the card, formed by
    initialize_multihost from torchrun's environment: its data-parallel
    step bit-equal to the plain step (RetinaNet R50-FPN-512 b16 bf16, and
    SSD-512 b32 with train_bn and remat); K2 bit-equal on the rank's
    augmented local batch; the sharded eval step (config #3 b32): K1 once
    per batch, bit-equal on the candidates of the rank's rows, and the
    detections gathered equal to make_eval_step's without a group."""
    import torch.distributed as dist

    from shape_based_object_detection_torch.data.augment import augment_batch
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model
    from shape_based_object_detection_torch.parallel import initialize_multihost, shutdown
    from tests.torch_kernel_cases import match_check

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out, k1, k2 = {}, {}, {}
    try:
        mesh = initialize_multihost()
        backend = dist.get_backend()
        if backend != "nccl" or not mesh.distributed or mesh.device.type != "cuda":
            raise RuntimeError(f"the group formed on {backend}, {mesh}")
        try:
            r50 = train_config(config, "bfloat16", 16)
            launches, dp_ms, plain_ms = dp_equal_to_plain(
                torch, train, build_model, matching_cuda, mesh, r50,
                train_batch(np.random.default_rng(60), 16), "R50-FPN-512 b16 bf16")
            out.update({"dist_r50_b16_bf16_step_ms": dp_ms,
                        "plain_r50_b16_bf16_step_ms": plain_ms})
            ssd = ssd_train_config(config, 32)
            ssd = dataclasses.replace(ssd, model=dataclasses.replace(ssd.model, train_bn=True,
                                                                     remat=True))
            batch = train_batch(np.random.default_rng(61), 32, g=100, classes=20)
            launches, dp_ms, plain_ms = dp_equal_to_plain(
                torch, train, build_model, matching_cuda, mesh, ssd, batch,
                "SSD-512 b32 (config #3) with train_bn and remat")
            out.update({"dist_ssd512_b32_step_ms": dp_ms, "plain_ssd512_b32_step_ms": plain_ms})
            k2["dist_launches"] = launches

            # K2 on the rank's augmented local batch (its rows of the global batch)
            gen = torch.Generator(device="cuda").manual_seed(ssd.train.seed)
            rows = mesh.rows(32)
            _, gt, lbl, ok = augment_batch(
                gen, *(torch.from_numpy(batch[k][rows]).cuda() for k in
                       ("images", "boxes", "labels", "valid")),
                ssd.data, ssd.model.image_size, mesh.rank, mesh.world)
            anchors = anchors_for_model(ssd.model).cuda()
            passed, err, line = match_check(anchors, gt.contiguous(), lbl.contiguous(),
                                            ok.contiguous(), ssd.match.shape_weight,
                                            ssd.model.anchors.variances, cfg=ssd.match,
                                            exact=True)
            log(f"[kernel] match_anchors on rank {mesh.rank}'s augmented rows {rows} of the "
                f"global b32 (config #3): {line}")
            if not passed:
                raise RuntimeError("match_anchors differs from the plain version on the "
                                   "rank's batch")
            k2["dist_max_abs_err"] = err

            # the sharded eval step on config #3 at threshold 0
            cfg = config.resolve_config("config3_ssd512_voc_train",
                                        ["model.detect.score_threshold=0.0"])
            module, anchors = build_model(cfg.model, device="cuda", train=True,
                                          generator=torch.Generator().manual_seed(4))
            state = train.create_train_state(module, cfg)
            images = torch.from_numpy(batch["images"]).cuda()
            reset_counts()
            det = train.make_eval_step(module, anchors, cfg, mesh=mesh)(state, images[rows])
            torch.cuda.synchronize()
            k1["dist_eval_launches"] = nms_cuda.launches
            want = train.make_eval_step(module, anchors, cfg)(state, images)
            same = all(torch.equal(a, b) for a, b in zip(det, want))
            with torch.inference_mode():
                x = detection.image_lib.normalize_images(images[rows])
                cands = detection.select_candidates(*module(x.permute(0, 3, 1, 2)), anchors,
                                                    cfg.model)
            k1["dist_eval_max_abs_err"] = k1_on(torch, nms, cands, cfg.model.detect,
                                                "the sharded eval step's candidates")
            log(f"[dist] the sharded eval step (config #3 b32 at threshold 0) in the group: K1 "
                f"launches {k1['dist_eval_launches']} for one batch; its gathered detections "
                f"equal make_eval_step's without a group: {same}")
            if k1["dist_eval_launches"] != 1 or not same:
                raise RuntimeError("the sharded eval step")
            del module, state
            torch.cuda.empty_cache()
        finally:
            shutdown(mesh)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, k1, k2


def dist_cli_worker(kind, out_path, *argv):
    """One rank of ``torch.distributed.run``: train_cli or eval_cli
    (``kind``) with ``argv``, its kernels' launches counted from 0 and, for
    eval_cli, the records it fed its Evaluator, written to ``out_path``
    (pickle). Run as ``python -m torch.distributed.run --standalone
    --nproc_per_node 1 --no-python python3 -c "import sys, chip_smoke;
    chip_smoke.dist_cli_worker(*sys.argv[1:])" KIND OUT ARGS...``."""
    import pickle

    import torch

    from shape_based_object_detection_torch import eval as eval_pkg
    from shape_based_object_detection_torch.cli import eval_cli, train_cli
    from shape_based_object_detection_torch.ops import matching_cuda, nms_cuda

    nms_cuda.launches = matching_cuda.launches = 0
    with KeptEvaluators(eval_pkg) as made:
        (train_cli if kind == "train" else eval_cli).main(list(argv))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    report = {"k1": nms_cuda.launches, "k2": matching_cuda.launches, "records": [
        argparse_ns(area_scale=e.area_scale, detections=e.detections,
                    ground_truth=e.ground_truth) for e in made]}
    with open(out_path, "wb") as f:
        pickle.dump(report, f)


def torchrun(args, out_path, timeout=300):
    """``dist_cli_worker`` under torch.distributed.run with one process:
    (its output, its report)."""
    import pickle

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "--no-python", sys.executable, "-c",
           "import sys, chip_smoke; chip_smoke.dist_cli_worker(*sys.argv[1:])", *args[:1],
           out_path, *args[1:]]
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        log(f"[torchrun] {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun {args[:1]}: exit {proc.returncode}: {proc.stderr[-2000:]}")
    with open(out_path, "rb") as f:
        return proc.stdout, pickle.load(f)


def phase_dist_cli(torch, cli_eval, nms_cuda, reset_counts, workdir):
    """train_cli on config #3 under torch.distributed.run with one process
    per card (an NCCL group of one): 8 steps, a val eval, a checkpoint;
    then its resume to step 12; K2 once per step in each; then eval_cli
    on that checkpoint the same way, its records equal to eval_cli's
    without a group."""
    import json as json_lib

    from shape_based_object_detection_torch import eval as eval_pkg

    ckpt = os.path.join(workdir, "dist_ckpt")
    common = ["--config", "config3_ssd512_voc_train", "--data-root", APP_TRAIN,
              "--log-every", "4", "--workers", "8", "--checkpoint-dir", ckpt]
    t = time.perf_counter()
    text, first = torchrun(["train", *common, "--steps", "8", "--eval-every", "8",
                            "--val-root", APP_VAL, "--val-batches", "1"],
                           os.path.join(workdir, "dist_train.pkl"))
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    text2, second = torchrun(["train", *common, "--steps", "12"],
                             os.path.join(workdir, "dist_resume.pkl"))
    second_s = time.perf_counter() - t
    ok = ("done at step 8" in text and "voc-mAP(val)=" in text
          and "restored checkpoint at step 8" in text2 and "done at step 12" in text2
          and sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())[-1] == 12)
    log(f"[dist] train_cli config #3 under torch.distributed.run --nproc_per_node 1 (NCCL): "
        f"8 steps with a val eval in {first_s:.1f} s, K2 {first['k2']}, K1 {first['k1']}; "
        f"resumed to step 12 in {second_s:.1f} s, K2 {second['k2']}; checkpoint and resume "
        f"as expected: {ok}")
    if not ok or first["k2"] != 8 or second["k2"] != 4 or first["k1"] != 1:
        raise RuntimeError(f"train_cli under torchrun: {text[-500:]} {text2[-500:]}")

    argv = ["--config", "config3_ssd512_voc_train", "--data-root", APP_VAL, "--checkpoint-dir",
            ckpt, "--max-batches", "2", "--protocol", "voc", "--set",
            "model.detect.score_threshold=0.0"]
    text, report = torchrun(["eval", *argv], os.path.join(workdir, "dist_eval.pkl"))
    reset_counts()
    with KeptEvaluators(eval_pkg) as made:
        alone = run_cli(cli_eval.main, argv)
    got, want = json_lib.loads(text[text.index("{"):]), json_lib.loads(alone[alone.index("{"):])
    (records,), (ev,) = report["records"], made
    same = records_equal(records, ev) and got == want
    log(f"[dist] eval_cli under torch.distributed.run --nproc_per_node 1: voc mAP "
        f"{got['mAP']:.6f}, K1 {report['k1']} for 2 batches; its records and metrics equal to "
        f"eval_cli's without a group: {same}")
    if not same or report["k1"] != 2:
        raise RuntimeError("eval_cli under torchrun differs from eval_cli alone")
    return {"dist_train_cli_8_steps_s": first_s, "dist_train_cli_resume_s": second_s}, {
        "dist_cli_launches": first["k2"] + second["k2"]}, {"dist_eval_cli_launches": report["k1"]}


GLOO_STEPS = 2


def gloo_rank(rank, world, store, out_path):
    """One of ``world`` ranks on one card in a gloo group (``file://``
    store): the data-parallel R50-FPN-512 step, float32 with TF32 off and
    augmentation, on its rows of the global b4; metrics to ``out_path``
    (JSON). Run as ``python3 -c "import sys, chip_smoke;
    chip_smoke.gloo_rank(*sys.argv[1:])" RANK WORLD STORE OUT``."""
    import torch
    import torch.distributed as dist

    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.parallel import Mesh

    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = Mesh(dist.group.WORLD, rank, world, torch.device("cuda", 0))
        metrics = gloo_steps(torch, config, train, build_model, mesh)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(metrics, f)


def gloo_steps(torch, config, train, build_model, mesh):
    """GLOO_STEPS steps of R50-FPN-512 (float32, TF32 off, augmentation,
    weights from seed 5) on ``mesh``'s rows of a b4 batch from seed 70
    (``mesh`` None: the whole batch in one process): their metrics."""
    cfg = train_config(config, "float32", 4, precision="highest", warmup_steps=1)
    batch = train_batch(np.random.default_rng(70), 4)
    rows = slice(None) if mesh is None else mesh.rows(4)
    module, anchors = build_model(cfg.model, device="cuda", train=True,
                                  generator=torch.Generator().manual_seed(5))
    state = train.create_train_state(module, cfg)
    step = train.make_train_step(module, anchors, cfg, mesh=mesh)
    out = []
    for _ in range(GLOO_STEPS):
        state, m = step(state, {k: v[rows] for k, v in batch.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


def phase_dist_gloo(torch, config, train, build_model, workdir):
    """Two ranks sharing the one card over gloo (NCCL refuses two ranks on
    one device): their data-parallel step on b/2 each against this
    process's step on the global b4 (R50-FPN-512 float32, TF32 off,
    augmentation): loss within 1e-5 relative, grad_norm within 1e-4. When
    gloo cannot run the collectives on CUDA tensors, that is reported and
    nothing is claimed."""
    store = os.path.join(workdir, "gloo_store")
    outs = [os.path.join(workdir, f"gloo_rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.gloo_rank(*sys.argv[1:])",
         str(r), "2", store, outs[r]], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = gloo_steps(torch, config, train, build_model, None)
    if any(p.returncode for p in procs):
        unsupported = [t for t in texts if "gloo" in t.lower() and (
            "not supported" in t.lower() or "unsupported" in t.lower())]
        if unsupported:
            log(f"[dist] gloo on CUDA tensors: not served here, nothing claimed: "
                f"{unsupported[0].strip().splitlines()[-1]}")
            return {"dist_gloo_two_ranks": "not served"}
        raise RuntimeError(f"the gloo ranks failed: {[t[-1500:] for t in texts]}")
    got = [json.load(open(o)) for o in outs]
    worst = {}
    for r in got:
        for g, w in zip(r, want):
            for k in ("loss", "grad_norm", "num_pos", "loss_cls", "loss_box"):
                worst[k] = max(worst.get(k, 0.0), abs(g[k] - w[k]) / max(abs(w[k]), 1e-12))
    ok = got[0] == got[1] and worst["loss"] <= 1e-5 and worst["grad_norm"] <= 1e-4
    log(f"[dist] two ranks on the one card over gloo, b2 each, vs one process on the global "
        f"b4 (R50-FPN-512 fp32, TF32 off, augmentation, {GLOO_STEPS} steps): ranks agree: "
        f"{got[0] == got[1]}; worst relative differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + " (bounds: loss 1e-5, grad_norm 1e-4)")
    if not ok:
        raise RuntimeError(f"gloo two-rank step differs: {worst}")
    return {f"dist_gloo_worst_rel_{k}": v for k, v in worst.items()}


# the spatial group: checked steps, then timed steps, of each run
SPATIAL_STEPS = 2
SPATIAL_TIMED = 3


def spatial_config(config, preset, batch, mp, **model_changes):
    """``preset``'s config (config #5: R101-FPN at 1024 px, focal, the
    whole-forward ``train.remat``) in float32 with TF32 off, warmup 1 so
    that step 2 moves the parameters, at global ``batch`` with a model axis
    of ``mp`` ranks."""
    cfg = config.get_config(preset)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32", precision="highest",
                                       **model_changes),
        data=dataclasses.replace(cfg.data, batch_size=batch),
        train=dataclasses.replace(cfg.train, warmup_steps=1),
        mesh=dataclasses.replace(cfg.mesh, model_parallelism=mp))


def spatial_widen(module):
    """Scores away from the 0.01 prior, so detections separate."""
    module.cls_head.predict.weight.mul_(100.0)


def spatial_run(torch, plan, mesh, device):
    """One process's part of a spatial run (``mesh`` None: the unsplit
    reference, alone): SPATIAL_STEPS train steps with cuDNN's deterministic
    algorithms (their metrics, K2 launches and peak memory), SPATIAL_TIMED
    timed steps, the halo exchanges of one forward, then detect on the
    images with its K1 launches, gathered over the data axis."""
    from shape_based_object_detection_torch import train
    from shape_based_object_detection_torch.detection import make_detect_fn, select_candidates
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching_cuda, nms_cuda
    from shape_based_object_detection_torch.parallel.mesh import all_gather_rows
    from shape_based_object_detection_torch.utils import image as image_lib

    cfg, batch = plan["cfg"], plan["batch"]
    b = cfg.data.batch_size
    rows = slice(None) if mesh is None else mesh.rows(b)
    local = {k: torch.from_numpy(v[rows]).to(device) for k, v in batch.items()}
    module, anchors = build_model(cfg.model, device=device, train=True,
                                  generator=torch.Generator().manual_seed(plan["seed"]))
    state = train.create_train_state(module, cfg, device=device)
    step = train.make_train_step(module, anchors, cfg, augment=False, device=device, mesh=mesh)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        matching_cuda.launches = 0
        metrics = []
        for _ in range(SPATIAL_STEPS):
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize(device)
        out = {"metrics": metrics, "k2": matching_cuda.launches,
               "peak": torch.cuda.max_memory_allocated(device),
               "state": {k: v.cpu() for k, v in module.state_dict().items()}
               if plan["keep_state"] else None,
               "sums": [float(v.double().sum()) for v in module.state_dict().values()]}
        times = []
        for _ in range(SPATIAL_TIMED):
            t = time.perf_counter()
            step(state, local)
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t) * 1e3)
        out["step_ms"] = times
        shard = module.row_shard
        x = image_lib.normalize_images(local["images"]).permute(0, 3, 1, 2)
        if shard is not None:
            shard.reset_counts()
            with torch.no_grad():
                module(shard.split(x))
            out["halo"] = (shard.exchanges, shard.halo_bytes, shard.moved_bytes)
        del module, state, step
        dcfg = plan["detect_cfg"]
        module, anchors = build_model(dcfg.model, device=device,
                                      generator=torch.Generator().manual_seed(plan["seed"]))
        with torch.no_grad():
            spatial_widen(module)
        detect = make_detect_fn(module, anchors, dcfg.model, dcfg.data, device, mesh)
        images = torch.from_numpy(plan["images"][rows]).to(device)
        nms_cuda.launches = 0
        det = detect(images)
        torch.cuda.synchronize(device)
        out["k1"] = nms_cuda.launches
        if mesh is not None:
            det = all_gather_rows(det, mesh)
        out["det"] = [t.cpu() for t in det]
        with torch.inference_mode():
            x = image_lib.normalize_images(images).permute(0, 3, 1, 2)
            shard = module.row_shard
            out["cands"] = [t.cpu() for t in select_candidates(
                *module(x if shard is None else shard.split(x)), anchors, dcfg.model)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def spatial_rank(rank, world, backend, store, plan_path, out_path):
    """One of ``world`` ranks of a spatial run: gloo with every rank on
    card 0 (NCCL refuses two ranks on one card), or NCCL with rank r on
    card r; ``spatial_run`` on the plan's mesh, its results to
    ``out_path`` (torch.save). Run as ``python3 -c "import sys, chip_smoke;
    chip_smoke.spatial_rank(*sys.argv[1:])" RANK WORLD BACKEND STORE PLAN
    OUT``."""
    import torch
    import torch.distributed as dist

    from shape_based_object_detection_torch.parallel import make_mesh

    rank, world = int(rank), int(world)
    plan = torch.load(plan_path, weights_only=False)
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, **kw)
    try:
        mesh = make_mesh(device, plan["cfg"].mesh)
        out = spatial_run(torch, dict(plan, keep_state=plan["keep_state"] and rank == 0),
                          mesh, device)
        out["layout"] = (mesh.data_index, mesh.model_index, mesh.data_size,
                         mesh.data_group is not None)
    finally:
        dist.destroy_process_group()
    torch.save(out, out_path)


def spatial_ranks(plan, world, backend, workdir, tag):
    """``world`` ``spatial_rank`` processes on ``plan``: their results in
    rank order. A rank that fails, or runs past 600 s, fails the run."""
    import torch

    plan_path = os.path.join(workdir, f"{tag}_plan.pt")
    torch.save(plan, plan_path)
    store = os.path.join(workdir, f"{tag}_store")
    outs = [os.path.join(workdir, f"{tag}_rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.spatial_rank(*sys.argv[1:])",
         str(r), str(world), backend, store, plan_path, outs[r]], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode:
            raise RuntimeError(f"{tag}: {backend} rank {r} exited {p.returncode}: "
                               f"{text[-3000:]}")
    return [torch.load(o, weights_only=False) for o in outs]


def spatial_compare(torch, split, alone, name, backend, check_state=True):
    """The split ranks against the unsplit process: loss within 1e-5
    relative, grad_norm 1e-4, the parameters after the steps within 2e-5,
    every rank's parameters alike, the gathered detections at the
    reference's bounds (valid and labels equal, scores rtol 1e-5 atol 1e-7,
    boxes rtol 1e-5 atol 1e-6). Logs each rank's peak memory and step time
    beside the unsplit process's. Returns the worst differences."""
    worst = {}
    for r in split:
        for g, w in zip(r["metrics"], alone["metrics"]):
            for k in ("loss", "grad_norm", "num_pos", "loss_cls", "loss_box"):
                worst[k] = max(worst.get(k, 0.0), abs(g[k] - w[k]) / max(abs(w[k]), 1e-12))
    state = split[0]["state"]
    worst["params"] = (max(float((state[k] - v).abs().max()) for k, v in alone["state"].items())
                       if check_state else None)
    alike = all(r["sums"] == split[0]["sums"] for r in split)
    det_ok = True
    for r in split:
        g, w = r["det"], alone["det"]
        det_ok &= (torch.equal(g[3], w[3]) and torch.equal(g[2], w[2])
                   and bool(torch.isclose(g[1], w[1], rtol=1e-5, atol=1e-7).all())
                   and bool(torch.isclose(g[0], w[0], rtol=1e-5, atol=1e-6).all()))
    n_det = int(alone["det"][3].sum())
    smi = nvidia_smi_line()
    peaks = ", ".join(f"rank {i} {r['peak'] / 2**30:.3f} GiB" for i, r in enumerate(split))
    times = ", ".join(f"rank {i} {float(np.median(r['step_ms'])):.1f}"
                      for i, r in enumerate(split))
    log(f"[spatial] {name} over {backend}: {len(split)} ranks (data index, model index, "
        f"data size, data group): {[r['layout'] for r in split]}; {SPATIAL_STEPS} steps vs "
        f"one process on the global batch: worst relative differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items() if k != "params")
        + (f", parameters max |err| {worst['params']:.2e}" if check_state else "")
        + f" (bounds: loss 1e-5, grad_norm 1e-4, parameters 2e-5); ranks alike: {alike}; "
        f"detect ({n_det} detections, threshold 0) equal at the reference's bounds: {det_ok}; "
        f"K2 launches {[r['k2'] for r in split]} in {SPATIAL_STEPS} steps, K1 "
        f"{[r['k1'] for r in split]} in one detect")
    log(f"[spatial] {name} peak memory (torch.cuda.max_memory_allocated over the checked "
        f"steps): {peaks}; unsplit {alone['peak'] / 2**30:.3f} GiB ({smi})")
    log(f"[spatial] {name} step ms (host clock to a synchronize, median of {SPATIAL_TIMED}; "
        f"{backend}{' through the host, not NCCL' if backend == 'gloo' else ''}): {times}; "
        f"unsplit {float(np.median(alone['step_ms'])):.1f} ({smi})")
    images = alone["det"][0].shape[0] // split[0]["layout"][2]
    log(f"[spatial] {name} halo exchanges in one forward of a data index's {images} images: "
        + ", ".join(f"rank {i} {r['halo'][0]} exchanges, {r['halo'][1]} bytes of "
                    f"neighbours' rows received, {r['halo'][2]} bytes brought in by the "
                    f"all-gathers" for i, r in enumerate(split)))
    ok = (worst["loss"] <= 1e-5 and worst["grad_norm"] <= 1e-4 and alike and det_ok
          and (not check_state or worst["params"] <= 2e-5)
          and all(r["k2"] == SPATIAL_STEPS and r["k1"] == 1 for r in split)
          and n_det > 0)
    if not ok:
        raise RuntimeError(f"{name}: the split run differs from the unsplit one: {worst}, "
                           f"alike {alike}, detect {det_ok}")
    return worst


def phase_spatial(torch, config, nms, nms_cuda, matching, matching_cuda, workdir):
    """The model axis (image rows split across ranks) on the card: config
    #5's model (R101-FPN, 1024 px, float32 with TF32 off, focal, the
    whole-forward train.remat) on 1 data x 2 model ranks over gloo sharing
    the card, b2: its train steps and detect against one process's; where
    the machine has two or more cards the same over NCCL; then 2 data x 2
    model ranks (R50-FPN-512, b4); K1 and K2 bit-equal to their plain
    versions on this path's candidates and GT, and their times there."""
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model
    from tests.torch_kernel_cases import match_check

    out, k1, k2 = {}, {}, {}
    cfg5 = spatial_config(config, "config5_multihost_dp_train", 2, 2)
    plan = {"cfg": cfg5, "seed": 9, "keep_state": True,
            "batch": train_batch(np.random.default_rng(90), 2, size=1024, g=100),
            "images": np.random.default_rng(91).integers(0, 256, (2, 1024, 1024, 3),
                                                           dtype=np.uint8),
            "detect_cfg": dataclasses.replace(cfg5, model=dataclasses.replace(
                cfg5.model, detect=dataclasses.replace(cfg5.model.detect,
                                                       score_threshold=0.0)))}
    t = time.perf_counter()
    alone = spatial_run(torch, plan, None, torch.device("cuda", 0))
    torch.cuda.empty_cache()
    log(f"[spatial] config #5 (R101-FPN 1024 px fp32, TF32 off, train.remat, focal, b2) in one "
        f"process: loss {alone['metrics'][-1]['loss']:.6f}, {time.perf_counter() - t:.1f} s")
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    if len(backends) == 1:
        log(f"[spatial] NCCL: not run, the machine has {torch.cuda.device_count()} card "
            "(NCCL takes one rank per card)")
    for backend in backends:
        t = time.perf_counter()
        split = spatial_ranks(plan, 2, backend, workdir, f"spatial_{backend}")
        worst = spatial_compare(torch, split, alone, "config #5 on 1 data x 2 model", backend)
        log(f"[spatial] the {backend} run took {time.perf_counter() - t:.1f} s")
        out.update({f"spatial_{backend}_worst_rel_{k}": v for k, v in worst.items()})
        out.update({f"spatial_{backend}_rank{i}_peak_bytes": r["peak"]
                    for i, r in enumerate(split)})
        out.update({f"spatial_{backend}_step_ms": float(np.median(split[0]["step_ms"]))})
        if backend == "gloo":
            gloo = split
    out.update({"spatial_unsplit_peak_bytes": alone["peak"],
                "spatial_unsplit_step_ms": float(np.median(alone["step_ms"])),
                "spatial_halo_exchanges_per_forward": gloo[0]["halo"][0],
                "spatial_halo_bytes_per_forward": [r["halo"][1] for r in gloo]})
    k1["spatial_launches"] = sum(r["k1"] for r in gloo)
    k2["spatial_launches"] = sum(r["k2"] for r in gloo)

    # K1 on rank 0's candidates (the gathered outputs' selection), K2 on the
    # step's GT against config #5's 196,416 anchors: bit-equal, and timed
    cands = [c.cuda() for c in gloo[0]["cands"]]
    k1["spatial_max_abs_err"] = k1_on(torch, nms, cands, cfg5.model.detect,
                                      "the split detect's candidates (config #5, rank 0)")
    k1.update({f"spatial_{k}": v for k, v in nms_timing(
        nms, nms_cuda, cands, cfg5.model.detect, "the split detect's candidates").items()})
    anchors = anchors_for_model(cfg5.model).cuda()
    gt, lbl, ok = (torch.from_numpy(plan["batch"][k]).cuda() for k in ("boxes", "labels",
                                                                          "valid"))
    passed, err, line = match_check(anchors, gt, lbl, ok, cfg5.match.shape_weight,
                                    cfg5.model.anchors.variances, cfg=cfg5.match, exact=True)
    log(f"[kernel] match_anchors on the split step's GT (config #5, (B, A, G) = (2, "
        f"{anchors.shape[0]}, 100)): {line}")
    if not passed:
        raise RuntimeError("match_anchors differs from the plain version on config #5's GT")
    k2["spatial_max_abs_err"] = err
    k2.update({f"spatial_{k}": v for k, v in match_timing(
        torch, matching, matching_cuda, anchors, cfg5, "config #5's split step", gt, lbl,
        ok).items()})
    del alone, gloo, cands
    torch.cuda.empty_cache()

    # the 2-D mesh: 2 data x 2 model ranks, R50-FPN-512, b4
    cfg2d = spatial_config(config, "config4_retinanet_r101_coco_train", 4, 2,
                           backbone="resnet50", name="retinanet_r50_fpn", image_size=512)
    plan = {"cfg": cfg2d, "seed": 10, "keep_state": True,
            "batch": train_batch(np.random.default_rng(92), 4),
            "images": np.random.default_rng(93).integers(0, 256, (4, 512, 512, 3),
                                                           dtype=np.uint8),
            "detect_cfg": dataclasses.replace(cfg2d, model=dataclasses.replace(
                cfg2d.model, detect=dataclasses.replace(cfg2d.model.detect,
                                                        score_threshold=0.0)))}
    alone = spatial_run(torch, plan, None, torch.device("cuda", 0))
    torch.cuda.empty_cache()
    split = spatial_ranks(plan, 4, "gloo", workdir, "spatial_2d")
    worst = spatial_compare(torch, split, alone, "R50-FPN-512 on 2 data x 2 model", "gloo")
    if not all(r["layout"][2] == 2 and r["layout"][3] for r in split):
        raise RuntimeError(f"the 2-D mesh's data axis: {[r['layout'] for r in split]}")
    out.update({f"spatial_2d_worst_rel_{k}": v for k, v in worst.items()})
    k1["spatial_2d_launches"] = sum(r["k1"] for r in split)
    k2["spatial_2d_launches"] = sum(r["k2"] for r in split)
    return out, k1, k2


def host_average(snaps):
    """The float leaves of checkpoint snapshots (oldest first) averaged with
    numpy in float32, ``0 + l0 + l1 + ...`` divided by the count: what the
    averaged checkpoint is held to. {part: {name: array}}."""
    out = {}
    for part in ("params", "buffers", "ema"):
        if snaps[-1][part] is None:
            continue
        out[part] = {}
        for k, t in snaps[-1][part].items():
            if t.is_floating_point():
                if t.dtype.itemsize != 4:
                    raise RuntimeError(f"{part} {k} is {t.dtype}: the check averages float32")
                acc = 0
                for snap in snaps:
                    acc = acc + snap[part][k].numpy()
                out[part][k] = acc / np.float32(len(snaps))
    return out


EXAMPLES = {  # module: (arguments, lines its output must hold)
    "demo": ([], ("overfitting 150 steps", "  step 0: loss ", "voc mAP@0.5: ",
                  "demo_0.png", "demo_1.png")),
    "serving_quickstart": ([], ("predictor  image 0: ", "submit/poll: ", "quantized  : ",
                                "full-int8  : ", "artifact   : ", "output boxes (2, 100, 4)")),
}


def phase_tools(torch, cli_train, cli_eval, nms_cuda, matching_cuda, reset_counts, workdir):
    """The checkpoint tools and the examples on the card: a config #3
    train_cli run (SSD-512 b32 fp32, 3 steps, a checkpoint each) averaged by
    tools/average_checkpoints over its last 3 and held bit for bit to a
    numpy average of the same snapshots; eval_cli on the average (K1 once
    per batch); export_model --checkpoint-dir on it and the artifact run
    once (K1 once); a one-step train_cli resume from it (K2 once);
    tools/convert_checkpoint --mode vgg_backbone on a full-width synthetic
    torchvision VGG-16, then 2 train_cli steps from the file with
    --init-params (K2 twice); both examples as subprocesses, each exiting 0
    with its lines. Returns (results, K1 rows, K2 rows)."""
    import subprocess

    from shape_based_object_detection_torch.checkpoint import CheckpointManager
    from shape_based_object_detection_torch.export import load_artifact
    from shape_based_object_detection_torch.tools import (
        average_checkpoints, convert_checkpoint, export_model,
    )
    from tests.torch_kernel_cases import torchvision_vgg16

    out, k1, k2, secs = {}, {}, {}, {}
    config3 = ["--config", "config3_ssd512_voc_train"]
    train = [*config3, "--data-root", APP_TRAIN, "--workers", "8", "--log-every", "1"]
    run, avg = os.path.join(workdir, "tools_run"), os.path.join(workdir, "tools_avg")

    t = time.perf_counter()
    run_cli(cli_train.main, [*train, "--steps", "3", "--set", "train.checkpoint_every=1",
                             "--checkpoint-dir", run])
    secs["train_3_steps"] = time.perf_counter() - t
    steps = CheckpointManager(run).all_steps()
    if steps != [1, 2, 3]:
        raise RuntimeError(f"the config #3 run kept checkpoints {steps}, not [1, 2, 3]")
    t = time.perf_counter()
    run_cli(average_checkpoints.main, [*config3, "--checkpoint-dir", run, "--last", "3",
                                       "--out", avg])
    secs["average"] = time.perf_counter() - t
    snaps = [CheckpointManager(run).read(step) for step in steps]
    got = CheckpointManager(avg).read(3)
    want = host_average(snaps)
    differ = [f"{part} {k}" for part, leaves in want.items() for k, v in leaves.items()
              if not np.array_equal(got[part][k].numpy().view(np.int32), v.view(np.int32))]
    newest = snaps[-1]["opt"]
    opt_same = all(torch.equal(got["opt"][key][k], v) for key in ("trace", "mu", "nu", "acc")
                   if newest[key] is not None for k, v in newest[key].items())
    leaves = sum(len(v) for v in want.values())
    log(f"[tools] average_checkpoints over steps {steps} of config #3 ({leaves} float leaves, "
        f"{sum(v.size for v in want['params'].values())} parameters; EMA "
        f"{'averaged' if 'ema' in want else 'absent'}): bit-equal to the numpy float32 "
        f"average={not differ}, the optimizer state the newest's={opt_same}, step "
        f"{got['step']}")
    if differ or not opt_same or got["step"] != 3:
        raise RuntimeError(f"the averaged checkpoint differs from the host average: {differ[:5]}")
    del snaps, got

    reset_counts()
    t = time.perf_counter()
    text = run_cli(cli_eval.main, [*config3, "--data-root", APP_VAL, "--checkpoint-dir", avg,
                                   "--set", "model.detect.score_threshold=0.0"])
    torch.cuda.synchronize()
    secs["eval_cli"] = time.perf_counter() - t
    k1["tools_eval_launches"] = nms_cuda.launches
    if nms_cuda.launches != 2 or "mAP" not in text:
        raise RuntimeError(f"eval_cli on the averaged checkpoint launched K1 "
                           f"{nms_cuda.launches} times for 2 batches: {text[-300:]}")

    artifact = os.path.join(workdir, "tools_avg.sbdx")
    t = time.perf_counter()
    run_cli(export_model.main, [*config3, "--checkpoint-dir", avg, "--batch-size", "2",
                                "--out", artifact])
    secs["export"] = time.perf_counter() - t
    loaded = load_artifact(artifact)
    reset_counts()
    det = loaded(np.zeros((2, 512, 512, 3), np.uint8))
    torch.cuda.synchronize()
    k1["tools_artifact_launches"] = nms_cuda.launches
    if nms_cuda.launches != 1 or tuple(det.boxes.shape) != (2, 200, 4):
        raise RuntimeError(f"the averaged checkpoint's artifact launched K1 "
                           f"{nms_cuda.launches} times, boxes {tuple(det.boxes.shape)}")
    del loaded

    reset_counts()
    t = time.perf_counter()
    text = run_cli(cli_train.main, [*train, "--steps", "4", "--checkpoint-dir", avg])
    torch.cuda.synchronize()
    secs["resume_1_step"] = time.perf_counter() - t
    k2["tools_resume_launches"] = matching_cuda.launches
    if (matching_cuda.launches != 1 or "restored checkpoint at step 3" not in text
            or "done at step 4" not in text):
        raise RuntimeError(f"train_cli did not resume from the average for one step: "
                           f"{text[-300:]}")

    t = time.perf_counter()
    vgg = torchvision_vgg16(np.random.default_rng(31))
    with torch.no_grad():
        for key, v in vgg.items():  # lecun-normal, as trained weights are scaled
            if key.endswith("weight"):
                v.mul_(1.0 / np.sqrt(v[0].numel()))
    vgg_path, init = os.path.join(workdir, "vgg16.pth"), os.path.join(workdir, "vgg_init.pt")
    torch.save(vgg, vgg_path)
    secs["write_vgg16"] = time.perf_counter() - t
    t = time.perf_counter()
    run_cli(convert_checkpoint.main, ["--model", "config3_ssd512_voc_train", "--torch-ckpt",
                                      vgg_path, "--mode", "vgg_backbone", "--out", init])
    secs["convert"] = time.perf_counter() - t
    conv = torch.load(init, weights_only=True)
    fc6 = vgg["classifier.0.weight"].reshape(4096, 512, 7, 7)[::4, :, ::3, ::3]
    merged = (torch.equal(conv["vgg.conv1_1.weight"], vgg["features.0.weight"])
              and torch.equal(conv["vgg.conv6.weight"], fc6))
    n_vgg = sum(v.numel() for v in vgg.values())
    del vgg, conv, fc6
    reset_counts()
    t = time.perf_counter()
    text = run_cli(cli_train.main, [*train, "--steps", "2", "--init-params", init,
                                    "--checkpoint-dir", os.path.join(workdir, "tools_init")])
    torch.cuda.synchronize()
    secs["init_params_2_steps"] = time.perf_counter() - t
    k2["tools_init_params_launches"] = matching_cuda.launches
    log(f"[tools] convert_checkpoint --mode vgg_backbone: a synthetic torchvision VGG-16 of "
        f"{n_vgg} parameters ({os.path.getsize(vgg_path)} bytes) into config #3's SSD-512 "
        f"({os.path.getsize(init)} bytes written), conv1_1 and the decimated conv6 "
        f"equal={merged}; train_cli --init-params: K2 launches {matching_cuda.launches} "
        f"in 2 steps")
    if (not merged or matching_cuda.launches != 2 or "initialized params from" not in text
            or "done at step 2" not in text):
        raise RuntimeError(f"the converted VGG-16 did not train 2 steps: {text[-300:]}")

    for name, (args, expect) in EXAMPLES.items():
        folder = os.path.join(workdir, f"example_{name}")
        os.makedirs(folder)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"shape_based_object_detection_torch.examples.{name}",
             *args, *(["--out", folder] if name == "demo" else [])],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        secs[f"example_{name}"] = time.perf_counter() - t
        missing = [e for e in expect if e not in proc.stdout]
        for line in proc.stdout.splitlines():
            log(f"[{name}] {line}")
        if proc.returncode != 0 or missing:
            raise RuntimeError(f"example {name} exited {proc.returncode}, missing {missing}: "
                               f"{proc.stderr[-2000:]}")
    log(f"[tools] seconds per part ({nvidia_smi_line()}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    out.update({f"tools_{k}_s": v for k, v in secs.items()})
    return out, k1, k2


PHASES = ("base", "bn", "pipelined", "app", "ckpt", "loader", "serve", "int8", "data", "dist",
          "spatial",
          "tools")


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default="",
                        help=f"run only these comma-separated phase groups of {PHASES} "
                             "(a partial run prints no result line)")
    args = parser.parse_args()
    only = set(args.only.split(",")) - {""}
    if only - set(PHASES):
        parser.error(f"unknown phase groups {sorted(only - set(PHASES))}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    adopt_orphans()
    sys.path.insert(0, ROOT)
    from shape_based_object_detection_torch.utils import image as image_lib
    from shape_based_object_detection_torch.utils import native

    def want(group):
        return not only or group in only

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    t = time.perf_counter()
    libs = KERNELS + ("ap_matcher",)
    with ThreadPoolExecutor(len(libs) + 1) as pool:  # one compiler per source
        # the JPEG decoder is built as DataConfig's "auto" resolves it: where
        # it does not build (no libjpeg), "auto" is PIL and the reason shows
        decoder = pool.submit(image_lib.effective_decode_backend, "auto")
        list(pool.map(native.build, libs))
        backend = decoder.result()
    for name in libs:
        native.load(name)
    log(f"[build] {', '.join(k + '.cu' for k in KERNELS)} (nvcc) and "
        f"{', '.join(k + '.cpp' for k in HOST_LIBRARIES)} (g++) built in parallel and "
        f"loaded in {time.perf_counter() - t:.2f} s; the host JPEG decode backend 'auto' is "
        + (repr(backend) if backend == "native"
           else f"{backend!r} ({image_lib.AUTO_BACKEND_REASON})"))
    workdir = os.path.join(ROOT, "tmp", "smoke_work")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        kernels = run_phases(torch, want, only, t0, workdir)
    finally:
        t = time.perf_counter()
        stop_children()
        shutil.rmtree(workdir, ignore_errors=True)
        log(f"[procs] every process this run started has ended (checked and reaped in "
            f"{time.perf_counter() - t:.2f} s)")
    if kernels is None:
        return 0
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(torch, want, only, t0, workdir):
    """The phase groups in order: the kernels' entries of the result, None
    for a partial run."""
    from shape_based_object_detection_torch import config, detection, serving, train
    from shape_based_object_detection_torch.cli import eval_cli as cli_eval
    from shape_based_object_detection_torch.cli import train_cli as cli_train
    from shape_based_object_detection_torch.data.augment import augment_batch
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching, matching_cuda, nms, nms_cuda
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model

    def reset_counts():
        """Every kernel's launch count to 0, just before a path is driven."""
        nms_cuda.launches = 0
        matching_cuda.launches = 0

    results, k1, k2 = {}, {}, {}
    if want("base"):
        nms_err, walk_rows = phase_kernel(torch, nms, nms_cuda)
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

        # the SSD family: config #3's matching, then SSD300 serving, then
        # SSD-512 training, remat, and trainable BatchNorm on R50-FPN-512
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
            ssd_train_timing["ssd512_train_b32_fp32_step_median_ms"],
            "ssd512_train_b32_fp32"))
        state, _, module, anchors, ssd_cfg, batch, _ = ssd_trained
        del ssd_trained, state
        ssd_train_timing.update(phase_remat(torch, train, build_model, module, anchors,
                                            ssd_cfg, batch))
        del module, batch
        torch.cuda.empty_cache()
        phase_train_bn(torch, config, train, build_model)
        results.update({**e2e, **{k: v for k, v in timing.items() if k != "nms"},
                        **{k: v for k, v in train_timing.items() if k != "match"},
                        **{k: v for k, v in ssd_timing.items() if k != "nms"},
                        **{k: v for k, v in ssd_train_timing.items() if k != "match"}})
        ssd_nms, ssd_match = ssd_timing["nms"], ssd_train_timing["match"]
        k1.update({
            "launches": nms_launches,  # the serving path's
            "bit_equal": True,  # phase_kernel raises on any differing bit
            "max_abs_err": nms_err,
            **timing["nms"],
            "library_ms": None,
            # the SSD300 serving path's launches, and K1 at (16, 400, 200) there
            "ssd_launches": ssd_nms_launches,
            "ssd_max_abs_err": ssd_nms["max_abs_err"],
            **{f"ssd_{k}": v for k, v in ssd_nms.items() if k != "max_abs_err"},
            # the walk route (N > 4096) at (1, 4097, 100), (4, 8192, 100) and
            # (1, 20000, 100): times, bound, peak allocation of one call
            **walk_rows})
        k2.update({
            "launches": match_launches,  # the training path's
            "bit_equal": True,  # assignments; phase_match_kernel raises otherwise
            "max_abs_err": match_err,
            **train_timing["match"],
            "library_ms": None,
            # the SSD-512 trainer's launches, and K2 at (32, 24564, 100) with
            # shape_weight 0.3 there
            "ssd_launches": ssd_match_launches,
            "ssd_max_abs_err": ssd_match_err,
            **{f"ssd_{k}": v for k, v in ssd_match.items()}})

    # the training application
    if want("bn"):
        results.update(phase_bn_repair(torch, config, train, build_model, make_detect_fn))
    if want("pipelined"):
        results.update(phase_pipelined(
            torch, train, build_model, matching_cuda, train_config(config, "bfloat16", 16),
            [train_batch(np.random.default_rng(30 + i), 16) for i in range(4)],
            "r50_b16_bf16"))
        results.update(phase_pipelined(
            torch, train, build_model, matching_cuda, ssd_train_config(config, 32),
            [train_batch(np.random.default_rng(40 + i), 32, g=100, classes=20)
             for i in range(4)], "ssd512_b32_fp32"))
    if want("app"):
        ckpt, cli_k1, cli_k2, app = phase_app(torch, train, cli_train, nms_cuda,
                                              matching_cuda, reset_counts, workdir)
        results.update(app)
        phase_preempt(torch, cli_train, workdir)
        eval_k1, eval_launches, config2_launches, ev = phase_eval(
            torch, config, train, build_model, cli_train, cli_eval, nms, nms_cuda, detection,
            reset_counts, ckpt)
        results.update(ev)
        cli_match = phase_cli_match_timing(torch, config, matching, matching_cuda, cli_train)
        # K1 once per eval batch in train_cli and eval_cli; its time and bound
        # at (32, 400, 200) on config #3's eval candidates
        k1.update({"cli_launches": cli_k1, "cli_eval_launches": eval_launches,
                   "cli_eval_config2_launches": config2_launches,
                   "cli_max_abs_err": eval_k1.pop("max_abs_err"),
                   **{f"cli_{k}": v for k, v in eval_k1.items()}})
        # K2 once per train_cli step; its time and bound on the CLI's batch
        k2.update({"cli_launches": cli_k2, "cli_max_abs_err": cli_match.pop("max_abs_err"),
                   **{f"cli_{k}": v for k, v in cli_match.items()}})
    if want("ckpt"):
        results.update(phase_ckpt_round_trip(torch, config, train, build_model, workdir))
    if want("loader"):
        results.update(phase_loader(torch))
    # the float serving tier: TTA, the NMS variants, the server and its CLIs
    if want("serve"):
        from shape_based_object_detection_torch.cli import detect_cli as cli_detect

        serve_out, serve_k1 = phase_serve_nms(torch, config, build_model, detection, nms,
                                              nms_cuda, reset_counts)
        results.update(serve_out)
        large_out, large_k1 = phase_serve_large_merges(torch, config, build_model, detection,
                                                       nms, nms_cuda, reset_counts)
        results.update(large_out)
        serve_k1.update(large_k1)
        ms_out, ms_k1 = phase_serve_multiscale(torch, config, build_model, serving, nms,
                                               nms_cuda, reset_counts)
        results.update(ms_out)
        serve_k1.update(ms_k1)
        server_out, serve_launches = phase_server(torch, config, serving, nms_cuda,
                                                  reset_counts, workdir)
        results.update(server_out)
        clis = phase_serve_clis(torch, cli_detect, nms_cuda, reset_counts, workdir)
        results.update(clis)
        # K1 once per TTA batch, S + 1 per multi-scale batch, once per served
        # batch; its time and bound on the hflip and 2-scale merges
        k1.update({**serve_k1, "serve_launches": serve_launches,
                   "detect_cli_launches": clis["detect_cli_launches"]})
    # the int8 serving tiers and the exported artifact
    if want("int8"):
        int8_out, int8_k1 = phase_int8(torch, config, serving, detection, build_model,
                                       nms_cuda, reset_counts, workdir)
        results.update(int8_out)
        # K1 once per batch in every tier, 3 per 2-scale int8 batch, once per
        # artifact call
        k1.update(int8_k1)
    # the input pipelines: the cache, the card-staged cache, worker processes
    if want("data"):
        results.update(phase_data(torch, train, cli_train, matching_cuda, reset_counts,
                                  workdir))
    # data parallelism: NCCL groups of one, torchrun, two ranks over gloo
    if want("dist"):
        dist_out, dist_k1, dist_k2 = phase_dist_nccl(torch, config, train, build_model,
                                                     matching_cuda, nms_cuda, nms, detection,
                                                     reset_counts)
        results.update(dist_out)
        cli_out, cli_k2, cli_k1 = phase_dist_cli(torch, cli_eval, nms_cuda, reset_counts,
                                                 workdir)
        results.update(cli_out)
        results.update(phase_dist_gloo(torch, config, train, build_model, workdir))
        # K2 once per data-parallel step and K1 once per sharded eval batch
        k1.update({**dist_k1, **cli_k1})
        k2.update({**dist_k2, **cli_k2})
    # the model axis: image rows split across ranks (config #5, and 2 x 2)
    if want("spatial"):
        spatial_out, spatial_k1, spatial_k2 = phase_spatial(
            torch, config, nms, nms_cuda, matching, matching_cuda, workdir)
        results.update(spatial_out)
        k1.update(spatial_k1)
        k2.update(spatial_k2)

    # the checkpoint tools and the examples
    if want("tools"):
        tools_out, tools_k1, tools_k2 = phase_tools(torch, cli_train, cli_eval, nms_cuda,
                                                    matching_cuda, reset_counts, workdir)
        results.update(tools_out)
        k1.update(tools_k1)
        k2.update(tools_k2)

    log(json.dumps(results))
    if only:
        log(f"[partial] phase groups {sorted(only)} passed in "
            f"{time.perf_counter() - t0:.1f} s; no result line for a partial run")
        return None
    kernels = [{
        "name": "nms_greedy",
        "route": "cuda",
        "source": "shape_based_object_detection_torch/csrc/nms_greedy.cu",
        "replaces": "shape_based_object_detection_tpu/ops/nms_pallas.py:33",
        **k1,
    }, {
        "name": "match_anchors",
        "route": "cuda",
        "source": "shape_based_object_detection_torch/csrc/match_anchors.cu",
        "replaces": "shape_based_object_detection_tpu/ops/matching_pallas.py:72",
        **k2,
    }]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
