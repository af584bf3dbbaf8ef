"""On-card check of the PyTorch port on one NVIDIA GPU (Hopper).

Drives the port's paths at full width with random weights from a seed and
holds each against the CPU or the kernels' plain versions: the RetinaNet
serving path (R50-FPN at 512 px through ``serving.Predictor``) and
training path (the same model's ``train.make_train_step`` in bf16 at batch
16 with augmentation), then the SSD serving path (SSD300, config #1) and
training path (SSD-512, config #3, shape matching), remat and trainable
BatchNorm. Every check raises on a mismatch. Beside the checks it times
the hand-written kernels alone (K1, K2 and K3, and the int8 product's
stages) on the paths' own inputs, beside their bounds and their plain
versions; the port's end-to-end numbers are the benchmark's
(``benchmark/run.py``), and none is taken here. The groups:

  1. device and build: the card, its power limit, the CUDA kernels built
     from ``shape_based_object_detection_torch/csrc`` (one nvcc per source,
     all started together);
  2. kernel vs plain: the greedy-NMS kernel (K1) against
     ``ops.nms.greedy_nms`` on the card at (B, N, M) = (16, 1000, 100),
     (16, 400, 200) and (8, 2000, 100), with class-offset boxes, padding
     rows and tied scores, and on the walk route above 4096 candidates per
     image at (1, 4097, 100), (4, 8192, 100) and (1, 20000, 100); idx,
     valid and the score bits must be equal, one launch each; each shape
     with its route, scratch bytes and measured peak allocation, and the
     walk shapes timed (the edge cases of ``tests/torch_kernel_cases.py``
     are the card tests');
  3. forward on the card vs the CPU, float32 with TF32 off, one image, the
     same weights; then detect end to end on both, matched detection by
     detection;
  4. the serving path: a bf16 Predictor at batch 16 answers requests of
     16, 5 and 1 images of differing sizes; K1 must have launched once per
     batch and K3 49 times a batch, and run_nms through the kernel must
     equal the plain version on the same candidates;
  5. K1's time on the serving path's candidates at batch 16 (CUDA events
     between back-to-back wrapper calls, and the device time of its kernels
     under torch.profiler) beside its bound and the plain version's time,
     and its device time on random scores of that shape;
  6. the matching kernel (K2) against ``ops.matching.match_reductions_plain``
     at (B, A, G) = (16, 49104, 64) (every GT the same box, 8 of 64 valid:
     all ties), (16, 49104, 100) (random boxes, invalid rows, an image with
     no valid GT, duplicate GTs) and (4, 76725, 100) with shape_weight 0.3;
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
  9. K2's time (CUDA events and profiler device time, as for K1) on that
     trainer's batch augmented as its step augments it and on
     bench_train.py's batch, beside its bound and the plain version's time;
 10. K2 on config #3's path: an augmented batch of 32 at (B, A, G) = (32,
     24564, 100), shape_weight 0.3, VOC labels, 1-100 valid boxes per
     image; assignments and best_q bit-equal, the MatchResult under config
     #3's thresholds equal after the epilogue;
 11. the SSD300 forward (COCO, full width) on the card vs the CPU, float32
     with TF32 off, then detect on both, matched detection by detection;
 12. the SSD300 serving path: config #1's Predictor (batch 1) answers
     requests of 1 and 3 images, a bf16 batch-16 Predictor one of 16; K1
     once per batch; K1 against the plain version on the candidates of the
     bf16 b16 detect (bit-equal, one launch), with their count, and K1's
     time at (16, 400, 200) on them;
 13. two float32 SSD-512 train steps of config #3 card vs CPU (TF32 off,
     augment off, batch 2), with group 7's tolerances;
 14. the SSD-512 trainer as config #3 sets it (float32, b32, augmentation,
     100 boxes, multibox with 3:1 mining, shape_weight 0.3): K2 once per
     step, parameters still at step 1 and moved at step 2; K2's time and
     bound on its augmented batch;
 15. remat: the SSD-512 b32 step with model.remat on and off, same weights
     and batch: loss and grad_norm within 1e-5, and both peaks of
     torch.cuda.max_memory_allocated;
 16. trainable BatchNorm: two float32 R50-FPN-512 steps with train_bn at b2
     card vs CPU (group 7's tolerances; the update's held to the CPU's own
     float32 spread; running statistics within 1e-5 + 1e-5*|cpu|),
     and a bf16 b16 step with train_bn and remat whose running statistics
     equal the same step's without remat (updated once).

The group ``k3`` holds the frozen BatchNorm kernel (K3) bit for bit
against the plain composition on its edge cases and at each of the 49
launches of a b16 Predictor's detect forward (bf16 and float32), and times
those launches per shape and as one CUDA graph beside their bound. The
groups after it drive the training application (``bn``, ``pipelined``,
``app``, ``ckpt``, ``loader``), the float serving tier (``serve``) and the
int8 tiers with the exported artifact (``int8``):

 17. the R50-512 backbone's bf16 forward with its frozen BatchNorm as the
     plain layers, card vs CPU against the CPU's float32 one; the pipelined
     step against the plain step (R50 bf16 b16, SSD-512 b32): losses
     within 1e-6, K2 once per step;
 18. train_cli on config #3 (K1 and K2 counts), a SIGTERM'd subprocess and
     its resume, eval_cli (VOC and COCO) with its Evaluator's records equal
     to make_eval_step's, the C++ and numpy matchers, eval_cli on config #2,
     K1 and K2 on the CLI's batches bit-equal and timed; checkpoint round
     trips bit-equal; Loader.device_batches bit-equal and pinned;
 19. hflip TTA detect on R50-FPN-512 card vs CPU (float32, TF32 off, b1,
     matched detection by detection); K1 bit-equal to its plain version on
     the hflip merge at (16, 2000, 100), whose candidates arrive unsorted,
     on the 2-scale (512, 640) merge at (16, 200, 100) and on SSD300's hflip
     merge at (1, 800, 200); K1 once per TTA batch and S + 1 times per
     multi-scale batch; the reference's "matrix" backend name runs K1 once;
     soft-NMS (sigma 0.5) card vs CPU within 1e-6; K1's time on the merges;
     R50-FPN-512 hflip TTA at b16 bf16 with pre_nms_top_k 2100 and 5000
     (merges of 4200 and 10000 candidates per image, K1's walk route): K1
     bit-equal on each merge and once per TTA batch, its time, scratch and
     peak allocation; the (16, 1000, 100) serving row timed again;
 20. the HTTP server over a bf16 b16 Predictor with buckets 1-16, warmed
     up: 512 PNG/JPEG requests of 200-900 px from 16 client threads in a
     process of their own, every answer equal to Predictor.predict of the
     same batch (0.01 px, 1e-5), every request in one batch, K1 once per
     batch; a lone request on the b1 bucket;
 21. detect_cli on SSD300 with --tta-hflip --tta-scales 300 --save-viz (K1
     twice), and serve_cli as a subprocess: /healthz, /detect, SIGTERM;
 22. each int8 tier's full-width forward card vs CPU (R50-FPN-512 and
     SSD300, b1, float32 with TF32 off): weight-only within 0.02 / 0.002;
     in the full tiers every int8 convolution of the card's forward
     bit-equal to the CPU's on the card's input, and the whole forward
     within 3x the CPU's own spread under 1e-7 noise at each int8
     convolution's input;
 23. R50-FPN-512 bf16 Predictors (buckets 1 and 16) in the float, weights,
     full-dynamic and full-static tiers (static scales calibrated on 4
     synthetic b16 batches) and SSD300 config #1 Predictors: K1 once per
     batch in every tier; every int8 product of R50 b16 and b1 and of
     SSD300 b1 (the dilated conv6) bit-equal to its plain version on the
     card; weight bytes, and the full tiers' product stage times (quantize,
     im2col, _int_mm, epilogue) against cuDNN's bf16 convolutions of the
     same shapes; the 2-scale int8 detector (K1 3 times);
 24. the bf16 b16 float and full-static R50 programs exported on the card
     and a tiny SSD on the CPU; a fresh process loads each with the port
     alone: detections equal to the live Predictor's, one K1 launch per
     call, the CPU artifact run on the card; meanwhile serve_cli serves the
     static tier (--quantize full --act-scales) and an artifact (--artifact)
     as subprocesses; last, ArtifactPredictor.predict on each artifact, one
     K1 launch each.

The groups ``data`` and ``dist`` drive the input pipelines and data
parallelism:

 25. config #3's input (SSD-512, b32, 512 px, max_boxes 100): build_cache
     of the 256-image synthetic split (bytes), the cache staged on the card
     (bytes there, every batch bit-equal to CacheLoader's), the thread
     Loader and GrainLoader at 0, 4 and 8 worker processes on that split
     and on a VOC folder of 256 JPEGs of 500 x 375 written from a seed (the
     decode-bound case) across an epoch's end, and train_cli on config #3
     under --loader threads, cache and device (synthetic) and threads and
     grain (JPEGs): K2 once per step; no loader worker process may outlive
     its GrainLoader's close();
 26. an NCCL group of one rank formed from torchrun's environment: the
     data-parallel step bit-equal to the plain step (R50-FPN-512 b16 bf16;
     SSD-512 b32 with train_bn and remat; cuDNN deterministic) with K2 once
     per step, K2 bit-equal on the rank's augmented rows, the sharded eval
     step with K1 once per batch and bit-equal on its candidates;
     train_cli under torch.distributed.run (8 steps, a val eval, a
     checkpoint, its resume to 12) and eval_cli the same way, its records
     equal to eval_cli's without a group; two ranks sharing the card over
     gloo, b2 each, against one process's step on the global b4.

The group ``spatial`` drives the model axis (image rows split across the
ranks of a model group in GSPMD's ceil layout, a row fetch in every
convolution, pool and upsample):

 27. config #5's model as the preset sets it (R101-FPN at 1024 px, focal,
     the whole-forward train.remat), float32 with TF32 off and cuDNN
     deterministic, b2: two train steps and a detect (threshold 0) in this
     process, then on 1 data x 2 model gloo ranks sharing the card (NCCL,
     one rank per card, too where the machine has two cards): loss within
     1e-5 relative, grad_norm 1e-4, parameters 2e-5, detections at the
     reference's bounds; each rank's peak memory beside this process's,
     the halo exchanges of one forward and their bytes; K2 once per step
     and K1 once per detect on every rank;
 28. K1 bit-equal to its plain version on rank 0's candidates (2, 1000,
     100) and K2 on the step's GT against the 196,416 anchors, both timed;
 29. R50-FPN-512 b4 on 2 data x 2 model gloo ranks: the same checks, with
     a data group and a model group of two ranks each;
 30. config #3's SSD-512 as its preset sets it, cut to b8, on 1 x 2 ranks
     (maps of 4, 2 and 1 rows split unevenly): the same train checks; its
     detect, and config #1's SSD300 detect at b16 on 1 x 4 ranks (conv6's
     dilated windows reach past the neighbouring rank), with their gathered
     head outputs within 2e-4 of the unsplit ones and each rank's
     detections bit-equal to the unsplit postprocess of its outputs (how
     many images equal the unsplit detect at the reference's bounds is
     logged); K2 on the SSD-512 step's GT and K1 on both detects'
     candidates bit-equal and timed;
 31. the serving R50-FPN-512 at b16 on 1 x 2 ranks: hflip TTA, two-scale
     (512, 640) TTA and the weight-only, full-dynamic and full-static int8
     tiers, each against the unsplit path (matched one to one at the repo's
     end-to-end bar, the reference's bounds logged), K1 once per batch (3
     per two-scale batch) and bit-equal on each path's merged candidates;
 32. the artifact exported from a row-split module, loaded on the card,
     equal bit for bit to the unsplit module's artifact.

The group ``tools`` drives the checkpoint tools and the examples:

 33. a config #3 train_cli run (3 steps, a checkpoint each) averaged by
     tools/average_checkpoints, bit-equal to a numpy float32 average of the
     same snapshots; eval_cli (K1 once per batch), export_model
     --checkpoint-dir (its artifact K1 once) and a one-step train_cli
     resume (K2 once) on the average; tools/convert_checkpoint --mode
     vgg_backbone on a full-width synthetic torchvision VGG-16 (138 M
     parameters) and 2 train_cli steps from it with --init-params (K2
     twice); both examples as subprocesses, exiting 0 with their lines.

The group ``accuracy`` drives the accuracy tools (``tools/matching_analysis``,
``tools/ablate_matching``, ``tools/ablate_tta``, ``tools/ablate_quantize``):

 34. matching_analysis on R50-FPN-512's 49104 anchors and SSD300's 8732 with
     200 GTs: K2 once per shape weight (5 per model), positives and matched
     GTs bit-equal to the plain route's, the table; SSD300's rows at w = 0
     and 0.3 equal to the recorded 4.64 / 6.25 positives per GT and 23.4 % /
     25.5 % extreme-aspect coverage; K2 timed at (1, A, 200);
 35. both arms of seed 7 of ablate_matching at full width (SSD300, 20
     classes, the device loader, b16, 512 training and 128 validation
     images, aspect_std 1.2, 1000 steps each): K2 once per step, K1 once per
     validation batch and bit-equal to its plain version on each arm's last
     validation batch (trained scores, timed), each arm's mAP above the
     fresh model's on the same split; each arm's row and the paired delta;
 36. the w = 0 arm's weights through ablate_tta's and ablate_quantize's
     scoring: plain and hflip TTA, the float, weight-only, full-dynamic and
     full-static tiers, K1 once per batch in each, the float tier's metrics
     equal to the plain mode's, each int8 tier's drift; K1 bit-equal on the
     hflip merge and timed;
 37. ablate_tta's RetinaNet branch: R50-FPN-512 in bf16 trained 24 steps at
     b8, then plain, hflip, and (512, 640) multi-scale TTA with and without
     hflip on 8 images: K1 once per batch and 3 times per 2-scale image; K1
     bit-equal on a 2-scale merge of those weights at score threshold 0
     (at 0.05 so few steps leave no candidate) and timed.

Every process the run starts ends before it does: the script is the child
subreaper of its descendants (a worker whose parent exits is re-parented to
it), and after the last phase, or a failed one, it stops multiprocessing's
fork server, then whatever else still runs (named in its log), then
multiprocessing's resource tracker, and reaps them all.

Prints its results, a ``[group]`` line as each group passes (seconds into
the run), a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without printing a result when there is no CUDA device or a phase fails.

    python3 chip_smoke.py
    python3 chip_smoke.py --only serve   # one group, no result line
    python3 chip_smoke.py --only int8    # the int8 tiers and the artifact
    python3 chip_smoke.py --only data,dist   # the loaders, data parallelism
    python3 chip_smoke.py --only spatial     # the model axis
    python3 chip_smoke.py --only tools       # the checkpoint tools, the examples
    python3 chip_smoke.py --only accuracy    # the accuracy tools
    python3 chip_smoke.py --only k3          # the frozen BatchNorm kernel alone
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the card's peaks and the K1 and K2 bounds: the benchmark's frozen arithmetic
from benchmark.harness.roofline import (  # noqa: F401 (the constants: this module's names)
    FP32_FLOPS, HBM_BYTES_PER_S, MATCH_OPS_PER_PAIR, MATCH_SHAPE_OPS_PER_BOX,
    MATCH_SHAPE_OPS_PER_PAIR, NMS_OPS_PER_ELEMENT, match_bound_s, nms_bound_s,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("nms_greedy", "match_anchors", "frozen_bn")
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
    """Kernel vs plain on the card, bit for bit, at the path's shapes and at
    WALK_SHAPES, above 4096 candidates per image (the edge cases are the card
    tests'), each shape with its route, scratch bytes (the kernel's layout,
    and the peak allocation measured around one call); the walk shapes
    timed. Returns (the largest |difference| seen over idx and score, K1's
    rows for the walk route)."""
    from tests.torch_kernel_cases import nms_bit_equal, nms_inputs

    rng = np.random.default_rng(0)
    worst = 0.0
    cases = []
    for b, n, m in ((16, 1000, 100), (16, 400, 200), (8, 2000, 100)) + WALK_SHAPES:
        boxes, scores, cls, valid = (torch.from_numpy(a).cuda()
                                     for a in nms_inputs(rng, b, n))
        cases.append((f"(B, N, M)=({b}, {n}, {m})", nms.class_offset_boxes(boxes, cls),
                      scores, valid, 0.5, m))
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


def phase_serving(torch, config, serving, nms_cuda, frozen_bn_cuda, detection, reset_counts):
    """The main path: a bf16 batch-16 Predictor answering three requests,
    one K1 launch and 49 K3 launches a batch (the first batch's eager
    forward, then each replay of the bucket's graph)."""
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
    launches, k3_launches = nms_cuda.launches, frozen_bn_cuda.launches
    if launches != len(requests):
        raise RuntimeError(f"the NMS kernel ran {launches} times for "
                           f"{len(requests)} batches")
    if k3_launches != R50_K3_LAUNCHES * len(requests):
        raise RuntimeError(f"the frozen BatchNorm kernel ran {k3_launches} times for "
                           f"{len(requests)} batches, not {R50_K3_LAUNCHES} a batch")
    counts = check_answers(requests, answers)
    log(f"[serving] bf16 Predictor b16: requests of 16, 5, 1 images answered, "
        f"detections per image {counts}, NMS kernel launches {launches}, frozen BatchNorm "
        f"kernel launches {k3_launches}")

    # the kernel against the plain version on the same candidates
    batch, _ = serving.prepare_batch(requests[0], 512, 16)
    cands = path_candidates(torch, detection, pred.module, pred.anchors, cfg.model,
                            torch.from_numpy(batch).cuda())
    with torch.inference_mode():
        got = detection.run_nms(*cands, cfg.model, backend="cuda")
        want = detection.run_nms(*cands, cfg.model, backend="plain")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"[serving] run_nms kernel vs plain on the path's candidates: "
        f"equal={same}, kept per image {got.valid.sum(1).tolist()}")
    if not same:
        raise RuntimeError("run_nms through the kernel differs from the plain version")
    return launches, k3_launches


def path_candidates(torch, detection, module, anchors, cfg, images):
    """The candidates detect hands NMS for ``images`` (uint8 NHWC on the
    card)."""
    with torch.inference_mode():
        x = detection.image_lib.normalize_images(images).permute(0, 3, 1, 2)
        return detection.select_candidates(*module(x), anchors, cfg)


def phase_nms_timing(torch, config, build_model, detection, nms, nms_cuda):
    """K1 on the serving path's own candidates (the bf16 model at b16), and
    on the same shape with random scores. Returns the first's timing."""
    from tests.torch_kernel_cases import nms_inputs

    cfg = serving_config(config, "bfloat16").model
    module, anchors = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (16, 512, 512, 3), dtype=np.uint8)).cuda()
    cands = path_candidates(torch, detection, module, anchors, cfg, images)
    del module
    timing = nms_timing(nms, nms_cuda, cands, cfg.detect, "the path's candidates")
    # random scores, which the kernel has to sort (the path's candidates
    # arrive in order and skip the sort)
    b, n = cands[1].shape
    m, t = cfg.detect.max_detections, cfg.detect.nms_iou_threshold
    rb, rs, rc, rv = (torch.from_numpy(x).cuda() for x in nms_inputs(np.random.default_rng(7), b, n))
    rshift = nms.class_offset_boxes(rb, rc)
    log(f"[timing] nms_greedy ({b}, {n}, {m}) on random scores (the sort runs): "
        + fmt_device(*device_ms_per_call(
            lambda: nms_cuda.greedy_nms_cuda(rshift, rs, rv, t, m))))
    return timing


def bound_label(bound_s, bytes_s):
    """What bounds a kernel: "bytes" where moving them takes the bound's
    time, else "operations"."""
    return "bytes" if bytes_s >= bound_s else "operations"


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
    kept = [int(k) for k in res.valid.sum(1).cpu()]
    bound = nms_bound_s(b, n, m, kept)
    bound_by = bound_label(bound, nms_bound_s(b, n, m, []))  # no step: the bytes alone
    log(f"[timing] nms_greedy ({b}, {n}, {m}) on {name} "
        f"({nvidia_smi_line()}): kernel CUDA events between back-to-back calls "
        f"{spread(k_times)}; {fmt_device(dev_ms, dev_names)}; plain "
        f"{spread(p_times)}; bound {bound * 1e3:.5f} ms ({bound_by}; {sum(kept)} kept), "
        f"library call: none (no PyTorch op computes greedy NMS)")
    return dict(ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, bound_ms=bound * 1e3,
                bound_by=bound_by)


def phase_match_kernel(torch, config, anchors_for_model):
    """K2 vs plain on the card at the path's shapes (the edge cases are the
    card tests'). Returns the worst |difference| over best_q and reg (the
    assignments must be equal)."""
    from tests.torch_kernel_cases import match_check, match_inputs

    rng = np.random.default_rng(5)
    r50 = config.get_config("retinanet_r50_fpn").model
    r101 = config.get_config("retinanet_r101_fpn").model
    cases = [(kind, model, *match_inputs(rng, b, g, kind), sw)
             for model, b, g, kind, sw in ((r50, 16, 64, "ties", 0.0),
                                           (r50, 16, 100, "random", 0.0),
                                           (r101, 4, 100, "random", 0.3))]
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
        metrics[key] = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics[key].append({k: float(v) for k, v in m.items()})
        runs[key] = (module, start)
    worst = {}
    for i, (c, g) in enumerate(zip(metrics["cpu"], metrics["cuda"])):
        for key in ("loss", "loss_cls", "loss_box", "grad_norm", "num_pos"):
            rel = abs(g[key] - c[key]) / max(abs(c[key]), 1e-12)
            worst[key] = max(worst.get(key, 0.0), rel)
            if not (np.isfinite(g[key]) and rel <= 1e-4):
                raise RuntimeError(f"train step {i + 1} {key}: card {g[key]} vs CPU {c[key]}")
    cpu, start = runs["cpu"]

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
        f"{note}")
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


def phase_train_match_timing(torch, matching, matching_cuda, state, anchors, cfg, batch,
                             ties=True):
    """K2's time on a training path's batch augmented as its step augments
    it (and, with ``ties``, on bench_train.py's batch). Returns the first's
    timing."""
    from shape_based_object_detection_torch.data.augment import augment_batch
    from tests.torch_kernel_cases import match_inputs

    images, boxes, labels, valid = (batch[k] for k in ("images", "boxes", "labels", "valid"))
    aug = augment_batch(state.generator, images, boxes, labels, valid, cfg.data,
                        cfg.model.image_size)
    cases = [("the path's augmented batch", aug[1:4])]
    if ties:
        cases.append(("bench_train.py's batch (8 of 64 GTs valid, all one box)",
                      [torch.from_numpy(x).cuda()
                       for x in match_inputs(np.random.default_rng(9), 16, 64, "ties")]))
    timed = [match_timing(torch, matching, matching_cuda, anchors, cfg, name, gt, lbl, ok)
             for name, (gt, lbl, ok) in cases]
    return timed[0]


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
    # an invalid row needs no arithmetic (its quality is -1)
    n_valid = int(ok.sum())
    bound = match_bound_s(b, a, g, n_valid, sw)
    bound_by = bound_label(bound, match_bound_s(b, a, g, 0, 0.0))  # no pair: the bytes alone
    log(f"[timing] match_anchors (B, A, G)=({b}, {a}, {g}) on {name} "
        f"({nvidia_smi_line()}): kernel CUDA events between back-to-back calls "
        f"{spread(k_times)}; {fmt_device(dev_ms, dev_names)}; plain "
        f"{spread(p_times)}; bound {bound * 1e3:.5f} ms "
        f"({bound_by}; {n_valid} valid GTs, shape_weight {sw}), library call: none (no "
        f"PyTorch op computes the matching)")
    return dict(ms=float(np.median(k_times)), device_ms=dev_ms,
                plain_ms=float(np.median(p_times)), bound_ms=bound * 1e3, bound_by=bound_by)


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
    the bf16 Predictor)."""
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
    return launches, preds[1]


def phase_ssd_nms(torch, detection, nms, nms_cuda, pred):
    """K1 against the plain version on the candidates of the SSD300 bf16
    b16 Predictor's detect, and K1's time there. Returns the timing, with
    the largest difference as ``max_abs_err``."""
    images = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (16, 300, 300, 3), dtype=np.uint8)).cuda()
    cands = path_candidates(torch, detection, pred.module, pred.anchors, pred.cfg.model, images)
    det = pred.cfg.model.detect
    err = k1_on(torch, nms, cands, det, "the SSD300 bf16 b16 candidates")
    timing = nms_timing(nms, nms_cuda, cands, det, "the SSD300 path's candidates")
    timing["max_abs_err"] = err
    return timing


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
    (group 7's tolerances, the update's held to the CPU's own float32
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
def graph_replay_ms(torch, fn, iters=30):
    """Device ms of one replay of ``fn`` captured as a CUDA graph (CUDA
    events around each of ``iters`` replays, median): launches without the
    host's time between them, as a served batch replays them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = cuda_times_ms(graph.replay, iters)
    del graph
    return float(np.median(times))


# a ResNet-50 forward's K3 launches: the stem, then each of 16 bottlenecks'
# bn1, bn2 and end (53 BatchNorms: the 4 downsample ones at their block's end)
R50_K3_LAUNCHES = 49


def abs_err(torch, got, want) -> float:
    """The largest |got - want| over the elements; 0 where both are equal
    or both NaN, inf where only one is NaN or they are unequal infinities."""
    g, w = got.float(), want.float()
    same = (g == w) | (g.isnan() & w.isnan())
    d = torch.where(same, torch.zeros_like(g), (g - w).abs())
    return float(d.nan_to_num(nan=float("inf")).max()) if d.numel() else 0.0


class K3Sites:
    """``with K3Sites(torch, frozen_bn_cuda) as rec:`` records each K3
    launch made inside, through the wrapper's two entry points that the ops
    call: ``rec.sites`` holds (form, the launch's arguments) in launch
    order, ``rec.equal`` whether K3's output equals the plain composition's
    on those arguments bit for bit, ``rec.err`` their largest absolute
    difference."""

    def __init__(self, torch, frozen_bn_cuda):
        self.torch, self.mod = torch, frozen_bn_cuda
        self.saved = frozen_bn_cuda.frozen_bn_act_cuda, frozen_bn_cuda.frozen_bn_add_relu_cuda
        self.sites, self.equal, self.err = [], [], 0.0

    def _record(self, form, kernel, plain, args):
        from tests.torch_kernel_cases import bits_equal

        out = kernel(*args)
        want = plain(*args)
        self.sites.append((form, args))
        self.equal.append(bits_equal(out, want))
        self.err = max(self.err, abs_err(self.torch, out, want))
        return out

    def __enter__(self):
        from shape_based_object_detection_torch.ops import frozen_bn

        act, add = self.saved
        self.mod.frozen_bn_act_cuda = lambda *a: self._record(
            "act" if a[6] else "bn", act, frozen_bn.bn_act, a)
        self.mod.frozen_bn_add_relu_cuda = lambda *a: self._record(
            "residual" if len(a) < 8 or a[7] is None else "downsample", add,
            frozen_bn.bn_add_relu, a)
        return self

    def __exit__(self, *exc):
        self.mod.frozen_bn_act_cuda, self.mod.frozen_bn_add_relu_cuda = self.saved


def serving_k3_sites(torch, config, serving, frozen_bn_cuda, dtype):
    """The K3 launches of one forward of the serving path: a b16 Predictor's
    detect program (the one each bucket's graph captures) on a batch of 16
    requests of 200-900 px, recorded by ``K3Sites``. Returns the recorder
    and the launches the forward added to ``frozen_bn_cuda.launches``."""
    pred = serving.Predictor(serving_config(config, dtype), batch_size=16, device="cuda",
                             generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    request = [rng.integers(0, 256, (int(rng.integers(200, 900)),
                                     int(rng.integers(200, 900)), 3), dtype=np.uint8)
               for _ in range(16)]
    batch, _ = serving.prepare_batch(request, pred.size, 16)
    images = torch.from_numpy(batch).cuda()
    before = frozen_bn_cuda.launches
    with K3Sites(torch, frozen_bn_cuda) as rec, torch.inference_mode():
        pred._detect.program(images)
    torch.cuda.synchronize()
    return rec, frozen_bn_cuda.launches - before


def k3_forward_times(torch, sites):
    """K3 against the plain composition at each of ``sites`` (form, launch
    arguments), each on its own tensors: each distinct (form, shape) on the
    vector route, its device ms per call (20 calls of its first site as one
    CUDA graph) for both, and the sites' launches in order as one CUDA graph
    for both. Returns ({(form, shape): (K3 ms, plain ms)}, K3 graph ms,
    plain graph ms)."""
    from shape_based_object_detection_torch.ops import frozen_bn, frozen_bn_cuda

    def pair(form, args):
        if form in ("act", "bn"):
            return (lambda: frozen_bn_cuda.frozen_bn_act_cuda(*args),
                    lambda: frozen_bn.bn_act(*args))
        return (lambda: frozen_bn_cuda.frozen_bn_add_relu_cuda(*args),
                lambda: frozen_bn.bn_add_relu(*args))

    calls = [pair(form, args) for form, args in sites]
    per_shape = {}
    for (form, args), (kernel, plain) in zip(sites, calls):
        key = form, tuple(args[0].shape)
        if key in per_shape:
            continue
        r = args[6] if form in ("residual", "downsample") else None
        if frozen_bn_cuda.route(args[0], r) != "vector":
            raise RuntimeError(f"K3 at {key} {args[0].dtype}: not the vector route")
        per_shape[key] = tuple(
            graph_replay_ms(torch, lambda f=f: [f() for _ in range(20)]) / 20
            for f in (kernel, plain))
    k_graph = graph_replay_ms(torch, lambda: [k() for k, _ in calls])
    p_graph = graph_replay_ms(torch, lambda: [p() for _, p in calls])
    return per_shape, k_graph, p_graph


def phase_frozen_bn_kernel(torch, config, serving):
    """K3 against the plain composition on the card: bit-equal on the edge
    cases (both routes, odd C, NCHW, mixed layouts, NaN, +-inf, the largest
    values); then one forward of the serving path's b16 detect program
    (bf16, and float32), each K3 launch recorded with its own tensors and
    checked bit for bit against the plain composition on them, 49 launches
    a forward; each recorded shape's device time beside its bound, bytes /
    HBM_BYTES_PER_S, and the plain composition's; the forward's launches as
    one CUDA graph, K3's and the plain composition's. Returns K3's entries
    of the result, with the bit-equality and the largest difference found."""
    from shape_based_object_detection_torch.ops import frozen_bn_cuda
    from tests.torch_kernel_cases import (
        FROZEN_BN_FORMS, bits_equal, frozen_bn_bytes, frozen_bn_inputs, frozen_bn_pair,
        resnet_bn_sites,
    )

    checked, err = 0, 0.0
    for form in FROZEN_BN_FORMS:
        for dtype in (torch.bfloat16, torch.float32):
            for layouts, c in ((("nhwc", "nhwc"), 256), (("nhwc", "nhwc"), 19),
                               (("nchw", "nchw"), 64), (("nhwc", "nchw"), 32)):
                args = frozen_bn_inputs(form, (3, c, 7, 5), dtype, c, layouts, edge=True)
                got, want = frozen_bn_pair(form, *args)
                if not bits_equal(got, want):
                    raise RuntimeError(f"K3 differs from the plain composition: {form} "
                                       f"{dtype} {layouts} C={c}")
                err = max(err, abs_err(torch, got, want))
                checked += 1
    log(f"[k3] edge cases: {checked} bit-equal (NaN, +-inf, the largest values, -0, "
        f"subnormals; zero, huge and negative statistics), largest difference {err}")
    rows = {"edge_cases_checked": checked, "library_ms": None}
    equal = []
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "fp32")):
        rec, launched = serving_k3_sites(torch, config, serving, frozen_bn_cuda, dtype)
        sites = [(form, tuple(args[0].shape)) for form, args in rec.sites]
        layouts = {args[0].is_contiguous(memory_format=torch.channels_last)
                   for _, args in rec.sites}
        if launched != R50_K3_LAUNCHES or len(sites) != R50_K3_LAUNCHES:
            raise RuntimeError(f"the {tag} serving forward launched K3 {launched} times "
                               f"({len(sites)} recorded), not {R50_K3_LAUNCHES}")
        if sites != resnet_bn_sites(16, 512):
            raise RuntimeError(f"the {tag} serving forward's K3 sites differ from "
                               "tests/torch_kernel_cases.resnet_bn_sites")
        if not all(rec.equal):
            raise RuntimeError(f"K3 differs from the plain composition at "
                               f"{rec.equal.count(False)} of the {tag} serving forward's sites")
        equal += rec.equal
        err = max(err, rec.err)
        log(f"[k3] {tag} serving forward (Predictor b16's detect program): {launched} K3 "
            f"launches, each bit-equal to the plain composition on its own tensors (largest "
            f"difference {rec.err}); channels-last {sorted(layouts)}")
        per_shape, k_graph, p_graph = k3_forward_times(torch, rec.sites)
        dt = rec.sites[0][1][0].dtype
        bound = {s: frozen_bn_bytes(*s, dt) / HBM_BYTES_PER_S * 1e3 for s in per_shape}
        for s, (k_ms, p_ms) in per_shape.items():
            log(f"[k3] {tag} {s[0]} {s[1]} x{sites.count(s)}: device K3 {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, bound {bound[s]:.4f} ms ({bound[s] / k_ms * 100:.1f} % of it)")
        k_sum = sum(per_shape[s][0] for s in sites)
        p_sum = sum(per_shape[s][1] for s in sites)
        b_sum = sum(bound[s] for s in sites)
        log(f"[k3] {tag} R50-512 b16 forward, {len(sites)} launches: device K3 {k_sum:.4f} ms "
            f"(shapes summed), {k_graph:.4f} ms as one CUDA graph ({b_sum / k_graph * 100:.1f} % "
            f"of the bound); plain {p_sum:.4f} ms, {p_graph:.4f} ms as one graph; bound "
            f"{b_sum:.4f} ms ({nvidia_smi_line()})")
        rows.update({f"r50_b16_{tag}_forward_launches": launched,
                     f"r50_b16_{tag}_graph_ms": k_graph, f"r50_b16_{tag}_device_ms": k_sum,
                     f"r50_b16_{tag}_plain_graph_ms": p_graph,
                     f"r50_b16_{tag}_plain_device_ms": p_sum,
                     f"r50_b16_{tag}_bound_ms": b_sum})
        del rec
        torch.cuda.empty_cache()
    rows.update({"bit_equal": all(equal), "max_abs_err": err})
    return rows


# The training application: the frozen-BatchNorm repair, the pipelined
# step, train_cli and eval_cli on config #3, checkpoints, the Loader
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_batchnorm(resnet):
    """Inside the block every frozen BatchNorm runs as the plain layers: K3
    does not run."""
    fuses = resnet.fuses
    resnet.fuses = lambda *args: False
    try:
        yield
    finally:
        resnet.fuses = fuses


def phase_bn_repair(torch, config, build_model):
    """The repaired frozen BatchNorm on the card: the R50-512 backbone's bf16
    forward as the plain layers, card vs CPU, both against the CPU's
    float32 one."""
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
            with plain_batchnorm(resnet):
                outs[dev] = [o.float().cpu() for o in m.backbone(xd)]
            del m
    ref = outs["cpu32"]

    def mean_err(o, r):
        return float(sum((a - b).abs().sum() for a, b in zip(o, r))
                     / sum(b.numel() for b in r))

    card, cpu = outs["cuda"], outs["cpu"]
    e_card, e_cpu = mean_err(card, ref), mean_err(cpu, ref)
    card_cpu = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
    finite = all(bool(torch.isfinite(o).all()) for o in card)
    log(f"[bn] R50-512 backbone (C3-C5) in bf16, one 512 px image, the same weights: mean "
        f"|bf16 - CPU float32| card {e_card:.5f}, CPU {e_cpu:.5f} (bound: card <= 2 x CPU "
        f"+ 1e-3); card vs CPU bf16 max |err| {card_cpu:.4f}")
    if not (finite and e_card <= 2 * e_cpu + 1e-3):
        raise RuntimeError(f"bf16 forward on the card is off: {e_card} vs CPU {e_cpu}")
    return {"bn_bf16_forward_mean_err_card": e_card, "bn_bf16_forward_mean_err_cpu": e_cpu}


def phase_pipelined(torch, train, build_model, matching_cuda, cfg, batches, tag):
    """The pipelined step against the plain step: the same weights, batches
    and generator seed give the same losses (within 1e-6 relative), K2 once
    per step."""
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in batches]
    n = len(batches)
    losses = {}
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
        else:
            step = train.make_train_step(module, anchors, cfg)
            out = [float(step(state, b)[1]["loss"]) for b in batches]
        if matching_cuda.launches - before != n:
            raise RuntimeError(f"K2 ran {matching_cuda.launches - before} times in {n} steps")
        losses[pipelined] = out
        del module, state
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses[True], losses[False]))
    log(f"[pipelined] {tag}, prime + {n} steps: losses {losses[True]}; plain step on the same "
        f"batches and generator {losses[False]}; worst relative difference {rel:.2e} "
        f"(bound 1e-6); K2 launches {n} per run")
    if not rel <= 1e-6:
        raise RuntimeError(f"pipelined losses differ from the plain step's: {rel}")
    torch.cuda.empty_cache()
    return {f"pipelined_{tag}_loss_max_rel_diff": rel}


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
    tee = Tee("[cli] ")
    with contextlib.redirect_stdout(tee):
        main(argv)
    return tee.text


def argparse_ns(**kw):
    import argparse

    return argparse.Namespace(**kw)


APP_TRAIN = "synthetic://train?n=256&max_objects=8&aspect_std=0.6"
APP_VAL = "synthetic://val?n=64&max_objects=8&aspect_std=0.6"


def phase_app(torch, cli_train, nms_cuda, matching_cuda, reset_counts, workdir):
    """train_cli on config #3 (SSD-512 b32 float32, shape_weight 0.3) on a
    512 px synthetic split: 24 steps, a val eval every 12 on 2 batches. K2
    once per step, K1 once per eval batch, finite losses. Returns (the
    checkpoint folder, K1 launches, K2 launches)."""
    steps, every, val_batches, workers = 24, 12, 2, 8
    ckpt = os.path.join(workdir, "app_ckpt")
    argv = ["--config", "config3_ssd512_voc_train", "--data-root", APP_TRAIN,
            "--steps", str(steps), "--eval-every", str(every), "--val-root", APP_VAL,
            "--val-batches", str(val_batches), "--log-every", "4", "--workers", str(workers),
            "--checkpoint-dir", ckpt]
    reset_counts()
    text = run_cli(cli_train.main, argv)
    torch.cuda.synchronize()
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
        f"every {every} on {val_batches} val batches: losses {losses}; K2 launches {k2} (one "
        f"per step), K1 {k1} (one per eval batch); checkpoints {saved}; voc-mAP {maps}")
    return ckpt, k1, k2


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
    state bit-equal; the file's size."""
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
        mgr.save(state, 3)
        mgr.wait()
        size = os.path.getsize(os.path.join(workdir, f"rt_{tag}", "3", "state.pt"))
        other, _ = build_model(cfg.model, device="cuda", train=True,
                               generator=torch.Generator().manual_seed(5))
        restored = mgr.restore_step(3, train.create_train_state(
            other, cfg, generator=torch.Generator(device="cuda").manual_seed(99)))
        torch.cuda.synchronize()
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
            f"bit-equal={same}; {size / 2**20:.1f} MiB")
        if not same:
            raise RuntimeError(f"{tag} checkpoint round trip is not bit-equal")
        mgr.close()
        results[f"ckpt_{tag}_mib"] = size / 2**20
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
    numpy matchers equal on jittered ground truth; eval_cli on config #2
    (R50 b32, threshold 0)."""
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
    cands = path_candidates(torch, detection, module, anchors, cfg.model,
                            torch.from_numpy(b.images).cuda())
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
    scores_m = {matcher: (voc_map(dets, ev.ground_truth, matcher=matcher)["mAP"],
                          coco_map(dets, ev.ground_truth, area_scale=512.0,
                                   matcher=matcher)["mAP"])
                for matcher in ("native", "numpy")}
    agree = scores_m["native"] == scores_m["numpy"] and min(scores_m["native"]) > 0
    log(f"[eval] with jittered ground truth as detections ({len(dets)} images): voc mAP "
        f"{scores_m['native'][0]:.6f}, coco mAP {scores_m['native'][1]:.6f}; C++ and numpy "
        f"matchers equal and non-zero: {agree}")
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
        "eval_jittered_coco_map": scores_m["native"][1]}


def phase_loader(torch):
    """Loader.device_batches on the card at b32 (512 px, 100 boxes, 8
    threads): batches bit-equal to the host batches, staged pinned."""
    from shape_based_object_detection_torch.data.pipeline import Loader, pin_batch
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

    loader = Loader(SyntheticDetection(size=512, num_images=96, num_classes=20, max_objects=8),
                    32, 100, seed=1, workers=8)
    host = list(loader.batches(0))
    dev = list(loader.device_batches(0))
    equal = len(host) == len(dev) == 3 and all(
        np.array_equal(a, b.cpu().numpy()) for h, d in zip(host, dev) for a, b in zip(h, d))
    is_pinned = all(t.is_pinned() for t in pin_batch(host[0]))
    loader.close()
    log(f"[loader] device_batches: 3 b32 batches bit-equal to the host batches: {equal}; "
        f"staged pinned: {is_pinned}")
    if not (equal and is_pinned):
        raise RuntimeError(f"device_batches: equal {equal}, pinned {is_pinned}")


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


def phase_serve_nms(torch, config, build_model, detection, nms, nms_cuda, reset_counts):
    """hflip detect card vs CPU at b1 in float32; K1 on the hflip merges (R50
    at b16, SSD300 at b1), bit-equal to its plain version, once per TTA
    batch, and timed; the "matrix" backend name runs K1, soft-NMS card vs
    CPU. Returns K1's entries."""
    from shape_based_object_detection_torch.detection import make_detect_fn

    k1 = {}
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

    # the matrix backend name and soft-NMS on the same merge
    matrix_route_is_k1(torch, detection, nms_cuda, cands, cfg, "the R50 hflip merge at b16")
    soft_card_vs_cpu(torch, detection, cands, cfg, "the R50 hflip merge at b16")
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
    return k1


def phase_serve_large_merges(torch, config, build_model, detection, nms, nms_cuda,
                             reset_counts):
    """R50-FPN-512 hflip TTA at b16 in bf16 (random weights from seed 1,
    score threshold 0) with pre_nms_top_k 2100 and 5000: merges of 4200 and
    10000 candidates per image, which run K1's walk route. K1 bit-equal to
    its plain version on each merge and once per TTA batch, its time (CUDA
    events, profiler device time) beside its bound and scratch; then the
    (16, 1000, 100) serving row, the same model's plain detect candidates on
    the bitmask route, timed again in this run. Returns K1's entries."""
    from shape_based_object_detection_torch.detection import make_detect_fn

    k1 = {}
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
        log(f"[serve] hflip TTA detect b16 bf16 at pre_nms_top_k {k} ({2 * k} candidates "
            f"into K1's {nms_cuda.route(2 * k)} route): K1 launches per batch "
            f"{k1[f'{tag}_launches']}, scratch "
            f"{nms_cuda.scratch_bytes(16, 2 * k, det.max_detections)} bytes, peak allocation "
            f"of one K1 call {k1[f'{tag}_peak_alloc_bytes']} bytes")
    cands = path_candidates(torch, detection, module, anchors, base, images)
    timing = nms_timing(nms, nms_cuda, cands, base.detect,
                        "the serving path's candidates (route bitmask), beside the merges")
    k1.update({f"serve_row_{key}": v for key, v in timing.items()})
    return k1


def phase_serve_multiscale(torch, config, build_model, nms, nms_cuda, reset_counts):
    """R50-FPN-512 at b16 (random weights from seed 0): the 2-scale batch
    detector launches K1 S + 1 times per batch, and K1 is bit-equal on its
    merge (float32, whose scores are not tied as bf16's are) and timed
    there. Returns K1's entries."""
    from shape_based_object_detection_torch.detection import MultiScaleBatchDetector
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
    return k1


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
    share one request after another; write the answers as JSON to ``out``.
    Run as ``python3 -c "import sys, chip_smoke;
    chip_smoke.load_client(*sys.argv[1:])" PORT FOLDER CLIENTS OUT`` from
    the repo root."""
    names = sorted(os.listdir(folder))
    bodies = []
    for name in names:
        with open(os.path.join(folder, name), "rb") as f:
            bodies.append(f.read())
    n, clients = len(bodies), int(clients)
    answers = [None] * n

    def client(c):
        for i in range(c, n, clients):
            answers[i] = post(int(port), bodies[i])

    with ThreadPoolExecutor(clients) as pool:
        list(pool.map(client, range(clients)))
    with open(out, "w") as f:
        json.dump(answers, f)


def phase_server(torch, config, serving, nms_cuda, reset_counts, workdir):
    """DetectionServer over a bf16 R50-FPN-512 Predictor (b16, buckets
    1-16, warmed up): 512 encoded images from 16 client threads in another
    process. Every answer equals Predictor.predict of the same decoded
    images in the same batch (boxes within 0.01 px, scores 1e-5: the JSON's
    rounding); K1 once per batch; then one lone request, which rides the b1
    bucket. Returns K1's launches under the load."""
    import urllib.request

    from shape_based_object_detection_torch.server import DetectionServer

    cfg = serving_config(config, "bfloat16")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, decode_backend="pil"))
    pred = serving.Predictor(cfg, batch_size=16, device="cuda",
                             bucket_sizes=serving.default_bucket_sizes(16),
                             generator=torch.Generator().manual_seed(0))
    pred.warmup()
    n = SERVER_REQUESTS
    bodies, decoded = encoded_requests(n, 23)
    key = {img.shape[:2]: i for i, img in enumerate(decoded)}
    folder = os.path.join(workdir, "requests")
    os.makedirs(folder, exist_ok=True)
    for i, body in enumerate(bodies):
        with open(os.path.join(folder, f"{i:05d}"), "wb") as f:
            f.write(body)
    answers_path = os.path.join(workdir, "answers.json")
    batches = []
    submit = pred.submit

    def recording(items):
        """Which requests rode the batch."""
        batches.append([key[hw] for _, hw in items])
        submit(items)

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
        if client.returncode != 0:
            raise RuntimeError(f"the load client failed: {client.stderr[-2000:]}")
        launches = nms_cuda.launches
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        served = list(batches)
        # a lone request: the b1 bucket
        post(server.port, bodies[0])
        torch.cuda.synchronize()
        lone = batches[len(served):]
        lone_launches = nms_cuda.launches - launches
    finally:
        server.close()
        pred.submit = submit
    with open(answers_path) as f:
        answers = json.load(f)
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
    log(f"[server] bf16 R50-FPN-512 Predictor b16, buckets {pred.bucket_sizes}: {n} requests "
        f"(PNG/JPEG, 200-900 px) from {SERVER_CLIENTS} client threads in another process; "
        f"{stats['batches']} batches of sizes {sorted(len(b) for b in served)}, "
        f"{stats['batch_errors']} batch errors; nms_greedy launches "
        f"{launches} = batches; every answer equal to Predictor.predict of the same batch "
        f"(max |box diff| {worst_box:.4f} px, |score diff| {worst_score:.2e}); a lone request "
        f"rode a batch of 1 (bucket {pred._bucket_for(1)}), 1 launch")
    return launches


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
    /healthz, one /detect, then SIGTERM. Returns detect_cli's K1
    launches."""
    import io

    from PIL import Image

    path = os.path.join(workdir, "street.png")
    bodies, decoded = encoded_requests(1, 24)
    Image.fromarray(decoded[0]).save(path)
    viz = os.path.join(workdir, "viz")
    reset_counts()
    buf = io.StringIO()  # its 200 detections are not printed
    with contextlib.redirect_stdout(buf):
        cli_detect.main(["--config", "config1_ssd300_infer", "--image", path, "--tta-hflip",
                         "--tta-scales", "300", "--save-viz", viz, "--min-score", "0.0",
                         "--set", "model.detect.score_threshold=0.0"])
    torch.cuda.synchronize()
    dets = json.loads(buf.getvalue())
    drawn = np.asarray(Image.open(os.path.join(viz, "street_det.png")))
    launches = nms_cuda.launches
    log(f"[cli] detect_cli SSD300 --tta-hflip --tta-scales 300 --save-viz: {len(dets)} "
        f"detections, viz {drawn.shape}, "
        f"nms_greedy launches {launches} (the hflip merge and the scale merge)")
    if not dets or drawn.shape != decoded[0].shape or launches != 2:
        raise RuntimeError("detect_cli with TTA did not run as expected")

    serve_cli_answers(
        ["--config", "config2_retinanet_r50_infer", "--batch-size", "4",
         "--set", "model.detect.score_threshold=0.0", "--set", "data.decode_backend=pil"],
        bodies[0], "config #2 (b4, buckets 1-4)")
    return launches


def serve_cli_answers(args, body, name):
    """serve_cli with ``args`` as a subprocess on a free port: /healthz, one
    /detect of ``body``, then SIGTERM, which must end it with exit 0."""
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
    try:
        seen = read_until(lines, "serving on", 300)
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
    log(f"[cli] serve_cli {name} subprocess: ready "
        f"('{seen[1] if len(seen) > 1 else seen[0]}'), /healthz {health!r}, /detect "
        f"{len(answer['detections'])} detections for a {answer['width']}x{answer['height']} "
        f"image, SIGTERM -> exit {rc}, '{seen[-1]}'")
    if health != b"ok" or not answer["detections"] or rc != 0:
        raise RuntimeError(f"serve_cli {name} did not serve and stop cleanly")


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
    b16 and b1 and SSD300 b1; the stage times of the full tiers' products;
    weight bytes on the card."""
    cfg = serving_config(config, "bfloat16")
    base = serving.Predictor(cfg, batch_size=16, device="cuda", bucket_sizes=(1, 16))
    calib = [smooth_images(torch, 60 + i, 16, 512) for i in range(4)]
    scales = quantize.calibrate_activation_scales(base.module, calib, cfg.data)
    log(f"[int8] calibrated {len(scales)} activation scales on 4 synthetic b16 batches "
        f"(R50 bf16)")
    preds = {"float": base}
    for tier, mode, static in INT8_TIERS:
        preds[tier] = serving.Predictor(cfg, batch_size=16, device="cuda", bucket_sizes=(1, 16),
                                        quantize=mode,
                                        activation_scales=scales if static else None)
    out, k1 = {}, {}
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
        else:
            out[f"int8_ssd300_{tier}_weight_bytes"] = sum(
                t.nbytes for t in pred.module.state_dict().values())
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
    (``<name>_out.npz``), and the K1 launches of the call
    (``client.json``). Run as ``python3 -c "import sys, chip_smoke;
    chip_smoke.artifact_client(sys.argv[1])" FOLDER`` from the repo root."""
    import torch

    from shape_based_object_detection_torch.export import load_artifact
    from shape_based_object_detection_torch.ops import nms_cuda

    report = {}
    for name, batch in (("float", "batch16"), ("full_static", "batch16"),
                        ("tiny_cpu", "tiny_batch")):
        model = load_artifact(os.path.join(folder, f"{name}.sbdx"))
        images = np.load(os.path.join(folder, f"{batch}.npy"))
        nms_cuda.launches = 0
        det = model(images)
        torch.cuda.synchronize()
        report[name] = {"launches": nms_cuda.launches,
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
        blob = export.export_detect(base.module, base.anchors, base.cfg.model, base.cfg.data,
                                    16, "cuda", **kw)
        out[f"artifact_{name}_bytes"] = len(blob)
        export.save_artifact(blob, os.path.join(folder, f"{name}.sbdx"))
        live[name] = preds[name]._detect(x16)
        log(f"[artifact] exported R50 bf16 b16 {name} on the card: {len(blob)} bytes")
    tiny = config.resolve_config("tiny_ssd", ["model.detect.score_threshold=0.0"])
    blob = export.export_from_config(tiny, batch_size=1, device="cpu")
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
        log(f"[artifact] {name}: reloaded in a fresh process "
            f"(exported on {report[name]['exported_on']}, runs on {report[name]['runs_on']}); "
            f"labels and valid equal={same}, boxes and scores max |err| {err:.3e} against the "
            f"live Predictor ({int(want['valid'].sum())} detections); K1 launches "
            f"{report[name]['launches']} for 1 call")
        if not same or err > 1e-5 or report[name]["launches"] != 1:
            raise RuntimeError(f"the reloaded {name} artifact differs from the live Predictor")
        out[f"artifact_{name}_max_abs_err"] = err
    out["launches"] = {name: r["launches"] for name, r in report.items()}
    got, want = np.load(os.path.join(folder, "tiny_cpu_out.npz")), live["tiny_cpu"]
    vg, vw = got["valid"][0], want.valid[0].numpy()
    n = matched(tuple(got[k][0][vg] for k in ("boxes", "scores", "labels")),
                tuple(getattr(want, k)[0].numpy()[vw] for k in ("boxes", "scores", "labels")))
    log(f"[artifact] tiny SSD exported on the CPU, moved to {report['tiny_cpu']['runs_on']} at "
        f"load: K1 launches "
        f"{report['tiny_cpu']['launches']}, {n} detections matched the CPU's detect (label, "
        "IoU >= 0.99, |dscore| <= 1e-3)")
    if report["tiny_cpu"]["launches"] != 1 or n == 0:
        raise RuntimeError("the CPU artifact did not run K1 on the card")
    return out


def int8_artifact_predictors(torch, serving, nms_cuda, reset_counts, folder):
    """ArtifactPredictor.predict on 16 images of 200-900 px for each
    artifact: one K1 launch each."""
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
        log(f"[artifact] ArtifactPredictor {name}: a request of 16 images of 200-900 px, K1 "
            "launches 1")


def phase_int8(torch, config, serving, detection, build_model, nms_cuda, reset_counts,
               workdir):
    """Group int8, in order: the tiers' full-width forwards card vs CPU; the
    bf16 Predictors in every tier (K1 gates, the int8 product gates, the
    products' stage times); the artifacts exported, then read back in a
    fresh process while serve_cli serves the static tier and an artifact
    (three processes at once); last, ArtifactPredictor on each artifact."""
    from shape_based_object_detection_torch import export, quantize

    log(f"[int8] the group's numbers are this card's: {nvidia_smi_line()}")
    out = phase_int8_forward(torch, config, build_model, quantize)
    serve_out, k1, preds, scales = phase_int8_serving(torch, config, serving, quantize,
                                                      nms_cuda, reset_counts)
    out.update(serve_out)
    art_out, folder, client, live = int8_export_artifacts(
        torch, config, export, detection, build_model, preds, scales, workdir)
    out.update(art_out)
    try:
        scales_path = os.path.join(workdir, "scales.json")
        quantize.save_activation_scales(scales_path, scales)
        bodies, _ = encoded_requests(1, 67)
        runs = (  # both at once, beside the artifact client
            (["--config", "config2_retinanet_r50_infer", "--batch-size", "4", "--quantize",
              "full", "--act-scales", scales_path, "--set", "model.dtype=\"bfloat16\"",
              "--set", "model.detect.score_threshold=0.0",
              "--set", "data.decode_backend=pil"],
             bodies[0], "config #2 bf16 --quantize full --act-scales"),
            (["--artifact", os.path.join(folder, "full_static.sbdx")], bodies[0],
             "--artifact (R50 bf16 b16 full_static)"))
        with ThreadPoolExecutor(len(runs)) as pool:
            for done in [pool.submit(serve_cli_answers, *run) for run in runs]:
                done.result()
    except BaseException:
        client.kill()
        client.wait()
        raise
    checked = int8_check_artifacts(client, folder, live)
    # one K1 launch per call of each loaded artifact
    k1.update({f"int8_artifact_{k}_launches": v for k, v in checked.pop("launches").items()})
    out.update(checked)
    int8_artifact_predictors(torch, serving, nms_cuda, reset_counts, folder)
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


def drive_loaders(cfg, ds, name, workers_list):
    """The thread Loader (8 threads) and GrainLoader at each of
    ``workers_list`` worker processes on ``ds`` at b32: each gives an
    epoch's batches and the next epoch's first, and no worker process
    outlives GrainLoader's close()."""
    import itertools

    from shape_based_object_detection_torch.data.grain_pipeline import GrainLoader
    from shape_based_object_detection_torch.data.pipeline import Loader

    g = cfg.data.max_boxes
    batches = len(ds) // 32 + 1
    for label, make in [("thread Loader (8 threads)",
                         lambda: Loader(ds, 32, g, seed=1, workers=8))] + [
            (f"GrainLoader, {w} worker processes",
             lambda w=w: GrainLoader(ds, 32, g, seed=1, workers=w)) for w in workers_list]:
        loader = make()
        epochs = itertools.chain.from_iterable(loader.batches(e) for e in itertools.count())
        got = [b.images.shape for b in itertools.islice(epochs, batches)]
        loader.close()
        left = loader_workers_left()
        log(f"[data] {name}: {label}, {len(got)} b32 batches of {got[0][1:]} over an epoch's "
            f"end; worker processes left after close {len(left)}")
        if len(got) != batches or left:
            raise RuntimeError(f"{name} {label}: {len(got)} batches, workers left {left}")


def phase_data(torch, cli_train, matching_cuda, reset_counts, workdir):
    """The input pipelines on config #3's input (SSD-512, b32, 512 px,
    max_boxes 100): the cache built from the 512 px synthetic split and its
    bytes; the cache staged on the card (bytes there, every batch bit-equal
    to CacheLoader's); GrainLoader at 0, 4 and 8 worker processes and the
    thread Loader on the same split and on a VOC folder of 256 JPEGs of
    500 x 375 (the decode-bound case), and that folder's cache; then
    train_cli on config #3 under each --loader: K2 once per step, no loader
    worker left running."""
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
    build_cache(ds, cache_dir, g, workers=8)
    cache_bytes = sum(os.path.getsize(os.path.join(cache_dir, f))
                      for f in os.listdir(cache_dir) if f.endswith(".npy"))
    mm = MemmapDetection(cache_dir)
    dev = DeviceCacheLoader(mm, 32, g, seed=1)
    on_card = sum(v.numel() * v.element_size() for v in dev._dev.values())
    host = CacheLoader(mm, 32, g, seed=1)
    pairs = list(zip(dev.device_batches(0), host.batches(0)))
    equal = len(pairs) == len(ds) // 32 and all(
        np.array_equal(a.cpu().numpy(), b) for d, h in pairs for a, b in zip(d, h))
    log(f"[data] build_cache of {APP_TRAIN} ({len(ds)} images at 512 px, max_boxes {g}, 8 "
        f"threads): {cache_bytes} bytes; DeviceCacheLoader: {on_card} bytes staged on the "
        f"card; {len(pairs)} b32 batches bit-equal to CacheLoader's: {equal}")
    if not equal:
        raise RuntimeError("DeviceCacheLoader's batches differ from CacheLoader's")
    results.update({"cache_bytes": cache_bytes, "device_cache_bytes": on_card})
    del dev, pairs
    torch.cuda.empty_cache()

    drive_loaders(cfg, ds, "synthetic", (0, 4, 8))
    voc_root = os.path.join(workdir, "voc")
    jpeg_bytes = write_voc_folder(voc_root, VOC_IMAGES, 9)
    voc = VOCDetection(voc_root, "train", image_size=512, decode_backend="auto")
    log(f"[data] a VOC folder of {VOC_IMAGES} JPEGs of 500 x 375 ({jpeg_bytes} bytes); "
        f"decode backend {voc.decode_backend!r}")
    drive_loaders(cfg, voc, "voc_jpeg", (0, 4, 8))
    build_cache(voc, os.path.join(workdir, "voc_cache"), g, workers=8)
    log("[data] build_cache of the VOC folder (8 threads, one decode per image) done")

    # train_cli on config #3 under each loader, into a second epoch. One
    # grain run: on the card, a second GrainLoader driven by train_cli in one
    # process waits 5 s per worker to close
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
        text = run_cli(cli_train.main, argv)
        torch.cuda.synchronize()
        k2 = matching_cuda.launches
        left = loader_workers_left()
        if k2 != steps or f"done at step {steps}" not in text or left:
            raise RuntimeError(f"train_cli --loader {loader} on {root}: K2 {k2} in {steps} "
                               f"steps, loader workers left running {left}: {text[-300:]}")
        log(f"[data] train_cli config #3 --loader {loader} on {tag.split('_', 1)[1]}: "
            f"{steps} steps, K2 launches {k2} (one per step); no loader worker left running")
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
    data-parallel step's K2 launches."""
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    runs, launches = {}, None
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
        del module, state, step
        torch.cuda.empty_cache()
    (dp_m, dp_s), (pl_m, pl_s) = runs[False], runs[True]
    same = (all(torch.equal(a[k], b[k]) for a, b in zip(dp_m, pl_m) for k in b)
            and all(torch.equal(dp_s[k], v) for k, v in pl_s.items()))
    log(f"[dist] {name}: the data-parallel step in an NCCL group of one vs the plain step, 2 "
        f"steps, cuDNN deterministic: metrics and state bit-equal: {same} (loss "
        f"{float(dp_m[-1]['loss']):.6f}); K2 launches {launches} in 2 data-parallel steps")
    if not same or launches != 2:
        raise RuntimeError(f"{name}: data-parallel step bit-equal {same}, K2 {launches}")
    return launches


def phase_dist_nccl(torch, config, train, build_model, matching_cuda, nms_cuda, nms,
                    detection, reset_counts):
    """An NCCL group of one rank on the card, formed by
    initialize_multihost from torchrun's environment: its data-parallel
    step bit-equal to the plain step (RetinaNet R50-FPN-512 b16 bf16, and
    SSD-512 b32 with train_bn and remat); K2 bit-equal on the rank's
    augmented local batch; the sharded eval step (config #3 b32): K1 once
    per batch, bit-equal on the candidates of the rank's rows, and the
    detections gathered equal to make_eval_step's without a group. Returns
    (K1 entries, K2 entries)."""
    import torch.distributed as dist

    from shape_based_object_detection_torch.data.augment import augment_batch
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model
    from shape_based_object_detection_torch.parallel import initialize_multihost, shutdown
    from tests.torch_kernel_cases import match_check

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    k1, k2 = {}, {}
    try:
        mesh = initialize_multihost()
        backend = dist.get_backend()
        if backend != "nccl" or not mesh.distributed or mesh.device.type != "cuda":
            raise RuntimeError(f"the group formed on {backend}, {mesh}")
        try:
            r50 = train_config(config, "bfloat16", 16)
            dp_equal_to_plain(torch, train, build_model, matching_cuda, mesh, r50,
                              train_batch(np.random.default_rng(60), 16), "R50-FPN-512 b16 bf16")
            ssd = ssd_train_config(config, 32)
            ssd = dataclasses.replace(ssd, model=dataclasses.replace(ssd.model, train_bn=True,
                                                                     remat=True))
            batch = train_batch(np.random.default_rng(61), 32, g=100, classes=20)
            k2["dist_launches"] = dp_equal_to_plain(
                torch, train, build_model, matching_cuda, mesh, ssd, batch,
                "SSD-512 b32 (config #3) with train_bn and remat")

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
            cands = path_candidates(torch, detection, module, anchors, cfg.model,
                                    images[rows])
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
    return k1, k2


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
    without a group. Returns (K2 entries, K1 entries)."""
    import json as json_lib

    from shape_based_object_detection_torch import eval as eval_pkg

    ckpt = os.path.join(workdir, "dist_ckpt")
    common = ["--config", "config3_ssd512_voc_train", "--data-root", APP_TRAIN,
              "--log-every", "4", "--workers", "8", "--checkpoint-dir", ckpt]
    text, first = torchrun(["train", *common, "--steps", "8", "--eval-every", "8",
                            "--val-root", APP_VAL, "--val-batches", "1"],
                           os.path.join(workdir, "dist_train.pkl"))
    text2, second = torchrun(["train", *common, "--steps", "12"],
                             os.path.join(workdir, "dist_resume.pkl"))
    ok = ("done at step 8" in text and "voc-mAP(val)=" in text
          and "restored checkpoint at step 8" in text2 and "done at step 12" in text2
          and sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())[-1] == 12)
    log(f"[dist] train_cli config #3 under torch.distributed.run --nproc_per_node 1 (NCCL): "
        f"8 steps with a val eval, K2 {first['k2']}, K1 {first['k1']}; resumed to step 12, "
        f"K2 {second['k2']}; checkpoint and resume as expected: {ok}")
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
    return ({"dist_cli_launches": first["k2"] + second["k2"]},
            {"dist_eval_cli_launches": report["k1"]})


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


# the spatial group: checked steps of each run
SPATIAL_STEPS = 2


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
    """Scores apart, so detections separate: RetinaNet's classifier x100,
    off the 0.01 prior; SSD's x2, as phase_ssd_forward opens the gap at
    its top-400 cut, where a fresh model's softmax scores crowd."""
    if hasattr(module, "cls_head"):
        module.cls_head.predict.weight.mul_(100.0)
        return
    for i in range(len(module.cfg.anchors.aspect_ratios)):
        getattr(module, f"cls_{i}").weight.mul_(2.0)


def spatial_train(torch, plan, mesh, device, rows):
    """The train part of ``spatial_run``: SPATIAL_STEPS steps (metrics, K2
    launches, peak memory, parameters) and the row exchanges of one
    forward."""
    from shape_based_object_detection_torch import train
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching_cuda
    from shape_based_object_detection_torch.utils import image as image_lib

    cfg = plan["cfg"]
    local = {k: torch.from_numpy(v[rows]).to(device) for k, v in plan["batch"].items()}
    module, anchors = build_model(cfg.model, device=device, train=True,
                                  generator=torch.Generator().manual_seed(plan["seed"]))
    state = train.create_train_state(module, cfg, device=device)
    step = train.make_train_step(module, anchors, cfg, augment=False, device=device, mesh=mesh)
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
    shard = module.row_shard
    x = image_lib.normalize_images(local["images"]).permute(0, 3, 1, 2)
    if shard is not None:
        shard.reset_counts()
        with torch.no_grad():
            module(shard.split(x))
        out["halo"] = (shard.exchanges, shard.halo_bytes, shard.moved_bytes)
    return out


def spatial_run(torch, plan, mesh, device):
    """One process's part of a spatial run (``mesh`` None: the unsplit
    reference, alone): SPATIAL_STEPS train steps with cuDNN's deterministic
    algorithms (their metrics, K2 launches and peak memory), the row
    exchanges of one forward, then detect on the images with its K1
    launches, gathered over the data axis. A plan with ``train`` false
    drives detect alone: its peak memory and row exchanges are detect's."""
    from shape_based_object_detection_torch.detection import make_detect_fn, select_candidates
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import nms_cuda
    from shape_based_object_detection_torch.parallel.mesh import all_gather_rows
    from shape_based_object_detection_torch.utils import image as image_lib

    cfg = plan["cfg"]
    b = cfg.data.batch_size
    rows = slice(None) if mesh is None else mesh.rows(b)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        if plan.get("train", True):
            out.update(spatial_train(torch, plan, mesh, device, rows))
        dcfg = plan["detect_cfg"]
        module, anchors = build_model(dcfg.model, device=device,
                                      generator=torch.Generator().manual_seed(plan["seed"]))
        with torch.no_grad():
            spatial_widen(module)
        detect = make_detect_fn(module, anchors, dcfg.model, dcfg.data, device, mesh)
        images = torch.from_numpy(plan["images"][rows]).to(device)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        nms_cuda.launches = 0
        det = detect(images)
        torch.cuda.synchronize(device)
        out["k1"] = nms_cuda.launches
        if not plan.get("train", True):
            out["peak"] = torch.cuda.max_memory_allocated(device)
            shard = module.row_shard
            if shard is not None:
                shard.reset_counts()
                detect(images)
                out["halo"] = (shard.exchanges, shard.halo_bytes, shard.moved_bytes)
        if mesh is not None:
            det = all_gather_rows(det, mesh)
        out["det"] = [t.cpu() for t in det]
        with torch.inference_mode():
            x = image_lib.normalize_images(images).permute(0, 3, 1, 2)
            shard = module.row_shard
            forward = module(x if shard is None else shard.split(x))
            out["cands"] = [t.cpu() for t in select_candidates(*forward, anchors, dcfg.model)]
            if plan.get("keep_forward"):
                out["forward"] = [t.cpu() for t in forward]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def spatial_rank(rank, world, backend, store, plan_path, out_path):
    """One of ``world`` ranks of a spatial run: gloo with every rank on
    card 0 (NCCL refuses two ranks on one card), or NCCL with rank r on
    card r; ``spatial_run`` (``spatial_serve_run`` for a plan of kind
    "serve") on the plan's mesh, its results to
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
        run = spatial_serve_run if plan.get("kind") == "serve" else spatial_run
        out = run(torch, dict(plan, keep_state=plan.get("keep_state") and rank == 0), mesh,
                  device)
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


SPATIAL_FORWARD_ATOL = 2e-4  # the reference's fp32 forward bar (tests/test_model_parity.py:24)


def spatial_post(torch, model_cfg):
    """The unsplit postprocess of a forward's head outputs on the card."""
    from shape_based_object_detection_torch.detection import postprocess
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model

    anchors = anchors_for_model(model_cfg).cuda()

    def post(forward):
        with torch.inference_mode():
            return [t.cpu() for t in postprocess(*forward, anchors, model_cfg)]

    return post


def spatial_compare(torch, split, alone, name, backend, check_state=True, post=None):
    """The split ranks against the unsplit process: loss within 1e-5
    relative, grad_norm 1e-4, the parameters after the steps within 2e-5,
    every rank's parameters alike, the gathered detections at the
    reference's bounds (valid and labels equal, scores rtol 1e-5 atol 1e-7,
    boxes rtol 1e-5 atol 1e-6). With ``post`` (SSD's detect: the unsplit
    postprocess of a forward's head outputs on the card) the detect check
    is in two parts, as a fresh SSD's softmax scores crowd within float32's
    error of each other at the top-k cut and in NMS, where the split's
    other summation order (cuDNN picks its algorithms per shape, and a
    rank's windows are other shapes than the whole map) may flip a
    near-tie: the gathered head outputs within SPATIAL_FORWARD_ATOL of the
    unsplit ones, and each rank's detections bit-equal to ``post`` of its
    own gathered outputs; how many images also equal the unsplit detect at
    the reference's bounds is logged. Logs each rank's peak memory beside
    the unsplit process's. A detect-only run (no metrics) checks detect.
    Returns the worst differences."""
    from tests.torch_kernel_cases import same_detections

    trained = "metrics" in alone
    worst = {}
    for r in split if trained else ():
        for g, w in zip(r["metrics"], alone["metrics"]):
            for k in ("loss", "grad_norm", "num_pos", "loss_cls", "loss_box"):
                worst[k] = max(worst.get(k, 0.0), abs(g[k] - w[k]) / max(abs(w[k]), 1e-12))
    check_state &= trained
    if check_state:
        state = split[0]["state"]
        worst["params"] = max(float((state[k] - v).abs().max())
                              for k, v in alone["state"].items())
    alike = not trained or all(r["sums"] == split[0]["sums"] for r in split)
    det_ok, exact = True, []
    for r in split:
        g, w = r["det"], alone["det"]
        if post is None:
            det_ok &= (torch.equal(g[3], w[3]) and torch.equal(g[2], w[2])
                       and bool(torch.isclose(g[1], w[1], rtol=1e-5, atol=1e-7).all())
                       and bool(torch.isclose(g[0], w[0], rtol=1e-5, atol=1e-6).all()))
            continue
        worst["forward"] = max([worst.get("forward", 0.0)] + [
            float((a - b).abs().max()) for a, b in zip(r["forward"], alone["forward"])])
        det_ok &= all(torch.equal(a.cpu(), b) for a, b in zip(
            post([t.cuda() for t in r["forward"]]), g))
        exact.append(sum(same_detections([t[b:b + 1] for t in g], [t[b:b + 1] for t in w])
                         for b in range(w[3].shape[0])))
    if post is not None:
        det_ok &= worst["forward"] <= SPATIAL_FORWARD_ATOL
    n_det = int(alone["det"][3].sum())
    smi = nvidia_smi_line()
    peaks = ", ".join(f"rank {i} {r['peak'] / 2**30:.3f} GiB" for i, r in enumerate(split))
    log(f"[spatial] {name} over {backend}: {len(split)} ranks (data index, model index, "
        f"data size, data group): {[r['layout'] for r in split]}; "
        + (f"{SPATIAL_STEPS} steps vs one process on the global batch: worst relative "
           f"differences " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()
                                       if k != "params")
           + (f", parameters max |err| {worst['params']:.2e}" if check_state else "")
           + f" (bounds: loss 1e-5, grad_norm 1e-4, parameters 2e-5); ranks alike: "
             f"{alike}; " if trained else "")
        + (f"detect ({n_det} detections, threshold 0) equal at the reference's bounds: "
           f"{det_ok}; " if post is None else
           f"head outputs max |err| {worst['forward']:.3e} (bound {SPATIAL_FORWARD_ATOL}); "
           f"each rank's detect bit-equal to the unsplit postprocess of its head outputs, "
           f"within the bound: {det_ok}; images equal to the unsplit detect at the "
           f"reference's bounds, per rank: {exact} of {alone['det'][3].shape[0]}; ")
        + (f"K2 launches {[r['k2'] for r in split]} in {SPATIAL_STEPS} steps, "
           if trained else "")
        + f"K1 {[r['k1'] for r in split]} in one detect")
    log(f"[spatial] {name} peak memory (torch.cuda.max_memory_allocated over the checked "
        f"{'steps' if trained else 'detect'}): {peaks}; unsplit "
        f"{alone['peak'] / 2**30:.3f} GiB ({smi})")
    images = alone["det"][0].shape[0] // split[0]["layout"][2]
    log(f"[spatial] {name} row exchanges in one forward of a data index's {images} images: "
        + ", ".join(f"rank {i} {r['halo'][0]} exchanges, {r['halo'][1]} bytes of "
                    f"other ranks' rows used, {r['halo'][2]} bytes brought in by the "
                    f"all-gathers" for i, r in enumerate(split)))
    ok = (alike and det_ok and n_det > 0 and all(r["k1"] == 1 for r in split)
          and (not trained or (worst["loss"] <= 1e-5 and worst["grad_norm"] <= 1e-4
                               and all(r["k2"] == SPATIAL_STEPS for r in split)))
          and (not check_state or worst["params"] <= 2e-5))
    if not ok:
        raise RuntimeError(f"{name}: the split run differs from the unsplit one: {worst}, "
                           f"alike {alike}, detect {det_ok}")
    return worst


SPATIAL_TTA_SCALES = (512, 640)  # 640 px: P7's 5 rows do not split over 2 ranks
SPATIAL_TIERS = ("weights", "dynamic", "static")


def spatial_serve_run(torch, plan, mesh, device):
    """The serving paths under the model axis in one process (``mesh``
    None: unsplit, alone), on the plan's images (a data index's): hflip
    TTA, two-scale TTA and the three int8 tiers of the serving R50-FPN-512,
    each with its K1 launches counted from 0 around one detect call, its
    detections and the candidates its merge (or NMS) takes; then, on rank 0
    of a mesh, the artifact of the row-split module (``export_detect`` of
    its unsplit copy)."""
    from shape_based_object_detection_torch import export, quantize
    from shape_based_object_detection_torch.detection import (
        MultiScaleBatchDetector, _concat, make_detect_fn, select_candidates,
        tta_hflip_candidates,
    )
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import nms_cuda
    from shape_based_object_detection_torch.parallel import spatial_image_sharding
    from shape_based_object_detection_torch.parallel.spatial import set_row_shard
    from shape_based_object_detection_torch.utils import image as image_lib

    cfg = plan["cfg"]
    images = torch.from_numpy(plan["images"]).to(device)
    shard = None if mesh is None else spatial_image_sharding(mesh, model=cfg.model)

    def model():
        module, anchors = build_model(cfg.model, device=device,
                                      generator=torch.Generator().manual_seed(plan["seed"]))
        with torch.no_grad():
            spatial_widen(module)
        return module, anchors

    def forward(module, x):  # this rank's rows of NHWC x, through the module
        x = x.permute(0, 3, 1, 2)
        return module(x if shard is None else shard.split(x))

    def run(name, detect, candidates):
        torch.cuda.synchronize(device)
        nms_cuda.launches = 0
        det = detect(images)
        torch.cuda.synchronize(device)
        launches = nms_cuda.launches
        with torch.inference_mode():
            cands = candidates()
        out[name] = {"det": [t.cpu() for t in det], "k1": launches,
                     "cands": [t.cpu() for t in cands]}

    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x = image_lib.normalize_images(images)
        hcfg = dataclasses.replace(cfg.model, detect=dataclasses.replace(
            cfg.model.detect, tta_hflip=True))
        module, anchors = model()
        run("hflip", make_detect_fn(module, anchors, hcfg, cfg.data, device, mesh),
            lambda: tta_hflip_candidates(*forward(module, torch.cat([x, x.flip(2)])),
                                         anchors, hcfg))
        ms = MultiScaleBatchDetector(cfg.model, module, SPATIAL_TTA_SCALES, cfg.data, device,
                                     mesh=mesh)
        run("scales", ms, lambda: _concat(ms.scale_detections(images)))
        for tier in SPATIAL_TIERS:
            qmodule = quantize.quantize_module(
                module, "weights" if tier == "weights" else "full",
                plan["act_scales"] if tier == "static" else None, device=device)
            run(tier, make_detect_fn(qmodule, anchors, cfg.model, cfg.data, device, mesh),
                lambda: select_candidates(*forward(qmodule, x), anchors, cfg.model))
            del qmodule
        if mesh is not None and mesh.rank == 0:
            set_row_shard(module, shard)
            export.save_artifact(export.export_detect(
                module, anchors, cfg.model, cfg.data, batch_size=SPATIAL_ARTIFACT_BATCH,
                device=device), plan["artifact"])
            out["artifact_kept_shard"] = module.row_shard is shard
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


SPATIAL_ARTIFACT_BATCH = 2


def spatial_matched(got, want):
    """Every image's detections (tensors on the host) matched one to one
    at the repo's end-to-end bar (``matched``, in both directions)."""
    for b in range(want[3].shape[0]):
        g, w = (tuple(t[b][d[3][b]].numpy() for t in d[:3]) for d in (got, want))
        try:
            matched(g, w)
            matched(w, g)
        except RuntimeError:
            return False
    return True


def spatial_serve(torch, config, nms, nms_cuda, workdir):
    """The serving R50-FPN-512 (float32, TF32 off, score threshold 0) at b16
    on 1 data x 2 model ranks over gloo sharing the card, each path against
    the unsplit process's same path, matched one to one at the repo's
    end-to-end bar (cuDNN picks its algorithms per shape, so a rank's
    windows may sum in another order than the whole map; whether the
    reference's tighter bounds hold is logged): hflip TTA, two-scale (512,
    640) TTA, the weight-only, full-dynamic and full-static int8 tiers; K1
    bit-equal to its plain version on each path's merged
    candidates (rank 0's), with its launches; then the artifact of the
    row-split module, loaded on the card, against the unsplit module's
    artifact. Returns K1's entries."""
    from shape_based_object_detection_torch import export, quantize
    from shape_based_object_detection_torch.models.factory import build_model
    from tests.torch_kernel_cases import same_detections

    cfg = spatial_config(config, "config2_retinanet_r50_infer", 16, 2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, detect=dataclasses.replace(cfg.model.detect, score_threshold=0.0)))
    images = np.random.default_rng(95).integers(0, 256, (16, 512, 512, 3), dtype=np.uint8)
    plan = {"kind": "serve", "cfg": cfg, "seed": 12, "images": images,
            "artifact": os.path.join(workdir, "spatial_split.sbdx")}
    module, anchors = build_model(cfg.model, device="cuda",
                                  generator=torch.Generator().manual_seed(plan["seed"]))
    with torch.no_grad():
        spatial_widen(module)
    plan["act_scales"] = quantize.calibrate_activation_scales(module, [images[:8]], cfg.data)
    alone = spatial_serve_run(torch, plan, None, torch.device("cuda", 0))
    torch.cuda.empty_cache()
    split = spatial_ranks(plan, 2, "gloo", workdir, "spatial_serve")
    want_k1 = {"hflip": 1, "scales": len(SPATIAL_TTA_SCALES) + 1,
               **{tier: 1 for tier in SPATIAL_TIERS}}
    k1 = {}
    for path, launches in want_k1.items():
        w = alone[path]
        exact = [same_detections(r[path]["det"], w["det"]) for r in split]
        same = all(spatial_matched(r[path]["det"], w["det"]) for r in split)
        score_err = max(float((r[path]["det"][1] - w["det"][1]).abs().max()) for r in split)
        n_det = int(w["det"][3].sum())
        got_k1 = [r[path]["k1"] for r in split]
        log(f"[spatial] serving {path} (R50-FPN-512 b16, 1 x 2 over gloo): detections "
            f"({n_det}) matched one to one to unsplit at the repo's end-to-end bar (label, "
            f"IoU >= 0.99, |score difference| <= 1e-3): {same}; equal at the reference's "
            f"bounds per rank: {exact}; max |score difference| slot by slot {score_err:.3e}; "
            f"K1 launches {got_k1} per detect (unsplit {w['k1']}, expected {launches})")
        if not (same and n_det > 0 and all(k == launches for k in got_k1)
                and w["k1"] == launches):
            raise RuntimeError(f"serving {path} under the model axis differs from unsplit")
        cands = [c.cuda() for c in split[0][path]["cands"]]
        k1[f"spatial_{path}_launches"] = sum(got_k1)
        k1[f"spatial_{path}_max_abs_err"] = k1_on(
            torch, nms, cands, cfg.model.detect, f"the split {path} path's candidates (rank 0)")
        if path in ("hflip", "scales", "static"):
            k1.update({f"spatial_{path}_{k}": v for k, v in nms_timing(
                nms, nms_cuda, cands, cfg.model.detect,
                f"the split {path} path's candidates").items()})
    # the artifact: a program for one device, exported from a row-split module
    if not split[0].get("artifact_kept_shard"):
        raise RuntimeError("export_detect changed the row-split module's shard")
    blob = export.export_detect(module, anchors, cfg.model, cfg.data,
                                batch_size=SPATIAL_ARTIFACT_BATCH, device="cuda")
    got = export.load_artifact(plan["artifact"], "cuda")(images[:SPATIAL_ARTIFACT_BATCH])
    want = export.load_detect(blob, "cuda")(images[:SPATIAL_ARTIFACT_BATCH])
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"[spatial] the artifact exported from a row-split module (rank 0), loaded on the "
        f"card: detections ({int(want.valid.sum())}) equal to the unsplit module's artifact "
        f"bit for bit: {same}")
    if not (same and bool(want.valid.any())):
        raise RuntimeError("the row-split module's artifact differs from the unsplit one")
    return k1


def phase_spatial(torch, config, nms, nms_cuda, matching, matching_cuda, workdir):
    """The model axis (image rows split across ranks) on the card: config
    #5's model (R101-FPN, 1024 px, float32 with TF32 off, focal, the
    whole-forward train.remat) on 1 data x 2 model ranks over gloo sharing
    the card, b2: its train steps and detect against one process's; where
    the machine has two or more cards the same over NCCL; then 2 data x 2
    model ranks (R50-FPN-512, b4); config #3's SSD-512 (b8) on 1 x 2 and
    config #1's SSD300 detect (b16) on 1 x 4, whose maps split unevenly;
    the serving R50-FPN-512's TTA, int8 tiers and artifact on 1 x 2
    (``spatial_serve``); K1 and K2 bit-equal to their plain versions on
    these paths' candidates and GT, and their times there. Returns
    (results, K1 entries, K2 entries)."""
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
    alone = spatial_run(torch, plan, None, torch.device("cuda", 0))
    torch.cuda.empty_cache()
    log(f"[spatial] config #5 (R101-FPN 1024 px fp32, TF32 off, train.remat, focal, b2) in one "
        f"process: loss {alone['metrics'][-1]['loss']:.6f}")
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    if len(backends) == 1:
        log(f"[spatial] NCCL: not run, the machine has {torch.cuda.device_count()} card "
            "(NCCL takes one rank per card)")
    for backend in backends:
        split = spatial_ranks(plan, 2, backend, workdir, f"spatial_{backend}")
        worst = spatial_compare(torch, split, alone, "config #5 on 1 data x 2 model", backend)
        out.update({f"spatial_{backend}_worst_rel_{k}": v for k, v in worst.items()})
        out.update({f"spatial_{backend}_rank{i}_peak_bytes": r["peak"]
                    for i, r in enumerate(split)})
        if backend == "gloo":
            gloo = split
    out.update({"spatial_unsplit_peak_bytes": alone["peak"],
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
    del alone, split
    torch.cuda.empty_cache()

    # config #3's SSD-512 as its preset sets it (VGG-16, 512 px, shape_weight
    # 0.3, multibox 3:1), cut from b32 to b8, on 1 data x 2 model ranks: its
    # maps (64, 32, ..., 2, 1 rows) split unevenly from 4 rows down
    cfg3 = spatial_config(config, "config3_ssd512_voc_train", 8, 2)
    plan = {"cfg": cfg3, "seed": 13, "keep_state": True, "keep_forward": True,
            "batch": train_batch(np.random.default_rng(96), 8, g=100, classes=20),
            "images": np.random.default_rng(97).integers(0, 256, (8, 512, 512, 3),
                                                           dtype=np.uint8),
            "detect_cfg": dataclasses.replace(cfg3, model=dataclasses.replace(
                cfg3.model, detect=dataclasses.replace(cfg3.model.detect,
                                                       score_threshold=0.0)))}
    alone = spatial_run(torch, plan, None, torch.device("cuda", 0))
    torch.cuda.empty_cache()
    split = spatial_ranks(plan, 2, "gloo", workdir, "spatial_ssd512")
    worst = spatial_compare(torch, split, alone, "config #3 SSD-512 (b8) on 1 data x 2 model",
                            "gloo", post=spatial_post(torch, cfg3.model))
    out.update({f"spatial_ssd512_worst_rel_{k}": v for k, v in worst.items()})
    out.update({"spatial_ssd512_unsplit_peak_bytes": alone["peak"],
                **{f"spatial_ssd512_rank{i}_peak_bytes": r["peak"]
                   for i, r in enumerate(split)}})
    k1["spatial_ssd512_launches"] = sum(r["k1"] for r in split)
    k2["spatial_ssd512_launches"] = sum(r["k2"] for r in split)
    cands = [c.cuda() for c in split[0]["cands"]]
    k1["spatial_ssd512_max_abs_err"] = k1_on(torch, nms, cands, cfg3.model.detect,
                                             "the split SSD-512 detect's candidates (rank 0)")
    k1.update({f"spatial_ssd512_{k}": v for k, v in nms_timing(
        nms, nms_cuda, cands, cfg3.model.detect, "the split SSD-512 detect's candidates").items()})
    anchors = anchors_for_model(cfg3.model).cuda()
    gt, lbl, ok = (torch.from_numpy(plan["batch"][k]).cuda() for k in ("boxes", "labels",
                                                                          "valid"))
    passed, err, line = match_check(anchors, gt, lbl, ok, cfg3.match.shape_weight,
                                    cfg3.model.anchors.variances, cfg=cfg3.match, exact=True)
    log(f"[kernel] match_anchors on the split SSD-512 step's GT (config #3, (B, A, G) = (8, "
        f"{anchors.shape[0]}, 100), shape_weight {cfg3.match.shape_weight}): {line}")
    if not passed:
        raise RuntimeError("match_anchors differs from the plain version on config #3's GT")
    k2["spatial_ssd512_max_abs_err"] = err
    k2.update({f"spatial_ssd512_{k}": v for k, v in match_timing(
        torch, matching, matching_cuda, anchors, cfg3, "the split SSD-512 step", gt, lbl,
        ok).items()})
    del alone, split, cands
    torch.cuda.empty_cache()

    # config #1's SSD300 detect at b16 on 1 x 4 ranks: 19 rows over 4 give
    # conv6 (dilation 6) windows that reach past the neighbouring rank
    cfg1 = spatial_config(config, "config1_ssd300_infer", 16, 4)
    cfg1 = dataclasses.replace(cfg1, model=dataclasses.replace(
        cfg1.model, detect=dataclasses.replace(cfg1.model.detect, score_threshold=0.0)))
    plan = {"cfg": cfg1, "seed": 14, "train": False, "detect_cfg": cfg1, "keep_forward": True,
            "images": np.random.default_rng(98).integers(0, 256, (16, 300, 300, 3),
                                                           dtype=np.uint8)}
    alone = spatial_run(torch, plan, None, torch.device("cuda", 0))
    torch.cuda.empty_cache()
    split = spatial_ranks(plan, 4, "gloo", workdir, "spatial_ssd300")
    spatial_compare(torch, split, alone, "config #1 SSD300 detect (b16) on 1 data x 4 model",
                    "gloo", post=spatial_post(torch, cfg1.model))
    k1["spatial_ssd300_launches"] = sum(r["k1"] for r in split)
    cands = [c.cuda() for c in split[0]["cands"]]
    k1["spatial_ssd300_max_abs_err"] = k1_on(torch, nms, cands, cfg1.model.detect,
                                             "the split SSD300 detect's candidates (rank 0)")
    k1.update({f"spatial_ssd300_{k}": v for k, v in nms_timing(
        nms, nms_cuda, cands, cfg1.model.detect, "the split SSD300 detect's candidates").items()})
    del alone, split, cands
    torch.cuda.empty_cache()

    # the serving tier under the model axis: TTA, the int8 tiers, the artifact
    k1.update(spatial_serve(torch, config, nms, nms_cuda, workdir))
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
    with its lines. Returns (K1 rows, K2 rows)."""
    from shape_based_object_detection_torch.checkpoint import CheckpointManager
    from shape_based_object_detection_torch.export import load_artifact
    from shape_based_object_detection_torch.tools import (
        average_checkpoints, convert_checkpoint, export_model,
    )
    from tests.torch_kernel_cases import torchvision_vgg16

    k1, k2 = {}, {}
    config3 = ["--config", "config3_ssd512_voc_train"]
    train = [*config3, "--data-root", APP_TRAIN, "--workers", "8", "--log-every", "1"]
    run, avg = os.path.join(workdir, "tools_run"), os.path.join(workdir, "tools_avg")

    run_cli(cli_train.main, [*train, "--steps", "3", "--set", "train.checkpoint_every=1",
                             "--checkpoint-dir", run])
    steps = CheckpointManager(run).all_steps()
    if steps != [1, 2, 3]:
        raise RuntimeError(f"the config #3 run kept checkpoints {steps}, not [1, 2, 3]")
    run_cli(average_checkpoints.main, [*config3, "--checkpoint-dir", run, "--last", "3",
                                       "--out", avg])
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
    text = run_cli(cli_eval.main, [*config3, "--data-root", APP_VAL, "--checkpoint-dir", avg,
                                   "--set", "model.detect.score_threshold=0.0"])
    torch.cuda.synchronize()
    k1["tools_eval_launches"] = nms_cuda.launches
    if nms_cuda.launches != 2 or "mAP" not in text:
        raise RuntimeError(f"eval_cli on the averaged checkpoint launched K1 "
                           f"{nms_cuda.launches} times for 2 batches: {text[-300:]}")

    artifact = os.path.join(workdir, "tools_avg.sbdx")
    run_cli(export_model.main, [*config3, "--checkpoint-dir", avg, "--batch-size", "2",
                                "--out", artifact])
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
    text = run_cli(cli_train.main, [*train, "--steps", "4", "--checkpoint-dir", avg])
    torch.cuda.synchronize()
    k2["tools_resume_launches"] = matching_cuda.launches
    if (matching_cuda.launches != 1 or "restored checkpoint at step 3" not in text
            or "done at step 4" not in text):
        raise RuntimeError(f"train_cli did not resume from the average for one step: "
                           f"{text[-300:]}")

    vgg = torchvision_vgg16(np.random.default_rng(31))
    with torch.no_grad():
        for key, v in vgg.items():  # lecun-normal, as trained weights are scaled
            if key.endswith("weight"):
                v.mul_(1.0 / np.sqrt(v[0].numel()))
    vgg_path, init = os.path.join(workdir, "vgg16.pth"), os.path.join(workdir, "vgg_init.pt")
    torch.save(vgg, vgg_path)
    run_cli(convert_checkpoint.main, ["--model", "config3_ssd512_voc_train", "--torch-ckpt",
                                      vgg_path, "--mode", "vgg_backbone", "--out", init])
    conv = torch.load(init, weights_only=True)
    fc6 = vgg["classifier.0.weight"].reshape(4096, 512, 7, 7)[::4, :, ::3, ::3]
    merged = (torch.equal(conv["vgg.conv1_1.weight"], vgg["features.0.weight"])
              and torch.equal(conv["vgg.conv6.weight"], fc6))
    n_vgg = sum(v.numel() for v in vgg.values())
    del vgg, conv, fc6
    reset_counts()
    text = run_cli(cli_train.main, [*train, "--steps", "2", "--init-params", init,
                                    "--checkpoint-dir", os.path.join(workdir, "tools_init")])
    torch.cuda.synchronize()
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
        proc = subprocess.run(
            [sys.executable, "-m", f"shape_based_object_detection_torch.examples.{name}",
             *args, *(["--out", folder] if name == "demo" else [])],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        missing = [e for e in expect if e not in proc.stdout]
        for line in proc.stdout.splitlines():
            log(f"[{name}] {line}")
        if proc.returncode != 0 or missing:
            raise RuntimeError(f"example {name} exited {proc.returncode}, missing {missing}: "
                               f"{proc.stderr[-2000:]}")
    return k1, k2


ACCURACY_STEPS = 1000  # per arm of the ablation's seed
ACCURACY_R50_STEPS = 24  # ablate_tta's RetinaNet branch: drives the path only
ACCURACY_RECORDED = {0.0: (4.64, 23.4), 0.3: (6.25, 25.5)}  # ssd300, 200 GTs (the reference's)


def accuracy_matching_analysis(torch, config, matching, matching_cuda, reset_counts):
    """tools/matching_analysis on R50-FPN-512's 49104 anchors and SSD300's
    8732 with 200 GTs: 5 K2 launches per model, each result (positives,
    matched GT) bit-equal to the plain route's on the same card tensors,
    the table printed; SSD300's rows at w = 0 and 0.3 as the reference
    recorded them. K2 timed at (1, A, 200). Returns (results, K2 entries)."""
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model
    from shape_based_object_detection_torch.tools import matching_analysis as ma

    out, k2 = {}, {}
    launches = 0
    for model, tag in (("retinanet_r50_fpn", "r50"), ("ssd300", "ssd300")):
        cfg = config.get_config(model)
        reset_counts()
        n, n_extreme, rows = ma.analysis_rows(model, 200, 0, "cuda")
        torch.cuda.synchronize()
        if matching_cuda.launches != len(ma.SHAPE_WEIGHTS):
            raise RuntimeError(f"matching_analysis on {model} launched K2 "
                               f"{matching_cuda.launches} times for {len(ma.SHAPE_WEIGHTS)} rows")
        launches += matching_cuda.launches
        anchors = anchors_for_model(cfg.model).cuda()
        gt, _ = ma.synthetic_gt(200, 0)
        variances = cfg.model.anchors.variances
        for w in ma.SHAPE_WEIGHTS:
            got = ma.match_one(anchors, gt, w, variances, "auto")
            want = ma.match_one(anchors, gt, w, variances, "plain")
            if not (torch.equal(got.positive, want.positive)
                    and torch.equal(got.matched_gt_idx, want.matched_gt_idx)):
                raise RuntimeError(f"matching_analysis on {model}, w={w}: K2's positives or "
                                   "matched GTs differ from the plain route's")
        log(f"[accuracy] matching_analysis --model {model} ({nvidia_smi_line()}): 200 synthetic "
            f"GT on {n} anchors ({n_extreme} with extreme aspect); K2 launches "
            f"{len(ma.SHAPE_WEIGHTS)}, positives and matched GTs bit-equal to the plain route")
        log(f"[accuracy] {'shape_w':>8} {'pos/gt':>8} {'gt w/ pos':>10} {'extreme w/ pos':>15}")
        for w, per_gt, covered, extreme in rows:
            log(f"[accuracy] {w:>8.1f} {per_gt:>8.2f} {covered:>9.1f}% {extreme:>14.1f}%")
            out[f"accuracy_analysis_{tag}_w{w:g}"] = [per_gt, covered, extreme]
        if model == "ssd300":
            got = {w: (round(per_gt, 2), round(extreme, 1))
                   for w, per_gt, _, extreme in rows}
            for w, want in ACCURACY_RECORDED.items():
                if got[w] != want:
                    raise RuntimeError(f"matching_analysis ssd300 w={w}: (positives per GT, "
                                       f"extreme coverage %) {got[w]}, recorded {want}")
            log("[accuracy] ssd300 rows at w = 0 and 0.3 equal the recorded 4.64 / 6.25 "
                "positives per GT and 23.4 % / 25.5 % extreme-aspect coverage")
        lbl = torch.ones((1, 200), dtype=torch.int32, device=anchors.device)
        ok = torch.ones((1, 200), dtype=torch.bool, device=anchors.device)
        mcfg = dataclasses.replace(cfg, match=ma.match_config(0.3))
        timing = match_timing(torch, matching, matching_cuda, anchors, mcfg,
                              f"matching_analysis {model} (w = 0.3)",
                              torch.from_numpy(gt)[None].cuda(), lbl, ok)
        k2.update({f"accuracy_analysis_{tag}_{k}": v for k, v in timing.items()})
    k2["accuracy_analysis_launches"] = launches
    return out, k2


@contextlib.contextmanager
def last_nms_input(detection):
    """While the block runs, ``detection.run_nms`` (through which every
    detect path reaches K1) keeps the candidate set it was last handed:
    the yielded list holds it, so a check runs K1 on what the path gave."""
    kept, run = [], detection.run_nms

    def keep(*args, **kw):
        kept[:] = [args[:4]]
        return run(*args, **kw)

    detection.run_nms = keep
    try:
        yield kept
    finally:
        detection.run_nms = run


def counted(torch, nms_cuda, reset_counts, launched, kept, detection):
    """An ``each(name, run)`` for ``score_modes``/``score_tiers``: the
    launch counts set to 0 before each mode, its K1 launches read after
    into ``launched``, the candidates of its last NMS call into ``kept``."""
    def each(name, run):
        reset_counts()
        with last_nms_input(detection) as cands:
            ev = run()
        torch.cuda.synchronize()
        launched[name], kept[name] = nms_cuda.launches, cands[0]
        return ev

    return each


def same_metrics(a: dict, b: dict) -> bool:
    """Equal metric dicts, NaN equal to NaN."""
    return set(a) == set(b) and all(
        same_metrics(a[k], b[k]) if isinstance(a[k], dict)
        else (a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k]))) for k in a)


def accuracy_arms(torch, detection, nms, nms_cuda, matching, matching_cuda, reset_counts,
                  workdir):
    """Both arms of seed 7 of tools/ablate_matching at full width (SSD300, 20
    classes, device loader, b16, 512/128 images, aspect_std 1.2): one K2
    launch per step, one K1 per validation batch, K1 bit-equal to its plain
    version on each arm's last validation batch, each arm's mAP above the
    fresh model's on the same split. Returns (results, K1 entries, K2
    entries, the w = 0 arm, args)."""
    from shape_based_object_detection_torch.tools import ablate_matching as am
    from shape_based_object_detection_torch.tools._ablation import device_field
    from tests.torch_kernel_cases import match_check

    args = am._parser().parse_args([
        "--model-preset", "ssd300", "--num-classes", "20", "--loader", "device",
        "--batch", "16", "--steps", str(ACCURACY_STEPS), "--lr", "1e-3",
        "--train-images", "512", "--val-images", "128", "--max-objects", "8",
        "--aspect-std", "1.2", "--seeds", "1",
        "--cache-dir", os.path.join(workdir, "ablate_cache")])
    out, k1, k2 = {}, {"accuracy_launches": 0}, {"accuracy_launches": 0}
    device = device_field("cuda")
    rows, arms = [], {}
    val_batches = -(-args.val_images // args.batch)
    for w in (0.0, args.shape_weight):
        arm = am.build_arm(args, w, seed=7)
        mcfg = arm.cfg.match
        first = next(iter(arm.train_batches(0)))
        passed, err, line = match_check(arm.anchors, first.boxes, first.labels, first.valid,
                                        mcfg.shape_weight, arm.cfg.model.anchors.variances,
                                        cfg=mcfg, exact=True)
        (b, g), a = first.labels.shape, arm.anchors.shape[0]
        log(f"[kernel] match_anchors on the ablation's first (unaugmented) training batch "
            f"(B, A, G)=({b}, {a}, {g}), {int(first.valid.sum())} valid GTs, shape_weight {mcfg.shape_weight:g}, force_match_for_each_gt "
            f"{mcfg.force_match_for_each_gt}: {line}")
        if not passed:
            raise RuntimeError(f"match_anchors differs from the plain version on the "
                               f"ablation's training batch at shape_weight {w:g}")
        k2[f"accuracy_w{w:g}_max_abs_err"] = err
        fresh = am.score_arm(arm)
        reset_counts()
        _, last_loss, train_s = am.train_arm(args, arm, w)
        steps_k2 = matching_cuda.launches
        reset_counts()
        with last_nms_input(detection) as kept:
            metrics = am.score_arm(arm)
        torch.cuda.synchronize()
        score_k1 = nms_cuda.launches
        k1["accuracy_launches"] += score_k1
        k2["accuracy_launches"] += steps_k2
        row = am.arm_row(args, w, 7, metrics, last_loss, train_s, device)
        rows.append(row)
        shown = {k: v for k, v in row.items() if k != "train_s"}  # times are the benchmark's
        log(f"[accuracy] ablate_matching arm w={w:g} seed 7: {json.dumps(shown)}")
        log(f"[accuracy] arm w={w:g}: K2 launches {steps_k2} in {args.steps} steps, K1 "
            f"launches {score_k1} in {val_batches} validation batches; mAP "
            f"{metrics['mAP']:.4f} against the fresh model's {fresh['mAP']:.4f}")
        if steps_k2 != args.steps or score_k1 != val_batches:
            raise RuntimeError(f"arm w={w}: K2 {steps_k2} for {args.steps} steps, K1 "
                               f"{score_k1} for {val_batches} batches")
        if not metrics["mAP"] > fresh["mAP"]:
            raise RuntimeError(f"arm w={w}: mAP {metrics['mAP']} after {args.steps} steps is "
                               f"not above the fresh model's {fresh['mAP']}")
        cands = kept[0]  # the eval step's, on the last validation batch
        err = k1_on(torch, nms, cands, arm.cfg.model.detect,
                    f"arm w={w:g}'s last validation batch (trained scores)")
        k1[f"accuracy_w{w:g}_max_abs_err"] = err
        out[f"accuracy_arm_w{w:g}_mAP"] = metrics["mAP"]
        out[f"accuracy_arm_w{w:g}_fresh_mAP"] = fresh["mAP"]
        if w == 0.0:
            k1.update({f"accuracy_{k}": v for k, v in nms_timing(
                nms, nms_cuda, cands, arm.cfg.model.detect,
                "the trained SSD300's last validation batch").items()})
            k2.update({f"accuracy_step_{k}": v for k, v in match_timing(
                torch, matching, matching_cuda, arm.anchors, arm.cfg,
                "the ablation's first (unaugmented) training batch, SSD300 w = 0",
                first.boxes, first.labels, first.valid).items()})
        arms[w] = arm
    summary = am.summary(args, [7], rows, device)
    log(f"[accuracy] ablate_matching seed 7 paired delta (shape - IoU) "
        f"{summary['value']:+.4f} mAP after {args.steps} steps per arm ({device}): "
        f"{json.dumps({k: v for k, v in summary.items() if k != 'arms'})}")
    out["accuracy_delta"] = summary["value"]
    del arms[args.shape_weight]
    return out, k1, k2, arms[0.0], args


def accuracy_tta_and_tiers(torch, detection, nms, nms_cuda, reset_counts, arm, args):
    """The w = 0 arm's trained SSD300 through tools/ablate_tta's and
    tools/ablate_quantize's scoring (score threshold 0.05 as those tools
    set it) on the ablation's validation split: plain and hflip TTA, the
    four tiers; one K1 launch per batch in each; the float tier's metrics
    equal to the plain mode's; K1 bit-equal on the hflip merge of the last
    batch and timed there. Returns (results, K1 entries)."""
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.tools import ablate_matching as am
    from shape_based_object_detection_torch.tools import ablate_quantize as aq
    from shape_based_object_detection_torch.tools import ablate_tta as at

    cfg = arm.cfg
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, detect=dataclasses.replace(cfg.model.detect, score_threshold=0.05)))
    _, val_ds = am._splits(args, cfg)
    loader = Loader(val_ds, cfg.data.batch_size, cfg.data.max_boxes, shuffle=False)
    batches = len(val_ds) // cfg.data.batch_size
    launched, kept = {}, {}
    each = counted(torch, nms_cuda, reset_counts, launched, kept, detection)
    with contextlib.redirect_stdout(Tee("[accuracy] ablate_tta/ablate_quantize ")):
        evs = at.score_modes(cfg, arm.module, val_ds, loader, "cuda", each=each)
        evs.update(aq.score_tiers(cfg, arm.module, loader, 2, "cuda", each=each))
    log(f"[accuracy] K1 launches per mode and tier {launched} in {batches} batches each")
    if any(n != batches for n in launched.values()):
        raise RuntimeError(f"K1 launches {launched}, not one per batch of {batches}")
    k1 = {"accuracy_tta_launches": launched["plain"] + launched["hflip-tta"],
          "accuracy_tier_launches": sum(launched[name] for name, *_ in aq.TIERS)}
    maps = {name: ev.coco()["mAP"] for name, ev in evs.items()}
    if not same_metrics(evs["float"].coco(), evs["plain"].coco()):
        raise RuntimeError(f"the float tier's metrics differ from the plain mode's: "
                           f"{maps['float']} against {maps['plain']}")
    for name in ("weights", "full-dynamic", "full-static"):
        log(f"[accuracy] tier {name}: COCO mAP {maps[name]:.4f}, drift from float "
            f"{maps[name] - maps['float']:+.4f}")
    log(f"[accuracy] the float tier's metrics equal the plain mode's to the bit (mAP "
        f"{maps['float']!r}); hflip TTA {maps['hflip-tta'] - maps['plain']:+.4f} mAP; "
        f"largest |int8 drift| "
        f"{max(abs(maps[name] - maps['float']) for name, *_ in aq.TIERS):.4f} "
        f"({nvidia_smi_line()})")
    out = {f"accuracy_map_{name}": v for name, v in maps.items()}
    merge = kept["hflip-tta"]
    k1["accuracy_hflip_max_abs_err"] = k1_on(torch, nms, merge, cfg.model.detect,
                                             "the trained SSD300's hflip merge")
    k1.update({f"accuracy_hflip_{k}": v for k, v in nms_timing(
        nms, nms_cuda, merge, cfg.model.detect, "the trained SSD300's hflip merge").items()})
    return out, k1


def accuracy_multiscale(torch, config, detection, nms, nms_cuda, reset_counts):
    """tools/ablate_tta's RetinaNet branch: R50-FPN-512 (the preset in bf16)
    trained a few dozen steps at b8 with hflip augmentation, then plain and
    hflip TTA and multi-scale TTA at (512, 640) without and with hflip on 8
    held-out images: K1 once per batch, and 3 times per image of the 2-scale
    merge. The mAP after so few steps means nothing. Returns K1's
    entries."""
    from shape_based_object_detection_torch.detection import MultiScaleDetector
    from shape_based_object_detection_torch.tools import ablate_tta as at
    from shape_based_object_detection_torch.tools._ablation import (
        eval_split, preset_config, serving_module, train_preset,
    )

    cfg = preset_config("retinanet_r50_fpn", 8, hflip=True)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    trained, _ = train_preset(cfg, ACCURACY_R50_STEPS, 16, "cuda", augment=True,
                              what=" (hflip aug on)")
    torch.cuda.synchronize()
    dataset, loader = eval_split(cfg, 8)
    launched, kept = {}, {}
    with contextlib.redirect_stdout(Tee("[accuracy] ablate_tta R50-FPN-512 bf16 ")):
        at.score_modes(cfg, trained, dataset, loader, "cuda",
                       each=counted(torch, nms_cuda, reset_counts, launched, kept, detection))
    want = {name: 3 * len(dataset) if name.startswith("ms") else 1 for name in launched}
    log(f"[accuracy] ablate_tta R50-FPN-512 bf16: K1 launches {launched} (want {want})")
    if launched != want or len(want) != 4:
        raise RuntimeError(f"ablate_tta R50 launched K1 {launched} times, not {want}")
    log(f"[accuracy] R50-FPN-512 bf16: {ACCURACY_R50_STEPS} steps at b8; after so few steps "
        "its mAP means nothing: this drives the path")
    k1 = {"accuracy_multiscale_launches": sum(n for name, n in launched.items()
                                              if name.startswith("ms"))}
    # the merge's candidates at score threshold 0: after so few steps the
    # focal prior keeps every score under the tool's 0.05
    zero = dataclasses.replace(cfg.model, detect=dataclasses.replace(
        cfg.model.detect, score_threshold=0.0))
    module, _ = serving_module(cfg.model, trained, "cuda")
    scales = at.multiscale_scales(cfg.model.image_size)
    msd = MultiScaleDetector(zero, module, scales, cfg.data, "cuda")
    with last_nms_input(detection) as merge:  # its last NMS call is the merge
        msd(dataset[0][0])
    k1["accuracy_multiscale_max_abs_err"] = k1_on(
        torch, nms, merge[0], zero.detect, f"the trained R50's 2-scale merge {scales}, threshold 0")
    k1.update({f"accuracy_multiscale_{k}": v for k, v in nms_timing(
        nms, nms_cuda, merge[0], zero.detect, "the trained R50's 2-scale merge").items()})
    return k1


def phase_accuracy(torch, config, detection, nms, nms_cuda, matching, matching_cuda,
                   reset_counts, workdir):
    """The accuracy tools on the card. Returns (results, K1 entries, K2
    entries)."""
    out, k2 = accuracy_matching_analysis(torch, config, matching, matching_cuda, reset_counts)
    arms_out, k1, arms_k2, arm, args = accuracy_arms(
        torch, detection, nms, nms_cuda, matching, matching_cuda, reset_counts, workdir)
    out.update(arms_out)
    k2.update(arms_k2)
    tiers_out, tiers_k1 = accuracy_tta_and_tiers(torch, detection, nms, nms_cuda,
                                                 reset_counts, arm, args)
    out.update(tiers_out)
    k1.update(tiers_k1)
    del arm
    torch.cuda.empty_cache()
    k1.update(accuracy_multiscale(torch, config, detection, nms, nms_cuda, reset_counts))
    return out, k1, k2


PHASES = ("base", "k3", "bn", "pipelined", "app", "ckpt", "loader", "serve", "int8", "data",
          "dist", "spatial", "tools", "accuracy")


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
    from shape_based_object_detection_torch.ops import (
        frozen_bn_cuda, matching, matching_cuda, nms, nms_cuda,
    )
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model

    def reset_counts():
        """Every kernel's launch count to 0, just before a path is driven."""
        nms_cuda.launches = 0
        matching_cuda.launches = 0
        frozen_bn_cuda.launches = 0

    def passed(group):
        if want(group):
            log(f"[group] {group} passed, {time.perf_counter() - t0:.1f} s into the run")

    results, k1, k2, k3 = {}, {}, {}, {}
    if want("base"):
        nms_err, walk_rows = phase_kernel(torch, nms, nms_cuda)
        phase_forward(torch, config, build_model, make_detect_fn)
        nms_launches, k3["launches"] = phase_serving(  # the serving path's
            torch, config, serving, nms_cuda, frozen_bn_cuda, detection, reset_counts)
        nms_row = phase_nms_timing(torch, config, build_model, detection, nms, nms_cuda)
        match_err = phase_match_kernel(torch, config, anchors_for_model)
        phase_train_check(torch, config, train, build_model)
        state, _, _, anchors, cfg, batch, match_launches = phase_training(
            torch, train, build_model, matching_cuda, nms_cuda, reset_counts,
            train_config(config, "bfloat16", 16), train_batch(np.random.default_rng(8), 16),
            "bf16 R50-FPN-512 trainer b16")
        match_row = phase_train_match_timing(torch, matching, matching_cuda, state, anchors,
                                             cfg, batch)
        del state, anchors, batch

        # the SSD family: config #3's matching, then SSD300 serving, then
        # SSD-512 training, remat, and trainable BatchNorm on R50-FPN-512
        ssd_match_err = phase_ssd_match_kernel(torch, config, anchors_for_model, augment_batch)
        phase_ssd_forward(torch, config, build_model, make_detect_fn)
        ssd_nms_launches, pred = phase_ssd_serving(torch, config, serving, nms_cuda,
                                                   reset_counts)
        ssd_nms = phase_ssd_nms(torch, detection, nms, nms_cuda, pred)
        del pred
        ssd_cfg = ssd_train_config(config, 2, warmup_steps=1, lr_decay_steps=(60_000, 80_000))
        ssd_cfg = dataclasses.replace(ssd_cfg, model=dataclasses.replace(
            ssd_cfg.model, precision="highest"))
        train_check(torch, train, build_model, ssd_cfg,
                    train_batch(np.random.default_rng(17), 2, g=100, classes=20),
                    "SSD-512 (config #3, shape_weight 0.3)")
        state, _, module, anchors, ssd_cfg, batch, ssd_match_launches = phase_training(
            torch, train, build_model, matching_cuda, nms_cuda, reset_counts,
            ssd_train_config(config, 32),
            train_batch(np.random.default_rng(18), 32, g=100, classes=20),
            "SSD-512 config #3 trainer (fp32, b32, shape_weight 0.3)")
        ssd_match = phase_train_match_timing(torch, matching, matching_cuda, state, anchors,
                                             ssd_cfg, batch, ties=False)
        del state
        results.update(phase_remat(torch, train, build_model, module, anchors, ssd_cfg, batch))
        del module, batch
        torch.cuda.empty_cache()
        phase_train_bn(torch, config, train, build_model)
        k1.update({
            "launches": nms_launches,  # the serving path's
            "bit_equal": True,  # phase_kernel raises on any differing bit
            "max_abs_err": nms_err,
            **nms_row,
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
            **match_row,
            "library_ms": None,
            # the SSD-512 trainer's launches, and K2 at (32, 24564, 100) with
            # shape_weight 0.3 there
            "ssd_launches": ssd_match_launches,
            "ssd_max_abs_err": ssd_match_err,
            **{f"ssd_{k}": v for k, v in ssd_match.items()}})
    passed("base")

    if want("k3"):
        k3.update(phase_frozen_bn_kernel(torch, config, serving))
    passed("k3")
    # the training application
    if want("bn"):
        results.update(phase_bn_repair(torch, config, build_model))
    passed("bn")
    if want("pipelined"):
        results.update(phase_pipelined(
            torch, train, build_model, matching_cuda, train_config(config, "bfloat16", 16),
            [train_batch(np.random.default_rng(30 + i), 16) for i in range(4)],
            "r50_b16_bf16"))
        results.update(phase_pipelined(
            torch, train, build_model, matching_cuda, ssd_train_config(config, 32),
            [train_batch(np.random.default_rng(40 + i), 32, g=100, classes=20)
             for i in range(4)], "ssd512_b32_fp32"))
    passed("pipelined")
    if want("app"):
        ckpt, cli_k1, cli_k2 = phase_app(torch, cli_train, nms_cuda, matching_cuda,
                                         reset_counts, workdir)
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
    passed("app")
    if want("ckpt"):
        results.update(phase_ckpt_round_trip(torch, config, train, build_model, workdir))
    passed("ckpt")
    if want("loader"):
        phase_loader(torch)
    passed("loader")
    # the float serving tier: TTA, the NMS variants, the server and its CLIs
    if want("serve"):
        from shape_based_object_detection_torch.cli import detect_cli as cli_detect

        # K1 once per TTA batch, S + 1 per multi-scale batch, once per served
        # batch; its time and bound on the hflip and 2-scale merges
        k1.update(phase_serve_nms(torch, config, build_model, detection, nms, nms_cuda,
                                  reset_counts))
        k1.update(phase_serve_large_merges(torch, config, build_model, detection, nms,
                                           nms_cuda, reset_counts))
        k1.update(phase_serve_multiscale(torch, config, build_model, nms, nms_cuda,
                                         reset_counts))
        k1["serve_launches"] = phase_server(torch, config, serving, nms_cuda, reset_counts,
                                            workdir)
        k1["detect_cli_launches"] = phase_serve_clis(torch, cli_detect, nms_cuda,
                                                     reset_counts, workdir)
    passed("serve")
    # the int8 serving tiers and the exported artifact
    if want("int8"):
        int8_out, int8_k1 = phase_int8(torch, config, serving, detection, build_model,
                                       nms_cuda, reset_counts, workdir)
        results.update(int8_out)
        # K1 once per batch in every tier, 3 per 2-scale int8 batch, once per
        # artifact call
        k1.update(int8_k1)
    passed("int8")
    # the input pipelines: the cache, the card-staged cache, worker processes
    if want("data"):
        results.update(phase_data(torch, cli_train, matching_cuda, reset_counts, workdir))
    passed("data")
    # data parallelism: NCCL groups of one, torchrun, two ranks over gloo
    if want("dist"):
        dist_k1, dist_k2 = phase_dist_nccl(torch, config, train, build_model, matching_cuda,
                                           nms_cuda, nms, detection, reset_counts)
        cli_k2, cli_k1 = phase_dist_cli(torch, cli_eval, nms_cuda, reset_counts, workdir)
        results.update(phase_dist_gloo(torch, config, train, build_model, workdir))
        # K2 once per data-parallel step and K1 once per sharded eval batch
        k1.update({**dist_k1, **cli_k1})
        k2.update({**dist_k2, **cli_k2})
    passed("dist")
    # the model axis: image rows split across ranks (config #5, and 2 x 2)
    if want("spatial"):
        spatial_out, spatial_k1, spatial_k2 = phase_spatial(
            torch, config, nms, nms_cuda, matching, matching_cuda, workdir)
        results.update(spatial_out)
        k1.update(spatial_k1)
        k2.update(spatial_k2)
    passed("spatial")

    # the checkpoint tools and the examples
    if want("tools"):
        tools_k1, tools_k2 = phase_tools(torch, cli_train, cli_eval, nms_cuda, matching_cuda,
                                         reset_counts, workdir)
        k1.update(tools_k1)
        k2.update(tools_k2)
    passed("tools")

    # the accuracy tools: the matching analysis, the shape-matching
    # ablation's two arms, TTA and the int8 tiers on the trained weights
    if want("accuracy"):
        acc_out, acc_k1, acc_k2 = phase_accuracy(torch, config, detection, nms, nms_cuda,
                                                 matching, matching_cuda, reset_counts,
                                                 workdir)
        results.update(acc_out)
        k1.update(acc_k1)
        k2.update(acc_k2)
    passed("accuracy")

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
    }, {
        "name": "frozen_bn",
        "route": "cuda",
        "source": "shape_based_object_detection_torch/csrc/frozen_bn.cu",
        "replaces": None,  # flax's frozen BatchNorm, fused by XLA on the TPU
        **k3,
    }]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
