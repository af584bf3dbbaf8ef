"""Batched inference serving (port of the JAX package's ``serving.py``).

``Predictor.predict`` splits a request into batches, resizes and pads each on
the host to its bucket (the smallest batch size of ``bucket_sizes`` that
holds it), runs detect on the device and unpads the results. The next chunk
is prepared and launched before the previous one is read back, so host work
overlaps the device (PyTorch launches asynchronously on CUDA);
``submit``/``poll`` expose the same overlap to a caller (the HTTP server).
``Predictor`` serves a model in the float or an int8 tier (``quantize.py``);
``ArtifactPredictor`` serves an exported ``.sbdx`` program (``export.py``)
with the same surface and no model code.

On the card a ``Predictor`` captures each bucket's ``DetectProgram`` once,
at its first batch (``warmup`` runs one of each), as a CUDA graph, and
every later batch of the bucket is one replay: the host enqueues a copy
and a launch instead of the program's few hundred kernels. The buckets'
graphs hold their device memory in one shared pool. The paths that a graph
cannot hold stay eager: the CPU, a module split by rows over a model axis
(its halo exchanges are collectives), Soft-NMS (its loop makes host
constants per call) and ``ArtifactPredictor``. On every CUDA path each
batch is prepared in one of a few pinned host buffers, taken in turn, and
uploaded from there; its results are copied into pinned host memory behind
its launch, and ``poll`` waits for that batch's own event, not for the
batches launched after it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from shape_based_object_detection_torch import quantize as quantize_lib
from shape_based_object_detection_torch.config import ExperimentConfig
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.ops import frozen_bn_cuda, nms_cuda
from shape_based_object_detection_torch.ops.boxes import boxes_to_original
from shape_based_object_detection_torch.parallel.spatial import row_shard_of
from shape_based_object_detection_torch.utils import metrics as trace
from shape_based_object_detection_torch.utils.device import resolve_device
from shape_based_object_detection_torch.utils.image import (
    effective_decode_backend, letterbox_image_host, load_resized_image_host,
)


@dataclasses.dataclass
class Detection:
    boxes: np.ndarray  # (K, 4) pixel xyxy in the original image frame
    scores: np.ndarray  # (K,)
    labels: np.ndarray  # (K,) 0-based foreground class ids


def prepare_batch(images: Sequence, size: int, batch_size: int,
                  letterbox: bool = False,
                  decode_backend: str = "auto",
                  out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, list]:
    """Resize (BILINEAR) and zero-pad a request of <= batch_size images to
    the batch shape. Each item is a decoded (H, W, 3) uint8 array, a file
    path or encoded image bytes (decoded and resized on the host by
    ``load_resized_image_host``: JPEGs through the native decoder unless
    ``decode_backend`` is "pil"), or a pre-resized pair ``((size, size, 3)
    uint8, (h, w))``. Returns (batch (B, size, size, 3) uint8, original
    (h, w) sizes). ``out``: a uint8 array of at least ``batch_size`` rows
    of (size, size, 3) that the batch is written into (its first
    ``batch_size`` rows, padding zeroed) instead of a new array."""
    from PIL import Image

    if len(images) > batch_size:
        raise ValueError(f"{len(images)} images exceed batch_size {batch_size}")
    if out is None:
        batch = np.zeros((batch_size, size, size, 3), np.uint8)
    else:
        batch = out[:batch_size]
        if batch.shape != (batch_size, size, size, 3) or batch.dtype != np.uint8:
            raise ValueError(f"out must hold {batch_size} uint8 rows of ({size}, {size}, 3), "
                             f"got {out.shape} {out.dtype}")
        batch[len(images):] = 0
    sizes = []
    for i, img in enumerate(images):
        if isinstance(img, tuple):  # (pre-resized array, (h, w))
            resized, (h, w) = img
            resized = np.asarray(resized)
            if resized.shape != (size, size, 3):
                raise ValueError(
                    f"pre-resized item has shape {resized.shape}, expected "
                    f"({size}, {size}, 3)")
            if resized.dtype != np.uint8:
                raise ValueError(
                    f"pre-resized item must be uint8, got {resized.dtype}")
            batch[i] = resized
            sizes.append((int(h), int(w)))
            continue
        if not isinstance(img, np.ndarray):
            batch[i], h, w = load_resized_image_host(img, size, letterbox,
                                                     backend=decode_backend)
            sizes.append((h, w))
            continue
        h, w = img.shape[:2]
        sizes.append((h, w))
        if letterbox:
            batch[i] = letterbox_image_host(img, size)
        else:
            batch[i] = np.asarray(
                Image.fromarray(img).resize((size, size), Image.BILINEAR))
    return batch, sizes


def unpack_detections(det, sizes, min_score: float = 0.0,
                      letterbox: bool = False) -> List[Detection]:
    """Fixed-size Detections -> per-image unpadded pixel-space lists (reads
    results still on the device back, so it waits for them)."""
    boxes, scores, labels, valid = (t.cpu() for t in det)
    hw = torch.tensor(sizes, dtype=torch.float32).reshape(-1, 1, 2)
    boxes = boxes_to_original(boxes[:len(sizes)], hw[..., 0], hw[..., 1],
                              letterbox).numpy()
    scores, labels, valid = scores.numpy(), labels.numpy(), valid.numpy()
    out = []
    for i in range(len(sizes)):
        keep = valid[i] & (scores[i] >= min_score)
        out.append(Detection(boxes=boxes[i][keep], scores=scores[i][keep],
                             labels=labels[i][keep]))
    return out


def default_bucket_sizes(batch_size: int) -> list:
    """The standard bucket ladder: powers of 2 below ``batch_size``, then
    ``batch_size`` itself (serve_cli's "auto")."""
    return [b for b in (1, 2, 4, 8, 16, 32, 64) if b < batch_size] + [batch_size]


# pinned host buffers a Predictor prepares batches in, in turn: with a batch
# in flight behind the one read back, the oldest buffer's upload has run
_STAGING_BUFFERS = 3

# the modules whose ``launches`` count a hand-written kernel or an int8
# product that detect can launch
_LAUNCH_COUNTERS = (nms_cuda, quantize_lib, frozen_bn_cuda)


def graph_capturable(program, device: torch.device) -> bool:
    """Whether ``program`` (a ``DetectProgram``) can be served as a CUDA
    graph on ``device``: on the card, on whole images (a row shard's halo
    exchanges are collectives), with greedy NMS (Soft-NMS's loop makes host
    constants per call)."""
    return (device.type == "cuda" and program.row_shard is None
            and row_shard_of(program.module) is None
            and program.cfg.detect.soft_nms_sigma <= 0)


class _BucketGraph:
    """One bucket's detect as a CUDA graph. Each upload writes ``input``,
    the static (b, S, S, 3) uint8 batch. The first ``run`` serves its batch
    from an eager warm-up pass on a side stream (which also builds the
    kernels and fills the device constants), then captures ``program`` into
    ``pool``; each later ``run`` replays it. A replay writes ``outputs``,
    the static Detections, and the next replay of any graph of the pool
    overwrites them: the caller copies them out first, on the same stream.
    A replay adds to the kernels' ``launches`` and to the tracer's counters
    (``bn.frozen``, ``bn.fused``) what its capture recorded."""

    def __init__(self, program, shape, device: torch.device, pool):
        self.program, self.pool = program, pool
        self.input = torch.empty(shape, dtype=torch.uint8, device=device)
        self.graph = None
        self.outputs = None
        self.launches = ()  # (module, launches a replay adds to its count)
        self.counts = ()  # (tracer counter, what a replay adds to it)

    def run(self) -> Tuple[torch.Tensor, ...]:
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        for counter, n in self.launches:
            counter.launches += n
        for name, n in self.counts:
            trace.count(name, n)
        if trace.tracing():
            trace.count("serve.graph_replays")
        return self.outputs

    def _capture(self) -> Tuple[torch.Tensor, ...]:
        with torch.cuda.device(self.input.device):
            stream = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(stream)  # the upload into input
            with torch.cuda.stream(side), torch.inference_mode():
                served = self.program(self.input)
            stream.wait_stream(side)
            for t in served:
                t.record_stream(stream)
            before = [c.launches for c in _LAUNCH_COUNTERS]
            counted = trace.counters()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"), \
                    torch.inference_mode():
                self.outputs = self.program(self.input)
        # the capture ran nothing: a replay adds what it recorded
        self.launches = tuple((c, c.launches - n) for c, n in zip(_LAUNCH_COUNTERS, before))
        for c, n in zip(_LAUNCH_COUNTERS, before):
            c.launches = n
        self.counts = tuple((k, n - counted.get(k, 0)) for k, n in trace.counters().items()
                            if n != counted.get(k, 0))
        for name, n in self.counts:
            trace.count(name, -n)
        self.graph = graph
        return served


class _BatchedServing:
    """The serving surface that ``Predictor`` and ``ArtifactPredictor``
    share: buckets, upload, ``submit``/``poll``, ``predict``, ``warmup``.
    A subclass sets ``batch_size``, ``bucket_sizes``, ``min_score``,
    ``size``, ``letterbox``, ``device``, ``decode_backend`` and
    ``_detect`` (images on the device -> Detections).

    While a profiler records (``utils/metrics``), each batch's phases are
    spans: ``serve.submit`` (``serve.prepare``, ``serve.upload``,
    ``serve.launch``) and ``serve.readback``, and each graph replay adds 1
    to the counter ``serve.graph_replays``."""

    _submitted = 0  # batches submitted so far
    _graphs: Optional[Dict[int, _BucketGraph]] = None  # by bucket; None: eager
    # on the card: (pinned host buffer of batch_size images, the event after
    # the last upload that read it), taken in turn
    _staging: Optional[Deque[Tuple[torch.Tensor, torch.cuda.Event]]] = None

    def _graph_for(self, bucket: int) -> Optional[_BucketGraph]:
        if self._graphs is None:
            return None
        graph = self._graphs.get(bucket)
        if graph is None:
            graph = self._graphs[bucket] = _BucketGraph(
                self._detect.program, (bucket, self.size, self.size, 3), self.device,
                self._graph_pool)
        return graph

    def _stage(self) -> Optional[Tuple[torch.Tensor, torch.cuda.Event]]:
        """On the card, the next pinned host buffer of the ring that a batch
        is prepared in, once the upload that last read it has run, so the
        upload needs no copy of its own into pinned memory; None elsewhere."""
        if self.device.type != "cuda":
            return None
        if self._staging is None:
            self._staging = collections.deque(
                (torch.empty((self.batch_size, self.size, self.size, 3), dtype=torch.uint8,
                             pin_memory=True), torch.cuda.Event())
                for _ in range(_STAGING_BUFFERS))
        slot = self._staging[0]
        self._staging.rotate(-1)
        slot[1].synchronize()
        return slot

    def _upload(self, batch: np.ndarray, graph: Optional[_BucketGraph],
                slot: Optional[Tuple[torch.Tensor, torch.cuda.Event]] = None) -> torch.Tensor:
        if slot is not None:  # prepared in the slot's pinned buffer
            x = slot[0][:len(batch)]
        else:
            x = torch.from_numpy(batch)
        if graph is not None:
            x = graph.input.copy_(x, non_blocking=True)
        else:
            x = x.to(self.device, non_blocking=True)
        if slot is not None:
            slot[1].record(torch.cuda.current_stream(self.device))
        return x

    def _copy_out(self, det) -> Tuple[tuple, Optional[torch.cuda.Event]]:
        """On the card, the results' copies into pinned host memory, enqueued
        behind the launch, and an event after them."""
        if self.device.type != "cuda":
            return tuple(det), None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in det)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _bucket_for(self, n: int) -> int:
        """The smallest batch that holds ``n`` images."""
        for b in self.bucket_sizes:
            if n <= b:
                return b
        return self.batch_size  # prepare_batch refuses more

    def _submit(self, images: Sequence) -> Tuple:
        """(detections in flight, the event after their copies to the host
        or None, sizes, the batch's number from 1): the number is the id of
        the batch's ``serve.submit`` and ``serve.readback`` spans."""
        self._submitted += 1
        with trace.span("serve.submit", batch=self._submitted):
            with trace.span("serve.prepare"):
                slot = self._stage()
                batch, sizes = prepare_batch(images, self.size,
                                             self._bucket_for(len(images)),
                                             self.letterbox, self.decode_backend,
                                             out=None if slot is None else slot[0].numpy())
            graph = self._graph_for(len(batch))
            with trace.span("serve.upload"):
                x = self._upload(batch, graph, slot)
            with trace.span("serve.launch"):
                det = self._detect(x) if graph is None else graph.run()
                return (*self._copy_out(det), sizes, self._submitted)

    def _readback(self, det, done, sizes, batch: int) -> List[Detection]:
        with trace.span("serve.readback", batch=batch):
            if done is not None:
                done.synchronize()
            return unpack_detections(det, sizes, self.min_score, self.letterbox)

    def warmup(self) -> None:
        """One batch of each bucket, read back: builds the NMS kernel, runs
        cuDNN's first calls at every batch shape and, on the card, captures
        each bucket's graph before a real request arrives."""
        dummy = np.zeros((8, 8, 3), np.uint8)
        for b in self.bucket_sizes:
            self.submit([dummy] * b)
            self.poll()

    def submit(self, images: Sequence) -> None:
        """Launch a batch of at most ``batch_size`` images without waiting
        for it. Several batches may be in flight; ``poll`` returns them in
        submission order."""
        self._pending.append(self._submit(images))

    def poll(self) -> List[Detection]:
        """Wait for the oldest batch in flight and return its unpadded
        detections."""
        if not self._pending:
            raise RuntimeError("poll() without a batch in flight: submit() first")
        return self._readback(*self._pending.popleft())

    def predict(self, images: Sequence) -> List[Detection]:
        """Any request size: ceil(len / batch_size) batches, each padded to
        its bucket, pipelined so chunk i+1 is prepared and launched before
        chunk i is read back."""
        out: List[Detection] = []
        pending: Optional[Tuple] = None
        for i in range(0, len(images), self.batch_size):
            launched = self._submit(images[i:i + self.batch_size])
            if pending is not None:
                out.extend(self._readback(*pending))
            pending = launched
        if pending is not None:
            out.extend(self._readback(*pending))
        return out


class Predictor(_BatchedServing):
    """detect() as a service: fixed or bucketed batch, padded, launches
    overlapped with host work. Runs on the card unless ``device="cpu"``,
    each bucket as a CUDA graph where ``graph_capturable`` allows."""

    def __init__(self, cfg: ExperimentConfig, state_dict=None,
                 batch_size: int = 8, min_score: float = 0.0,
                 quantize: bool | str = False, device=None,
                 generator: torch.Generator | None = None,
                 bucket_sizes=None, activation_scales=None):
        """``state_dict``: weights to load (strict); None keeps the fresh
        initialisation drawn from ``generator``. ``quantize``: False (the
        float tier), True or "weights" (int8 weights dequantized in each
        convolution), or "full" (the s8×s8 → s32 tier, with per-image
        activation scales, or with ``activation_scales``, a calibration
        dict or the path of its JSON, static ones). ``module`` is the model
        that serves: the quantized copy in an int8 tier. ``bucket_sizes``
        (e.g. (1, 4, 16), ending at ``batch_size``): a request chunk pads
        only to the smallest bucket that holds it, so small requests skip
        most of the padded batch's upload and compute; None is
        ``[batch_size]``, every chunk padded to ``batch_size``."""
        self.cfg = cfg
        self.batch_size = batch_size
        bucket_sizes = sorted(set(int(b) for b in (bucket_sizes or [batch_size])))
        if bucket_sizes[-1] != batch_size:
            raise ValueError(f"bucket_sizes {bucket_sizes} must end at "
                             f"batch_size={batch_size}")
        self.bucket_sizes = bucket_sizes
        self.min_score = min_score
        self.size = cfg.model.image_size
        self.letterbox = cfg.data.letterbox
        self.device = resolve_device(device)
        # resolved once: "native" raises here, not at the first request,
        # where the decoder does not build
        self.decode_backend = effective_decode_backend(cfg.data.decode_backend)
        module, self.anchors = build_model(cfg.model, self.device, generator)
        if state_dict is not None:
            module.load_state_dict(state_dict, strict=True)
        self._detect, self.module = quantize_lib.make_serving_detect(
            module, self.anchors, cfg.model, cfg.data, quantize, self.device,
            activation_scales)
        if graph_capturable(self._detect.program, self.device):
            self._graphs, self._graph_pool = {}, torch.cuda.graph_pool_handle()
        self._pending: Deque[Tuple] = collections.deque()  # in flight, FIFO


class ArtifactPredictor(_BatchedServing):
    """The Predictor surface over an exported ``.sbdx`` artifact: the same
    host-side prepare, upload and unpack, no model-building code. The
    artifact has one batch shape, so it has one bucket. Runs on the card
    unless ``device="cpu"``; JPEGs decode as ``decode_backend="auto"``."""

    def __init__(self, artifact_path: str, min_score: float = 0.0, device=None):
        from shape_based_object_detection_torch.export import load_artifact

        self._detect = load_artifact(artifact_path, device)
        header = self._detect.header
        self.device = self._detect.device
        self.min_score = min_score
        self.size = header["image_size"]
        self.batch_size = header["batch_size"]
        self.bucket_sizes = [self.batch_size]
        self.letterbox = bool(header.get("letterbox", False))
        self.decode_backend = effective_decode_backend("auto")
        self._pending: Deque[Tuple] = collections.deque()  # in flight, FIFO
