"""Batching and host-to-device feeding (port of the JAX package's
``data/pipeline.py``).

Every image's annotations are padded to ``DataConfig.max_boxes`` with a
validity mask, and images are decoded and resized on the host to the
model's input size. ``Loader.batches`` yields numpy batches;
``Loader.device_batches`` prepares them on a background thread, stages each
in pinned host memory and copies it to the card with ``non_blocking=True``
on a copy stream of its own, which the consumer's stream waits on.
"""

from __future__ import annotations

import queue as queue_lib
import threading
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from shape_based_object_detection_torch.utils import metrics as trace
from shape_based_object_detection_torch.utils.device import resolve_device


class DetectionBatch(NamedTuple):
    images: np.ndarray  # (B, S, S, 3) uint8
    boxes: np.ndarray  # (B, G, 4) float32, normalized xyxy
    labels: np.ndarray  # (B, G) int32, 1-based foreground classes
    valid: np.ndarray  # (B, G) bool
    # (B, G) bool: crowd/ignore GT regions (eval protocol; all-False unless
    # the dataset yields crowd flags, e.g. CocoDetection(include_crowd=True))
    crowd: Optional[np.ndarray] = None


def pad_annotations(
    boxes: np.ndarray, labels: np.ndarray, max_boxes: int,
    flags: Optional[np.ndarray] = None,
):
    """(G, 4), (G,) -> fixed (max_boxes, ...) + validity mask.

    ``flags`` (G,) bool (e.g. crowd/ignore) pads alongside with the same
    truncation rule and comes back as a fourth array."""
    g = min(len(boxes), max_boxes)
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_labels = np.zeros((max_boxes,), np.int32)
    out_valid = np.zeros((max_boxes,), bool)
    if g:
        out_boxes[:g] = boxes[:g]
        out_labels[:g] = labels[:g]
        out_valid[:g] = True
    if flags is None:
        return out_boxes, out_labels, out_valid
    out_flags = np.zeros((max_boxes,), bool)
    if g:
        out_flags[:g] = np.asarray(flags, bool)[:g]
    return out_boxes, out_labels, out_valid, out_flags


def pin_batch(batch: DetectionBatch) -> DetectionBatch:
    """The batch as tensors in pinned (page-locked) host memory, from which
    a ``non_blocking`` copy to the card is asynchronous."""
    return DetectionBatch(*(None if a is None else torch.from_numpy(a).pin_memory()
                            for a in batch))


class Loader:
    """Epoch loader over an indexable dataset of (image_u8 (S,S,3), boxes
    (G,4) normalized, labels (G,)[, flags (G,)]) samples.

    Shuffles per epoch (``default_rng(seed + epoch)``), pads annotations,
    drops the ragged tail batch (``batches``) or pads it for eval
    (``batches_padded``), and shards by host: host ``host_id`` of
    ``num_hosts`` takes every ``num_hosts``-th sample of the same
    permutation.

    ``workers > 1`` fetches the samples of a batch through a thread pool:
    the per-sample work (the native JPEG decode, PIL, large numpy slicing)
    releases the GIL.
    """

    def __init__(
        self,
        dataset,  # supports __len__ / __getitem__
        batch_size: int,
        max_boxes: int,
        seed: int = 0,
        shuffle: bool = True,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
        workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.seed = seed
        self.shuffle = shuffle
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        if workers > 1:
            import weakref
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)
            # release the threads when the Loader is collected or closed
            self._finalizer = weakref.finalize(self, self._pool.shutdown, False)
        else:
            self._pool = None
            self._finalizer = None

    def close(self) -> None:
        """Shut down worker threads (also runs on garbage collection)."""
        if self._finalizer is not None:
            self._finalizer()

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            # the same permutation on every host, then sharded
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        # every host takes the same number of samples per epoch
        idx = idx[: n - n % self.num_hosts]
        return idx[self.host_id :: self.num_hosts]

    def _sample(self, i):
        sample = self.dataset[int(i)]
        img, boxes, labels = sample[:3]
        # optional 4th element: per-box crowd/ignore flags (eval protocol)
        flags = sample[3] if len(sample) > 3 else np.zeros(len(boxes), bool)
        b, l, v, cr = pad_annotations(boxes, labels, self.max_boxes, flags=flags)
        return img, b, l, v, cr

    def _collate(self, chunk) -> DetectionBatch:
        if self._pool is not None:
            samples = list(self._pool.map(self._sample, chunk))
        else:
            samples = [self._sample(i) for i in chunk]
        imgs, bxs, lbs, vds, crs = zip(*samples)
        return DetectionBatch(images=np.stack(imgs), boxes=np.stack(bxs),
                              labels=np.stack(lbs), valid=np.stack(vds),
                              crowd=np.stack(crs))

    def batches(self, epoch: int = 0) -> Iterator[DetectionBatch]:
        idx = self._epoch_indices(epoch)
        bs = self.batch_size
        if len(idx) < bs:
            # yielding no batch would make an epoch loop spin forever
            raise ValueError(
                f"per-host shard has {len(idx)} samples < batch_size {bs}: "
                "shrink the batch or grow the dataset")
        for start in range(0, len(idx) - bs + 1, bs):
            yield self._collate(idx[start : start + bs])

    def steps_per_epoch(self) -> int:
        """Full batches per epoch per host: the train loop's epoch length."""
        return len(self._epoch_indices(0)) // self.batch_size

    def _padded_chunks(self, epoch: int, rows: Optional[slice]):
        """(indices, n_valid) of ``batches_padded``."""
        idx = self._epoch_indices(epoch)
        bs = self.batch_size
        for start in range(0, len(idx), bs):
            chunk = idx[start:start + bs]
            n_valid = len(chunk)
            if n_valid < bs:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - n_valid)])
            yield (chunk if rows is None else chunk[rows]), n_valid

    def batches_padded(self, epoch: int = 0, rows: Optional[slice] = None):
        """Every sample of this host's shard exactly once, for eval: the
        ragged tail batch is padded to the batch shape by repeating its last
        sample. Yields ``(DetectionBatch, n_valid)``; rows >= n_valid are
        padding. With ``rows`` (a data-parallel rank's ``Mesh.rows`` of the
        batch size) only those rows of each padded batch are loaded, and
        ``n_valid`` is still the whole batch's: the ranks' rows, gathered in
        rank order, are the whole padded batch."""
        for chunk, n_valid in self._padded_chunks(epoch, rows):
            yield self._collate(chunk), n_valid

    def device_batches(self, epoch: int = 0, device=None) -> Iterator[DetectionBatch]:
        """``batches(epoch)`` as tensors on ``device`` (the card unless
        ``device="cpu"``), prepared on a background thread at most
        ``prefetch`` batches ahead. On the card each batch is staged in
        pinned memory and copied with ``non_blocking=True`` on a copy stream;
        the consumer's current stream waits for the copy before it gets the
        batch. An error in the producer is raised in the consumer; a
        consumer that stops early stops the producer. The producer marks the
        epoch's last batch (its ``steps_per_epoch()``-th), after which the
        consumer ends without another wait. While a profiler records, each
        wait for a batch is the span ``data.wait`` (``utils/metrics``)."""
        dev = resolve_device(device)
        q: queue_lib.Queue = queue_lib.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()
        error: list = []
        copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def transfer(batch: DetectionBatch):
            if copy_stream is None:
                return DetectionBatch(*(None if a is None else torch.from_numpy(a)
                                        for a in batch)), None
            pinned = pin_batch(batch)
            with torch.cuda.stream(copy_stream):
                out = DetectionBatch(*(None if t is None else t.to(dev, non_blocking=True)
                                       for t in pinned))
                done = torch.cuda.Event()
                done.record(copy_stream)
            return out, done

        def put(item) -> bool:
            # a bounded put that gives up once the consumer is gone, so the
            # thread and its prefetched batches do not live to process exit
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue_lib.Full:
                    continue
            return False

        def producer():
            try:
                if copy_stream is not None:
                    torch.cuda.set_device(dev)
                last = self.steps_per_epoch()  # the count of batches(epoch)
                for k, batch in enumerate(self.batches(epoch), 1):
                    if cancel.is_set() or not put((*transfer(batch), k == last)):
                        return
            except BaseException as e:  # raised in the consumer, never a hang
                error.append(e)
            finally:
                put(stop)

        started = False
        try:
            while True:
                with trace.span("data.wait"):
                    if not started:  # the epoch's first wait starts its producer
                        threading.Thread(target=producer, daemon=True).start()
                        started = True
                    item = q.get()
                    if item is not stop:
                        batch, done, last = item
                        if done is not None:
                            consumer = torch.cuda.current_stream(dev)
                            consumer.wait_event(done)
                            for x in batch:
                                if x is not None:
                                    # made on the copy stream, used on the
                                    # consumer's
                                    x.record_stream(consumer)
                if item is stop:
                    if error:
                        raise error[0]
                    break
                yield batch
                if last:
                    break
        finally:
            cancel.set()
            while True:  # release a producer blocked on a full queue
                try:
                    q.get_nowait()
                except queue_lib.Empty:
                    break
