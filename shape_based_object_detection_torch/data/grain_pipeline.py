"""Worker-process input pipeline (port of the JAX package's
``data/grain_pipeline.py``), over ``torch.utils.data.DataLoader`` in place
of Google grain.

The same indexable datasets as ``pipeline.Loader``, read by ``workers``
worker processes (JPEG decode and resize off the training process), with
grain's schedule: host ``host_id`` of ``num_hosts`` reads the contiguous
shard ``[host_id * n // num_hosts, (host_id + 1) * n // num_hosts)``, and
its epochs follow one another in one endless stream that batches run across
(the thread ``Loader`` strides its shards and starts each epoch afresh).
Unshuffled, the batches are grain's, record for record. Shuffled, each
epoch of the stream visits the shard's records once in an order seeded by
(``seed``, epoch); grain's own permutation cannot be reproduced without
grain. The source and the collate function are module-level, so the
workers (started by a fork server) can unpickle them.
"""

from __future__ import annotations

import multiprocessing
from typing import Iterator, Optional

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler

from shape_based_object_detection_torch.data.pipeline import (
    DetectionBatch, Loader, pad_annotations,
)


class PaddedDetectionSource:
    """Picklable random-access source over an indexable dataset of
    (image_u8, boxes_norm, labels[, crowd]) samples, padding to max_boxes."""

    def __init__(self, dataset, max_boxes: int):
        self.dataset = dataset
        self.max_boxes = max_boxes

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        sample = self.dataset[int(i)]
        img, boxes, labels = sample[:3]
        flags = (np.asarray(sample[3], bool) if len(sample) > 3
                 else np.zeros(len(boxes), bool))
        b, l, v, cr = pad_annotations(boxes, labels, self.max_boxes, flags=flags)
        return {"images": img, "boxes": b, "labels": l, "valid": v, "crowd": cr}


class ShardStreamSampler(Sampler):
    """grain's ``IndexSampler`` with ``drop_remainder=True`` shard options:
    the host's contiguous shard, epoch after epoch (endless when
    ``num_epochs`` is None), each epoch in order or, shuffled, in the
    permutation of ``default_rng((seed, epoch))``."""

    def __init__(self, num_records: int, shard_index: int = 0, shard_count: int = 1,
                 shuffle: bool = True, seed: int = 0, num_epochs: Optional[int] = None):
        size = num_records // shard_count
        if size == 0:
            raise ValueError(f"{num_records} records leave host {shard_index} of "
                             f"{shard_count} an empty shard")
        self.shard = np.arange(shard_index * size, (shard_index + 1) * size)
        self.shuffle = shuffle
        self.seed = seed
        self.num_epochs = num_epochs

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            order = (np.random.default_rng((self.seed, epoch)).permutation(self.shard)
                     if self.shuffle else self.shard)
            yield from (int(i) for i in order)
            epoch += 1


def collate_padded(samples) -> dict:
    """A list of ``PaddedDetectionSource`` samples as one dict of stacked
    tensors (tensors cross from a worker through shared memory)."""
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}


def padded_data_loader(dataset, batch_size: int, max_boxes: int, seed: int = 0,
                       shuffle: bool = True, host_id: int = 0, num_hosts: int = 1,
                       num_epochs: Optional[int] = None, worker_count: int = 0) -> DataLoader:
    """The ``DataLoader`` of the host's sample stream (see the module's
    docstring): dicts of stacked tensors. ``worker_count > 0`` reads in that
    many worker processes (from a fork server), started when its iterator
    is and kept until that iterator is shut down; 0 reads in this
    process."""
    context = None
    if worker_count > 0:
        # a server process started afresh forks the workers: none inherits
        # this process's threads (a CUDA context, a Loader's pool), and
        # unlike spawn's, they exit cleanly when the iterator stops them.
        # The server imports this module (torch with it) once, so a worker
        # starts without importing torch again.
        context = multiprocessing.get_context("forkserver")
        context.set_forkserver_preload([__name__])
    return DataLoader(
        PaddedDetectionSource(dataset, max_boxes), batch_size=batch_size,
        sampler=ShardStreamSampler(len(dataset), host_id, num_hosts, shuffle, seed,
                                   num_epochs),
        drop_last=True, num_workers=worker_count, collate_fn=collate_padded,
        persistent_workers=worker_count > 0, multiprocessing_context=context)


def as_numpy(batch: dict) -> DetectionBatch:
    """A ``padded_data_loader`` batch as ``Loader.batches``' numpy batch."""
    return DetectionBatch(**{k: v.numpy() for k, v in batch.items()})


def make_grain_iterator(
    dataset,  # indexable: (image_u8, boxes_norm, labels[, crowd])
    batch_size: int,
    max_boxes: int,
    seed: int = 0,
    shuffle: bool = True,
    host_id: int = 0,
    num_hosts: int = 1,
    num_epochs: Optional[int] = None,
    worker_count: int = 0,
) -> Iterator[DetectionBatch]:
    """Batches of ``batch_size`` from the host's sample stream (see the
    module's docstring), numpy like ``Loader.batches``'. ``worker_count >
    0`` starts that many worker processes (from a fork server) that live as
    long as the iterator; 0 reads in this process."""
    for batch in padded_data_loader(dataset, batch_size, max_boxes, seed, shuffle, host_id,
                                    num_hosts, num_epochs, worker_count):
        yield as_numpy(batch)


class GrainLoader:
    """``pipeline.Loader``-compatible facade (``batches``,
    ``device_batches``, ``steps_per_epoch``) over one persistent stream, for
    ``train_cli --loader grain --workers N``: the worker processes start
    once, not once per epoch, and ``batches(epoch)`` takes one epoch's worth
    of batches from the shared stream. ``close()`` stops the workers and
    returns once each has ended."""

    def __init__(self, dataset, batch_size: int, max_boxes: int,
                 seed: int = 0, shuffle: bool = True, host_id: int = 0,
                 num_hosts: int = 1, workers: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.seed = seed
        self.shuffle = shuffle
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.worker_count = workers
        self.prefetch = prefetch
        self._stream = None

    def _ensure_stream(self):
        if self._stream is None:
            # the DataLoader's iterator itself, not a generator around it:
            # close() shuts its workers down even while another thread (a
            # device_batches producer) waits in it
            self._stream = iter(padded_data_loader(
                self.dataset, self.batch_size, self.max_boxes,
                seed=self.seed, shuffle=self.shuffle,
                host_id=self.host_id, num_hosts=self.num_hosts,
                num_epochs=None,  # endless: epochs are consumed in slices
                worker_count=self.worker_count))
        return self._stream

    def steps_per_epoch(self) -> int:
        """Full batches per epoch per host."""
        return (len(self.dataset) // self.num_hosts) // self.batch_size

    def batches(self, epoch: int = 0):
        del epoch  # the stream owns the schedule
        n = self.steps_per_epoch()
        if n == 0:
            # pulling anyway would fill a batch from the next epoch of the
            # stream (duplicated samples, desynchronised epochs)
            raise ValueError(
                f"per-host shard has {len(self.dataset) // self.num_hosts} "
                f"samples < batch_size {self.batch_size}: shrink the batch "
                "or grow the dataset")
        stream = self._ensure_stream()
        for _ in range(n):
            yield as_numpy(next(stream))

    # the prefetching upload of the thread Loader (it reads only
    # self.batches and self.prefetch)
    device_batches = Loader.device_batches

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker processes: the DataLoader's own shutdown (a stop
        to each worker, a join, SIGTERM to a worker still running), then a
        join of each, SIGKILL to one still running ``timeout`` s later."""
        stream, self._stream = self._stream, None
        workers = list(getattr(stream, "_workers", ()))  # none at 0 workers
        if workers:
            stream._shutdown_workers()
            for w in workers:
                w.join(timeout)
                if w.is_alive():
                    w.kill()
                    w.join()
