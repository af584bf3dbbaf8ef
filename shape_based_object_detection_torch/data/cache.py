"""Pre-decoded sample cache (a copy of the JAX package's ``data/cache.py``,
on the port's ``Loader``; ``DeviceCacheLoader`` stages the cache on the card
as torch tensors). The input-supply lever for training throughput.

The per-step host cost of the plain Loader is JPEG decode + PIL resize per
sample (BASELINE.md: input supply, not the device, is the config #3-style
bottleneck on this host). This module materializes a dataset ONCE into
uniform memmap arrays (images u8, padded boxes/labels/valid/crowd), after
which an epoch is pure vectorized numpy gathers — no decode, no PIL, no
per-sample Python in the hot path.

    build_cache(dataset, "/data/cache_voc512", max_boxes=100)
    ds = MemmapDetection("/data/cache_voc512")       # indexable, Loader-ready
    loader = CacheLoader(ds, batch_size, max_boxes)  # vectorized batches

CacheLoader.batches() assembles a batch with one fancy-index per array;
device_batches() (inherited) overlaps the host gather with device compute.
The on-disk format is the JAX package's: each package reads the other's
cache.
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

import torch

from shape_based_object_detection_torch.data.pipeline import (
    DetectionBatch, Loader, pad_annotations,
)
from shape_based_object_detection_torch.utils.device import resolve_device

_META = "meta.json"
_LOCK = ".build_lock"
_LOCK_STALE_S = 600.0


# dataset attributes that change the cached BYTES without changing the
# dataset's length/type/size: annotation-protocol flags, source location,
# synthetic-generator parameters. Probed with getattr so each dataset type
# contributes only the knobs it has.
_IDENTITY_ATTRS = ("root", "split", "ann_file", "include_difficult",
                   "include_crowd", "seed", "num_classes", "num_images",
                   "max_objects", "aspect_std", "color_jitter",
                   "decode_backend")


def _source_fingerprint(dataset, max_boxes: int) -> dict:
    """Everything that determines the cached bytes. A cache is reusable ONLY
    if all of it matches — num_samples alone is not enough (the same dataset
    re-opened with a different image_size or letterbox setting has the same
    length but different pixels/coordinates), and neither is shape alone
    (e.g. CocoDetection(include_crowd=...) toggles which boxes exist)."""
    fp = {
        "num_samples": len(dataset),
        "max_boxes": max_boxes,
        "dataset_type": type(dataset).__name__,
        "image_size": getattr(dataset, "image_size",
                              getattr(dataset, "size", None)),
        "letterbox": getattr(dataset, "letterbox", None),
    }
    for attr in _IDENTITY_ATTRS:
        if hasattr(dataset, attr):
            v = getattr(dataset, attr)
            fp[attr] = v if isinstance(v, (str, int, float, bool,
                                           type(None))) else repr(v)
    return fp


def _cache_valid(meta_path: str, fingerprint: dict) -> bool:
    if not os.path.exists(meta_path):
        return False
    with open(meta_path) as f:
        meta = json.load(f)
    return meta.get("source") == fingerprint


def build_cache(dataset, out_dir: str, max_boxes: int,
                workers: int = 8) -> str:
    """Decode/resize every sample once into memmap arrays under ``out_dir``.

    dataset: indexable of (image_u8 (S,S,3), boxes (G,4), labels (G,)) or
    4-tuples with a crowd flag. Idempotent: an existing complete cache built
    from the same source fingerprint (length, max_boxes, dataset type,
    image_size, letterbox) is reused; anything else is rebuilt. Safe under
    concurrent callers (multi-host training on a shared filesystem): one
    process takes an exclusive lockfile and builds while the rest wait for
    the finished cache.
    """
    import time

    n = len(dataset)
    meta_path = os.path.join(out_dir, _META)
    fingerprint = _source_fingerprint(dataset, max_boxes)
    os.makedirs(out_dir, exist_ok=True)
    lock_path = os.path.join(out_dir, _LOCK)
    while True:
        if _cache_valid(meta_path, fingerprint):
            return out_dir
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            break  # this process builds
        except FileExistsError:
            # another process is building; a lock untouched for a long time
            # means the process building died — steal it. The steal is an atomic
            # RENAME (not unlink): if two waiters race, only one rename
            # succeeds, so two processes can never both proceed to build.
            try:
                if time.time() - os.path.getmtime(lock_path) > _LOCK_STALE_S:
                    os.rename(lock_path, f"{lock_path}.stale.{os.getpid()}")
                    os.unlink(f"{lock_path}.stale.{os.getpid()}")
                    continue
            except OSError:
                continue
            time.sleep(1.0)

    try:
        return _build_cache_locked(dataset, out_dir, max_boxes, workers,
                                   meta_path, lock_path, fingerprint)
    finally:
        try:
            os.unlink(lock_path)
        except OSError:
            pass


def _build_cache_locked(dataset, out_dir: str, max_boxes: int, workers: int,
                        meta_path: str, lock_path: str,
                        fingerprint: dict) -> str:
    import threading

    # a stale meta from a different fingerprint must not look "complete" if
    # this build crashes halfway
    if os.path.exists(meta_path):
        os.unlink(meta_path)

    # Heartbeat: keep the lock's mtime fresh on a fixed clock, independent of
    # per-sample speed (a single slow sample must not let waiters declare the
    # lock stale mid-build and start a second build).
    stop = threading.Event()

    def _heartbeat():
        while not stop.wait(30.0):
            try:
                os.utime(lock_path)
            except OSError:
                return  # lock stolen/removed: stop quietly, don't recreate
    hb = threading.Thread(target=_heartbeat, daemon=True)
    hb.start()
    try:
        return _write_cache(dataset, out_dir, max_boxes, workers,
                            meta_path, fingerprint)
    finally:
        stop.set()
        hb.join(timeout=5.0)


def _write_cache(dataset, out_dir: str, max_boxes: int, workers: int,
                 meta_path: str, fingerprint: dict) -> str:
    n = len(dataset)
    first = dataset[0]
    s = first[0].shape[0]
    images = np.lib.format.open_memmap(
        os.path.join(out_dir, "images.npy"), mode="w+",
        dtype=np.uint8, shape=(n, s, s, 3))
    boxes = np.lib.format.open_memmap(
        os.path.join(out_dir, "boxes.npy"), mode="w+",
        dtype=np.float32, shape=(n, max_boxes, 4))
    labels = np.lib.format.open_memmap(
        os.path.join(out_dir, "labels.npy"), mode="w+",
        dtype=np.int32, shape=(n, max_boxes))
    valid = np.lib.format.open_memmap(
        os.path.join(out_dir, "valid.npy"), mode="w+",
        dtype=bool, shape=(n, max_boxes))
    crowd = np.lib.format.open_memmap(
        os.path.join(out_dir, "crowd.npy"), mode="w+",
        dtype=bool, shape=(n, max_boxes))

    def write(i: int) -> None:
        sample = dataset[i]
        img, bx, lb = sample[:3]
        flags = sample[3] if len(sample) > 3 else np.zeros(len(bx), bool)
        b, l, v, f = pad_annotations(bx, lb, max_boxes, flags=flags)
        images[i] = img
        boxes[i] = b
        labels[i] = l
        valid[i] = v
        crowd[i] = f

    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(write, range(n)))
    else:
        for i in range(n):
            write(i)
    for arr in (images, boxes, labels, valid, crowd):
        arr.flush()
    with open(meta_path, "w") as f:
        json.dump({"num_samples": n, "image_size": s,
                   "max_boxes": max_boxes, "source": fingerprint}, f)
    return out_dir


class MemmapDetection:
    """Indexable view over a built cache — drop-in for Loader / grain.

    Samples come back already padded to the cache's max_boxes (the caller's
    pad_annotations then only truncates/copies, no shape work)."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, _META)) as f:
            self.meta = json.load(f)
        mm = lambda name: np.load(os.path.join(cache_dir, name),
                                  mmap_mode="r")
        self.images = mm("images.npy")
        self.boxes = mm("boxes.npy")
        self.labels = mm("labels.npy")
        self.valid = mm("valid.npy")
        self.crowd = mm("crowd.npy")

    def __len__(self) -> int:
        return int(self.meta["num_samples"])

    def __getitem__(self, i: int):
        v = self.valid[i]
        # 4-tuple WITH the cached crowd/ignore flags: dropping them here
        # would turn crowd GTs into ordinary ground truth for any generic
        # Loader/grain consumer (silently deflated eval mAP)
        return (np.asarray(self.images[i]), np.asarray(self.boxes[i][v]),
                np.asarray(self.labels[i][v]), np.asarray(self.crowd[i][v]))


class CacheLoader(Loader):
    """Loader over a MemmapDetection that assembles each batch with ONE
    vectorized gather per array instead of per-sample Python — the
    fast path for the pre-decoded cache (no decode, no PIL, no pool)."""

    def __init__(self, cache: MemmapDetection, batch_size: int,
                 max_boxes: int, **kwargs):
        kwargs.pop("workers", None)  # the gather path has no worker pool
        super().__init__(cache, batch_size, max_boxes, workers=0, **kwargs)
        assert max_boxes <= cache.meta["max_boxes"], (
            "cache built with smaller max_boxes")

    def batches(self, epoch: int = 0) -> Iterator[DetectionBatch]:
        ds: MemmapDetection = self.dataset
        idx = self._epoch_indices(epoch)
        bs, g = self.batch_size, self.max_boxes
        if len(idx) < bs:
            # same fail-fast as the base Loader: zero batches would turn the
            # caller's epoch loop into a silent infinite spin
            raise ValueError(
                f"per-host shard has {len(idx)} samples < batch_size {bs}: "
                "shrink the batch or grow the dataset")
        for start in range(0, len(idx) - bs + 1, bs):
            chunk = np.sort(idx[start:start + bs])  # sorted = sequential IO
            yield DetectionBatch(
                images=np.asarray(ds.images[chunk]),
                boxes=np.asarray(ds.boxes[chunk, :g]),
                labels=np.asarray(ds.labels[chunk, :g]),
                valid=np.asarray(ds.valid[chunk, :g]),
                crowd=np.asarray(ds.crowd[chunk, :g]),
            )


class DeviceCacheLoader(CacheLoader):
    """CacheLoader that stages the ENTIRE cache on the card once, then
    assembles every batch with an ``index_select`` there: no per-step
    host-to-device traffic.

    For hosts whose per-batch transfer, not the card, bounds training. The
    one-time cost is len(dataset) x S x S x 3 bytes of device memory and
    one bulk copy; use it only where that fits beside the model.

    ``device``: the card unless ``device="cpu"``. Single-process only (as
    the reference): under a process group of more than one rank it raises;
    there each rank's shard comes through ``CacheLoader``.
    """

    def __init__(self, cache: MemmapDetection, batch_size: int,
                 max_boxes: int, device=None, **kwargs):
        import torch.distributed as dist

        super().__init__(cache, batch_size, max_boxes, **kwargs)
        if (dist.is_initialized() and dist.get_world_size() > 1) or self.num_hosts > 1:
            raise ValueError(
                "DeviceCacheLoader is single-process; multi-process training "
                "shards batches per process — use CacheLoader")
        self.device = resolve_device(device)
        g = max_boxes
        host = {"images": cache.images, "boxes": cache.boxes[:, :g],
                "labels": cache.labels[:, :g], "valid": cache.valid[:, :g],
                "crowd": cache.crowd[:, :g]}
        self._dev = {k: torch.from_numpy(np.array(v)).to(self.device)
                     for k, v in host.items()}

    def _device_batch(self, chunk: np.ndarray) -> DetectionBatch:
        idx = torch.from_numpy(chunk.astype(np.int64)).to(self.device, non_blocking=True)
        return DetectionBatch(**{k: torch.index_select(v, 0, idx)
                                 for k, v in self._dev.items()})

    def device_batches(self, epoch: int = 0, device=None):
        """``batches(epoch)`` gathered on the card: batches of tensors there.
        ``device``, when given, must be the loader's."""
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"this DeviceCacheLoader stages on {self.device}, not {device}")
        idx = self._epoch_indices(epoch)
        bs = self.batch_size
        if len(idx) < bs:
            raise ValueError(
                f"shard has {len(idx)} samples < batch_size {bs}: "
                "shrink the batch or grow the dataset")
        for start in range(0, len(idx) - bs + 1, bs):
            # sorted batch membership matches CacheLoader bit for bit (its
            # sort is a memmap-IO optimization; on the card the order is
            # indifferent, so keeping it makes the two interchangeable
            # mid-run). batches_padded must NOT sort: eval's n_valid contract
            # is positional (pad rows live at the tail).
            yield self._device_batch(np.sort(idx[start:start + bs]))

    def batches_padded(self, epoch: int = 0, rows=None):
        """Eval-coverage iterator: images stay on the card, annotations come
        back as host numpy for the metric accumulators. ``rows`` as
        ``Loader.batches_padded``'s."""
        for chunk, n_valid in self._padded_chunks(epoch, rows):
            b = self._device_batch(chunk)
            yield DetectionBatch(
                images=b.images,
                boxes=b.boxes.cpu().numpy(), labels=b.labels.cpu().numpy(),
                valid=b.valid.cpu().numpy(), crowd=b.crowd.cpu().numpy(),
            ), n_valid
