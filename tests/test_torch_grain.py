"""The port's worker-process pipeline (``data/grain_pipeline.py``, over
``torch.utils.data.DataLoader``) against the JAX package's grain loader:
unshuffled, the same batches record for record, across epoch boundaries of
the endless stream, for one host and two and with 0 and 2 worker
processes; shuffled, each epoch of the stream visits the shard once, in a
seeded order; ``close()`` stops the workers."""

import multiprocessing

import numpy as np
import pytest

from shape_based_object_detection_tpu.data.grain_pipeline import GrainLoader as JaxGrainLoader
from shape_based_object_detection_tpu.data.synthetic import (
    SyntheticDetection as JaxSynthetic,
)
from shape_based_object_detection_torch.data.grain_pipeline import (
    GrainLoader, ShardStreamSampler,
)
from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

DATASET = dict(size=32, num_images=11, num_classes=4)
FIELDS = ("images", "boxes", "labels", "valid", "crowd")


def _epochs(loader, n):
    return [list(loader.batches(e)) for e in range(n)]


@pytest.mark.parametrize("num_hosts", [1, 2])
@pytest.mark.parametrize("workers", [0, 2])
def test_unshuffled_batches_equal_grains(num_hosts, workers):
    for host in range(num_hosts):
        kw = dict(batch_size=2, max_boxes=5, shuffle=False, host_id=host,
                  num_hosts=num_hosts)
        want_loader = JaxGrainLoader(JaxSynthetic(**DATASET), **kw)
        got_loader = GrainLoader(SyntheticDetection(**DATASET), workers=workers, **kw)
        try:
            assert got_loader.steps_per_epoch() == want_loader.steps_per_epoch()
            # three epochs: the stream's batches run across its epochs
            want, got = _epochs(want_loader, 3), _epochs(got_loader, 3)
        finally:
            want_loader.close()
            got_loader.close()
        assert [len(e) for e in got] == [len(e) for e in want]
        for g, w in zip(sum(got, []), sum(want, [])):
            for name in FIELDS:
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name))


def test_sampler_is_grains_schedule():
    """Host h of H reads the contiguous shard of n // H records (the thread
    Loader strides instead), epoch after epoch."""
    stream = iter(ShardStreamSampler(10, 0, 2, shuffle=False))
    assert [next(stream) for _ in range(12)] == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1]
    stream = iter(ShardStreamSampler(11, 1, 2, shuffle=False))
    assert [next(stream) for _ in range(6)] == [5, 6, 7, 8, 9, 5]
    assert list(ShardStreamSampler(4, 0, 1, shuffle=False, num_epochs=2)) == [0, 1, 2, 3] * 2
    with pytest.raises(ValueError, match="empty shard"):
        ShardStreamSampler(1, 0, 2)


def test_shuffled_epochs_cover_the_shard_once():
    orders = []
    for seed in (0, 0, 1):
        stream = iter(ShardStreamSampler(12, 1, 2, shuffle=True, seed=seed))
        epochs = [[next(stream) for _ in range(6)] for _ in range(3)]
        for e in epochs:
            assert sorted(e) == list(range(6, 12))
        assert epochs[0] != epochs[1]
        orders.append(epochs)
    assert orders[0] == orders[1] and orders[0] != orders[2]


def _close_ends_workers(prefetching):
    loader = GrainLoader(SyntheticDetection(**DATASET), 2, 5, workers=2)
    before = set(multiprocessing.active_children())
    if prefetching:
        batches = loader.device_batches(0, device="cpu")
        next(batches)
    else:
        next(loader.batches(0))
    started = set(multiprocessing.active_children()) - before
    assert len(started) == 2
    loader.close()
    # close() returns once every worker has ended
    assert not any(p.is_alive() for p in started)


def test_close_stops_the_workers():
    _close_ends_workers(prefetching=False)


def test_close_stops_the_workers_under_a_producer_thread():
    """Also while a device_batches producer thread still reads from the
    stream (the consumer stopped early, as train_cli's loop does)."""
    _close_ends_workers(prefetching=True)


def test_shard_smaller_than_batch_raises():
    loader = GrainLoader(SyntheticDetection(**DATASET), 8, 5, num_hosts=2)
    with pytest.raises(ValueError, match="batch_size"):
        next(loader.batches(0))
