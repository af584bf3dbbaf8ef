"""The port's pre-decoded sample cache (``data/cache.py``, a copy of the JAX
package's) against the original: the same arrays and ``meta.json`` from
the same dataset, each package reading the other's cache, ``CacheLoader``
batches bit for bit (one host and two), the fingerprint's invalidation and
two concurrent builds (as ``tests/test_data.py``), and
``DeviceCacheLoader`` with ``device="cpu"`` equal to ``CacheLoader``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu.data import cache as jax_cache
from shape_based_object_detection_tpu.data.synthetic import (
    SyntheticDetection as JaxSynthetic,
)
from shape_based_object_detection_torch.data import cache
from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = dict(size=48, num_images=11, num_classes=4, aspect_std=0.5)
ARRAYS = ("images", "boxes", "labels", "valid", "crowd")


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """One cache written by each package from the same dataset."""
    root = tmp_path_factory.mktemp("caches")
    port = cache.build_cache(SyntheticDetection(**DATASET), str(root / "port"),
                             max_boxes=6, workers=2)
    ref = jax_cache.build_cache(JaxSynthetic(**DATASET), str(root / "jax"), max_boxes=6,
                                workers=2)
    return port, ref


def test_build_cache_writes_the_references_files(caches):
    port, ref = caches
    for name in ARRAYS:
        a = np.load(os.path.join(port, f"{name}.npy"))
        b = np.load(os.path.join(ref, f"{name}.npy"))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    with open(os.path.join(port, "meta.json")) as f, open(os.path.join(ref, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    assert not os.path.exists(os.path.join(port, ".build_lock"))


def test_each_package_reads_the_others_cache(caches):
    port, ref = caches
    for a, b in ((cache.MemmapDetection(ref), jax_cache.MemmapDetection(ref)),
                 (cache.MemmapDetection(port), jax_cache.MemmapDetection(port))):
        assert len(a) == len(b) == DATASET["num_images"]
        for i in range(len(a)):
            got, want = a[i], b[i]
            assert len(got) == len(want) == 4  # crowd flags survive the cache
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("num_hosts", [1, 2])
def test_cache_loader_batches_equal_the_references(caches, num_hosts):
    port, ref = caches
    for host in range(num_hosts):
        kw = dict(batch_size=2, max_boxes=5, seed=3, host_id=host, num_hosts=num_hosts)
        got = cache.CacheLoader(cache.MemmapDetection(port), **kw)
        want = jax_cache.CacheLoader(jax_cache.MemmapDetection(ref), **kw)
        assert got.steps_per_epoch() == want.steps_per_epoch()
        for epoch in (0, 1):
            pairs = list(zip(got.batches(epoch), want.batches(epoch), strict=True))
            assert pairs
            for g, w in pairs:
                for name in ARRAYS:
                    np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        for (g, gn), (w, wn) in zip(got.batches_padded(), want.batches_padded(), strict=True):
            assert gn == wn
            np.testing.assert_array_equal(g.images, w.images)


def test_cache_fingerprint_invalidation(tmp_path):
    """Reused only when the whole fingerprint matches: the same length at
    another image size, or another max_boxes, is rebuilt."""
    cache_dir = str(tmp_path / "cache")
    ds64 = SyntheticDetection(size=64, num_images=8, num_classes=4)
    cache.build_cache(ds64, cache_dir, max_boxes=6, workers=1)
    mtime = os.path.getmtime(os.path.join(cache_dir, "images.npy"))
    cache.build_cache(ds64, cache_dir, max_boxes=6, workers=1)
    assert os.path.getmtime(os.path.join(cache_dir, "images.npy")) == mtime

    ds32 = SyntheticDetection(size=32, num_images=8, num_classes=4)
    cache.build_cache(ds32, cache_dir, max_boxes=6, workers=1)
    with open(os.path.join(cache_dir, "meta.json")) as f:
        assert json.load(f)["image_size"] == 32
    assert not os.path.exists(os.path.join(cache_dir, ".build_lock"))
    cache.build_cache(ds32, cache_dir, max_boxes=3, workers=1)
    with open(os.path.join(cache_dir, "meta.json")) as f:
        assert json.load(f)["max_boxes"] == 3
    # the reference's fingerprint of the same dataset is the port's: a cache
    # built by one package is reused by the other
    assert cache._source_fingerprint(ds32, 3) == jax_cache._source_fingerprint(
        JaxSynthetic(size=32, num_images=8, num_classes=4), 3)


def test_cache_concurrent_builds(tmp_path):
    """Two processes building the same directory at once: the lockfile
    serialises them and both end with one consistent cache."""
    cache_dir = str(tmp_path / "cache")
    prog = f"""
import sys
sys.path.insert(0, {ROOT!r})
for m in ("jax", "shape_based_object_detection_tpu"):
    sys.modules[m] = None
from shape_based_object_detection_torch.data.cache import build_cache
from shape_based_object_detection_torch.data.synthetic import SyntheticDetection
build_cache(SyntheticDetection(size=48, num_images=16, num_classes=4), {cache_dir!r},
            max_boxes=6, workers=1)
print("built-ok")
"""
    procs = [subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
        assert b"built-ok" in out
    assert not os.path.exists(os.path.join(cache_dir, ".build_lock"))
    mm = cache.MemmapDetection(cache_dir)
    assert len(mm) == 16
    ref = SyntheticDetection(size=48, num_images=16, num_classes=4)
    for i in (0, 15):
        np.testing.assert_array_equal(mm[i][0], ref[i][0])


def test_stale_lock_is_stolen(tmp_path):
    """A lock left by a build that died (untouched past the stale age) is
    taken over by rename, and the build completes."""
    cache_dir = tmp_path / "cache"
    cache_dir.mkdir()
    lock = cache_dir / ".build_lock"
    lock.write_text("")
    old = os.path.getmtime(lock) - 2 * cache._LOCK_STALE_S
    os.utime(lock, (old, old))
    cache.build_cache(SyntheticDetection(size=32, num_images=4, num_classes=4),
                      str(cache_dir), max_boxes=4, workers=1)
    assert not lock.exists()
    assert len(cache.MemmapDetection(str(cache_dir))) == 4


def test_device_cache_loader_equals_cache_loader(caches):
    port, _ = caches
    mm = cache.MemmapDetection(port)
    kw = dict(batch_size=3, max_boxes=5, seed=1)
    host = cache.CacheLoader(mm, **kw)
    dev = cache.DeviceCacheLoader(mm, device="cpu", **kw)
    for epoch in (0, 1):
        pairs = list(zip(dev.device_batches(epoch, device="cpu"), host.batches(epoch),
                         strict=True))
        assert len(pairs) == host.steps_per_epoch() == 3
        for d, h in pairs:
            for name in ARRAYS:
                x = getattr(d, name)
                assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
                np.testing.assert_array_equal(x.numpy(), getattr(h, name))
    padded = list(zip(dev.batches_padded(), host.batches_padded(), strict=True))
    assert [n for (_, n), _ in padded] == [3, 3, 3, 2]
    for (d, dn), (h, hn) in padded:
        assert dn == hn
        np.testing.assert_array_equal(d.images.numpy(), h.images)
        for name in ARRAYS[1:]:
            np.testing.assert_array_equal(getattr(d, name), getattr(h, name))
    with pytest.raises(ValueError, match="this DeviceCacheLoader stages on cpu"):
        next(dev.device_batches(0, device="meta"))


def test_device_cache_loader_is_single_process(caches):
    port, _ = caches
    with pytest.raises(ValueError, match="single-process"):
        cache.DeviceCacheLoader(cache.MemmapDetection(port), 2, 5, device="cpu",
                                host_id=0, num_hosts=2)
