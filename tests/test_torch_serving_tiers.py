"""The port's bucketed Predictor, following ``tests/test_serving.py``: the
bucket ladder equal to the JAX package's, bucketed batches equal to the
fixed batch, ``submit``/``poll`` as a FIFO with two batches in flight,
``warmup`` launching one batch per bucket, the decode backend resolved
when the Predictor is built, and the int8 tiers."""

import numpy as np
import pytest

from shape_based_object_detection_tpu import serving as jax_serving
from shape_based_object_detection_torch import config
from shape_based_object_detection_torch.serving import Predictor, default_bucket_sizes
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _images(seed, count):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (60 + 7 * i, 80 + 3 * i, 3), dtype=np.uint8)
            for i in range(count)]


def _cfg():
    cfg = config.get_config("tiny_retinanet")
    return config.dataclasses.replace(cfg, model=config.dataclasses.replace(
        cfg.model, detect=config.dataclasses.replace(cfg.model.detect,
                                                     score_threshold=0.0)))


@pytest.mark.parametrize("batch_size", [1, 2, 3, 8, 16, 48, 64, 100])
def test_default_bucket_sizes_equal_jax(batch_size):
    assert default_bucket_sizes(batch_size) == jax_serving.default_bucket_sizes(batch_size)


def test_bucketed_predictor_equals_fixed():
    """A request padded to the smallest bucket that holds it gets the same
    detections as one padded to the whole batch (boxes within 1e-4 px: the
    CPU's convolutions at batch 1 may round the last bit differently); a
    request larger than the batch is split, its last chunk into a smaller
    bucket."""
    fixed = Predictor(_cfg(), batch_size=4, device="cpu")
    bucketed = Predictor(_cfg(), batch_size=4, device="cpu", bucket_sizes=(1, 2, 4))
    assert [bucketed._bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    assert fixed._bucket_for(1) == 4
    images = _images(0, 6)
    for n in (1, 3, 6):
        a, b = fixed.predict(images[:n]), bucketed.predict(images[:n])
        assert len(a) == len(b) == n
        assert sum(len(d.scores) for d in a) > 0
        for da, db in zip(a, b):
            np.testing.assert_allclose(db.boxes, da.boxes, rtol=0, atol=1e-4)
            np.testing.assert_allclose(db.scores, da.scores, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(db.labels, da.labels)
    with pytest.raises(ValueError, match="end at batch_size"):
        Predictor(_cfg(), batch_size=4, device="cpu", bucket_sizes=(1, 2))


def _launch_sizes(pred):
    """The batch sizes ``pred`` launches from here on."""
    sizes = []
    detect = pred._detect

    def counting(x):
        sizes.append(x.shape[0])
        return detect(x)

    pred._detect = counting
    return sizes


def test_submit_poll_fifo_two_in_flight():
    """Two batches in flight at once; poll returns them in submit order,
    each equal to predict of the same images."""
    pred = Predictor(_cfg(), batch_size=2, device="cpu", bucket_sizes=(1, 2))
    a, b = _images(1, 2)
    sizes = _launch_sizes(pred)
    pred.submit([a])
    pred.submit([b, a])
    assert sizes == [1, 2]
    first, second = pred.poll(), pred.poll()
    assert len(first) == 1 and len(second) == 2
    want = pred.predict([b, a])
    for got, ref in zip([*first, *second], [pred.predict([a])[0], *want]):
        np.testing.assert_array_equal(got.boxes, ref.boxes)
        np.testing.assert_array_equal(got.scores, ref.scores)
    with pytest.raises(RuntimeError, match="submit"):
        pred.poll()
    with pytest.raises(ValueError, match="exceed batch_size"):
        pred.submit([a, a, a])


def test_warmup_runs_every_bucket():
    """warmup launches one batch of each bucket and reads it back, leaving
    nothing in flight; without buckets, one batch of batch_size."""
    pred = Predictor(_cfg(), batch_size=4, device="cpu", bucket_sizes=default_bucket_sizes(4))
    sizes = _launch_sizes(pred)
    pred.warmup()
    assert sizes == [1, 2, 4] and not pred._pending
    fixed = Predictor(_cfg(), batch_size=3, device="cpu")
    sizes = _launch_sizes(fixed)
    fixed.warmup()
    assert sizes == [3]


def test_decode_backend_resolved_at_construction(monkeypatch):
    """The Predictor resolves DataConfig.decode_backend once, when built:
    "pil" stays PIL, and "native" where the decoder does not build raises
    then, not at the first request."""
    from shape_based_object_detection_torch.utils import native

    def with_backend(backend):
        cfg = _cfg()
        return config.dataclasses.replace(cfg, data=config.dataclasses.replace(
            cfg.data, decode_backend=backend))

    pred = Predictor(with_backend("pil"), batch_size=1, device="cpu")
    assert pred.decode_backend == "pil"

    def no_decoder():
        raise RuntimeError("g++ failed: jpeglib.h: No such file")

    monkeypatch.setattr(native, "load_image_lib", no_decoder)
    with pytest.raises(RuntimeError, match="jpeglib"):
        Predictor(with_backend("native"), batch_size=1, device="cpu")
    with pytest.raises(ValueError, match="decode_backend"):
        Predictor(with_backend("turbo"), batch_size=1, device="cpu")


def test_unported_tiers_raise():
    """The int8 tiers (once unported, now ported): each quantize value
    serves through int8 convolutions, bucketed as the float tier; a
    misspelled mode raises."""
    from shape_based_object_detection_torch.quantize import Int8Conv2d

    images = _images(1, 3)
    for quantize in ("weights", True, "full"):
        pred = Predictor(_cfg(), batch_size=2, device="cpu", quantize=quantize,
                         bucket_sizes=(1, 2))
        out = pred.predict(images)
        assert len(out) == 3 and all(len(d.scores) > 0 for d in out)
        assert any(isinstance(m, Int8Conv2d) for m in pred.module.modules())
    with pytest.raises(ValueError, match="unknown quantize mode"):
        Predictor(_cfg(), batch_size=1, device="cpu", quantize="Full")
