"""The serving layer's CUDA graphs and its readback on each batch's event.

On the card a ``Predictor`` captures each bucket's detect once and replays
it: the replayed detections equal eager ``make_detect_fn`` on the same
batch bit for bit, in the float tier at every bucket, the full int8 tier
and hflip TTA; batches in flight come back in order; K1's launch count and
the ``serve.graph_replays`` counter grow by one per replay. The paths a
graph cannot hold stay eager, which the CPU cases show with the decision
itself. The card cases skip without a CUDA device and import no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_serving_graph.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shape_based_object_detection_torch import config, quantize, serving
from shape_based_object_detection_torch.detection import DetectProgram, make_detect_fn
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.ops import frozen_bn_cuda, nms_cuda
from shape_based_object_detection_torch.parallel.spatial import set_row_shard
from shape_based_object_detection_torch.serving import (
    Predictor, graph_capturable, prepare_batch, unpack_detections,
)
from shape_based_object_detection_torch.utils import metrics

REPLAYS = "serve.graph_replays"


@pytest.fixture(autouse=True)
def fresh_tracer():
    metrics.reset()
    yield
    metrics.reset()


def _with_detect(cfg, **changes):
    model = dataclasses.replace(cfg.model, detect=dataclasses.replace(
        cfg.model.detect, score_threshold=0.0, **changes))
    return dataclasses.replace(cfg, model=model)


def _items(seed, count, size):
    """Pre-resized (image, (h, w)) items."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (size, size, 3), dtype=np.uint8),
             (int(rng.integers(200, 700)), int(rng.integers(200, 700))))
            for _ in range(count)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))


# ------------------------------------------------------------------- the CPU

def test_cpu_predictor_stays_eager_with_batches_in_flight():
    """Three batches in flight on the CPU, under a profiler: each equals
    predict of its images, and no graph is replayed."""
    cfg = _with_detect(config.get_config("tiny_retinanet"))
    pred = Predictor(cfg, batch_size=2, device="cpu", bucket_sizes=(1, 2),
                     generator=torch.Generator().manual_seed(0))
    size = cfg.model.image_size
    batches = [_items(1, 2, size), _items(2, 1, size), _items(3, 2, size)]
    with profile(activities=[ProfilerActivity.CPU]):
        for b in batches:
            pred.submit(b)
        got = [pred.poll() for _ in batches]
    for g, b in zip(got, batches):
        _assert_same(g, pred.predict(b))
    assert REPLAYS not in metrics.snapshot()["counters"]
    assert pred._graphs is None


@pytest.mark.parametrize("count", [1, 3, 4])
def test_prepare_batch_into_a_reused_buffer_equals_a_fresh_batch(count):
    """A batch written into a buffer that held another batch (the card's
    pinned staging buffers) equals a fresh one, its padding rows zeroed; a
    buffer of the wrong shape or type is refused."""
    size = 32
    items = _items(count, count, size)
    want, want_sizes = prepare_batch(items, size, 4)
    buf = np.full((6, size, size, 3), 77, np.uint8)
    got, sizes = prepare_batch(items, size, 4, out=buf)
    assert np.shares_memory(got, buf) and got.shape == (4, size, size, 3)
    np.testing.assert_array_equal(got, want)
    assert sizes == want_sizes
    for bad in (buf[:3], buf.astype(np.int16), buf[:, :16]):
        with pytest.raises(ValueError, match="out must hold"):
            prepare_batch(items[:3], size, 4, out=bad)


def _soft(program):
    program.cfg = _with_detect(config.get_config("tiny_retinanet"), soft_nms_sigma=0.5).model


def _split_module(program):
    set_row_shard(program.module, object())  # what the model axis sets


def _split_program(program):
    program.row_shard = object()


@pytest.mark.parametrize("device,change,want", [
    ("cuda", None, True), ("cpu", None, False), ("cuda", _soft, False),
    ("cuda", _split_module, False), ("cuda", _split_program, False),
], ids=["card", "cpu", "soft-nms", "row-split-module", "row-split-program"])
def test_graph_capturable_decides_by_what_it_observes(device, change, want):
    """A graph on the card, on whole images, with greedy NMS; the CPU, a
    model axis's row shard and Soft-NMS stay eager."""
    cfg = _with_detect(config.get_config("tiny_retinanet"))
    module, anchors = build_model(cfg.model, "cpu", torch.Generator().manual_seed(0))
    program = DetectProgram(module, anchors, cfg.model, cfg.data)
    if change is not None:
        change(program)
    assert graph_capturable(program, torch.device(device)) is want


# ------------------------------------------------------------------ the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def _r50_cfg(**detect_changes):
    cfg = config.get_config("retinanet_r50_fpn")
    cfg = _with_detect(cfg, **detect_changes)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"))


@pytest.fixture(scope="module")
def r50():
    """An R50-FPN-512 bf16 Predictor with buckets (1, 4, 16), warmed up."""
    _card()
    pred = Predictor(_r50_cfg(), batch_size=16, bucket_sizes=(1, 4, 16), device="cuda",
                     generator=torch.Generator().manual_seed(0))
    pred.warmup()
    return pred


def _eager(pred, items):
    """The batch through eager ``make_detect_fn`` on the Predictor's module,
    raw and unpacked."""
    detect = make_detect_fn(pred.module, pred.anchors, pred.cfg.model, pred.cfg.data, "cuda")
    batch, sizes = prepare_batch(items, pred.size, pred._bucket_for(len(items)))
    raw = detect(torch.from_numpy(batch).cuda())
    return raw, unpack_detections(raw, sizes, pred.min_score, pred.letterbox)


def _served_equals_eager(pred, items):
    """A batch through the Predictor against eager detect: the answers, and
    where the batch was a replay, every slot of the graph's outputs."""
    bucket = pred._bucket_for(len(items))
    replay = bucket in pred._graphs
    pred.submit(items)
    got = pred.poll()
    graph = pred._graphs[bucket]
    assert graph.graph is not None
    outputs = [t.clone() for t in graph.outputs]  # this batch's, until the next replay
    raw, want = _eager(pred, items)
    if replay:
        for g, w in zip(outputs, raw):
            assert torch.equal(g, w)
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 3, 4, 16])
def test_each_bucket_replays_bit_equal_to_eager(r50, count):
    """Requests of 1, 3, 4 and 16 images ride buckets 1, 4, 4 and 16."""
    _served_equals_eager(r50, _items(count, count, r50.size))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["int8_full", "tta_hflip", "plain_nms"])
def test_tiers_replay_bit_equal_to_eager(tier):
    """The full int8 tier, hflip TTA and the plain greedy NMS, b4: the
    first batch is served by the capture's warm-up pass, the next two by
    replays."""
    _card()
    kw = {"quantize": "full"} if tier == "int8_full" else {}
    detect = {"tta_hflip": {"tta_hflip": True}, "plain_nms": {"nms_backend": "plain"}}
    pred = Predictor(_r50_cfg(**detect.get(tier, {})), batch_size=4, device="cuda",
                     generator=torch.Generator().manual_seed(1), **kw)
    for seed in (20, 21, 22):
        _served_equals_eager(pred, _items(seed, 4, pred.size))


@pytest.mark.cuda
def test_three_batches_in_flight_come_back_in_order(r50):
    """Three b16 batches submitted before the first poll: each replay's
    outputs are copied out before the next replay overwrites them."""
    batches = [_items(30 + i, 16, r50.size) for i in range(3)]
    for b in batches:
        r50.submit(b)
    got = [r50.poll() for _ in batches]
    for g, b in zip(got, batches):
        _assert_same(g, _eager(r50, b)[1])
    assert not np.array_equal(got[0][0].boxes, got[1][0].boxes)  # three batches, not one


@pytest.mark.cuda
def test_more_batches_in_flight_than_staging_buffers(r50):
    """Five batches of 16, 1, 4, 16 and 3 images submitted before the first
    poll take the pinned staging buffers round more than once: each answer
    equals eager detect of its own images."""
    counts = (16, 1, 4, 16, 3)
    assert len(counts) > serving._STAGING_BUFFERS
    batches = [_items(50 + i, n, r50.size) for i, n in enumerate(counts)]
    for b in batches:
        r50.submit(b)
    got = [r50.poll() for _ in batches]
    for g, b in zip(got, batches):
        _assert_same(g, _eager(r50, b)[1])


@pytest.mark.cuda
def test_each_replay_counts_its_kernels_and_itself(r50):
    """K1's count grows by the captured count (one) on every replay, the
    int8 products' by none, K3's by its 49 launches of an R50 forward, and
    ``serve.graph_replays`` by one per batch while a profiler records."""
    graph = r50._graphs[16]
    assert dict(graph.launches) == {nms_cuda: 1, quantize: 0, frozen_bn_cuda: 49}
    items = _items(40, 16, r50.size)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            before = nms_cuda.launches
            r50.submit(items)
            assert nms_cuda.launches == before + 1
            r50.poll()
    assert metrics.snapshot()["counters"][REPLAYS] == 3
    r50.submit(items)  # no profiler: counted by K1, not by the tracer
    r50.poll()
    assert metrics.snapshot()["counters"][REPLAYS] == 3


@pytest.mark.cuda
def test_a_capture_counts_only_the_pass_that_served():
    """The first batch of a bucket is served by the warm-up pass: K1 runs
    once for it, whatever the capture recorded."""
    _card()
    pred = Predictor(_r50_cfg(), batch_size=2, device="cuda",
                     generator=torch.Generator().manual_seed(2))
    before = nms_cuda.launches
    pred.predict([img for img, _ in _items(50, 2, pred.size)] * 2)
    assert nms_cuda.launches == before + 2 and pred._graphs[2].graph is not None


@pytest.mark.cuda
def test_soft_nms_serves_eagerly_on_the_card():
    """Soft-NMS on the card: no graph, no replay, and the event readback
    gives eager detect's answer."""
    _card()
    cfg = _with_detect(config.get_config("tiny_retinanet"), soft_nms_sigma=0.5)
    pred = Predictor(cfg, batch_size=2, device="cuda",
                     generator=torch.Generator().manual_seed(3))
    items = _items(60, 2, pred.size)
    with profile(activities=[ProfilerActivity.CPU]):
        pred.submit(items)
        pred.submit(items[:1])
        got = [pred.poll(), pred.poll()]
    assert pred._graphs is None and REPLAYS not in metrics.snapshot()["counters"]
    _assert_same(got[0], _eager(pred, items)[1])
    _assert_same(got[1], _eager(pred, items[:1])[1])
