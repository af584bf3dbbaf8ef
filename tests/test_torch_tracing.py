"""The port's tracer (``utils/metrics``): spans at the serving, data and
train-step boundaries recorded only while a ``torch.profiler`` session
records, with their parents, their batch and step ids and stamps that
bracket the profiler's own ranges; each phase once in a remat step; a
bounded number of spans held; an exported graph that holds no profiler op."""

import collections
import dataclasses
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shape_based_object_detection_torch import config, export, train
from shape_based_object_detection_torch.data.pipeline import Loader
from shape_based_object_detection_torch.data.synthetic import SyntheticDetection
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.serving import Predictor
from shape_based_object_detection_torch.utils import metrics

SERVE = ["serve.prepare", "serve.upload", "serve.launch"]
DETECT = ["detect.forward", "detect.select", "detect.nms"]
STEP = ["train.augment", "train.forward", "train.match", "train.loss", "train.backward",
        "train.update"]
# a span's stamps lie outside its record_function range (to BRACKET_NS), and
# typically within SLACK_NS of it (the first range of a process took ~0.2 ms
# to open on a CPU host; a loaded host can deschedule the thread for longer
# between a stamp and its range, so the distance is checked on the median)
BRACKET_NS, SLACK_NS = 20_000, 2_000_000


@pytest.fixture(autouse=True)
def fresh_tracer():
    torch.set_num_threads(2)
    metrics.reset()
    yield
    metrics.reset()


def _cfg(**train_changes):
    cfg = config.get_config("tiny_retinanet")
    model = dataclasses.replace(cfg.model, detect=dataclasses.replace(
        cfg.model.detect, score_threshold=0.0))
    return dataclasses.replace(cfg, model=model,
                               train=dataclasses.replace(cfg.train, **train_changes))


def _serve(pred):
    """Two batches in flight, then both read back."""
    images = [np.full((40 + 8 * i, 50, 3), 30 * i, np.uint8) for i in range(2)]
    pred.submit(images)
    pred.submit(images[:1])
    return pred.poll(), pred.poll()


def _trainer(cfg):
    module, anchors = build_model(cfg.model, "cpu", train=True)
    state = train.create_train_state(module, cfg, "cpu")
    return state, train.make_train_step(module, anchors, cfg, augment=True, device="cpu")


def _train_from_loader(cfg, steps):
    """``steps`` steps fed by ``Loader.device_batches`` (one epoch)."""
    state, step = _trainer(cfg)
    data = SyntheticDetection(size=cfg.model.image_size, num_images=2 * steps)
    loader = Loader(data, 2, cfg.data.max_boxes, shuffle=False)
    for batch in loader.device_batches(0, device="cpu"):
        state, _ = step(state, batch._asdict())
    return state


def _by_name(spans, name):
    return sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == parent.id]


def test_nothing_is_recorded_without_a_profiler():
    """Served batches, a loader's batches and train steps with no profiler
    recording: no span and no tracing counter is kept."""
    cfg = _cfg()
    _serve(Predictor(cfg, batch_size=2, device="cpu"))
    _train_from_loader(cfg, 2)
    snap = metrics.snapshot()
    assert snap["spans"] == []
    assert "mem.device_allocs" not in snap["counters"]


def test_profiled_calls_record_the_tree_on_the_profilers_clock():
    cfg = _cfg()
    pred = Predictor(cfg, batch_size=2, device="cpu")
    _serve(pred)  # warm: the first calls of a process are slow
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        answers = _serve(pred)
        _train_from_loader(cfg, 2)
    assert [len(a) for a in answers] == [2, 1]
    spans = metrics.snapshot()["spans"]

    submits = _by_name(spans, "serve.submit")
    assert [s.ids for s in submits] == [{"batch": 3}, {"batch": 4}]
    assert [s.ids for s in _by_name(spans, "serve.readback")] == [{"batch": 3}, {"batch": 4}]
    for s in submits:
        assert s.parent is None and _children(spans, s) == SERVE
        launch = next(c for c in spans if c.parent == s.id and c.name == "serve.launch")
        assert _children(spans, launch) == DETECT
    steps = _by_name(spans, "train.step")
    assert [s.ids for s in steps] == [{"step": 0}, {"step": 1}]
    for s in steps:
        assert s.parent is None and _children(spans, s) == STEP
    waits = _by_name(spans, "data.wait")
    assert len(waits) == 2 and all(w.parent is None for w in waits)
    assert all(w.end_ns <= s.start_ns for w, s in zip(waits, steps))

    # each span holds its record_function range, on the same clock
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    before, after = [], []
    for name in {s.name for s in spans}:
        got = _by_name(spans, name)
        ranges = sorted(events[name])
        assert len(ranges) == len(got), name
        for s, (start, end) in zip(got, ranges):
            assert s.start_ns <= start + BRACKET_NS and s.end_ns >= end - BRACKET_NS, name
            before.append(start - s.start_ns)
            after.append(s.end_ns - end)
    assert statistics.median(before) <= SLACK_NS and statistics.median(after) <= SLACK_NS


@pytest.mark.parametrize("remat", ["train", "model"])
def test_a_remat_step_records_each_phase_once(remat):
    """The whole forward checkpointed (``train.remat``) or the model's own
    segments (``model.remat``): the forward recomputed inside backward adds
    no span, and every span's parent was opened on its own thread."""
    cfg = _cfg(remat=remat == "train")
    if remat == "model":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True))
    with profile(activities=[ProfilerActivity.CPU]):
        _train_from_loader(cfg, 1)
    spans = metrics.snapshot()["spans"]
    names = sorted(s.name for s in spans)
    assert names == sorted(["data.wait", "train.step"] + STEP)
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.parent is None or by_id[s.parent].thread == s.thread, s


def test_the_pipelined_step_records_the_same_phases():
    """``make_train_step_pipelined``: the prime's augmentation alone, then
    each step with the next batch's augmentation among its phases."""
    cfg = _cfg()
    module, anchors = build_model(cfg.model, "cpu", train=True)
    state = train.create_train_state(module, cfg, "cpu")
    prime, step = train.make_train_step_pipelined(module, anchors, cfg, device="cpu")
    data = SyntheticDetection(size=cfg.model.image_size, num_images=4)
    batches = [b._asdict() for b in Loader(data, 2, cfg.data.max_boxes, shuffle=False).batches()]
    with profile(activities=[ProfilerActivity.CPU]):
        state, carry = prime(state, batches[0])
        state, carry, _ = step(state, carry, batches[1])
    spans = metrics.snapshot()["spans"]
    first = _by_name(spans, "train.augment")[0]
    (s,) = _by_name(spans, "train.step")
    assert first.parent is None and first.end_ns <= s.start_ns and s.ids == {"step": 0}
    assert _children(spans, s) == STEP


def test_the_tracer_holds_a_bounded_number_of_spans(monkeypatch):
    """The tracer keeps the newest ``MAX_SPANS`` spans: a long profiled run
    holds no more (here a tracer that holds 4)."""
    assert metrics._spans.maxlen == metrics.MAX_SPANS
    monkeypatch.setattr(metrics, "_spans", collections.deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with metrics.span("serve.readback", batch=i):
                pass
    assert [s.ids["batch"] for s in metrics.snapshot()["spans"]] == [2, 3, 4, 5]


def test_export_under_a_profiler_gives_the_same_graph():
    """``export_detect`` while a profiler records traces the same graph as
    without one, with no profiler op in it, and records no span."""
    cfg = _cfg()
    module, anchors = build_model(cfg.model, device="cpu")

    def graph():
        blob = export.export_detect(module, anchors, cfg.model, cfg.data, 1, "cpu")
        return str(export.load_detect(blob, "cpu").program.graph_module.code)

    plain = graph()
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = graph()
    assert profiled == plain and "profiler" not in plain
    assert metrics.snapshot()["spans"] == []
