"""``detect.graph_replay_share`` on snapshots whose answer is known: the
program's replay counter over its ``serve.launch`` spans, and nothing where
the program counts no replay (the CPU, an eager path, the parent commit)."""

from __future__ import annotations

import pytest

from benchmark import run as bench_run
from benchmark.tests.tiny import BENCH

TIMELINE = {"timeline": {"window_s": 1.0, "busy_s": 0.5, "kernels": []}}


def reader():
    return bench_run.load_file_module(BENCH / "metrics" / "detect.graph_replay_share.py",
                                      "m").read


def snapshot(monkeypatch, launches, counters):
    from shape_based_object_detection_torch.utils import metrics

    spans = [metrics.Span(i, "serve.launch", 10 * i, 10 * i + 5, None, 1, {})
             for i in range(launches)]
    monkeypatch.setattr(metrics, "snapshot", lambda: {"spans": spans, "counters": counters})


@pytest.mark.parametrize("launches,counters,want", [
    (4, {"serve.graph_replays": 4}, 100.0), (4, {"serve.graph_replays": 3}, 75.0),
    (4, {}, None), (0, {"serve.graph_replays": 2}, None),
], ids=["every-batch", "three-of-four", "eager", "no-launch"])
def test_replays_over_launches(monkeypatch, launches, counters, want):
    snapshot(monkeypatch, launches, counters)
    assert reader()(TIMELINE) == want
    assert reader()({}) is None  # an untraced run


def test_a_program_without_the_tracer_gives_no_number(monkeypatch):
    from shape_based_object_detection_torch.utils import metrics

    monkeypatch.delattr(metrics, "snapshot")
    assert reader()(TIMELINE) is None
