"""``detect.bn_fused_share`` on snapshots whose answer is known: the
program's ``bn.fused`` over its ``bn.frozen``, and nothing where the program
counts no frozen BatchNorm (the parent commit, an untraced run)."""

from __future__ import annotations

import pytest

from benchmark import run as bench_run
from benchmark.tests.tiny import BENCH

TIMELINE = {"timeline": {"window_s": 1.0, "busy_s": 0.5, "kernels": []}}


def reader():
    return bench_run.load_file_module(BENCH / "metrics" / "detect.bn_fused_share.py", "m").read


@pytest.mark.parametrize("counters,want", [
    ({"bn.frozen": 53, "bn.fused": 53}, 100.0), ({"bn.frozen": 106, "bn.fused": 53}, 50.0),
    ({"bn.frozen": 53}, 0.0), ({}, None), ({"serve.graph_replays": 3}, None),
], ids=["all-fused", "half", "plain", "no-counter", "other-counters"])
def test_fused_over_frozen(monkeypatch, counters, want):
    from shape_based_object_detection_torch.utils import metrics

    monkeypatch.setattr(metrics, "snapshot", lambda: {"spans": [], "counters": counters})
    assert reader()(TIMELINE) == want
    assert reader()({}) is None  # an untraced run


def test_a_program_without_the_tracer_gives_no_number(monkeypatch):
    from shape_based_object_detection_torch.utils import metrics

    monkeypatch.delattr(metrics, "snapshot")
    assert reader()(TIMELINE) is None
