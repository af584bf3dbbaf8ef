"""The per-layer metrics that read the program's own spans and counters:
a traced CPU run of each cell reports every span metric of its cell, the
inside readings agree with the benchmark's own spans around the same
calls, and the idle arithmetic holds on a timeline whose answer is known."""

from __future__ import annotations

import json

import pytest

from benchmark import run as bench_run
from benchmark.harness import program
from benchmark.tests.test_bench_runs import CELLS, run_cell
from benchmark.tests.tiny import BENCH, ROOT, write_tiny_checkout

# the metrics that read the program's spans, by cell; the allocator's
# counter is the card's alone
DETECT = ["detect.serve_submit_ms", "detect.serve_prepare_ms", "detect.serve_upload_ms",
          "detect.serve_launch_ms", "detect.serve_readback_ms", "detect.idle_in_submit_share"]
TRAIN = ["train.data_wait_ms", "train.step_enqueue_ms", "train.match_ms",
         "train.idle_in_step_share"]
SPAN_METRICS = {"r50_detect_b16": DETECT, "ssd512_train_b32": TRAIN, "r50_train_b16": TRAIN}
COUNTER = "train.device_allocs_per_step"
# (inside, outside): the program's span and the benchmark's around the same call
AGREE = {"r50_detect_b16": ("detect.serve_submit_ms", "detect.submit_ms"),
         "ssd512_train_b32": ("train.data_wait_ms", "train.loader_wait_ms"),
         "r50_train_b16": ("train.data_wait_ms", "train.loader_wait_ms")}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_program_spans(tiny, cell):
    result, err = run_cell(tiny, cell, trace=1)
    assert result["correct"] is True, err[-2000:]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SPAN_METRICS[cell]) <= set(got), err[-2000:]
    assert COUNTER not in got  # a CPU run has no caching allocator to read
    inside, outside = AGREE[cell]
    assert abs(got[inside] - got[outside]) <= max(0.5, 0.1 * got[outside]), (inside, got)
    if cell == "r50_detect_b16":
        parts = sum(got[f"detect.serve_{p}_ms"] for p in ("prepare", "upload", "launch"))
        assert parts <= got["detect.serve_submit_ms"]
        assert 0 < got["detect.idle_in_submit_share"] <= 100
    else:
        assert 0 < got["train.match_ms"] < got["train.step_enqueue_ms"]
        assert 0 < got["train.idle_in_step_share"] <= 100


# the device busy over [100, 300) and [500, 600) of a 1000 ns window (idle 700 ns);
# serve.submit over [0, 250) and [200, 550), whose union [0, 550) is idle for
# 100 + 200 ns: 300 / 700 of the window's idle time. train.step twice, idle
# 10 + 100 ns; the allocator's counter over the one step after the first.
KERNELS = [("k", 100, 200), ("k", 150, 300), ("k", 500, 600)]
SPANS = [(0, "serve.submit", 0, 250), (1, "serve.submit", 200, 550), (2, "train.step", 0, 10),
         (3, "train.step", 600, 700)]


@pytest.fixture
def synthetic(monkeypatch):
    from shape_based_object_detection_torch.utils import metrics

    snap = {"spans": [metrics.Span(i, n, s, e, None, 1, {}) for i, n, s, e in SPANS],
            "counters": {"mem.device_allocs": 6}}
    monkeypatch.setattr(metrics, "snapshot", lambda: snap)
    return {"timeline": {"window_s": 1000e-9, "busy_s": 300e-9, "kernels": KERNELS}}


def reader(name):
    return bench_run.load_file_module(BENCH / "metrics" / f"{name}.py", "m").read


def test_the_entries_name_these_cells():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {m["name"]: m["workloads"] for m in b["per_layer"]}
    for cell, names in SPAN_METRICS.items():
        assert all(cell in cells[n] for n in names + [COUNTER] * (cell != "r50_detect_b16"))


def test_idle_arithmetic_on_a_known_timeline(synthetic):
    assert program.idle_in([(0, 250), (200, 550)], [(s, e) for _, s, e in KERNELS]) == 300
    assert program.idle_in([(120, 140), (700, 900)], [(100, 200), (800, 850)]) == 150
    assert reader("detect.idle_in_submit_share")(synthetic) == pytest.approx(300 / 700 * 100)
    assert reader("train.idle_in_step_share")(synthetic) == pytest.approx(110 / 700 * 100)
    assert reader("detect.serve_submit_ms")(synthetic) == pytest.approx(300e-6)
    assert reader("train.device_allocs_per_step")(synthetic) == 6
    assert reader("detect.serve_readback_ms")(synthetic) is None  # no such span
    assert reader("detect.serve_submit_ms")({}) is None  # no timeline


def test_a_program_without_the_tracer_gives_no_number(synthetic, monkeypatch):
    """What the parent commit, which has no tracer, reads: nothing, no error."""
    from shape_based_object_detection_torch.utils import metrics

    monkeypatch.delattr(metrics, "snapshot")
    for name in DETECT + TRAIN + [COUNTER]:
        assert reader(name)(synthetic) is None, name
