"""The data-parallel cell ``r101_fpn_1024_dp4_train`` on the CPU as four
gloo ranks, at a tiny size (the configuration's widths cut to 1/8, 128 px,
a global batch of 8 from a pool of 16, 3 warm steps): one correct result
line with the cell's metrics, the all-reduce's span read in a traced run,
and the timed path broken in a rank reading not correct; the files keep the
benchmark's rules with the cell's four chips and its cut."""

from __future__ import annotations

import json

import pytest

from benchmark.tests.test_bench_files import check_files, check_rules
from benchmark.tests.test_bench_ranks import launch
from benchmark.tests.tiny import write_tiny_checkout

CELL = "r101_fpn_1024_dp4_train"
PARAMS = {"pool_images": 16, "workers": 2, "warm_steps": 3, "ref_block": 2}
GLOBAL_B = 8
# the cell's traffic with the program broken on the ranks that DP_FAULT
# names, before the real traffic runs
FAULTY = '''"""The data-parallel traffic with the program broken underneath."""
import os

from benchmark.traffic import train_dp

control = train_dp.control


def run(ctx):
    from shape_based_object_detection_torch import train

    fault = os.environ["DP_FAULT"]
    if fault == "half_rows" and ctx.rank == 1:  # this rank feeds half its rows
        batch_on = train._batch_on
        train._batch_on = lambda batch, dev: tuple(t[:t.shape[0] // 2]
                                                   for t in batch_on(batch, dev))
    if fault == "no_allreduce":  # every rank steps on its own gradients
        train.all_reduce_ = lambda tensors, mesh, data_axis=False: None
    return train_dp.run(ctx)
'''


def tiny_dp(dest):
    root = write_tiny_checkout(dest)
    here = root / "benchmark"
    path = here / "workloads" / f"{CELL}.json"
    cell = json.loads(path.read_text())
    cell["params"].update(PARAMS)
    path.write_text(json.dumps(cell))
    path = here / "configs" / f"{cell['config']}.json"
    cfg = json.loads(path.read_text())
    cfg["experiment"]["data"]["batch_size"] = GLOBAL_B
    path.write_text(json.dumps(cfg))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_dp(tmp_path_factory.mktemp("tiny_dp"))


def test_the_files_keep_the_rules_with_four_chips_and_the_cut(tiny):
    for root in (None, tiny):
        check_rules(*([root] if root else []))
        check_files(*([root] if root else []))
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    entry = next(w for w in b["workloads"] if w["name"] == CELL)
    config = next(c for c in b["configs"] if c["name"] == entry["config"])
    assert entry["chips"] == 4 and config["reduced"] == ["data.batch_size"]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_on_four_ranks(tiny, trace):
    rc, out, err, _, left = launch(tiny, CELL, trace=trace)
    assert rc == 0, err[-3000:]
    assert left == [] and len(out) == 1  # one result line, no process left
    result = json.loads(out[0])
    assert result["correct"] is True, err[-3000:]
    assert result["device"]["count"] == 4
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    if trace:
        assert result["metrics"]["train.allreduce_ms"]["value"] > 0
        # no NCCL kernels on the CPU: nothing to read, no number
        assert "train.allreduce_device_ms" not in result["metrics"]
        assert "train.allreduce_roofline" not in result["metrics"]
    else:
        names = {m["name"] for m in b["end_to_end"] if CELL in m.get("workloads", [CELL])}
        assert set(result["metrics"]) == names == {"train_images_per_s", "train_peak_gib",
                                                   "setup_s"}
        assert result["attempted"] > 0 and result["metrics"]["train_images_per_s"]["value"] > 0


@pytest.fixture(scope="module")
def faulty(tmp_path_factory):
    root = tiny_dp(tmp_path_factory.mktemp("faulty_dp"))
    (root / "benchmark" / "traffic" / "train_dp.py").write_text(FAULTY)
    return root


@pytest.mark.parametrize("fault", ["half_rows", "no_allreduce"])
def test_a_broken_step_is_not_correct(faulty, fault):
    rc, out, err, _, left = launch(faulty, CELL, env={"DP_FAULT": fault})
    assert rc == 0 and left == [] and len(out) == 1, err[-3000:]
    assert json.loads(out[0])["correct"] is False, err[-3000:]


def test_the_allreduce_readers_on_a_known_timeline(monkeypatch):
    """Two steps of 1 ms of NCCL all-reduce kernels each beside other
    kernels; 478.1 MB counted over 4 ranks is 717.2 MB of bus bytes, 1.5 ms
    at 18 x 26.562 GB/s: 75 % of the 2 ms. Without the program's counter (the
    parent's program) the share reads nothing; without a timeline, nothing."""
    from benchmark.harness import comm
    from shape_based_object_detection_torch.utils import metrics

    kernels = [("ncclDevKernel_AllReduce_Sum_f32_RING_SIMPLE(x)", 0, 900_000),
               ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 1_000_000, 1_100_000),
               ("ncclDevKernel_Broadcast_RING_LL(x)", 2_000_000, 9_000_000),
               ("sm90_xmma_fprop(x)", 3_000_000, 9_000_000),
               ("ncclDevKernel_AllReduce_Sum_f32_RING_SIMPLE(x)", 10_000_000, 11_000_000)]
    rec = {"timeline": {"window_s": 0.02, "busy_s": 0.02, "kernels": kernels},
           "steps": 2, "world": 4}
    nbytes = 1.5e-3 * 18 * 26.562e9 / 1.5  # 1.5 ms of bus bytes over 2 (N - 1) / N
    snap = {"spans": [], "counters": {"comm.all_reduce_bytes": nbytes}}
    monkeypatch.setattr(metrics, "snapshot", lambda: snap)
    assert comm.bus_bytes(100.0, 4) == pytest.approx(150.0)
    assert comm.device_ms_per_step(rec) == pytest.approx(1.0)
    assert comm.roofline(rec) == pytest.approx(75.0)
    snap["counters"] = {}
    assert comm.roofline(rec) is None
    assert comm.device_ms_per_step(dict(rec, timeline=None)) is None
    assert comm.roofline({"steps": 2, "world": 4}) is None
