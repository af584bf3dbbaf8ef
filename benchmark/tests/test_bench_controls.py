"""The controls, on the card: the reference one precision below each
configuration's, put in the program's place at the cell's own size, has to
come out as not correct under the cell's limits, and so has the training
fault of half of each batch left out. Needs the card; skips without one.

    python3 -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_controls.py
"""

from __future__ import annotations

import json

import pytest

from benchmark import run as bench_run
from benchmark.reference.precision import control_precision
from benchmark.tests.tiny import BENCH

CELLS = ("r50_detect_b16", "ssd512_train_b32", "r50_train_b16")


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items() if k in numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the controls run at the cells' own size, on the card")
    spec = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    config = json.loads((BENCH / "configs" / f"{spec['config']}.json").read_text())
    traffic = bench_run.load_file_module(BENCH / "traffic" / f"{spec['traffic']}.py", "traffic")
    ctx = bench_run.Context(cell, spec, config, 2 ** 33 + 17, 3.0, False, "cuda")
    out = traffic.control(ctx, control_precision(config["experiment"]["model"]))
    assert fails(out, spec["limits"]), out
    if "half_loss_gap" in out:
        fault = {k[len("half_"):]: v for k, v in out.items() if k.startswith("half_")}
        assert fails(fault, spec["limits"]), fault
