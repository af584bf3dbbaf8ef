"""A checkout of the benchmark at CPU size, for the tests: the real cells'
files with the width cut to 1/8, RetinaNet at 128 px, small batches and
pools, every model in float32 with TF32 off (the CPU's bf16 is not the
card's, and the cells' limits are set from the card's), written under a
directory the test gives."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"

# cell -> changes to its params
TINY_PARAMS = {
    "r50_detect_b16": {"batch": 2, "buckets": [2], "pool_images": 4, "check_images": 3,
                       "ref_pool": 300},
    "ssd512_train_b32": {"pool_images": 6, "workers": 2, "warm_steps": 3},
    "r50_train_b16": {"pool_images": 6, "workers": 2, "warm_steps": 3},
}


def tiny_experiment(exp: dict, batch: int) -> dict:
    exp = copy.deepcopy(exp)
    exp["model"]["width_mult"] = 0.125
    exp["model"]["dtype"] = "float32"
    exp["model"]["precision"] = "highest"
    if exp["model"]["family"] == "retinanet":
        exp["model"]["image_size"] = 128
        exp["model"]["detect"]["pre_nms_top_k"] = 200
        exp["model"]["detect"]["max_detections"] = 20
    exp["data"]["batch_size"] = batch
    exp["data"]["max_boxes"] = 8
    return exp


def write_tiny_checkout(dest: Path) -> Path:
    """A copy of BENCHMARK.json and benchmark/ at CPU size under ``dest``."""
    dest = Path(dest)
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, changes in TINY_PARAMS.items():
        path = dest / "benchmark" / "workloads" / f"{name}.json"
        cell = json.loads(path.read_text())
        cell["params"].update(changes)
        path.write_text(json.dumps(cell))
    for path in (dest / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["experiment"] = tiny_experiment(cfg["experiment"], 2)
        path.write_text(json.dumps(cfg))
    return dest
