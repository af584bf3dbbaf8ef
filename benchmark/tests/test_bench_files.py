"""BENCHMARK.json against the benchmark's rules, every name found as a
file, and a new cell, configuration, traffic kind and metric added with
new files alone."""

from __future__ import annotations

import json
import re
import shutil

from benchmark import run as bench_run
from benchmark.tests.tiny import ROOT, write_tiny_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# a width may never be cut: the last part of a key in ``reduced`` names none
WIDTH = re.compile(r"width|channels|hidden|intermediate|latent|expansion|projection|head_size"
                   r"|state_size|_dim$|_rank$")
MISSING = object()


def bench(root=ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def dotted(tree: dict, key: str):
    """The value at a dotted path such as ``data.batch_size``, or MISSING."""
    for part in key.split("."):
        if not isinstance(tree, dict) or part not in tree:
            return MISSING
        tree = tree[part]
    return tree


def check_cuts(cfg: dict, reduced: list) -> None:
    """Every key cut from the source is a dotted path into the file's
    ``experiment`` and no width, and the file says what it was published as
    and what deployment the cut stands for."""
    assert len(reduced) <= 16 and len(set(reduced)) == len(reduced)
    if not reduced:
        return
    assert set(cfg["published"]) == set(reduced) and line_ok(cfg["deployment"])
    for key in reduced:
        assert NAME.match(key) and not WIDTH.search(key.rsplit(".", 1)[-1])
        value = dotted(cfg["experiment"], key)
        assert value is not MISSING and value != cfg["published"][key]


def check_rules(root=ROOT):
    """BENCHMARK.json of the checkout at ``root`` against the rules."""
    b = bench(root)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 per cell runs of run_seconds + 60,
    # 2 x 90 s more per cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("benchmark/") and (root / c["file"]).is_file()
        check_cuts(json.loads((root / c["file"]).read_text()), c["reduced"])
        names.add(c["name"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        used.add(w["config"])
    assert used == names
    # four-chip cells: at most a quarter of the cells, rounded down, and one always
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line_ok(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:  # the cell reports the metric it moves
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:  # setup_s, another end-to-end metric, a per-layer one
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b).encode()) <= 64 * 1024


def check_files(root=ROOT):
    """Every name in BENCHMARK.json of the checkout at ``root`` is a file."""
    b, here = bench(root), root / "benchmark"
    for w in b["workloads"]:
        cell = json.loads((here / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert (here / "traffic" / f"{w['traffic']}.py").is_file()
        assert (here / "configs" / f"{w['config']}.json").is_file()
        assert set(cell) == {"config", "traffic", "params", "limits"}
    for m in b["per_layer"]:
        reader = bench_run.load_file_module(here / "metrics" / f"{m['name']}.py", "m")
        assert reader.read({}) is None  # nothing to read, no number
    for c in b["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert {"source", "experiment", "assumed"} <= set(cfg) and cfg["source"] == c["source"]


def test_benchmark_json_keeps_its_rules():
    check_rules()


def test_every_name_is_a_file():
    check_files()


NEW_TRAFFIC = '''"""A throwaway traffic kind: the offline detect traffic at another name."""
from benchmark.traffic.offline_detect import run  # noqa: F401
'''
NEW_METRIC = '''"""A throwaway metric: images in the traced window."""


def read(rec):
    return float(rec["images"]) if rec.get("images") else None
'''


def test_a_new_cell_takes_new_files_alone(tmp_path, capsys):
    root = write_tiny_checkout(tmp_path / "checkout")
    here = root / "benchmark"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    shutil.copy(here / "configs" / "retinanet_r50_fpn_512_bf16.json", here / "configs" / "r50_copy.json")
    (here / "traffic" / "detect_again.py").write_text(NEW_TRAFFIC)
    (here / "metrics" / "detect.images_seen.py").write_text(NEW_METRIC)
    cell = json.loads((here / "workloads" / "r50_detect_b16.json").read_text())
    cell.update(config="r50_copy", traffic="detect_again")
    (here / "workloads" / "new_cell.json").write_text(json.dumps(cell))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="r50_copy", file="benchmark/configs/r50_copy.json"))
    b["workloads"].append({"name": "new_cell", "config": "r50_copy", "traffic": "detect_again",
                           "chips": 1, "why": "a throwaway cell"})
    for m in b["end_to_end"]:
        if m["name"] == "detect_images_per_s":
            m["workloads"].append("new_cell")
    b["per_layer"].append({"name": "detect.images_seen", "unit": "images", "better": "higher",
                           "source": "program_counter", "layer": "serving",
                           "moves": "detect_images_per_s", "workloads": ["new_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
    assert bench_run.main(["--workload", "new_cell", "--seed", str(2 ** 33 + 5), "--seconds", "1",
                           "--trace", "1"], device="cpu", root=root) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["detect.images_seen"]["value"] > 0
    assert list(result)[-1] == "checks"
