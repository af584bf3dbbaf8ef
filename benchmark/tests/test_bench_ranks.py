"""A cell on four chips, run on the CPU as four gloo ranks: a four-chip
cell and a configuration with a cut added from new files and entries alone,
one result line for the cell, and every way a rank can fail ending the run
with no result line and no process left."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

from benchmark import run as bench_run
from benchmark.tests.test_bench_files import check_files, check_rules
from benchmark.tests.tiny import ROOT, write_tiny_checkout

SEED = 2 ** 33 + 11
# the traffic of a throwaway four-chip cell: the offline detect traffic on
# every rank of the group, the images summed over the group into rank 0's
# numbers; each rank also writes what it read itself to ``ranks/<r>.json``
GROUP_DETECT = '''"""Offline detect on every rank of a gloo group, summed over the group."""
import json
import os
from pathlib import Path

import torch
import torch.distributed as dist

from benchmark.traffic import offline_detect


def run(ctx):
    from shape_based_object_detection_torch.parallel import mesh

    group = mesh.initialize_multihost(device=ctx.device)
    try:
        out = offline_detect.run(ctx)
        own = {"pid": os.getpid(), "rank": ctx.rank, "world": ctx.world,
               "rate": out["e2e"]["detect_images_per_s"], "attempted": out["attempted"],
               "setup_s": ctx.setup_s}
        total = torch.tensor([own["rate"], float(own["attempted"])], dtype=torch.float64)
        dist.all_reduce(total)
        out["e2e"]["detect_images_per_s"] = float(total[0])
        out["attempted"] = int(total[1])
        out["memory_peak_bytes"] = 1000 * (ctx.rank + 1)  # stands in for each card's peak
    finally:
        mesh.shutdown(group)
    Path(ctx.params["ranks_dir"], f"{ctx.rank}.json").write_text(json.dumps(own))
    return out
'''
# one rank misbehaves as RANK_FAULT ("<fault>:<rank>") says; the others
# wait for it in a barrier, or have passed it
FAULTY = '''"""A gloo group in which one rank misbehaves."""
import os
import signal
import time
from pathlib import Path

import torch.distributed as dist


def run(ctx):
    from shape_based_object_detection_torch.parallel import mesh

    group = mesh.initialize_multihost(device=ctx.device)
    Path(ctx.params["ranks_dir"], f"{ctx.rank}.pid").write_text(str(os.getpid()))
    ctx.window_opens()
    fault, at = os.environ["RANK_FAULT"].split(":")
    fault = fault if ctx.rank == int(at) else None
    if fault == "raises":
        raise RuntimeError(f"a fault planted in rank {ctx.rank}")
    if fault == "killed":
        os.kill(os.getpid(), signal.SIGKILL)
    if fault == "sleeps":
        time.sleep(3600)
    dist.barrier()
    mesh.shutdown(group)
    if fault == "no_result":
        os._exit(0)
    if fault == "imports_jax":
        import jax  # noqa: F401
    return {"e2e": {"detect_images_per_s": 1.0}, "records": {}, "timeline": None,
            "checks": {}, "attempted": 1, "failed": 0, "memory_peak_bytes": 0}
'''


def add_four_chip_cell(root, name, traffic, source, ranks_dir, config=None):
    """Add a four-chip cell of ``traffic`` (its source written as a new
    file) to the checkout, on the RetinaNet configuration or on ``config``
    (name, file contents), from new files and entries alone."""
    here = root / "benchmark"
    (here / "traffic" / f"{traffic}.py").write_text(source)
    b = json.loads((root / "BENCHMARK.json").read_text())
    cell = json.loads((here / "workloads" / "r50_detect_b16.json").read_text())
    cell["traffic"] = traffic
    cell["params"]["ranks_dir"] = str(ranks_dir)
    if config is not None:
        cfg_name, cfg = config
        (here / "configs" / f"{cfg_name}.json").write_text(json.dumps(cfg))
        b["configs"].append(dict(b["configs"][0], name=cfg_name, reduced=sorted(cfg["published"]),
                                 file=f"benchmark/configs/{cfg_name}.json"))
        cell["config"] = cfg_name
    (here / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    b["workloads"].append({"name": name, "config": cell["config"], "traffic": traffic,
                           "chips": 4, "why": "a throwaway cell on four ranks"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "r50_detect_b16" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def launch(root, cell, trace=0, deadline_s=None, env=None):
    """Run the cell through ``main(..., device="cpu")`` in a process of its
    own: (exit code, stdout lines, stderr, seconds, children left)."""
    code = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {str(ROOT)!r})
        from benchmark import run
        if {deadline_s!r} is not None:
            run.RANK_DEADLINE_S = {deadline_s!r}
        rc = run.main(["--workload", {cell!r}, "--seed", "{SEED}", "--seconds", "1",
                       "--trace", "{trace}"], device="cpu", root={str(root)!r})
        left = []
        for tid in os.listdir("/proc/self/task"):
            with open(f"/proc/self/task/{{tid}}/children") as f:
                left += f.read().split()
        print("LEFT", left)
        sys.exit(rc)
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    t = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(root), env=env)
    seconds = time.monotonic() - t
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith("LEFT "), proc.stderr[-3000:]
    return proc.returncode, lines[:-1], proc.stderr, seconds, ast.literal_eval(lines[-1][5:])


def gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("trace", [0, 1])
def test_a_four_chip_cell_takes_new_files_alone(tmp_path, trace):
    root = write_tiny_checkout(tmp_path / "checkout")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    ranks_dir = tmp_path / "ranks"
    ranks_dir.mkdir()
    cfg = json.loads((root / "benchmark" / "configs" / "retinanet_r50_fpn_512_bf16.json")
                     .read_text())
    cfg["published"] = {"data.batch_size": 256}
    cfg["deployment"] = "one of four cards of a data-parallel job: the global batch cut to 4 x 2"
    add_four_chip_cell(root, "dp4_cell", "group_detect", GROUP_DETECT, ranks_dir,
                       ("r50_dp4_cut", cfg))
    assert {p: p.read_bytes() for p in before} == before  # no file that was there changed
    check_rules(root)
    check_files(root)

    rc, out, err, _, left = launch(root, "dp4_cell", trace=trace)
    assert rc == 0, err[-3000:]
    assert left == []
    assert len(out) == 1  # one result line for the cell
    result = json.loads(out[0])
    assert result["correct"] is True, err[-2000:]
    assert list(result)[-1] == "checks"
    ranks = [json.loads((ranks_dir / f"{r}.json").read_text()) for r in range(4)]
    assert [(r["rank"], r["world"]) for r in ranks] == [(r, 4) for r in range(4)]
    assert all(gone(r["pid"]) for r in ranks)
    assert result["device"]["count"] == 4
    assert result["device"]["memory_peak_bytes"] == 4000  # the largest rank's
    assert result["attempted"] == sum(r["attempted"] for r in ranks)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
        assert "detect.submit_ms" in result["metrics"]
    else:
        rate = result["metrics"]["detect_images_per_s"]["value"]
        assert rate == pytest.approx(sum(r["rate"] for r in ranks), rel=1e-12)
        # the launcher's age at the last window, not less than any rank's own
        assert result["metrics"]["setup_s"]["value"] >= max(r["setup_s"] for r in ranks)


FAULTS = {  # fault -> exit code, what the launcher says
    "raises": (1, "rank 2 exited with code 1"),
    "killed": (1, "rank 2 was killed by signal 9"),
    "no_result": (1, "rank 2 sent no result"),
    "sleeps": (1, "still running"),
    "imports_jax": (3, "rank 2 loaded jax"),
}
DEADLINE_S = 25.0


@pytest.fixture(scope="module")
def faulty(tmp_path_factory):
    root = write_tiny_checkout(tmp_path_factory.mktemp("faulty"))
    add_four_chip_cell(root, "faulty", "faulty", FAULTY, root / "ranks")
    return root


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_rank_at_fault_ends_the_run(faulty, fault):
    ranks_dir = faulty / "ranks"
    shutil.rmtree(ranks_dir, ignore_errors=True)
    ranks_dir.mkdir()
    rc, out, err, seconds, left = launch(faulty, "faulty", deadline_s=DEADLINE_S,
                                         env={"RANK_FAULT": f"{fault}:2"})
    code, says = FAULTS[fault]
    assert rc == code and out == [], err[-3000:]
    assert says in err
    if fault == "imports_jax":
        assert "the run loaded jax" in err
    else:
        assert "rank 2 (exit code" in err and "rank 0 (exit code" in err
    if fault == "raises":
        assert "a fault planted in rank 2" in err  # the end of the rank's standard error
    # every rank started, none is left
    pids = [int((ranks_dir / f"{r}.pid").read_text()) for r in range(4)]
    assert left == [] and all(gone(pid) for pid in pids)
    assert seconds < 1 + DEADLINE_S + 30 if fault == "sleeps" else seconds < DEADLINE_S


def test_four_chips_on_a_machine_without_them(tmp_path, capsys):
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found >= 4:
        pytest.skip(f"this machine has {found} cards")
    root = write_tiny_checkout(tmp_path / "checkout")
    add_four_chip_cell(root, "dp4_cell", "group_detect", GROUP_DETECT, tmp_path)
    assert bench_run.main(["--workload", "dp4_cell", "--seed", str(SEED), "--seconds", "1"],
                          root=root) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert f"the cell needs 4 CUDA device(s); found {found}" in captured.err
