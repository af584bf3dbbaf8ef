"""Every cell run end to end on the CPU at a tiny size, each in a process
of its own: correct against the reference, the metrics its entries name,
nothing of JAX or the JAX package loaded; and the timed path broken
underneath, once per fault the cell can have, reads not correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from benchmark.tests.tiny import ROOT, write_tiny_checkout

CELLS = ("r50_detect_b16", "ssd512_train_b32", "r50_train_b16")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "shape_based_object_detection_tpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny_checkout(tmp_path_factory.mktemp("tiny"))


def run_cell(tiny, cell, trace=0, patch="", seconds=2):
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        {textwrap.indent(textwrap.dedent(patch), '        ').strip()}
        from benchmark import run
        rc = run.main(["--workload", {cell!r}, "--seed", "8589934597", "--seconds", "{seconds}",
                       "--trace", "{trace}"], device="cpu", root={str(tiny)!r})
        loaded = sorted({{m.split(".")[0] for m in sys.modules}} & set({FORBIDDEN!r}))
        print("LOADED", loaded)
        sys.exit(rc)
    """)
    env = dict(os.environ, OMP_NUM_THREADS="2")  # the tests run side by side
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(tiny), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "LOADED []"
    return json.loads(lines[-2]), proc.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(tiny, cell):
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    result, err = run_cell(tiny, cell)
    assert result["correct"] is True, err[-2000:]
    names = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == names
    # a CPU run has no device memory to read
    assert all(v["value"] > 0 for k, v in result["metrics"].items() if k != "train_peak_gib")
    assert err.strip().splitlines()[-1].startswith("check failed ")
    assert list(result["checks"]) == list(result["checks"])[:-1] + ["failed"]


def test_traced_run_carries_the_breakdown(tiny):
    result, _ = run_cell(tiny, "ssd512_train_b32", trace=1)
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
    assert "train.loader_wait_ms" in result["metrics"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.models, benchmark.reference.ops, benchmark.reference.augment\n"
            "import benchmark.reference.detect, benchmark.reference.train, benchmark.reference.precision\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "shape_based_object_detection_torch" not in loaded
    assert not loaded & set(FORBIDDEN)


ALTER_ANSWER = """
    from shape_based_object_detection_torch import serving
    unpack = serving.unpack_detections
    def altered(*a, **k):
        out = unpack(*a, **k)
        for d in out:
            d.boxes[0] += 25.0  # an answer altered where it is produced
        return out
    serving.unpack_detections = altered
"""
HALF_DETECT = """
    from shape_based_object_detection_torch import serving
    prepare = serving.prepare_batch
    def half(images, *a, **k):
        batch, sizes = prepare(images, *a, **k)
        batch[len(batch) // 2:] = batch[:len(batch) - len(batch) // 2]  # the rest left out
        return batch, sizes
    serving.prepare_batch = half
"""
STATE_UNCHANGED = """
    from shape_based_object_detection_torch import train
    train.Optimizer.apply = lambda self, state, params, grads, mask: False
"""
HALF_TRAIN = """
    from shape_based_object_detection_torch import train
    batch_on = train._batch_on
    train._batch_on = lambda batch, dev: tuple(t[:t.shape[0] // 2] for t in batch_on(batch, dev))
"""


@pytest.mark.parametrize("cell,patch", [
    ("r50_detect_b16", ALTER_ANSWER), ("r50_detect_b16", HALF_DETECT),
    ("ssd512_train_b32", STATE_UNCHANGED), ("ssd512_train_b32", HALF_TRAIN),
    ("r50_train_b16", STATE_UNCHANGED), ("r50_train_b16", HALF_TRAIN),
], ids=["detect-altered", "detect-half", "ssd-unchanged", "ssd-half",
        "r50-unchanged", "r50-half"])
def test_a_broken_timed_path_is_not_correct(tiny, cell, patch):
    result, err = run_cell(tiny, cell, patch=patch)
    assert result["correct"] is False, err[-2000:]
