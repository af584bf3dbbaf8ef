"""chip_smoke.py stops every process it starts: as the child subreaper of
its descendants it finds a grandchild whose parent has exited, and its last
step stops that, a loader's worker processes left running, and
multiprocessing's fork server and resource tracker, so that no process
outlives the script."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import json, subprocess, sys, time
    import chip_smoke
    from shape_based_object_detection_torch.data.grain_pipeline import GrainLoader
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

    chip_smoke.adopt_orphans()
    ds = SyntheticDetection(size=32, num_images=8, num_classes=4)
    left_open = GrainLoader(ds, 2, 5, workers=2)
    next(left_open.batches(0))  # two workers, never closed
    closed = GrainLoader(ds, 2, 5, workers=2)
    next(closed.batches(0))
    closed.close()
    # a shell that exits at once, leaving its background sleep behind
    subprocess.run(["sh", "-c", "sleep 600 & exit 0"], check=True)
    time.sleep(0.2)
    before = chip_smoke.descendants()
    workers = chip_smoke.loader_workers_left()
    chip_smoke.stop_children(timeout=5)
    print(json.dumps({"before": list(before.values()), "workers": len(workers),
                      "after": list(chip_smoke.descendants().values())}))
""")


def test_stop_children_leaves_no_process():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    before = out["before"]
    # the orphaned sleep was re-parented to the script, and found
    assert any(c.startswith("sleep 600") for c in before)
    # the fork server, the open loader's two workers and the resource
    # tracker; the closed loader's workers had ended
    assert sum("forkserver import main" in c for c in before) == 3
    assert sum("resource_tracker import main" in c for c in before) == 1
    assert out["workers"] == 2  # the open loader's, the server left out
    assert out["after"] == []
    logged = [line for line in proc.stdout.splitlines() if line.startswith("[procs]")]
    assert len(logged) == 3  # the sleep and the two workers, by name
