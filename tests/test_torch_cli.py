"""The port's CLIs on the CPU (``--device cpu``), on the tiny presets and
synthetic data, following ``tests/test_cli.py``: train then resume, val
eval with the best checkpoint, the EMA reconciled on resume,
``--init-params``, ``--dump-config`` equal to the JAX CLI's JSON, preemption,
the divergence guard, ``eval_cli`` under both protocols (equal to an
in-process Evaluator fed by ``make_eval_step``) and with ``--dump-results``,
the cache, device and grain loaders with their resume, and data
parallelism: ``--num-processes 2`` as two processes, ``eval_cli`` in a
group of two, and a coordinator that never answers; and the model axis:
``train_cli`` and ``eval_cli`` with each image's rows split over two
processes."""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from shape_based_object_detection_torch.cli import eval_cli, train_cli
from tests.torch_parity import one_torch_thread, tiny_int8_files  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--workers", "0"]
ZERO_THRESHOLD = "model.detect.score_threshold=0.0"

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _train(ckpt, *extra, steps=2):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--config", "tiny_retinanet", "--steps", str(steps),
                        "--checkpoint-dir", str(ckpt), "--log-every", "1", *CPU, *extra])
    return buf.getvalue()


def _eval(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_cli.main(["--device", "cpu", *args])
    return buf.getvalue()


def test_train_then_resume(tmp_path):
    out = _train(tmp_path / "ckpt")
    assert "done at step 2" in out and "loss=" in out and "step 1  " in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2"]
    out = _train(tmp_path / "ckpt", steps=4)
    assert "restored checkpoint at step 2" in out
    assert "resuming data schedule at epoch 0, batch 2" in out
    assert "done at step 4" in out and "step 3  " in out


def test_val_eval_and_best_checkpoint(tmp_path):
    out = _train(tmp_path / "ckpt", "--eval-every", "2", "--val-root", "synthetic://val",
                 "--val-batches", "1", steps=4)
    assert "voc-mAP(val)=" in out and "[new best]" in out
    meta = json.loads((tmp_path / "ckpt" / "best" / "best.json").read_text())
    assert meta["step"] in (2, 4)
    assert os.listdir(tmp_path / "ckpt" / "best" / str(meta["step"]))
    out = _train(tmp_path / "ckpt2", "--eval-every", "2", steps=2)
    assert "voc-mAP(train-sample)=" in out


def test_resume_reconciles_the_ema(tmp_path):
    ckpt = tmp_path / "ckpt"
    _train(ckpt)
    out = _train(ckpt, "--ema-decay", "0.9", steps=3)
    assert "starting EMA from the restored params" in out and "done at step 3" in out
    out = _train(ckpt, "--ema-decay", "0", steps=4)
    assert "dropping them" in out and "done at step 4" in out


def test_init_params(tmp_path):
    from shape_based_object_detection_torch import config
    from shape_based_object_detection_torch.checkpoint import CheckpointManager
    from shape_based_object_detection_torch.models.factory import build_model

    module, _ = build_model(config.get_config("tiny_retinanet").model, device="cpu",
                            train=True)
    marked = {k: torch.full_like(v, 0.123) for k, v in module.state_dict().items()}
    torch.save(marked, tmp_path / "init.pt")
    out = _train(tmp_path / "ckpt", "--init-params", str(tmp_path / "init.pt"),
                 "--set", "train.base_lr=0.0", "--set", "train.grad_clip_norm=0.0",
                 steps=1)
    assert "initialized params from" in out and "done at step 1" in out
    snap = CheckpointManager(str(tmp_path / "ckpt")).read(1)
    assert all(bool((t == 0.123).all()) for t in snap["params"].values())


@pytest.mark.parametrize("config_name,sets", [
    ("config3_ssd512_voc_train", ["--set", "train.remat=true"]),
    ("tiny_retinanet", ["--set", "data.letterbox=true", "--batch-size", "4",
                        "--ema-decay", "0.99"])])
def test_dump_config_equals_the_jax_cli(tmp_path, config_name, sets):
    from shape_based_object_detection_tpu.cli import train_cli as ref_cli

    args = ["--config", config_name, "--checkpoint-dir", str(tmp_path / "c"), *sets]
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main([*args, "--dump-config", str(tmp_path / "port.json")])
        ref_cli.main([*args, "--dump-config", str(tmp_path / "ref.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == json.loads((tmp_path / "ref.json").read_text())
    assert got["model"]["remat"] == (config_name.startswith("config3"))


def test_divergence_guard(tmp_path):
    with pytest.raises(SystemExit, match="training has diverged"):
        _train(tmp_path / "ckpt", "--set", "train.base_lr=1e12",
               "--set", "train.grad_clip_norm=1e30", "--set", "train.warmup_steps=0",
               steps=12)


def test_stale_checkpoint_clear_error(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(["--config", "tiny_ssd", "--steps", "1", "--checkpoint-dir",
                        str(tmp_path / "ckpt"), *CPU])
    with pytest.raises(SystemExit, match="does not match the --config"):
        _train(tmp_path / "ckpt", steps=1)


def test_preemption_saves_and_resumes(tmp_path):
    """SIGTERM finishes the step, saves and exits 0; a rerun resumes there."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "shape_based_object_detection_torch.cli.train_cli",
         "--config", "tiny_retinanet", "--steps", "100000", "--checkpoint-dir", ckpt,
         "--log-every", "1", *CPU],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        for line in p.stdout:
            if line.startswith("step 5 "):
                break
        p.send_signal(signal.SIGTERM)
        out = p.stdout.read()
        assert p.wait(timeout=120) == 0, out
    finally:
        p.kill()
    assert "preempted: checkpoint saved at step" in out
    saved = int(out.split("preempted: checkpoint saved at step")[1].split()[0])
    out = _train(ckpt, steps=saved + 1)
    assert f"restored checkpoint at step {saved}" in out
    assert f"done at step {saved + 1}" in out


def test_without_a_card_the_clis_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--config", "tiny_retinanet", "--steps", "1",
                        "--checkpoint-dir", str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_cli.main(["--config", "tiny_retinanet", "--max-batches", "1"])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _losses(out):
    """The metrics (running means) of each logged step, without the
    throughput."""
    return {line.split()[1]: line.split("img/s")[0].split(None, 2)[2]
            for line in out.splitlines() if line.startswith("step ") and "loss=" in line}


@pytest.mark.parametrize("args", [["--loader", "grain"], ["--loader", "cache"],
                                  ["--loader", "device"], ["--num-processes", "2"]])
def test_train_cli_unported_options_raise(tmp_path, args):
    """The loaders and data parallelism, once unported, now run: each
    ``--loader`` trains 3 steps over epochs of 2 batches, then resumes at
    its place in the data schedule (epoch 1, batch 1) and takes the steps
    an uninterrupted run takes (the grain loader's one stream drops the
    whole consumed prefix); ``--num-processes 2`` with a coordinator at
    which no process listens fails within its ``--dist-timeout`` of 3 s
    (here under 60 s) instead of hanging."""
    import time

    if args[0] == "--num-processes":
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="timed out"):
            _train(tmp_path / "c", *args, "--process-id", "1", "--coordinator",
                   f"127.0.0.1:{_free_port()}", "--dist-timeout", "3")
        assert time.monotonic() - t0 < 60
        return
    small = [*args, "--data-root", "synthetic://train?n=8", "--batch-size", "4",
             "--cache-dir", str(tmp_path / "cache")]
    from shape_based_object_detection_torch.checkpoint import CheckpointManager

    assert "done at step 3" in _train(tmp_path / "c", *small, steps=3)
    resumed = _train(tmp_path / "c", *small, steps=5)
    assert "restored checkpoint at step 3" in resumed
    assert "resuming data schedule at epoch 1, batch 1" in resumed
    _train(tmp_path / "whole", *small, steps=5)
    got = CheckpointManager(str(tmp_path / "c")).read(5)["params"]
    want = CheckpointManager(str(tmp_path / "whole")).read(5)["params"]
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=0, atol=0, msg=k)
    if args[1] in ("cache", "device"):
        assert os.path.exists(tmp_path / "cache" / "meta.json")


def test_train_cli_two_processes(tmp_path):
    """``--num-processes 2``: two processes on gloo, each with half of the
    global batch of 4, log the single process's metrics on that global
    batch (the printed digits; the thread Loader strides its shards, so the
    global batch holds one process's images in another order, and the
    geometric and photometric augmentations, which draw per row, are off),
    evaluate the val split sharded to the same mAP, end with equal
    parameter checksums, and rank 0 alone writes the checkpoint, which a
    single process resumes."""
    common = ["--batch-size", "4",
              "--log-every", "1", "--eval-every", "3", "--val-root", "synthetic://val",
              "--val-batches", "2", *CPU,
              *(x for k in ("photometric", "expand", "random_crop", "hflip")
                for x in ("--set", f"data.{k}=false"))]
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "shape_based_object_detection_torch.cli.train_cli",
         "--config", "tiny_retinanet", "--steps", "3", *common,
         "--checkpoint-dir", str(tmp_path / "dp"), "--num-processes", "2",
         "--process-id", str(i), "--coordinator", f"127.0.0.1:{port}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    sums = [line.split("checksum")[1].strip() for out in outs for line in out.splitlines()
            if "parameter checksum" in line]
    assert len(sums) == 2 and sums[0] == sums[1]
    assert "done at step 3" in outs[0] and "done at step 3" not in outs[1]
    assert "loss=" not in outs[1]
    alone = _train(tmp_path / "alone", *common, steps=3)
    assert _losses(outs[0]) == _losses(alone) and len(_losses(alone)) == 3
    val = [line for line in outs[0].splitlines() if "voc-mAP(val)" in line]
    assert val and val == [line for line in alone.splitlines() if "voc-mAP(val)" in line]
    assert sorted(os.listdir(tmp_path / "dp")) == ["3", "best"]
    out = _train(tmp_path / "dp", *common, steps=4)
    assert "restored checkpoint at step 3" in out and "done at step 4" in out


def _torchrun_env_pair(module, argv, port):
    """Two processes of ``module`` in a group of two from torchrun's
    environment."""
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "--device", "cpu", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT))
    return procs


def _outputs(procs, timeout=180):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_train_and_eval_cli_split_rows_over_two_processes(tmp_path, int8_files):
    """``--set mesh.model_parallelism=2`` on two processes: one data index
    whose two ranks each compute their rows of every image, at the tiny
    preset's 128 px, whose P7 (one row) does not split evenly. ``train_cli``
    logs the single process's losses and val mAP and ends with equal
    parameter checksums; ``eval_cli`` on its checkpoint, in a group of two
    from torchrun's environment, prints the single process's metrics: in
    the float tier; with ``--quantize full --act-scales`` (the static int8
    tier), ``--tta-hflip`` and ``--tta-scales 128,160`` together; and with
    ``--artifact``, run whole on each rank."""
    common = ["--batch-size", "2", "--log-every", "1", "--eval-every", "2",
              "--val-root", "synthetic://val", "--val-batches", "1", *CPU]
    split = ["--set", "mesh.model_parallelism=2"]
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "shape_based_object_detection_torch.cli.train_cli",
         "--config", "tiny_retinanet", "--steps", "2", *common, *split,
         "--checkpoint-dir", str(tmp_path / "mp"), "--num-processes", "2",
         "--process-id", str(i), "--coordinator", f"127.0.0.1:{port}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for i in range(2)]
    outs = _outputs(procs)
    sums = [line.split("checksum")[1].strip() for out in outs for line in out.splitlines()
            if "parameter checksum" in line]
    assert len(sums) == 2 and sums[0] == sums[1]
    alone = _train(tmp_path / "alone", *common, steps=2)
    assert _losses(outs[0]) == _losses(alone) and len(_losses(alone)) == 2
    val = [line for line in outs[0].splitlines() if "voc-mAP(val)" in line]
    assert val and val == [line for line in alone.splitlines() if "voc-mAP(val)" in line]

    scales, artifact = int8_files
    base = ["--config", "tiny_retinanet", "--protocol", "voc", "--data-root", "synthetic://val",
            "--max-batches", "2", "--set", ZERO_THRESHOLD, "--set", "data.batch_size=2"]
    weights = ["--checkpoint-dir", str(tmp_path / "mp")]
    runs = {"float": base + weights,
            "int8_tta": base + weights + ["--quantize", "full", "--act-scales", scales,
                                          "--tta-hflip", "--tta-scales", "128,160"],
            "artifact": base + ["--artifact", artifact]}
    started = {name: _torchrun_env_pair("shape_based_object_detection_torch.cli.eval_cli",
                                        args + split, _free_port())
               for name, args in runs.items()}
    for name, args in runs.items():
        outs = _outputs(started[name])
        assert "{" not in outs[1], name
        got = json.loads(outs[0][outs[0].index("{"):])
        want = json.loads((lambda t: t[t.index("{"):])(_eval(*args)))
        assert set(got) == set(want) and want["mAP"] > 0, name
        for key, value in want.items():
            assert np.isclose(got[key], value, rtol=0, atol=1e-6, equal_nan=True), (name, key)


def test_eval_cli_under_torchrun_equals_one_process(tmp_path):
    """eval_cli in a group of two (torchrun's environment): each rank
    detects its rows of every batch, rank 0 prints the metrics and writes
    --dump-results, equal to one process's; the other rank prints
    nothing."""
    data = _coco_fixture(tmp_path / "coco")
    args = ["--config", "tiny_retinanet", "--protocol", "coco", *data,
            "--set", ZERO_THRESHOLD, "--set", "data.batch_size=2",
            "--set", "data.decode_backend=pil"]
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "shape_based_object_detection_torch.cli.eval_cli",
             "--device", "cpu", *args, "--dump-results", str(tmp_path / f"dp{rank}.json")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "{" not in outs[1] and not os.path.exists(tmp_path / "dp1.json")
    alone = _eval(*args, "--dump-results", str(tmp_path / "alone.json"))
    got = json.loads(outs[0][outs[0].index("{"):])
    want = json.loads(alone[alone.index("{"):])
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.isclose(got[key], value, rtol=0, atol=1e-6, equal_nan=True), key
    got = json.loads((tmp_path / "dp0.json").read_text())
    want = json.loads((tmp_path / "alone.json").read_text())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"] + [g["score"]], w["bbox"] + [w["score"]],
                                   atol=0.011)


@pytest.fixture(scope="module")
def int8_files(tmp_path_factory):
    """Scales calibrated on the tiny RetinaNet and its full-static artifact."""
    return tiny_int8_files(str(tmp_path_factory.mktemp("int8")))


@pytest.mark.parametrize("args", [["--quantize"], ["--quantize", "full"],
                                  ["--act-scales", "x.json"], ["--artifact", "m.sbdx"]])
def test_eval_cli_unported_options_raise(args, int8_files):
    """The int8 tiers' and the artifact's flags (once unported, now
    ported) run: ``--act-scales`` with the ``--quantize full`` it needs and
    a scales file, ``--artifact`` with an artifact of the config; each
    prints its metric. The reference's conflict checks raise."""
    scales, artifact = int8_files
    files = {"x.json": scales, "m.sbdx": artifact}
    argv = [files.get(a, a) for a in args]
    if "--act-scales" in args:
        argv = ["--quantize", "full", *argv]
    out = _eval("--config", "tiny_retinanet", "--max-batches", "1", "--protocol", "voc",
                "--set", ZERO_THRESHOLD, *argv)
    assert 0.0 <= json.loads(out)["mAP"] <= 1.0
    if "--artifact" in args:
        with pytest.raises(SystemExit, match="frozen program: --quantize"):
            _eval("--config", "tiny_retinanet", *argv, "--quantize")
        with pytest.raises(SystemExit, match="artifact/config mismatch"):
            _eval("--config", "tiny_ssd", *argv)
    if "--act-scales" in args:
        with pytest.raises(SystemExit, match="requires --quantize full"):
            _eval("--config", "tiny_retinanet", *argv[2:])


def _in_process(ckpt, max_batches):
    """An in-process Evaluator fed by ``make_eval_step`` on the checkpoint's
    train state, over the same synthetic val split, at score threshold 0."""
    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.checkpoint import CheckpointManager
    from shape_based_object_detection_torch.data.pipeline import Loader
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = config.resolve_config("tiny_retinanet", [ZERO_THRESHOLD])
    module, anchors = build_model(cfg.model, device="cpu", train=True)
    state = CheckpointManager(str(ckpt)).restore_latest(
        train.create_train_state(module, cfg, device="cpu"))
    args = types.SimpleNamespace(data_root="", split="val", ann_file="")
    loader = Loader(train_cli.build_dataset(cfg, args, include_ignore=True),
                    cfg.data.batch_size, cfg.data.max_boxes, shuffle=False)
    return train_cli.evaluate(train.make_eval_step(module, anchors, cfg, device="cpu"),
                              state, loader, cfg, torch.device("cpu"), max_batches)


def _kept_evaluators(monkeypatch, eval_pkg):
    """Every Evaluator that ``eval_pkg.Evaluator`` builds from here on, in
    the list returned: the records a CLI fed it stay readable."""
    made = []

    class Kept(eval_pkg.Evaluator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(eval_pkg, "Evaluator", Kept)
    return made


def _same_ground_truth(got, want):
    """Two Evaluators' ground-truth records, element by element: boxes,
    labels, the crowd and ignore channels and the area factors."""
    assert got.area_scale == want.area_scale
    assert len(got.ground_truth) == len(want.ground_truth) > 0
    for g, w in zip(got.ground_truth, want.ground_truth):
        assert (g.image_id, g.area_factor) == (w.image_id, w.area_factor)
        for field in ("boxes", "labels", "crowd", "ignore"):
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)


def _detections(ev):
    return [(d.boxes, d.scores, d.labels) for d in ev.detections]


def test_eval_cli_equals_the_in_process_evaluator(tmp_path, monkeypatch):
    """The records eval_cli feeds its Evaluator equal, element by element,
    those of an Evaluator fed by ``make_eval_step`` (a fresh model scores
    mAP near 0, so equal metrics alone would say little); so do the
    metrics."""
    from shape_based_object_detection_torch import eval as eval_pkg

    ckpt = tmp_path / "ckpt"
    _train(ckpt, "--set", "train.base_lr=0.05", steps=3)
    want = _in_process(ckpt, 3)
    kept = _kept_evaluators(monkeypatch, eval_pkg)
    for protocol in ("voc", "coco"):
        got = json.loads(_eval("--config", "tiny_retinanet", "--checkpoint-dir", str(ckpt),
                               "--protocol", protocol, "--max-batches", "3", "--per-class",
                               "--set", ZERO_THRESHOLD))
        ev = kept.pop()
        _same_ground_truth(ev, want)
        assert len(ev.detections) == len(want.detections)
        assert sum(len(d.scores) for d in ev.detections) > 0
        for g, w in zip(_detections(ev), _detections(want)):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        metrics = want.coco() if protocol == "coco" else want.voc()
        assert set(got) == set(metrics)
        for key, value in metrics.items():
            if key == "per_class":
                assert got[key] == {str(c): v for c, v in value.items()}
            else:
                assert np.isclose(got[key], value, atol=0, rtol=0, equal_nan=True), key
    with pytest.raises(SystemExit, match="no checkpoint"):
        _eval("--config", "tiny_retinanet", "--checkpoint-dir", str(tmp_path / "none"))
    with pytest.raises(SystemExit, match="no EMA"):
        _eval("--config", "tiny_retinanet", "--checkpoint-dir", str(ckpt), "--ema")


def _voc_fixture(root):
    """A VOCdevkit tree of three JPEGs, with difficult objects."""
    from PIL import Image

    (root / "JPEGImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    (root / "ImageSets" / "Main").mkdir(parents=True)
    rng = np.random.default_rng(0)
    objects = {"a": [("dog", 10, 12, 80, 90, 0), ("person", 5, 5, 40, 60, 1)],
               "b": [("car", 20, 30, 150, 100, 0), ("dog", 60, 10, 120, 70, 0)],
               "c": [("cat", 2, 3, 60, 70, 1), ("car", 30, 40, 90, 110, 0)]}
    for name, objs in objects.items():
        h, w = int(rng.integers(90, 140)), int(rng.integers(120, 170))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{name}.jpg", quality=90)
        body = "".join(
            f"<object><name>{n}</name><difficult>{d}</difficult><bndbox><xmin>{x0}</xmin>"
            f"<ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>"
            for n, x0, y0, x1, y1, d in objs)
        (root / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height></size>{body}"
            "</annotation>")
    (root / "ImageSets" / "Main" / "val.txt").write_text("a\nb\nc\n")
    return ["--dataset", "voc", "--data-root", str(root), "--split", "val",
            "--set", "model.num_classes=20"]


def _coco_fixture(root):
    """A COCO tree of three images (one PNG) with a crowd region, and
    letterboxing, so the area factors and the crowd channel are used."""
    from PIL import Image

    root.mkdir()
    ann = {"images": [{"id": 11, "file_name": "a.jpg", "height": 100, "width": 160},
                      {"id": 12, "file_name": "b.jpg", "height": 120, "width": 80},
                      {"id": 13, "file_name": "c.png", "height": 90, "width": 90}],
           "categories": [{"id": c, "name": f"c{c}"} for c in (1, 5, 7, 90)],
           "annotations": [
               {"id": 1, "image_id": 11, "category_id": 5, "bbox": [10, 10, 40, 40],
                "iscrowd": 0},
               {"id": 2, "image_id": 11, "category_id": 90, "bbox": [0, 0, 150, 30],
                "iscrowd": 1},
               {"id": 3, "image_id": 12, "category_id": 1, "bbox": [5, 5, 30, 60],
                "iscrowd": 0},
               {"id": 4, "image_id": 13, "category_id": 7, "bbox": [20, 30, 40, 20],
                "iscrowd": 0}]}
    (root / "ann.json").write_text(json.dumps(ann))
    rng = np.random.default_rng(1)
    for im in ann["images"]:
        Image.fromarray(rng.integers(0, 255, (im["height"], im["width"], 3),
                                     dtype=np.uint8)).save(root / im["file_name"])
    return ["--dataset", "coco", "--data-root", str(root), "--ann-file",
            str(root / "ann.json"), "--set", "data.letterbox=true"]


@pytest.mark.parametrize("fixture,protocol", [(_voc_fixture, "voc"), (_coco_fixture, "coco")])
def test_eval_cli_equals_the_jax_eval_cli(tmp_path, monkeypatch, fixture, protocol):
    """The port's eval_cli and the JAX package's, on the same weights and a
    VOC tree with difficult objects or a COCO tree with a crowd region:
    the ground truth each feeds its Evaluator equal element by element
    (labels shifted to 0-based, the difficult or crowd channel, the area
    factors), every detection matched (same label, box IoU >= 0.99, scores
    within 1e-3), and the metrics within 1e-6."""
    from shape_based_object_detection_tpu import eval as ref_eval
    from shape_based_object_detection_tpu.cli import eval_cli as ref_cli
    from shape_based_object_detection_tpu.models import factory as ref_factory
    from shape_based_object_detection_tpu.ops.anchors import anchors_for_model
    from shape_based_object_detection_torch import eval as eval_pkg
    from shape_based_object_detection_torch.models import factory
    from shape_based_object_detection_torch.utils.convert import (
        state_dict_from_jax_variables,
    )
    from tests.torch_parity import assert_matched, jax_variables

    args = [*fixture(tmp_path / "data"), "--config", "tiny_retinanet", "--protocol", protocol,
            "--set", "data.decode_backend=pil", "--set", ZERO_THRESHOLD]
    weights = {}
    build = factory.build_model

    def ref_fast_build(cfg_model, rng=None):
        # the JAX module without flax's initialisers, on seeded variables
        module, weights["variables"] = jax_variables(cfg_model, seed=1)
        return module, weights["variables"], anchors_for_model(cfg_model)

    def port_build(cfg_model, device=None, **kw):
        module, anchors = build(cfg_model, device, **kw)
        module.load_state_dict(state_dict_from_jax_variables(weights["variables"]),
                               strict=True)
        return module, anchors

    monkeypatch.setattr(ref_factory, "build_model", ref_fast_build)
    monkeypatch.setattr(factory, "build_model", port_build)
    ref_kept = _kept_evaluators(monkeypatch, ref_eval)
    kept = _kept_evaluators(monkeypatch, eval_pkg)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_cli.main(args)
    want_metrics = json.loads(buf.getvalue())
    got_metrics = json.loads(_eval(*args))
    (want,), (got,) = ref_kept, kept
    _same_ground_truth(got, want)
    flags = [g.crowd if protocol == "coco" else g.ignore for g in got.ground_truth]
    assert any(f.any() for f in flags) and not all(f.all() for f in flags)
    assert_matched(_detections(got), _detections(want), [1.0] * len(want.detections))
    assert set(got_metrics) == set(want_metrics)
    for key, value in want_metrics.items():
        assert np.isclose(got_metrics[key], value, rtol=0, atol=1e-6, equal_nan=True), key


def test_eval_cli_coco_dump_results(tmp_path):
    from PIL import Image

    root = tmp_path / "coco"
    root.mkdir()
    ann = {"images": [{"id": 11, "file_name": "a.jpg", "height": 100, "width": 160},
                      {"id": 12, "file_name": "b.jpg", "height": 120, "width": 80},
                      {"id": 13, "file_name": "c.png", "height": 90, "width": 90}],
           "categories": [{"id": c, "name": f"c{c}"} for c in (1, 5, 7, 90)],
           "annotations": [
               {"id": 1, "image_id": 11, "category_id": 5, "bbox": [10, 10, 40, 40],
                "iscrowd": 0},
               {"id": 2, "image_id": 12, "category_id": 1, "bbox": [5, 5, 30, 60],
                "iscrowd": 1},
               {"id": 3, "image_id": 13, "category_id": 90, "bbox": [20, 30, 40, 20],
                "iscrowd": 0}]}
    (root / "ann.json").write_text(json.dumps(ann))
    rng = np.random.default_rng(0)
    for im in ann["images"]:
        Image.fromarray(rng.integers(0, 255, (im["height"], im["width"], 3),
                                     dtype=np.uint8)).save(root / im["file_name"])
    out_json = tmp_path / "results.json"
    for protocol in ("coco", "voc"):
        out = _eval("--config", "tiny_retinanet", "--dataset", "coco", "--protocol", protocol,
                    "--data-root", str(root), "--ann-file", str(root / "ann.json"),
                    "--dump-results", str(out_json),
                    "--set", "model.detect.score_threshold=0.0")
        assert "wrote" in out
        metrics = json.loads(out[out.index("{"):])
        assert "mAP" in metrics and ("AP50" in metrics) == (protocol == "coco")
    results = json.loads(out_json.read_text())
    assert results and {r["image_id"] for r in results} == {11, 12, 13}
    for r in results:
        assert set(r) == {"image_id", "category_id", "bbox", "score"}
        assert r["category_id"] in (1, 5, 7, 90)
        assert len(r["bbox"]) == 4 and r["bbox"][2] >= 0 and r["bbox"][3] >= 0


def test_synthetic_scheme():
    from shape_based_object_detection_torch import config
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

    cfg = config.get_config("config3_ssd512_voc_train")

    def build(root):
        return train_cli.build_dataset(cfg, types.SimpleNamespace(
            data_root=root, ann_file="", split="val"), include_ignore=True)

    ds = build("synthetic://cap?n=16&max_objects=8&aspect_std=0.6&color_jitter=0.1"
               "&classes=20")
    assert isinstance(ds, SyntheticDetection)
    assert (len(ds), ds.max_objects, ds.num_classes) == (16, 8, 20)
    np.testing.assert_array_equal(build("synthetic://cap")[0][0],
                                  build("synthetic://cap?n=16")[0][0])
    with pytest.raises(SystemExit, match="unknown synthetic"):
        build("synthetic://cap?nimages=10")
