"""The port's serving CLIs on the CPU (``--device cpu``): ``detect_cli`` with
hflip and multi-scale TTA and ``--save-viz`` against the JAX package's
``detect_cli`` on the same weights, ``eval_cli --tta-hflip``/``--tta-scales``
against the JAX ``eval_cli`` on the fixture trees of
``tests/test_torch_cli.py``, ``serve_cli`` in a subprocess (``/healthz``,
``/detect``, SIGTERM), and the int8 tiers' and the artifact's flags of
``serve_cli`` and ``detect_cli``."""

import contextlib
import io
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from shape_based_object_detection_torch.cli import detect_cli, eval_cli, serve_cli
from tests.test_torch_cli import (
    ZERO_THRESHOLD, _coco_fixture, _detections, _kept_evaluators, _same_ground_truth,
    _voc_fixture,
)
from tests.torch_parity import (  # noqa: F401
    assert_matched, jax_variables, one_torch_thread, tiny_int8_files,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30


def _same_weights(monkeypatch):
    """Both packages' build_model on the same seeded weights (the JAX one
    without flax's initialisers)."""
    from shape_based_object_detection_tpu.models import factory as ref_factory
    from shape_based_object_detection_tpu.ops.anchors import anchors_for_model
    from shape_based_object_detection_torch.models import factory
    from shape_based_object_detection_torch.utils.convert import (
        state_dict_from_jax_variables,
    )

    weights = {}
    build = factory.build_model

    def ref_build(cfg_model, rng=None):
        module, weights["variables"] = jax_variables(cfg_model, seed=1)
        return module, weights["variables"], anchors_for_model(cfg_model)

    def port_build(cfg_model, device=None, **kw):
        module, anchors = build(cfg_model, device, **kw)
        module.load_state_dict(state_dict_from_jax_variables(weights["variables"]),
                               strict=True)
        return module, anchors

    monkeypatch.setattr(ref_factory, "build_model", ref_build)
    monkeypatch.setattr(factory, "build_model", port_build)


def _stdout(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(args)
    return buf.getvalue()


def _as_arrays(dets):
    return (np.array([d["box"] for d in dets], np.float64).reshape(-1, 4),
            np.array([d["score"] for d in dets]), np.array([d["label"] for d in dets]))


@pytest.mark.parametrize("config_name,flags", [
    ("tiny_retinanet", ["--tta-hflip", "--tta-scales", "128,160"]),
    ("tiny_ssd", ["--tta-hflip", "--tta-scales", "300"]),
    ("tiny_retinanet", ["--set", "data.letterbox=true", "--tta-scales", "128,96"])])
def test_detect_cli_equals_the_jax_detect_cli(tmp_path, monkeypatch, config_name, flags):
    """One odd-sized image through both detect_clis with the same weights:
    every detection matched (same label, box IoU >= 0.99, score within 1e-3
    after the JSON's rounding), and --save-viz draws a copy of the image."""
    from PIL import Image

    from shape_based_object_detection_tpu.cli import detect_cli as ref_cli

    _same_weights(monkeypatch)
    image = np.random.default_rng(0).integers(0, 256, (101, 143, 3), dtype=np.uint8)
    Image.fromarray(image).save(tmp_path / "img.png")
    args = ["--config", config_name, "--image", str(tmp_path / "img.png"),
            "--min-score", "0.0", "--set", ZERO_THRESHOLD, *flags]
    want = json.loads(_stdout(ref_cli.main, [*args, "--save-viz", str(tmp_path / "ref")]))
    got = json.loads(_stdout(detect_cli.main, [*args, "--device", "cpu",
                                               "--save-viz", str(tmp_path / "port")]))
    assert len(got) > 0
    assert_matched([_as_arrays(got)], [_as_arrays(want)], [143.0])
    drawn = np.asarray(Image.open(tmp_path / "port" / "img_det.png"))
    assert drawn.shape == image.shape and (drawn != image).any()
    assert drawn.shape == np.asarray(Image.open(tmp_path / "ref" / "img_det.png")).shape


def test_detect_cli_directory_mode(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    (tmp_path / "imgs").mkdir()
    for name, size in (("a.jpg", (70, 90)), ("b.png", (120, 64))):
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
            tmp_path / "imgs" / name)
    out = json.loads(_stdout(detect_cli.main, [
        "--device", "cpu", "--config", "tiny_retinanet", "--image", str(tmp_path / "imgs"),
        "--min-score", "0.0", "--set", ZERO_THRESHOLD]))
    assert sorted(out) == ["a.jpg", "b.png"] and all(out.values())
    assert all(d["label"] >= 1 for dets in out.values() for d in dets)
    with pytest.raises(SystemExit, match="no images"):
        detect_cli.main(["--device", "cpu", "--image", str(tmp_path)])


@pytest.mark.parametrize("fixture,protocol,flags", [
    (_voc_fixture, "voc", ["--tta-hflip"]),
    (_coco_fixture, "coco", ["--tta-hflip", "--tta-scales", "128,160"])])
def test_eval_cli_tta_equals_the_jax_eval_cli(tmp_path, monkeypatch, fixture, protocol,
                                              flags):
    """eval_cli with hflip TTA (VOC, difficult objects) and hflip plus two
    scales (COCO, crowd region, letterbox), against the JAX eval_cli on the
    same weights: the ground truth equal element by element, every
    detection matched, the metrics within 1e-6."""
    from shape_based_object_detection_tpu import eval as ref_eval
    from shape_based_object_detection_tpu.cli import eval_cli as ref_cli
    from shape_based_object_detection_torch import eval as eval_pkg

    args = [*fixture(tmp_path / "data"), "--config", "tiny_retinanet", "--protocol", protocol,
            "--set", "data.decode_backend=pil", "--set", ZERO_THRESHOLD, *flags]
    _same_weights(monkeypatch)
    ref_kept = _kept_evaluators(monkeypatch, ref_eval)
    kept = _kept_evaluators(monkeypatch, eval_pkg)
    want_metrics = json.loads(_stdout(ref_cli.main, args))
    got_metrics = json.loads(_stdout(eval_cli.main, ["--device", "cpu", *args]))
    (want,), (got,) = ref_kept, kept
    _same_ground_truth(got, want)
    assert_matched(_detections(got), _detections(want), [1.0] * len(want.detections))
    assert set(got_metrics) == set(want_metrics)
    for key, value in want_metrics.items():
        assert np.isclose(got_metrics[key], value, rtol=0, atol=1e-6, equal_nan=True), key


def test_eval_cli_rejects_a_scale_that_changes_the_ssd_plan():
    with pytest.raises(SystemExit, match="not scale-agnostic"):
        eval_cli.main(["--device", "cpu", "--config", "tiny_ssd", "--tta-scales", "300,512"])
    with pytest.raises(SystemExit, match="comma-separated integers"):
        eval_cli.main(["--device", "cpu", "--config", "tiny_retinanet", "--tta-scales", "a,b"])


@pytest.fixture(scope="module")
def int8_files(tmp_path_factory):
    """Scales calibrated on the tiny RetinaNet and its full-static artifact
    (batch 2)."""
    return tiny_int8_files(str(tmp_path_factory.mktemp("int8")))


def _png(seed=2, h=80, w=100):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _serve_once(monkeypatch, argv):
    """serve_cli.main(argv) in this process, its serve_forever replaced by:
    serve on a thread, answer one /detect, return (serve_cli then closes
    the server). Returns (the answer, serve_cli's stdout)."""
    from shape_based_object_detection_torch import server as server_lib

    answers = []

    def once(self):
        self.start()
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}/detect?min_score=0.0",
                                     data=_png())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            answers.append(json.loads(r.read()))

    monkeypatch.setattr(server_lib.DetectionServer, "serve_forever", once)
    out = _stdout(serve_cli.main, argv)
    return answers[0], out


@pytest.mark.parametrize("args", [["--quantize"], ["--quantize", "full"],
                                  ["--act-scales", "s.json"], ["--artifact", "m.sbdx"]])
def test_serve_cli_unported_options_raise(args, int8_files, monkeypatch):
    """The int8 tiers' and the artifact's flags (once unported, now ported)
    serve: ``--act-scales`` with the ``--quantize full`` it needs and a
    scales file, ``--artifact`` with an artifact; one /detect answered,
    the server stopped. An artifact refuses --quantize/--act-scales."""
    scales, artifact = int8_files
    files = {"s.json": scales, "m.sbdx": artifact}
    argv = [files.get(a, a) for a in args]
    if "--act-scales" in args:
        argv = ["--quantize", "full", *argv]
    answer, out = _serve_once(monkeypatch, [
        "--device", "cpu", "--config", "tiny_retinanet", "--batch-size", "2",
        "--set", ZERO_THRESHOLD, "--set", "data.decode_backend=pil", *argv])
    assert answer["detections"] and (answer["width"], answer["height"]) == (100, 80)
    assert "server stopped" in out
    buckets = "[2]" if "--artifact" in args else "[1, 2]"
    assert f"batch buckets={buckets}" in out
    if "--artifact" in args:
        with pytest.raises(SystemExit, match="cannot modify an exported"):
            serve_cli.main(["--device", "cpu", *argv, "--quantize"])


@pytest.mark.parametrize("args,error", [
    (["--quantize"], None),
    (["--quantize", "--int8-activations"], None),
    (["--quantize", "--int8-activations", "--act-scales", "s.json"], None),
    (["--artifact", "m.sbdx"], None),
    (["--int8-activations"], SystemExit),
    (["--artifact", "m.sbdx", "--tta-hflip"], SystemExit),
    (["--artifact", "m.sbdx", "--tta-scales", "300"], SystemExit),
    (["--artifact", "m.sbdx", "--quantize"], SystemExit)])
def test_detect_cli_unported_and_conflicting_options(tmp_path, args, error, int8_files):
    """The flags of the int8 and artifact tiers (once unported, now
    ported) detect on the tiny RetinaNet; the reference's conflict checks
    raise SystemExit before anything is built."""
    from PIL import Image

    scales, artifact = int8_files
    argv = [{"s.json": scales, "m.sbdx": artifact}.get(a, a) for a in args]
    if error is not None:
        with pytest.raises(error):
            detect_cli.main(["--device", "cpu", "--image", str(tmp_path), *argv])
        return
    Image.open(io.BytesIO(_png(3, 90, 70))).save(tmp_path / "a.png")
    out = _stdout(detect_cli.main, [
        "--device", "cpu", "--config", "tiny_retinanet", "--image", str(tmp_path / "a.png"),
        "--min-score", "0.0", "--set", ZERO_THRESHOLD, *argv])
    dets = json.loads(out)
    assert dets and all(0 <= d["box"][0] <= d["box"][2] <= 70 for d in dets)


def test_serve_cli_serves_and_stops_on_sigterm(tmp_path):
    """serve_cli on a free port: /healthz, one /detect, then SIGTERM ends
    it cleanly."""
    from PIL import Image

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "shape_based_object_detection_torch.cli.serve_cli",
         "--device", "cpu", "--config", "tiny_retinanet", "--port", "0", "--batch-size", "2",
         "--set", ZERO_THRESHOLD, "--set", "data.decode_backend=pil"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    try:
        seen = []
        while not (seen and seen[-1].startswith("serving on")):
            seen.append(lines.get(timeout=TIMEOUT))
        port = int(seen[-1].split("http://127.0.0.1:")[1].split("/")[0])
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=TIMEOUT) as r:
            assert r.read() == b"ok"
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(2).integers(
            0, 256, (80, 100, 3), dtype=np.uint8)).save(buf, format="PNG")
        req = urllib.request.Request(f"{base}/detect?min_score=0.0", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            out = json.loads(r.read())
        assert out["detections"] and (out["width"], out["height"]) == (100, 80)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT) == 0
        while not seen[-1].startswith("server stopped"):
            seen.append(lines.get(timeout=TIMEOUT))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
