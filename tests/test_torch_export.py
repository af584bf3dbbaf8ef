"""The port's exported artifact (``export.py``) and ``ArtifactPredictor``,
following ``tests/test_export.py``: the round trip equal to live detect on
the CPU (float and full-static int8), the program calling
``sbd::greedy_nms`` (not an unrolled loop), the header and magic, the file
round trip, the int8 artifact's size, the flag checks, the dtype override,
each package's loader refusing the other's blob, eager detect after an
export (``utils/device.constant`` under tracing), and ``ArtifactPredictor``
against ``Predictor``; the two tools."""

import contextlib
import io
import json
import zipfile

import numpy as np
import pytest
import torch

from shape_based_object_detection_torch import config, export, quantize
from shape_based_object_detection_torch.detection import make_detect_fn
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.ops import nms_cuda
from shape_based_object_detection_torch.serving import ArtifactPredictor, Predictor
from shape_based_object_detection_torch.utils import device as device_lib
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ZERO = ["model.detect.score_threshold=0.0"]


def _cfg(name="tiny_retinanet"):
    return config.resolve_config(name, ZERO)


def _images(b=2, size=128, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3), dtype=np.uint8)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    module, anchors = build_model(cfg.model, device="cpu")
    scales = quantize.calibrate_activation_scales(module, [_images(seed=1)], cfg.data)
    blobs = {
        "float": export.export_detect(module, anchors, cfg.model, cfg.data, 2, "cpu"),
        "full_static": export.export_detect(module, anchors, cfg.model, cfg.data, 2, "cpu",
                                            quantize=True, int8_activations=True,
                                            activation_scales=scales),
    }
    loaded = {k: export.load_detect(v, "cpu") for k, v in blobs.items()}
    return dict(cfg=cfg, module=module, anchors=anchors, scales=scales, blobs=blobs,
                loaded=loaded)


def test_eager_detect_after_export_is_unchanged():
    """Eager detect, then an export traced with an empty constant cache,
    then eager detect again in the same process: equal results. A tracer's
    tensor kept by ``utils/device.constant`` would reach the second detect."""
    cfg = _cfg()
    module, anchors = build_model(cfg.model, device="cpu")
    detect = make_detect_fn(module, anchors, cfg.model, cfg.data, "cpu")
    images = _images()
    before = detect(images)
    device_lib._cached_constant.cache_clear()
    export.export_detect(module, anchors, cfg.model, cfg.data, 2, "cpu")
    after = detect(images)
    assert _equal(before, after)
    c = device_lib.constant((1.0, 2.0), torch.float32, torch.device("cpu"))
    assert type(c) is torch.Tensor and c.tolist() == [1.0, 2.0]


@pytest.mark.parametrize("tier", ["float", "full_static"])
def test_round_trip_equals_live_detect(tiny, tier, monkeypatch):
    """The loaded program reproduces live detect exactly on the CPU, and
    its NMS is one call of ``sbd::greedy_nms`` (its CPU body, the plain
    greedy NMS, runs once per call), not an unrolled loop."""
    cfg, module, anchors = tiny["cfg"], tiny["module"], tiny["anchors"]
    if tier == "float":
        live = make_detect_fn(module, anchors, cfg.model, cfg.data, "cpu")
    else:
        live, _ = quantize.make_serving_detect(module, anchors, cfg.model, cfg.data, "full",
                                               "cpu", tiny["scales"])
    loaded = tiny["loaded"][tier]
    targets = [n.target for n in loaded.program.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.sbd.greedy_nms.default) == 1
    assert (targets.count(torch.ops.sbd.int8_conv2d.default) > 0) == (tier != "float")
    calls = []
    plain = nms_cuda.greedy_nms
    monkeypatch.setattr(nms_cuda, "greedy_nms", lambda *a: calls.append(1) or plain(*a))
    images = _images(seed=2)
    got = loaded(images)
    assert calls == [1]
    assert _equal(got, live(images))
    assert got.valid.any()


def test_header_and_magic(tiny):
    blob = tiny["blobs"]["full_static"]
    assert blob[:8] == export.MAGIC != export.REFERENCE_MAGIC
    header = tiny["loaded"]["full_static"].header
    cfg = tiny["cfg"]
    assert header["model"] == cfg.model.name and header["image_size"] == 128
    assert header["batch_size"] == 2 and header["num_classes"] == cfg.model.num_classes
    assert header["quantized"] is True and header["int8_activations"] is True
    assert header["activation_scale_mode"] == "static" and header["letterbox"] is False
    assert header["outputs"] == ["boxes", "scores", "labels", "valid"]
    assert header["dtype"] == "float32" and header["precision"] == cfg.model.precision
    assert header["device"] == "cpu" and header["platforms"] == ["cuda", "cpu"]
    assert header["torch_version"] == torch.__version__
    float_header = tiny["loaded"]["float"].header
    assert float_header["quantized"] is False and float_header["activation_scale_mode"] == ""


def test_file_round_trip(tiny, tmp_path):
    path = str(tmp_path / "m.sbdx")
    export.save_artifact(tiny["blobs"]["float"], path)
    images = _images(seed=3)
    a = export.load_artifact(path, "cpu")(images)
    b = tiny["loaded"]["float"](images)
    assert _equal(a, b)


def _tensor_bytes(blob):
    """The bytes of the tensors a ``torch.export.save`` archive holds (its
    ``data`` entries), apart from the serialized program."""
    hlen = int.from_bytes(blob[8:16], "little")
    archive = zipfile.ZipFile(io.BytesIO(blob[16 + hlen:]))
    return sum(i.file_size for i in archive.infolist() if i.filename.split("/")[1] == "data")


def test_int8_artifact_smaller(tiny):
    """The int8 artifacts hold under half the float artifact's tensor bytes.
    (The serialized program, 2.4 MB in float and 3.1 MB with the int8
    convolutions' extra nodes, is most of a tiny model's artifact; at full
    width the weights are.) A truncated blob raises."""
    cfg, module, anchors = tiny["cfg"], tiny["module"], tiny["anchors"]
    weights = export.export_detect(module, anchors, cfg.model, cfg.data, 2, "cpu",
                                   quantize=True)
    float_blob = tiny["blobs"]["float"]
    for blob in (weights, tiny["blobs"]["full_static"]):
        assert _tensor_bytes(blob) < 0.5 * _tensor_bytes(float_blob)
    with pytest.raises(ValueError, match="truncated"):
        export.load_detect(weights[:20], "cpu")


def test_flag_checks(tiny):
    cfg, module, anchors = tiny["cfg"], tiny["module"], tiny["anchors"]
    with pytest.raises(ValueError, match="int8_activations=True requires quantize"):
        export.export_detect(module, anchors, cfg.model, cfg.data, 2, "cpu",
                             int8_activations=True)
    with pytest.raises(ValueError, match="activation_scales requires int8_activations"):
        export.export_detect(module, anchors, cfg.model, cfg.data, 2, "cpu", quantize=True,
                             activation_scales=tiny["scales"])


def test_dtype_override():
    """``dtype`` bakes the compute type in: a bf16 artifact of the tiny SSD
    equals the live bf16 detect."""
    cfg = _cfg("tiny_ssd")
    blob = export.export_from_config(cfg, batch_size=1, dtype="bfloat16", device="cpu")
    loaded = export.load_detect(blob, "cpu")
    assert loaded.header["dtype"] == "bfloat16"
    bf16 = config.dataclasses.replace(cfg.model, dtype="bfloat16")
    module, anchors = build_model(bf16, device="cpu")
    images = _images(1, 300, seed=4)
    assert _equal(loaded(images), make_detect_fn(module, anchors, bf16, cfg.data, "cpu")(images))


def test_loaders_refuse_each_others_blobs(tiny):
    """A blob with the JAX package's magic is refused, naming it; the JAX
    package's loader refuses the port's blob."""
    from shape_based_object_detection_tpu import export as jax_export

    reference = export.REFERENCE_MAGIC + (2).to_bytes(8, "little") + b"{}" + b"payload"
    with pytest.raises(ValueError, match="JAX package.*SBDX0001"):
        export.load_detect(reference, "cpu")
    with pytest.raises(ValueError, match="bad magic"):
        export.load_detect(b"NOTSBDX!" + reference[8:], "cpu")
    with pytest.raises(ValueError, match="bad magic"):
        jax_export.load_detect(tiny["blobs"]["float"])


def test_artifact_predictor_equals_predictor(tiny, tmp_path):
    """ArtifactPredictor over the float artifact answers as the Predictor of
    the same config and weights: same boxes, scores and labels; one bucket;
    submit/poll and warmup as the Predictor's."""
    path = str(tmp_path / "m.sbdx")
    export.save_artifact(tiny["blobs"]["float"], path)
    ap = ArtifactPredictor(path, device="cpu")
    pred = Predictor(tiny["cfg"], batch_size=2, device="cpu")
    assert ap.bucket_sizes == [2] and ap.batch_size == 2 and ap.size == 128
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (90 + 9 * i, 120 - 7 * i, 3), dtype=np.uint8)
              for i in range(3)]
    got, want = ap.predict(images), pred.predict(images)
    assert len(got) == len(want) == 3 and sum(len(d.scores) for d in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.scores, w.scores)
        np.testing.assert_array_equal(g.labels, w.labels)
    ap.warmup()
    ap.submit(images[:1])
    np.testing.assert_array_equal(ap.poll()[0].scores, want[0].scores)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_tools_calibrate_and_export(tmp_path):
    """The two tools on the CPU: the scales they write load, and the
    artifact exported with them runs in the static tier."""
    from shape_based_object_detection_torch.tools import calibrate_scales, export_model

    scales = str(tmp_path / "s.json")
    out = _run(calibrate_scales.main, ["--device", "cpu", "--config", "tiny_retinanet",
                                       "--batches", "1", "--out", scales])
    assert "conv scales" in out and quantize.load_activation_scales(scales)
    path = str(tmp_path / "m.sbdx")
    out = _run(export_model.main, ["--device", "cpu", "--config", "tiny_retinanet",
                                   "--batch-size", "1", "--quantize", "--int8-activations",
                                   "--act-scales", scales, "--set", ZERO[0], "--out", path])
    assert "quantized=True" in out
    loaded = export.load_artifact(path, "cpu")
    assert loaded.header["activation_scale_mode"] == "static"
    det = loaded(_images(1, seed=6))
    assert det.valid.any() and torch.isfinite(det.scores).all()
    with pytest.raises(SystemExit, match="requires --quantize"):
        export_model.main(["--device", "cpu", "--config", "tiny_retinanet",
                           "--int8-activations", "--out", path])
    with pytest.raises(SystemExit, match="requires --int8-activations"):
        export_model.main(["--device", "cpu", "--config", "tiny_retinanet", "--quantize",
                           "--act-scales", scales, "--out", path])
    json.loads(open(scales).read())
