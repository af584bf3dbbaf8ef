"""The PyTorch port stands alone: no file of it, nor chip_smoke.py and the
kernel cases it shares with the tests, imports JAX, flax or the JAX
package; its modules import without nvcc or a card; its entry points refuse
to run quietly on the CPU; its kernel wrapper refuses CPU tensors."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "shape_based_object_detection_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grain",
             "shape_based_object_detection_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "torch_kernel_cases.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_no_prebuilt_library_is_loaded():
    """The port builds its host libraries from its own csrc/ into _build/;
    no source names the reference's prebuilt csrc/*.so."""
    for path in SOURCES:
        text = path.read_text()
        for name in ("libap_matcher.so", "libsbd_image.so"):
            assert name not in text, f"{path.relative_to(ROOT)} names {name}"


def test_modules_import_without_jax_or_nvcc():
    """In a fresh interpreter with jax and flax made unimportable and no
    nvcc on PATH, every module of the port imports, and none of them pulls
    in the JAX package."""
    names = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                   for p in PORT.rglob("*.py"))
    names = [n[: -len(".__init__")] if n.endswith(".__init__") else n for n in names]
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'shape_based_object_detection_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=str(ROOT),
               CUDA_VISIBLE_DEVICES="")
    env.pop("CUDA_HOME", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    from shape_based_object_detection_torch import config
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.serving import Predictor

    _no_cuda(monkeypatch)
    for name in ("tiny_retinanet", "tiny_ssd"):
        cfg = config.get_config(name)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg.model)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Predictor(cfg, batch_size=1)
        module, anchors = build_model(cfg.model, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_detect_fn(module, anchors, cfg.model)
        assert next(module.parameters()).device.type == "cpu"


def test_cuda_wrapper_refuses_cpu_tensors():
    from shape_based_object_detection_torch.ops import nms_cuda

    boxes = torch.rand(2, 8, 4)
    scores = torch.rand(2, 8)
    valid = torch.ones(2, 8, dtype=torch.bool)
    classes = torch.zeros(2, 8, dtype=torch.int32)
    before = nms_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nms_cuda.greedy_nms_cuda(boxes, scores, valid, 0.5, 4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nms_cuda.batched_class_aware_nms_cuda(boxes, scores, classes, valid, 0.5, 4)
    assert nms_cuda.launches == before


def test_run_nms_routes_by_device_and_backend():
    """'auto' on CPU tensors is the plain version; 'cuda' (and the
    reference's 'pallas') means the kernel and so raises on CPU tensors;
    unported options raise NotImplementedError."""
    from shape_based_object_detection_torch import config
    from shape_based_object_detection_torch.detection import run_nms
    from shape_based_object_detection_torch.ops import nms as nms_lib

    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 0.5, (2, 32, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + 0.3], -1).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 32)).astype(np.float32))
    classes = torch.from_numpy(rng.integers(0, 3, (2, 32)).astype(np.int32))
    valid = torch.ones(2, 32, dtype=torch.bool)
    cfg = config.tiny_test_model("retinanet")
    got = run_nms(boxes, scores, classes, valid, cfg)
    want = nms_lib.batched_class_aware_nms(boxes, scores, classes, valid,
                                           cfg.detect.nms_iou_threshold,
                                           cfg.detect.max_detections)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for backend in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            run_nms(boxes, scores, classes, valid, cfg, backend=backend)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_nms(boxes, scores, classes, valid, cfg, backend="matrix")
    soft = config.dataclasses.replace(
        cfg, detect=config.dataclasses.replace(cfg.detect, soft_nms_sigma=0.5))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_nms(boxes, scores, classes, valid, soft)


def _match_inputs():
    rng = np.random.default_rng(0)
    anchors = torch.from_numpy(np.concatenate(
        [rng.uniform(0.2, 0.8, (50, 2)), rng.uniform(0.05, 0.4, (50, 2))], 1)
        .astype(np.float32))
    xy = rng.uniform(0, 0.5, (2, 6, 2))
    gt = torch.from_numpy(np.concatenate([xy, xy + 0.3], -1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(1, 4, (2, 6)).astype(np.int32))
    valid = torch.ones(2, 6, dtype=torch.bool)
    return anchors, gt, labels, valid


def test_matching_wrapper_refuses_cpu_tensors():
    from shape_based_object_detection_torch.ops import matching_cuda

    before = matching_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        matching_cuda.match_reductions_cuda(*_match_inputs())
    assert matching_cuda.launches == before


def test_match_batch_routes_by_device_and_backend():
    """'auto' on CPU tensors is the plain version ('plain' and the
    reference's 'jnp' too); 'cuda' and the reference's 'pallas' mean the
    kernel and so raise on CPU tensors."""
    import dataclasses

    from shape_based_object_detection_torch.config import MatchConfig
    from shape_based_object_detection_torch.ops import matching

    args = _match_inputs()
    cfg = MatchConfig(pos_threshold=0.5, neg_threshold=0.4, allow_low_quality=True)
    auto = matching.match_batch(*args, cfg)
    for backend in ("plain", "jnp"):
        got = matching.match_batch(*args, dataclasses.replace(cfg, backend=backend))
        assert all(torch.equal(a, b) for a, b in zip(got, auto))
    for backend in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            matching.match_batch(*args, dataclasses.replace(cfg, backend=backend))


def test_train_entry_points_raise_without_cuda(monkeypatch):
    import dataclasses

    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.models.factory import build_model

    _no_cuda(monkeypatch)
    cfg = config.get_config("tiny_retinanet")
    module, anchors = build_model(cfg.model, device="cpu", train=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.create_train_state(module, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.make_train_step(module, anchors, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.make_eval_step(module, anchors, cfg)
    state = train.create_train_state(module, cfg, device="cpu")
    assert state.generator.device.type == "cpu"
    train.make_train_step(module, anchors, cfg, device="cpu")
    # train_bn, both remat switches and the pipelined step are ported
    for ok in (dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, train_bn=True)),
               dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True)),
               dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=True))):
        train.create_train_state(module, ok, device="cpu")
        train.make_train_step(module, anchors, ok, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.make_train_step_pipelined(module, anchors, cfg)
    train.make_train_step_pipelined(module, anchors, cfg, device="cpu")
    ssd = config.get_config("tiny_ssd")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(ssd.model, train=True)
    ssd_module, ssd_anchors = build_model(ssd.model, device="cpu", train=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.make_train_step(ssd_module, ssd_anchors, ssd)
    bf16 = dataclasses.replace(cfg.model, dtype="bfloat16")
    served, _ = build_model(bf16, device="cpu")
    with pytest.raises(ValueError, match="train=True"):
        train.create_train_state(served, dataclasses.replace(cfg, model=bf16), device="cpu")
