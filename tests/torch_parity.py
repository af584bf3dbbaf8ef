"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: the same weights and inputs, made with numpy from a seed, for
both."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu.models.factory import build_module
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.utils.convert import (
    state_dict_from_jax_variables,
)


def with_detect(cfg, **changes):
    """``cfg`` (a ModelConfig) with DetectConfig fields replaced."""
    return dataclasses.replace(cfg, detect=dataclasses.replace(cfg.detect, **changes))


def jax_variables(cfg, seed: int = 0, cls_predict_scale: float = 4.0):
    """Random flax variables for ``cfg`` as nested dicts of numpy arrays,
    without running flax's initialisers (only the shapes are traced).

    Kernels are normal with variance 1/fan_in, biases small, BatchNorm
    statistics and affine terms away from identity so the conversion of
    every leaf matters. The classification kernels that give the scores
    (RetinaNet's ``cls_head/predict``, SSD's ``cls_{i}``) are scaled up so
    scores spread away from the prior and detections separate. SSD's
    L2Norm scale is drawn around its working value of 20."""
    module = build_module(cfg)
    size = cfg.image_size
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        names = [p.key for p in path]
        shape, name = leaf.shape, names[-1]
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            w = rng.normal(0.0, np.sqrt(1.0 / fan_in), shape)
            if (names[-3:-1] == ["cls_head", "predict"]
                    or names[-2].startswith("cls_")):
                w = w * cls_predict_scale
        elif name == "bias" and names[0] == "params" and "bn" not in names[-2]:
            w = rng.normal(0.0, 0.01, shape)
        elif name == "scale" and names[-2] == "l2norm":
            w = rng.uniform(10.0, 30.0, shape)
        elif name == "scale":
            w = rng.uniform(0.5, 1.0, shape)
        elif name == "bias":  # BatchNorm shift
            w = rng.normal(0.0, 0.1, shape)
        elif name == "mean":
            w = rng.normal(0.0, 0.1, shape)
        elif name == "var":
            w = rng.uniform(0.5, 1.5, shape)
        else:
            raise KeyError(f"unexpected leaf {names}")
        return np.asarray(w, np.float32)

    variables = jax.tree_util.tree_map_with_path(make, shapes)
    return module, variables


def tiny_configs(family: str, model=None, **sections):
    """The same tiny ExperimentConfig from both packages: ``model`` replaces
    ModelConfig fields, each keyword a section's fields."""
    def make(lib):
        m = dataclasses.replace(lib.tiny_test_model(family), **(model or {}))
        return lib.ExperimentConfig(model=m, **{
            k: getattr(lib, f"{k.capitalize()}Config")(**v) for k, v in sections.items()})

    return make(jax_config), make(torch_config)


def gt_batch(seed, b, g, size, classes):
    """uint8 images and 1 to g valid GT boxes of mixed sizes per image."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 0.6, (b, g, 2))
    wh = np.exp(rng.uniform(np.log(0.05), np.log(0.4), (b, g, 2)))
    batch = {
        "images": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
        "boxes": np.clip(np.concatenate([xy, xy + wh], -1), 0, 1).astype(np.float32),
        "labels": rng.integers(1, classes + 1, (b, g)).astype(np.int32),
        "valid": np.arange(g)[None] < rng.integers(1, g + 1, (b, 1)),
    }
    batch["boxes"][~batch["valid"]] = 0.0
    return batch


def _iou(a, b):
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    inter = np.prod(np.clip(rb - lt, 0, None))
    union = np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter
    return inter / max(union, 1e-12)


def assert_matched(got, want, scales):
    """Every valid reference detection has its own counterpart: same label,
    box IoU >= 0.99, |score difference| <= 1e-3 (the reference's end-to-end
    bar). A box clipped to zero width or height has no IoU with anything;
    its corners must then agree within 1e-4 of the image's ``scale``.
    ``got`` / ``want``: lists of (boxes, scores, labels) per image."""
    assert len(got) == len(want) == len(scales)
    total = 0
    for (gb, gs, gl), (wb, ws, wl), scale in zip(got, want, scales):
        assert len(gs) == len(ws)
        free = list(range(len(gs)))
        for box, score, label in zip(wb, ws, wl):
            hit = next((j for j in free if gl[j] == label
                        and abs(gs[j] - score) <= 1e-3
                        and (_iou(gb[j], box) >= 0.99
                             or np.abs(gb[j] - box).max() <= 1e-4 * scale)),
                       None)
            assert hit is not None, (box, score, label)
            free.remove(hit)
        total += len(ws)
    assert total > 0


FOCAL_PRIOR = 0.01  # RetinaNet's classifier prior


def focal_weights(j_cfg, seed):
    """Weights of ``j_cfg.model`` from ``seed`` as a first step meets them
    (``jax_variables`` with the classifier at its initial scale and, in
    RetinaNet, the focal prior in its bias, as the packages initialise it),
    and the port's state dict of them."""
    _, variables = jax_variables(j_cfg.model, seed=seed, cls_predict_scale=1.0)
    if "cls_head" in variables["params"]:
        bias = variables["params"]["cls_head"]["predict"]["bias"]
        bias[...] = -np.log((1 - FOCAL_PRIOR) / FOCAL_PRIOR)
    return variables, state_dict_from_jax_variables(variables)


def jax_train_steps(case):
    """The JAX package's ``train_step`` on ``case["batches"]`` (the global
    batches), from ``case["variables"]`` under ``case["j_cfg"]``, eagerly:
    the metrics of each step and the state dict after the last. Under jit,
    XLA on the CPU changes the reference's matcher on padded GT rows (496
    qualities and 2 positives of one batch of ``test_torch_parallel.py``
    differ from its eager run, whose matches the port's equal bit for bit),
    and its loss then leaves its own eager value (loss_box by 2.3 %)."""
    from shape_based_object_detection_tpu import train as jax_train
    from shape_based_object_detection_tpu.ops.anchors import anchors_for_model

    j_cfg = case["j_cfg"]
    module = build_module(j_cfg.model)
    state = jax_train.create_train_state(module, case["variables"], j_cfg)
    step = jax_train.make_train_step(module, anchors_for_model(j_cfg.model), j_cfg,
                                     augment=False)
    metrics = []
    with jax.disable_jit():
        for batch in case["batches"]:
            state, m = step(state, dict(batch))
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state_dict_from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, **state.extra_vars}))


def port_model(cfg, variables):
    """The port's module for ``cfg`` on the CPU with the JAX variables
    loaded (strict), and its anchors."""
    module, anchors = build_model(cfg, device="cpu")
    module.load_state_dict(state_dict_from_jax_variables(variables), strict=True)
    return module, anchors


def nhwc_to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's tests: the tiny models run fastest
    on one, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_int8_files(folder, batch_size: int = 2):
    """Activation scales calibrated on the tiny RetinaNet (fresh weights from
    seed 0, score threshold 0) and a full-static int8 artifact of it at
    ``batch_size``, written to ``folder``: (scales path, artifact path)."""
    import os

    from shape_based_object_detection_torch import export, quantize

    cfg = torch_config.resolve_config("tiny_retinanet", ["model.detect.score_threshold=0.0"])
    module, _ = build_model(cfg.model, device="cpu")
    images = np.random.default_rng(9).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    scales = os.path.join(folder, "scales.json")
    quantize.save_activation_scales(
        scales, quantize.calibrate_activation_scales(module, [images], cfg.data))
    artifact = os.path.join(folder, "model.sbdx")
    export.save_artifact(export.export_from_config(
        cfg, batch_size=batch_size, quantize=True, int8_activations=True,
        activation_scales=scales, device="cpu"), artifact)
    return scales, artifact
