"""The port's detection path against the JAX package's: postprocess on the
same logits, and end-to-end detect / Predictor.predict on the tiny
RetinaNet with the same weights."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu import detection as jax_det
from shape_based_object_detection_tpu import serving as jax_serving
from shape_based_object_detection_tpu.ops import anchors as jax_anchors
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch import detection as torch_det
from shape_based_object_detection_torch.serving import Predictor
from shape_based_object_detection_torch.utils.convert import (
    state_dict_from_jax_variables,
)
from tests.torch_parity import assert_matched, jax_variables, port_model, with_detect


@pytest.mark.parametrize("batch,sigmoid", [(1, True), (4, True), (2, False)])
def test_postprocess_same_logits(batch, sigmoid):
    """Same numpy logits and offsets into both postprocess functions (plain
    NMS on the port's side): labels and valid equal, boxes and scores
    within 1e-6 (exp and sigmoid may differ in the last bit). Batch 1 takes
    the flat top-k, batch 4 the two-stage one; sigmoid=False is the softmax
    branch."""
    jcfg = with_detect(jax_config.tiny_test_model("retinanet"), use_sigmoid=sigmoid,
                       pre_nms_top_k=300, max_detections=50)
    tcfg = with_detect(torch_config.tiny_test_model("retinanet"), use_sigmoid=sigmoid,
                       pre_nms_top_k=300, max_detections=50)
    anchors = np.asarray(jax_anchors.anchors_for_model(jcfg))
    rng = np.random.default_rng(batch)
    a, k = anchors.shape[0], jcfg.num_classes
    logits = rng.normal(-2.0, 2.0, (batch, a, k)).astype(np.float32)
    logits[:, 100:140] = logits[:, 50:51]  # tied anchors
    offsets = rng.normal(0.0, 0.3, (batch, a, 4)).astype(np.float32)

    want = jax_det.postprocess(jnp.asarray(logits), jnp.asarray(offsets),
                               jnp.asarray(anchors), jcfg, use_pallas=False)
    got = torch_det.postprocess(torch.from_numpy(logits), torch.from_numpy(offsets),
                                torch.from_numpy(anchors.copy()), tcfg)
    assert got.valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-6)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_config.get_config("tiny_retinanet")
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data,
                                                              decode_backend="pil"))
    tcfg = torch_config.get_config("tiny_retinanet")
    module, variables = jax_variables(jcfg.model, seed=1)
    return jcfg, tcfg, module, variables


def test_detect_end_to_end(tiny):
    jcfg, tcfg, module, variables = tiny
    anchors = jax_anchors.anchors_for_model(jcfg.model)
    jax_detect = jax_det.make_detect_fn(module, anchors, jcfg.model, jcfg.data,
                                        use_pallas=False)
    port, port_anchors = port_model(tcfg.model, variables)
    detect = torch_det.make_detect_fn(port, port_anchors, tcfg.model, tcfg.data,
                                      device="cpu")
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    want = jax_detect(variables, jnp.asarray(images))
    got = detect(images)

    def lists(det):
        out = []
        for i in range(images.shape[0]):
            v = np.asarray(det.valid[i])
            out.append(tuple(np.asarray(t[i])[v] for t in (det.boxes, det.scores,
                                                          det.labels)))
        return out

    assert_matched(lists(got), lists(want), [1.0] * images.shape[0])


def test_predictor_end_to_end(tiny, monkeypatch):
    """Requests of mixed sizes and counts through both Predictors. The JAX
    Predictor's own build_model runs flax's initialisers (tens of seconds
    on the CPU); it is given the same module without them, and the
    variables are passed in."""
    jcfg, tcfg, module, variables = tiny

    def fast_build(model_cfg):
        return module, None, jax_anchors.anchors_for_model(model_cfg)

    monkeypatch.setattr(jax_serving, "build_model", fast_build)
    jax_pred = jax_serving.Predictor(jcfg, variables, batch_size=4)
    port = Predictor(tcfg, state_dict_from_jax_variables(variables), batch_size=4,
                     device="cpu")
    rng = np.random.default_rng(9)
    shapes = [(100, 150), (128, 128), (64, 200), (90, 90), (200, 120)]
    images = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes]
    pre = (rng.integers(0, 256, (128, 128, 3), dtype=np.uint8), (256, 300))
    for request in (images, images[:1], [pre] + images[:2]):
        got = port.predict(request)
        want = jax_pred.predict(request)
        assert_matched([(d.boxes, d.scores, d.labels) for d in got],
                       [(d.boxes, d.scores, d.labels) for d in want],
                       [max(_size(item)) for item in request])


def _size(item):
    return item[1] if isinstance(item, tuple) else item.shape[:2]
