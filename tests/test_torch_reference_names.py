"""The JAX package's small public helpers under their own names in the port,
against the JAX functions: ``RetinaNet.feature_sizes``,
``SSD.feature_sizes``, ``ops/nms.nms_mask``,
``ops/nms.select_top_candidates`` and
``utils/image.boxes_norm_to_original_px``."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu.models.factory import build_module as jax_build_module
from shape_based_object_detection_tpu.ops import nms as jax_nms
from shape_based_object_detection_tpu.utils import image as jax_image
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch.models.factory import build_module
from shape_based_object_detection_torch.ops import nms as torch_nms
from shape_based_object_detection_torch.utils import image as torch_image


@pytest.mark.parametrize("name,size", [("retinanet_r50_fpn", 128),
                                       ("retinanet_r101_fpn", 1024),
                                       ("retinanet_r50_fpn", 100), ("ssd300", 300),
                                       ("ssd512", 512)])
def test_feature_sizes_equal(name, size):
    jcfg = dataclasses.replace(jax_config.get_config(name).model, image_size=size)
    tcfg = dataclasses.replace(torch_config.get_config(name).model, image_size=size)
    with torch.device("meta"):
        port = build_module(tcfg)
    assert port.feature_sizes() == tuple(jax_build_module(jcfg).feature_sizes())


def _boxes(rng, n):
    cxcy = rng.uniform(0.0, 1.0, (n, 2))
    wh = rng.uniform(0.05, 0.5, (n, 2))
    return np.clip(np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1), 0, 1).astype(np.float32)


@pytest.mark.parametrize("seed,with_valid", [(0, False), (1, True), (2, True)])
def test_nms_mask_equals_jax(seed, with_valid):
    """The keep mask bit-equal, ties and padding rows included."""
    rng = np.random.default_rng(seed)
    n = 64
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[10:20] = scores[3]
    valid = rng.uniform(size=n) > 0.2 if with_valid else None
    want = jax_nms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                            None if valid is None else jnp.asarray(valid))
    got = torch_nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                             None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.bool and got.any() and not got.all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("two_stage,activation", [(True, "sigmoid"), (False, None),
                                                  (None, "sigmoid")])
def test_select_top_candidates_equals_jax(two_stage, activation):
    """Boxes, classes and valid equal; scores within 1e-6 (sigmoid may
    differ in its last bit)."""
    rng = np.random.default_rng(4)
    a, c, k = 300, 5, 40
    boxes = _boxes(rng, a)
    scores = rng.normal(0.0, 2.0, (a, c)).astype(np.float32)
    # about the k-th score of the 1500 pairs: some winners fall below it
    threshold = float(1 / (1 + np.exp(-4.0))) if activation else 4.0
    want = jax_nms.select_top_candidates(
        jnp.asarray(boxes), jnp.asarray(scores), threshold, k,
        activation=jax.nn.sigmoid if activation else None, two_stage=two_stage)
    got = torch_nms.select_top_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores), threshold, k,
        activation=torch.sigmoid if activation else None, two_stage=two_stage)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].any() and not got[3].all()


@pytest.mark.parametrize("letterbox", [False, True])
def test_boxes_norm_to_original_px_equals_jax(letterbox):
    """Bit-equal: the same float32 products and clips."""
    rng = np.random.default_rng(5)
    boxes = rng.uniform(-0.2, 1.3, (3, 7, 4)).astype(np.float32)
    want = jax_image.boxes_norm_to_original_px(boxes, 375, 500, letterbox)
    got = torch_image.boxes_norm_to_original_px(boxes, 375, 500, letterbox)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
