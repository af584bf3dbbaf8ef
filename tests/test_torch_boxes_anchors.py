"""The port's anchors and box ops against the JAX package's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu.ops import anchors as jax_anchors
from shape_based_object_detection_tpu.ops import boxes as jax_boxes
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch.ops import anchors as torch_anchors
from shape_based_object_detection_torch.ops import boxes as torch_boxes


@pytest.mark.parametrize("name,rows", [
    ("ssd300", 8732), ("ssd512", 24564), ("retinanet_r50_fpn", 49104),
    ("retinanet_r101_fpn", 76725),
])
def test_anchors_equal(name, rows):
    """Exact (atol 0): both packages run the same numpy arithmetic."""
    want = np.asarray(jax_anchors.anchors_for_model(jax_config.get_config(name).model))
    got = torch_anchors.anchors_for_model(torch_config.get_config(name).model)
    assert got.dtype == torch.float32 and got.shape == (rows, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_anchors_at_other_sizes_equal():
    for size in (100, 300, 600):
        cfg = torch_config.dataclasses.replace(
            torch_config.RETINANET_R50_512, image_size=size)
        jcfg = jax_config.dataclasses.replace(
            jax_config.RETINANET_R50_512, image_size=size)
        np.testing.assert_array_equal(
            torch_anchors.anchors_for_model(cfg).numpy(),
            np.asarray(jax_anchors.anchors_for_model(jcfg)))
    assert torch_anchors.ssd_feature_sizes(600) == jax_anchors.ssd_feature_sizes(600)


def _random_boxes(rng, shape):
    cxcy = rng.uniform(-0.1, 1.1, shape + (2,))
    wh = rng.uniform(0.0, 0.6, shape + (2,))
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


@pytest.mark.parametrize("variances", [(1.0, 1.0), (0.1, 0.2)])
def test_decode_clip_convert_agree(rng, variances):
    """Within 1e-6: the same float ops in the same order; exp may differ in
    its last bit between the two libraries."""
    anchors = _random_boxes(rng, (64,))
    offsets = rng.normal(0.0, 1.0, (3, 64, 4)).astype(np.float32)
    want = jax_boxes.decode_boxes(jnp.asarray(offsets), jnp.asarray(anchors), variances)
    got = torch_boxes.decode_boxes(torch.from_numpy(offsets), torch.from_numpy(anchors),
                                   variances)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    xyxy_want = jax_boxes.cxcywh_to_xyxy(want)
    xyxy_got = torch_boxes.cxcywh_to_xyxy(torch.from_numpy(np.array(want)))
    np.testing.assert_allclose(xyxy_got.numpy(), np.asarray(xyxy_want), atol=1e-6)
    np.testing.assert_allclose(
        torch_boxes.clip_boxes(xyxy_got).numpy(),
        np.asarray(jax_boxes.clip_boxes(xyxy_want)), atol=1e-6)
    np.testing.assert_allclose(
        torch_boxes.xyxy_to_cxcywh(xyxy_got).numpy(),
        np.asarray(jax_boxes.xyxy_to_cxcywh(xyxy_want)), atol=1e-6)
    np.testing.assert_allclose(
        torch_boxes.box_area(xyxy_got).numpy(),
        np.asarray(jax_boxes.box_area(xyxy_want)), atol=1e-6)
