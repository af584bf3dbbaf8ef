"""Forward parity of the port's RetinaNet with the JAX package's, on the
tiny preset with the same weights (converted by the port's
state_dict_from_jax_variables, loaded strictly)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.models.retinanet import PRIOR_PROB
from tests.torch_parity import jax_variables, nhwc_to_torch, port_model


@pytest.fixture(scope="module")
def models():
    module, variables = jax_variables(jax_config.tiny_test_model("retinanet"))
    port, _ = port_model(torch_config.tiny_test_model("retinanet"), variables)
    return module, variables, port


@pytest.mark.parametrize("size", [128, 100])
def test_forward_parity(models, size):
    """atol 2e-4, rtol 1e-3 (the reference's parity bar), float32 with
    precision "highest" on both sides. 100 px makes the FPN's top-down
    upsample ragged (C5 4x4 -> C4 7x7), the half-pixel nearest path."""
    module, variables, port = models
    rng = np.random.default_rng(size)
    img = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    cls_j, box_j = module.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        cls_t, box_t = port(nhwc_to_torch(img))
    assert cls_t.dtype == torch.float32 and box_t.dtype == torch.float32
    assert cls_t.shape == cls_j.shape and box_t.shape == box_j.shape
    np.testing.assert_allclose(cls_t.numpy(), np.asarray(cls_j), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(box_t.numpy(), np.asarray(box_j), atol=2e-4, rtol=1e-3)


def test_fresh_model_init():
    """The port's own initialisation: the classification prior, zero box
    bias, identity BatchNorm, the heads' normal(0.01) and the lecun-normal
    scale elsewhere; the same generator seed gives the same weights."""
    cfg = torch_config.tiny_test_model("retinanet")
    module, anchors = build_model(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    again, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, a), b in zip(module.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    prior = -np.log((1 - PRIOR_PROB) / PRIOR_PROB)
    np.testing.assert_allclose(module.cls_head.predict.bias.detach().numpy(), prior, rtol=1e-6)
    assert not module.box_head.predict.bias.any()
    assert torch.equal(module.backbone.bn1.weight, torch.ones(8))
    assert abs(module.cls_head.conv_0.weight.std().item() - 0.01) < 1e-3
    w = module.backbone.layer4_0.conv2.weight
    assert abs(w.std().item() * np.sqrt(w[0].numel()) - 1.0) < 0.05
    with torch.no_grad():
        cls_logits, box_offsets = module(torch.zeros(1, 3, 128, 128))
    assert cls_logits.shape == (1, anchors.shape[0], cfg.num_classes)
    assert box_offsets.shape == (1, anchors.shape[0], 4)
