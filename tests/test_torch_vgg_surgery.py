"""The port's VGG-16 fc6/fc7 -> conv6/conv7 surgery against the JAX
package's ``utils/vgg_surgery.py``, on synthetic torchvision-layout
checkpoints (no pretrained file is in the repository)."""

import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu.utils import vgg_surgery as ref
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch.utils import vgg_surgery
from shape_based_object_detection_torch.utils.convert import (
    state_dict_from_jax_variables,
)
from tests.torch_kernel_cases import torchvision_vgg16
from tests.torch_parity import jax_variables, port_model


@pytest.mark.parametrize("steps", [[2, None], [None, 3], [4, 3], [1, 1]])
def test_decimate_equals_reference(steps):
    a = np.random.default_rng(0).normal(size=(10, 7)).astype(np.float32)
    np.testing.assert_array_equal(vgg_surgery.decimate(a, steps), ref.decimate(a, steps))


def test_fc_to_convs_equals_reference():
    """HWIO kernels and biases equal to the reference's, to the bit, at the
    real fc7 width and a quarter of fc6's input channels."""
    rng = np.random.default_rng(1)
    args = (rng.normal(size=(4096, 128 * 49)).astype(np.float32),
            rng.normal(size=4096).astype(np.float32),
            rng.normal(size=(4096, 4096)).astype(np.float32),
            rng.normal(size=4096).astype(np.float32))
    got, want = vgg_surgery.vgg_fc_to_ssd_convs(*args), ref.vgg_fc_to_ssd_convs(*args)
    assert got["conv6"][0].shape == (3, 3, 128, 1024)
    assert got["conv7"][0].shape == (1, 1, 1024, 1024)
    for name in ("conv6", "conv7"):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)


def test_load_equals_reference():
    """A torchvision dict at the tiny SSD's widths merged into the port's
    state dict equals the reference's merge into its flax variables,
    converted; the result loads strictly and every layer without a source
    keeps its value."""
    _, variables = jax_variables(jax_config.tiny_test_model("ssd"), seed=3)
    port, _ = port_model(torch_config.tiny_test_model("ssd"), variables)
    sd = torchvision_vgg16(np.random.default_rng(4), width=64, fc=512)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = vgg_surgery.load_pretrained_vgg(sd, port.state_dict())
    want = state_dict_from_jax_variables(ref.load_pretrained_vgg_into_flax(sd, variables))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    port.load_state_dict(got, strict=True)
    torch.testing.assert_close(port.vgg.conv1_1.weight.detach(), sd["features.0.weight"],
                               rtol=0, atol=0)
    for key in before:
        moved = not torch.equal(before[key], got[key])
        assert moved == key.startswith("vgg."), key


def test_features_only_checkpoint_raises():
    """No classifier.* keys: fail loud instead of leaving conv6/conv7 at
    their random initialisation; a checkpoint of other widths fails too."""
    _, variables = jax_variables(jax_config.tiny_test_model("ssd"))
    port, _ = port_model(torch_config.tiny_test_model("ssd"), variables)
    sd = torchvision_vgg16(np.random.default_rng(5), width=64, fc=512)
    features = {k: v for k, v in sd.items() if k.startswith("features.")}
    with pytest.raises(ValueError, match="classifier"):
        vgg_surgery.load_pretrained_vgg(features, port.state_dict())
    with pytest.raises(ValueError, match="classifier"):
        ref.load_pretrained_vgg_into_flax(features, variables)
    wide = torchvision_vgg16(np.random.default_rng(6), width=128, fc=512)
    with pytest.raises(ValueError, match="shape"):
        vgg_surgery.load_pretrained_vgg(wide, port.state_dict())
