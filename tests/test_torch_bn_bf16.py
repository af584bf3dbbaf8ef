"""Frozen BatchNorm in bf16 against flax's ``nn.BatchNorm(use_running_average=
True, dtype=bfloat16)``, alone and inside the tiny RetinaNet's bf16 forward.

flax computes ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32
(the float32 statistics promote a bf16 x) and rounds to bf16 once; the
port's frozen branch does the same, so the layer alone is bit-equal. Inside
the whole bf16 network the two sides' convolutions still round their own
sums (oneDNN and XLA add in other orders, and the heads add their bias
before rounding in PyTorch, after it in flax), so the network is held to
bounds measured for this arithmetic: a frozen BatchNorm that rounded its
scale and shift to bf16 first breaks them (about half of C3's elements
differ then, and the mean |error| of the logits grows by about 40 %)."""

import dataclasses

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch.models.resnet import BatchNorm
from tests.torch_parity import jax_variables, nhwc_to_torch, port_model


def _layer(rng, c):
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.normal(0.0, 0.1, c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0.0, 0.5, c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)},
    }
    bn = BatchNorm(c)
    with torch.no_grad():
        for name, arr in (("weight", variables["params"]["scale"]),
                          ("bias", variables["params"]["bias"]),
                          ("running_mean", variables["batch_stats"]["mean"]),
                          ("running_var", variables["batch_stats"]["var"])):
            getattr(bn, name).copy_(torch.from_numpy(arr))
    return variables, bn


@pytest.mark.parametrize("c,scale", [(64, 3.0), (8, 0.05), (256, 40.0)])
def test_frozen_batchnorm_bf16_bit_equal_to_flax(c, scale):
    rng = np.random.default_rng(c)
    variables, bn = _layer(rng, c)
    x = jnp.asarray(rng.normal(0.0, scale, (2, 9, 7, c)), jnp.bfloat16)
    want = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5,
                        dtype=jnp.bfloat16).apply(variables, x)
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got = bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_frozen_batchnorm_float32_matches_flax():
    """float32 keeps flax's order too: within 4 float32 ulps of flax's output
    (XLA's rsqrt and PyTorch's differ in their last bits)."""
    rng = np.random.default_rng(1)
    variables, bn = _layer(rng, 32)
    x = rng.normal(0.0, 3.0, (2, 5, 5, 32)).astype(np.float32)
    want = np.asarray(nn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=4 * 2 ** -23, atol=1e-7)


def _bf16_models(seed):
    j_cfg = dataclasses.replace(jax_config.tiny_test_model("retinanet"), dtype="bfloat16")
    t_cfg = dataclasses.replace(torch_config.tiny_test_model("retinanet"), dtype="bfloat16")
    module, variables = jax_variables(j_cfg, seed=seed)
    port, _ = port_model(t_cfg, variables)
    return module, variables, port


@pytest.mark.parametrize("size,seed", [(128, 1), (128, 2), (100, 3)])
def test_bf16_backbone_close_to_jax(size, seed):
    """C3-C5 of the bf16 backbone: at most 10 % of C3's elements differ
    from JAX's (a bf16-rounded scale and shift: about 50 %), and none by
    more than 0.03 (a few bf16 ulps at the features' scale of ~2)."""
    module, variables, port = _bf16_models(seed)
    img = np.random.default_rng(seed).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    _, inter = module.apply(variables, jnp.asarray(img), mutable=["intermediates"],
                            capture_intermediates=lambda m, _: m.name == "backbone")
    want = [np.asarray(f, np.float32) for f in inter["intermediates"]["backbone"]["__call__"][0]]
    with torch.no_grad():
        got = port.backbone(nhwc_to_torch(img).to(torch.bfloat16))
    got = [g.float().permute(0, 2, 3, 1).numpy() for g in got]
    for level, (g, w) in enumerate(zip(got, want), 3):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 0.03, f"C{level}"
    assert (got[0] != want[0]).mean() <= 0.10


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_forward_close_to_jax(seed):
    """The whole bf16 forward at 128 px: mean |error| of the logits <= 0.0105
    and of the box offsets <= 0.0027 (a bf16-rounded scale and shift gives
    0.0115-0.0129 and 0.0029-0.0033 on these weights)."""
    module, variables, port = _bf16_models(seed)
    img = np.random.default_rng(seed).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    cls_j, box_j = (np.asarray(a, np.float32) for a in module.apply(variables, jnp.asarray(img)))
    with torch.no_grad():
        cls_t, box_t = (a.numpy() for a in port(nhwc_to_torch(img)))
    assert np.isfinite(cls_t).all() and np.isfinite(box_t).all()
    assert np.abs(cls_t - cls_j).mean() <= 0.0105
    assert np.abs(box_t - box_j).mean() <= 0.0027
