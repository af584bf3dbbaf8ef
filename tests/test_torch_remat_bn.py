"""Remat and trainable BatchNorm in the port's train step, against the JAX
package's: gradients with the model's remat segments and with the whole
forward checkpointed (``train.remat``) equal those without, and the JAX
package's with its ``nn.remat`` segments; BatchNorm's running statistics
after one and two steps equal the JAX step's ``batch_stats``, updated once
per step with remat on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import train as jax_train
from shape_based_object_detection_tpu.ops.anchors import anchors_for_model
from shape_based_object_detection_torch import train
from shape_based_object_detection_torch.utils.convert import (
    state_dict_from_jax_variables,
)
from tests.torch_parity import gt_batch, jax_variables, port_model, tiny_configs


def _port_grads(cfg, variables, batch, remat=False, train_remat=False):
    """The port's loss, metrics and gradients (by name) of one loss_fn call,
    and the module, with ``model.remat`` / ``train.remat`` as given."""
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=remat),
        train=dataclasses.replace(cfg.train, remat=train_remat))
    module, anchors = port_model(cfg.model, variables)
    loss_fn = train.make_loss_fn(module, anchors, cfg)
    images = torch.from_numpy(batch["images"]).float().permute(0, 3, 1, 2) / 255.0
    loss, metrics = loss_fn(images, *(torch.from_numpy(batch[k])
                                      for k in ("boxes", "labels", "valid")))
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in module.named_parameters()}, module


@pytest.mark.parametrize("family", ["retinanet", "ssd"])
def test_remat_gradients_match(family):
    """Loss and gradients with ``model.remat`` (the model's own segments)
    and with ``train.remat`` alone (the whole forward) equal those without
    remat, and the JAX package's with its ``nn.remat`` segments (1e-5
    relative on the loss, gradients within 1e-4 of their largest entry)."""
    kind = "multibox" if family == "ssd" else "focal"
    j_cfg, t_cfg = tiny_configs(
        family, match=dict(pos_threshold=0.5, neg_threshold=0.4, allow_low_quality=True),
        loss=dict(kind=kind))
    size, classes = j_cfg.model.image_size, j_cfg.model.num_classes
    _, variables = jax_variables(j_cfg.model, seed=8)
    batch = gt_batch(9, 2, 4, size, classes)
    loss, grads, _ = _port_grads(t_cfg, variables, batch)
    for kw in (dict(remat=True), dict(train_remat=True)):
        loss_r, grads_r, _ = _port_grads(t_cfg, variables, batch, **kw)
        assert loss_r == loss, kw
        for name, g in grads.items():
            torch.testing.assert_close(grads_r[name], g, rtol=1e-6, atol=1e-9,
                                       msg=f"{name} {kw}")

    remat_model = dataclasses.replace(j_cfg.model, remat=True)
    module, _ = jax_variables(remat_model, seed=8)
    j_loss_fn = jax_train.make_loss_fn(module, anchors_for_model(remat_model),
                                       dataclasses.replace(j_cfg, model=remat_model))
    images = jnp.asarray(batch["images"], jnp.float32) / 255.0
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True))(
        variables["params"], {k: v for k, v in variables.items() if k != "params"}, images,
        *(jnp.asarray(batch[k]) for k in ("boxes", "labels", "valid")))
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    want = state_dict_from_jax_variables(
        jax.tree_util.tree_map(np.asarray, {"params": j_grads}))
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def _batch_stats(module):
    return {n: b.clone() for n, b in module.named_buffers()}


def test_train_bn_running_stats_match_jax():
    """Trainable BatchNorm (flax's momentum 0.9, biased batch variance) on
    the tiny RetinaNet: after one and two steps the running statistics
    equal the JAX step's ``batch_stats``, with ``model.remat`` on and off;
    remat leaves them updated exactly once per step (equal, to the bit, to
    the statistics without it), and the losses agree to 1e-5. The bound on
    the statistics, 1e-4, is set by layer4's 4 x 4 maps: 32 samples per
    channel, where the two packages' float32 sums, taken in other orders
    through the whole backbone, part beyond 1e-5."""
    j_cfg, t_cfg = tiny_configs(
        "retinanet", model=dict(train_bn=True), data=dict(batch_size=2, max_boxes=4),
        train=dict(base_lr=0.05, warmup_steps=1, weight_decay=0.0, lr_decay_steps=(100,)),
        match=dict(pos_threshold=0.5, neg_threshold=0.4, allow_low_quality=True),
        loss=dict(kind="focal"))
    module, variables = jax_variables(j_cfg.model, seed=10)
    batch = gt_batch(11, 2, 4, j_cfg.model.image_size, j_cfg.model.num_classes)
    j_state = jax_train.create_train_state(module, variables, j_cfg)
    j_step = jax_train.make_train_step(module, anchors_for_model(j_cfg.model), j_cfg,
                                       augment=False)
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(t_cfg, model=dataclasses.replace(t_cfg.model, remat=remat))
        port, anchors = port_model(cfg.model, variables)
        state = train.create_train_state(port, cfg, device="cpu")
        step = train.make_train_step(port, anchors, cfg, augment=False, device="cpu")
        runs[remat] = (port, state, step)
    start = _batch_stats(runs[False][0])
    for i in range(2):
        j_state, j_metrics = j_step(j_state, dict(batch))
        want = state_dict_from_jax_variables(
            jax.tree_util.tree_map(np.asarray, {"batch_stats": j_state.extra_vars["batch_stats"]}))
        got = {}
        for remat, (port, state, step) in runs.items():
            _, metrics = step(state, batch)
            np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                                       rtol=1e-5, err_msg=f"step {i}, remat {remat}")
            got[remat] = _batch_stats(port)
            assert set(got[remat]) == set(want)
            for name, w in want.items():
                np.testing.assert_allclose(got[remat][name].numpy(), w.numpy(), rtol=1e-4,
                                           atol=1e-4, err_msg=f"{name} step {i} remat {remat}")
        for name in want:
            assert torch.equal(got[True][name], got[False][name]), name
    assert any(not torch.equal(start[n], got[False][n]) for n in start)
    # detect and eval read the running statistics: no batch statistics there
    port = runs[False][0]
    x = torch.rand(2, 3, 128, 128)
    with torch.no_grad():
        a, b = port(x), port(x[:1])
    torch.testing.assert_close(a[0][:1], b[0], rtol=1e-5, atol=1e-5)
