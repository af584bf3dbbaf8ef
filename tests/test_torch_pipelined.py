"""The pipelined train step (``train.make_train_step_pipelined``).

- Within the port: prime + 3 steps give the losses of the plain step on the
  same batches and the same generator, the same parameters, and leave the
  generator where 4 plain steps leave it (the augmentation draws in the
  plain step's order); the carry is the plain augmentation of its batch.
- Against the JAX package: fed a carry of un-augmented, normalized images,
  one ``step`` gives the loss, metrics and updated parameters of the JAX
  ``make_train_step(..., augment=False)`` on the same batch, to 2e-5 (JAX's
  rng and PyTorch's generator draw different numbers, so augmented carries
  are compared only within the port).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import train as jax_train
from shape_based_object_detection_tpu.ops.anchors import anchors_for_model
from shape_based_object_detection_torch import config, train
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.utils import image as image_lib
from shape_based_object_detection_torch.utils.convert import (
    state_dict_from_jax_variables,
)
from tests.torch_parity import gt_batch, jax_variables, port_model, tiny_configs
from tests.torch_parity import one_torch_thread  # noqa: F401

KEYS = ("loss", "loss_cls", "loss_box", "num_pos", "grad_norm")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _run(cfg, batches, pipelined):
    module, anchors = build_model(cfg.model, device="cpu", train=True,
                                  generator=torch.Generator().manual_seed(3))
    state = train.create_train_state(module, cfg, device="cpu")
    metrics = []
    if pipelined:
        prime, step = train.make_train_step_pipelined(module, anchors, cfg, device="cpu")
        state, carry = prime(state, batches[0])
        for nxt in batches[1:]:
            state, carry, m = step(state, carry, nxt)
            metrics.append(m)
        return module, state, metrics, (step, carry)
    step = train.make_train_step(module, anchors, cfg, device="cpu")
    for b in batches:
        state, m = step(state, b)
        metrics.append(m)
    return module, state, metrics, None


@pytest.mark.parametrize("family", ["retinanet", "ssd"])
def test_pipelined_losses_equal_plain(family):
    cfg = config.get_config(f"tiny_{family}")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, warmup_steps=1),
                              data=dataclasses.replace(cfg.data, max_boxes=5))
    size = cfg.model.image_size
    batches = [gt_batch(10 + i, 2, 5, size, cfg.model.num_classes) for i in range(4)]
    p_mod, p_state, p_metrics, (step, carry) = _run(cfg, batches, pipelined=True)
    q_mod, q_state, q_metrics, _ = _run(cfg, batches, pipelined=False)
    assert len(p_metrics) == 3
    for i, (a, b) in enumerate(zip(p_metrics, q_metrics)):
        for k in KEYS:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-6, atol=0,
                                       err_msg=f"{k} at step {i}")
    # prime + 3 steps drew 4 augmentations, as 4 plain steps did
    assert torch.equal(p_state.generator.get_state(), q_state.generator.get_state())
    assert p_state.step == 3 and q_state.step == 4
    # the carry is batch 3 augmented by the draws the plain step 4 used:
    # one more step on it gives the plain step 4's loss
    _, _, last = step(p_state, carry, batches[0])
    np.testing.assert_allclose(float(last["loss"]), float(q_metrics[3]["loss"]), rtol=1e-6)
    for (name, a), b in zip(p_mod.named_parameters(), q_mod.parameters()):
        assert torch.equal(a, b), name


def test_pipelined_step_matches_jax_on_a_normalized_carry():
    j_cfg, t_cfg = tiny_configs(
        "retinanet", data=dict(batch_size=2, max_boxes=4),
        train=dict(base_lr=0.05, warmup_steps=1, weight_decay=1e-2, grad_clip_norm=0.5,
                   lr_decay_steps=(100,)),
        match=dict(pos_threshold=0.5, neg_threshold=0.4, allow_low_quality=True),
        loss=dict(kind="focal"))
    module, variables = jax_variables(j_cfg.model, seed=8)
    batch = gt_batch(9, 2, 4, j_cfg.model.image_size, j_cfg.model.num_classes)
    j_state = jax_train.create_train_state(module, variables, j_cfg)
    j_step = jax_train.make_train_step(module, anchors_for_model(j_cfg.model), j_cfg,
                                       augment=False)
    port, t_anchors = port_model(t_cfg.model, variables)
    t_state = train.create_train_state(port, t_cfg, device="cpu")
    _, t_step = train.make_train_step_pipelined(port, t_anchors, t_cfg, device="cpu")
    for i in range(2):  # step 1 at warmup lr 0, step 2 moves the parameters
        j_state, j_metrics = j_step(j_state, dict(batch))
        images = image_lib.normalize_images(torch.from_numpy(batch["images"]),
                                            t_cfg.data.mean, t_cfg.data.std)
        carry = (images, *(torch.from_numpy(batch[k]) for k in ("boxes", "labels", "valid")))
        t_state, _, t_metrics = t_step(t_state, carry, batch)
        for key in KEYS:
            np.testing.assert_allclose(float(t_metrics[key]), float(j_metrics[key]),
                                       rtol=2e-5, err_msg=f"{key} at step {i}")
    want = state_dict_from_jax_variables(
        jax.tree_util.tree_map(np.asarray, {"params": j_state.params}))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
