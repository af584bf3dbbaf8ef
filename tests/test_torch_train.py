"""The port's training step against the JAX package's (``train.py``).

- the learning-rate schedule and the weight-decay mask;
- the optimizer alone (SGD with weight decay, clipping and a bf16
  momentum; AdamW; gradient accumulation) against the optax chain of
  ``make_optimizer`` on the same parameters and gradients;
- three train steps of the tiny RetinaNet (augment off, weight decay and
  clipping engaged) against ``make_train_step``, the same weights on both
  sides, compared through ``state_dict_from_jax_variables``;
- EMA and gradient accumulation of the port's own step;
- three train steps of the tiny SSD with config #3's multibox loss and
  shape matching against ``make_train_step``.

Tolerances (float32, precision "highest"): losses, metrics and the
optimizer's outputs to 1e-5 relative; the parameters after three steps to
2e-5 absolute (gradients summed in another order, three updates of lr up
to 0.05)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu import train as jax_train
from shape_based_object_detection_tpu.ops.anchors import anchors_for_model
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch import train
from shape_based_object_detection_torch.utils.convert import (
    state_dict_from_jax_variables,
)
from tests.torch_parity import gt_batch, jax_variables, port_model, tiny_configs


def _both(section: str, **kw):
    """The same dataclass from both packages' config modules."""
    return (getattr(jax_config, section)(**kw), getattr(torch_config, section)(**kw))


@pytest.mark.parametrize("warmup,decay,steps", [
    (10, (100, 200), (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 150, 199, 200, 250)),
    (500, (60_000, 80_000), (0, 1, 250, 499, 500, 59_999, 60_000, 80_000, 90_000)),
    (0, (3,), (0, 1, 2, 3, 4)),
])
def test_lr_schedule_matches_optax(warmup, decay, steps):
    j, t = _both("TrainConfig", base_lr=0.01, warmup_steps=warmup,
                 lr_decay_steps=decay, lr_decay_factor=0.1)
    want, got = jax_train.make_lr_schedule(j), train.make_lr_schedule(t)
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-7, atol=0,
                                   err_msg=f"step {s}")
    assert got(0) == 0.0


def test_lr_decay_at_or_before_warmup_raises():
    with pytest.raises(ValueError, match="GLOBAL"):
        train.make_lr_schedule(torch_config.TrainConfig(warmup_steps=10,
                                                        lr_decay_steps=(10,)))


def _flax_name(path) -> str:
    names = {"kernel": "weight", "bias": "bias", "scale": "weight"}
    keys = [p.key for p in path]
    return ".".join(keys[:-1] + [names[keys[-1]]])


def test_decay_mask_matches_jax():
    _, variables = jax_variables(jax_config.tiny_test_model("retinanet"))
    module, _ = port_model(torch_config.tiny_test_model("retinanet"), variables)
    want = {_flax_name(p): bool(v) for p, v in jax.tree_util.tree_leaves_with_path(
        jax_train.decay_mask(variables["params"]))}
    got = train.decay_mask(module)
    assert got == want
    assert any(got.values()) and not all(got.values())


def _param_tree(seed):
    """A small flax-like parameter tree and the port's (name, tensor) list
    of the same values (conv kernels transposed to OIHW)."""
    rng = np.random.default_rng(seed)
    tree = {
        "conv": {"kernel": rng.normal(0, 1, (3, 3, 2, 4)), "bias": rng.normal(0, 1, (4,))},
        "bn": {"scale": rng.uniform(0.5, 1, (4,)), "bias": rng.normal(0, 1, (4,))},
        "head": {"kernel": rng.normal(0, 1, (1, 1, 4, 3))},
    }
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)

    def port(t):
        flat = jax.tree_util.tree_leaves_with_path(t)
        return [(_flax_name(p), torch.from_numpy(np.array(
            np.asarray(v).transpose(3, 2, 0, 1) if np.ndim(v) == 4 else v)))
            for p, v in flat]

    return tree, port


@pytest.mark.parametrize("kw", [
    dict(optimizer="sgd", weight_decay=0.05, grad_clip_norm=2.0),
    dict(optimizer="sgd", weight_decay=0.05, grad_clip_norm=1e9, momentum_dtype="bfloat16"),
    dict(optimizer="adamw", weight_decay=0.05, grad_clip_norm=2.0),
    dict(optimizer="sgd", weight_decay=0.0, grad_clip_norm=2.0, grad_accum_steps=2),
])
def test_optimizer_matches_optax(kw):
    j_cfg, t_cfg = _both("TrainConfig", base_lr=0.1, warmup_steps=2,
                         lr_decay_steps=(5,), **kw)
    tree, port = _param_tree(0)
    tx = jax_train.make_optimizer(j_cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = tx.init(j_params)
    names = [n for n, _ in port(tree)]
    t_params = [p.clone() for _, p in port(tree)]
    opt = train.make_optimizer(t_cfg)
    t_state = opt.init(t_params)
    mask = [n.endswith("weight") and p.dim() >= 2 for n, p in zip(names, t_params)]
    rng = np.random.default_rng(1)
    for step in range(7):
        grads = jax.tree_util.tree_map(
            lambda x: np.asarray(rng.normal(0, 1.5, x.shape), np.float32), tree)
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                     j_state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, updates)
        moved = opt.apply(t_state, t_params, [g.clone() for _, g in port(grads)], mask)
        assert moved == (step % t_cfg.grad_accum_steps == t_cfg.grad_accum_steps - 1)
        for (name, want), got in zip(port(jax.tree_util.tree_map(np.asarray, j_params)),
                                     t_params):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} at step {step}")
    if kw.get("momentum_dtype") == "bfloat16":
        assert all(t.dtype == torch.bfloat16 for t in t_state.trace)


@pytest.fixture(scope="module")
def tiny_train():
    """Config, weights and batch for the tiny RetinaNet train steps: weight
    decay and clipping engaged, augment off, allow_low_quality matching."""
    j_cfg, t_cfg = tiny_configs(
        "retinanet", data=dict(batch_size=2, max_boxes=4),
        train=dict(base_lr=0.05, warmup_steps=2, weight_decay=1e-2,
                   grad_clip_norm=0.5, lr_decay_steps=(100,)),
        match=dict(pos_threshold=0.5, neg_threshold=0.4, allow_low_quality=True),
        loss=dict(kind="focal"))
    module, variables = jax_variables(j_cfg.model, seed=4)
    rng = np.random.default_rng(5)
    b, g, s = 2, 4, j_cfg.model.image_size
    xy = rng.uniform(0.0, 0.6, (b, g, 2))
    wh = rng.uniform(0.1, 0.4, (b, g, 2))
    batch = {
        "images": rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
        "boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
        "labels": rng.integers(1, 5, (b, g)).astype(np.int32),
        "valid": np.array([[True, True, True, False], [True, False, False, False]]),
    }
    batch["boxes"][~batch["valid"]] = 0.0
    return j_cfg, t_cfg, module, variables, batch


def test_three_train_steps_match_jax(tiny_train):
    j_cfg, t_cfg, module, variables, batch = tiny_train
    anchors = anchors_for_model(j_cfg.model)
    j_state = jax_train.create_train_state(module, variables, j_cfg)
    j_step = jax_train.make_train_step(module, anchors, j_cfg, augment=False)

    port, t_anchors = port_model(t_cfg.model, variables)
    t_state = train.create_train_state(port, t_cfg, device="cpu")
    t_step = train.make_train_step(port, t_anchors, t_cfg, augment=False, device="cpu")
    for step in range(3):
        j_state, j_metrics = j_step(j_state, dict(batch))
        t_state, t_metrics = t_step(t_state, batch)
        for key in ("loss", "loss_cls", "loss_box", "num_pos", "grad_norm"):
            np.testing.assert_allclose(float(t_metrics[key]), float(j_metrics[key]),
                                       rtol=1e-5, err_msg=f"{key} at step {step}")
        assert float(t_metrics["grad_norm"]) > t_cfg.train.grad_clip_norm  # clipping on
    assert t_state.step == 3 and t_state.opt_state.count == 3
    want = state_dict_from_jax_variables(
        jax.tree_util.tree_map(np.asarray, {"params": j_state.params}))
    got = dict(port.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
    start = state_dict_from_jax_variables({"params": variables["params"]})
    assert max(float((got[n].detach() - start[n]).abs().max()) for n in start) > 1e-3


def test_ema_counts_applied_updates(tiny_train):
    """ema = d*ema + (1-d)*params after every applied update: the closed
    form after two steps from ema0 = p0 is d^2 p0 + d(1-d) p1 + (1-d) p2."""
    _, t_cfg, _, variables, batch = tiny_train
    d = 0.5
    cfg = dataclasses.replace(t_cfg, train=dataclasses.replace(t_cfg.train, ema_decay=d))
    module, anchors = port_model(cfg.model, variables)
    state = train.create_train_state(module, cfg, device="cpu")
    step = train.make_train_step(module, anchors, cfg, augment=False, device="cpu")
    snaps = [{n: p.detach().clone() for n, p in module.named_parameters()}]
    for _ in range(3):
        state, _ = step(state, batch)
        snaps.append({n: p.detach().clone() for n, p in module.named_parameters()})
    for name in snaps[0]:
        p0, p1, p2, p3 = (s[name] for s in snaps)
        want = d ** 3 * p0 + d ** 2 * (1 - d) * p1 + d * (1 - d) * p2 + (1 - d) * p3
        np.testing.assert_allclose(state.ema[name].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    eval_ema = train.make_eval_step(module, anchors, cfg, use_ema=True, device="cpu")
    det = eval_ema(state, batch["images"])
    assert torch.isfinite(det.scores).all()
    with pytest.raises(ValueError, match="no EMA"):
        train.make_eval_step(module, anchors, t_cfg, use_ema=True, device="cpu")(
            train.create_train_state(module, t_cfg, device="cpu"), batch["images"])


def test_grad_accumulation_matches_big_batch(tiny_train):
    """Two micro-steps of half the batch with grad_accum_steps=2 equal one
    step on the whole batch (the same mean gradient reaches the optimizer;
    nothing moves on the first micro-step), EMA included."""
    _, t_cfg, _, variables, batch = tiny_train
    # the same boxes in both images: each half then has as many positives
    # as the other, so the mean of the halves' losses is the whole batch's
    batch = dict(batch, boxes=np.repeat(batch["boxes"][:1], 2, 0),
                 labels=np.repeat(batch["labels"][:1], 2, 0),
                 valid=np.repeat(batch["valid"][:1], 2, 0))
    base = dataclasses.replace(t_cfg.train, warmup_steps=0, grad_clip_norm=1e9,
                               weight_decay=0.0, ema_decay=0.9)
    big_cfg = dataclasses.replace(t_cfg, train=base)
    module, anchors = port_model(big_cfg.model, variables)
    s_big = train.create_train_state(module, big_cfg, device="cpu")
    train.make_train_step(module, anchors, big_cfg, augment=False, device="cpu")(s_big, batch)

    acc_cfg = dataclasses.replace(t_cfg, train=dataclasses.replace(base, grad_accum_steps=2))
    acc_module, _ = port_model(acc_cfg.model, variables)
    s_acc = train.create_train_state(acc_module, acc_cfg, device="cpu")
    step = train.make_train_step(acc_module, anchors, acc_cfg, augment=False, device="cpu")
    p0 = [p.detach().clone() for p in acc_module.parameters()]
    step(s_acc, {k: v[:1] for k, v in batch.items()})
    assert all(torch.equal(a, b) for a, b in zip(p0, acc_module.parameters()))
    assert all(torch.equal(s_acc.ema[n], p.detach()) for n, p in
               zip(s_acc.ema, p0))
    step(s_acc, {k: v[1:] for k, v in batch.items()})
    assert s_acc.opt_state.count == 1 and s_acc.step == 2
    for (name, a), b in zip(acc_module.named_parameters(), module.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=name)


def test_three_ssd_train_steps_match_jax():
    """Config #3's recipe on the tiny SSD: multibox loss with hard-negative
    mining at 3:1 and shape matching (shape_weight 0.3, tau 1), weight decay
    and clipping engaged, augment off. Metrics to 1e-5 relative and the
    parameters after three steps to 2e-5, as the RetinaNet steps."""
    j_cfg, t_cfg = tiny_configs(
        "ssd", data=dict(batch_size=2, max_boxes=6),
        train=dict(base_lr=0.05, warmup_steps=2, weight_decay=1e-2, grad_clip_norm=1.0,
                   lr_decay_steps=(100,)),
        match=dict(pos_threshold=0.5, neg_threshold=0.5, shape_weight=0.3, shape_tau=1.0),
        loss=dict(kind="multibox", neg_pos_ratio=3.0))
    module, variables = jax_variables(j_cfg.model, seed=6)
    batch = gt_batch(7, 2, 6, 300, j_cfg.model.num_classes)
    j_state = jax_train.create_train_state(module, variables, j_cfg)
    j_step = jax_train.make_train_step(module, anchors_for_model(j_cfg.model), j_cfg,
                                       augment=False)
    port, t_anchors = port_model(t_cfg.model, variables)
    t_state = train.create_train_state(port, t_cfg, device="cpu")
    t_step = train.make_train_step(port, t_anchors, t_cfg, augment=False, device="cpu")
    for step in range(3):
        j_state, j_metrics = j_step(j_state, dict(batch))
        t_state, t_metrics = t_step(t_state, batch)
        for key in ("loss", "loss_cls", "loss_box", "num_pos", "grad_norm"):
            np.testing.assert_allclose(float(t_metrics[key]), float(j_metrics[key]),
                                       rtol=1e-5, err_msg=f"{key} at step {step}")
    assert float(t_metrics["num_pos"]) > 0
    want = state_dict_from_jax_variables(
        jax.tree_util.tree_map(np.asarray, {"params": j_state.params}))
    got = dict(port.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)

