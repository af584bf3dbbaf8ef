"""The port's losses and their gradients against the JAX package's
(``losses.py``, gradients by ``jax.grad``).

Tolerance: relative 1e-5 (absolute 1e-6 for gradients) in float32. Both
sides run the same formulas; they differ only in the order of the sums and
in the last bits of log/exp/log1p. The hard-negative selection must be the
same set exactly, so the multibox case is built with many tied
cross-entropies (duplicate logit rows) where only a stable sort agrees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import losses as jax_losses
from shape_based_object_detection_tpu.config import LossConfig as JaxLossConfig
from shape_based_object_detection_tpu.ops.matching import MatchResult as JaxMatch
from shape_based_object_detection_torch import losses
from shape_based_object_detection_torch.config import LossConfig
from shape_based_object_detection_torch.ops.matching import MatchResult


def _case(seed, b, a, classes, kind):
    rng = np.random.default_rng(seed)
    width = classes + 1 if kind == "multibox" else classes
    logits = rng.normal(0.0, 2.0, (b, a, width)).astype(np.float32)
    logits[:, a // 2:] = logits[:, a // 2:a // 2 + 1]  # tied rows
    reg = rng.normal(0.0, 1.0, (b, a, 4)).astype(np.float32)
    cls_t = rng.choice([-1, 0, 0, 0, 1, 2, 3], (b, a)).astype(np.int32)
    cls_t[:, classes:] = np.minimum(cls_t[:, classes:], classes)
    cls_t[:, -a // 4:] = 0  # background among the tied rows
    pos = cls_t > 0
    reg_t = np.where(pos[..., None], rng.normal(0.0, 1.5, (b, a, 4)), 0.0)
    reg_t = reg_t.astype(np.float32)
    idx = rng.integers(0, 5, (b, a)).astype(np.int32)
    quality = rng.uniform(0, 1, (b, a)).astype(np.float32)
    return logits, reg, (idx, cls_t, reg_t, pos, quality)


@pytest.mark.parametrize("kind,beta", [("focal", 1.0), ("focal", 0.0),
                                       ("focal", 0.11), ("multibox", 1.0),
                                       ("multibox", 0.0)])
def test_loss_and_grads_match_jax(kind, beta):
    logits, reg, match = _case(3, 2, 64, 3, kind)
    kw = dict(kind=kind, smooth_l1_beta=beta, box_loss_weight=1.5,
              neg_pos_ratio=3.0)

    def jax_total(lg, rg):
        total, metrics = jax_losses.detection_loss(
            lg, rg, JaxMatch(*(jnp.asarray(x) for x in match)),
            JaxLossConfig(**kw))
        return total, metrics

    (j_total, j_metrics), (j_glog, j_greg) = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(jnp.asarray(logits), jnp.asarray(reg))

    t_log = torch.from_numpy(logits).requires_grad_()
    t_reg = torch.from_numpy(reg).requires_grad_()
    total, metrics = losses.detection_loss(
        t_log, t_reg, MatchResult(*(torch.from_numpy(x) for x in match)),
        LossConfig(**kw))
    total.backward()

    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=1e-5)
    for key in ("loss", "loss_cls", "loss_box", "num_pos"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(j_metrics[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(t_log.grad.numpy(), np.asarray(j_glog),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_reg.grad.numpy(), np.asarray(j_greg),
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(t_reg.grad.numpy()).all()


@pytest.mark.parametrize("beta", [1.0, 0.5, 0.0])
def test_smooth_l1_and_grad_match_jax(beta):
    x = np.linspace(-2.0, 2.0, 41, dtype=np.float32)
    t = torch.from_numpy(x).requires_grad_()
    y = losses.smooth_l1(t, beta)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax_losses.smooth_l1(jnp.asarray(x), beta)),
                               rtol=1e-6)
    g = jax.grad(lambda v: jax_losses.smooth_l1(v, beta).sum())(jnp.asarray(x))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6)


def test_sigmoid_focal_ce_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 6.0, (50, 5)).astype(np.float32)
    targets = (rng.uniform(size=(50, 5)) < 0.3).astype(np.float32)
    got = losses.sigmoid_focal_ce(torch.from_numpy(logits), torch.from_numpy(targets),
                                  0.25, 2.0)
    want = jax_losses.sigmoid_focal_ce(jnp.asarray(logits), jnp.asarray(targets),
                                       0.25, 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_unknown_loss_kind_raises():
    logits, reg, match = _case(0, 1, 8, 2, "focal")
    with pytest.raises(ValueError, match="unknown loss kind"):
        losses.detection_loss(torch.from_numpy(logits), torch.from_numpy(reg),
                              MatchResult(*(torch.from_numpy(x) for x in match)),
                              LossConfig(kind="ce"))
