"""The port's checkpoints (``checkpoint.py``): a round trip of the whole
train state is bit-equal (parameters, ``train_bn`` buffers, momentum or
AdamW moments, EMA, step, the generator), the newest ``keep`` are kept, an
interrupted write leaves no partial checkpoint, the EMA follows the
checkpoint, ``BestCheckpointKeeper`` refuses NaN and worse values, and a
checkpoint of another model fails with the keys that differ."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from shape_based_object_detection_torch import checkpoint, config, train
from shape_based_object_detection_torch.models.factory import build_model
from tests.torch_parity import gt_batch, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _trained(family="retinanet", steps=2, seed=0, **train_kw):
    cfg = config.get_config(f"tiny_{family}")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, train_bn=family == "retinanet"),
        train=dataclasses.replace(cfg.train, warmup_steps=1, **train_kw))
    module, anchors = build_model(cfg.model, device="cpu", train=True,
                                  generator=torch.Generator().manual_seed(seed))
    state = train.create_train_state(module, cfg, device="cpu")
    step = train.make_train_step(module, anchors, cfg, device="cpu")
    batch = gt_batch(seed, 2, cfg.data.max_boxes, cfg.model.image_size, cfg.model.num_classes)
    for _ in range(steps):
        state, _ = step(state, batch)
    return cfg, state


def _fresh(cfg, seed=9):
    module, _ = build_model(cfg.model, device="cpu", train=True,
                            generator=torch.Generator().manual_seed(seed))
    return train.create_train_state(module, cfg, device="cpu")


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (n, x), y in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(x, y), n
    for key in ("trace", "mu", "nu", "acc"):
        xs, ys = getattr(a.opt_state, key), getattr(b.opt_state, key)
        assert (xs is None) == (ys is None), key
        for x, y in zip(xs or [], ys or []):
            assert x.dtype == y.dtype and torch.equal(x, y), key
    assert (a.opt_state.count, a.opt_state.mini_step) == (b.opt_state.count,
                                                          b.opt_state.mini_step)
    assert (a.ema is None) == (b.ema is None)
    for n in a.ema or {}:
        assert torch.equal(a.ema[n], b.ema[n]), n
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("family,kw", [
    ("retinanet", dict(ema_decay=0.9, momentum_dtype="bfloat16")),
    ("ssd", dict(optimizer="adamw")),
    ("retinanet", dict(grad_accum_steps=2))])
def test_round_trip_bit_equal(tmp_path, family, kw):
    cfg, state = _trained(family, steps=3, **kw)
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    mgr.save(state)
    mgr.wait()
    assert mgr.all_steps() == [3]
    restored = mgr.restore_latest(_fresh(cfg))
    _assert_states_equal(restored, state)
    if family == "retinanet" and cfg.model.train_bn:
        assert not torch.equal(restored.module.backbone.bn1.running_var,
                               torch.ones_like(restored.module.backbone.bn1.running_var))
    mgr.close()


def test_save_snapshots_before_the_next_step(tmp_path):
    """The snapshot is taken when ``save`` returns: updating the state in
    place afterwards does not reach the checkpoint."""
    cfg, state = _trained(steps=1)
    want = {n: p.detach().clone() for n, p in state.module.named_parameters()}
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(state)
    with torch.no_grad():
        for p in state.module.parameters():
            p.add_(1.0)
    mgr.wait()
    snap = mgr.read(1)
    for n, w in want.items():
        assert torch.equal(snap["params"][n], w), n


def test_keep_rotation_and_replacement(tmp_path):
    cfg, state = _trained(steps=1)
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(state, s)
    mgr.save(state, 40)  # the same step again replaces it
    mgr.wait()
    assert mgr.all_steps() == [30, 40]
    assert sorted(os.listdir(tmp_path)) == ["30", "40"]
    assert mgr.restore_step(30, _fresh(cfg)).step == 30


def test_interrupted_write_leaves_no_partial_checkpoint(tmp_path, monkeypatch):
    cfg, state = _trained(steps=1)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(state, 1)
    mgr.wait()

    def dies(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dies)
    mgr.save(state, 2)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == [1]
    assert os.listdir(tmp_path) == ["1"]
    assert mgr.restore_latest(_fresh(cfg)).step == 1


def test_ema_follows_the_checkpoint(tmp_path):
    cfg, with_ema = _trained(steps=2, ema_decay=0.5)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "a"))
    mgr.save(with_ema)
    mgr.wait()
    no_ema_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema_decay=0.0))
    template = _fresh(no_ema_cfg)
    assert template.ema is None
    restored = mgr.restore_latest(template)
    assert restored.ema is not None
    for n, e in with_ema.ema.items():
        assert torch.equal(restored.ema[n], e)
    _, without = _trained(steps=1)
    mgr_b = checkpoint.CheckpointManager(str(tmp_path / "b"))
    mgr_b.save(without)
    mgr_b.wait()
    assert mgr_b.restore_latest(_fresh(cfg)).ema is None
    assert checkpoint.CheckpointManager(str(tmp_path / "c")).restore_latest(_fresh(cfg)) is None


def test_mismatch_names_the_keys(tmp_path):
    _, state = _trained("ssd", steps=1)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(state)
    mgr.wait()
    with pytest.raises(ValueError, match="do not match: parameters missing") as err:
        mgr.restore_latest(_fresh(config.get_config("tiny_retinanet")))
    assert "backbone.bn1.weight" in str(err.value)


def test_best_keeper(tmp_path):
    cfg, state = _trained(steps=1)
    keeper = checkpoint.BestCheckpointKeeper(str(tmp_path / "best"))
    assert keeper.maybe_save(state, 1, 0.25)
    assert not keeper.maybe_save(state, 2, float("nan"))
    assert not keeper.maybe_save(state, 3, 0.2)
    assert not keeper.maybe_save(state, 4, 0.25)
    state.step = 5
    assert keeper.maybe_save(state, 5, 0.5)
    meta = json.loads((tmp_path / "best" / "best.json").read_text())
    assert meta == {"step": 5, "value": 0.5}
    again = checkpoint.BestCheckpointKeeper(str(tmp_path / "best"))
    assert (again.best_step, again.best_value) == (5, 0.5)
    assert not again.maybe_save(state, 6, 0.4)
    restored = again.restore_best(_fresh(cfg))
    assert restored.step == 5 and not math.isnan(meta["value"])
    assert checkpoint.CheckpointManager(str(tmp_path / "best")).all_steps() == [5]
    np.testing.assert_array_equal(
        restored.module.backbone.conv1.weight.detach().numpy(),
        state.module.backbone.conv1.weight.detach().numpy())
