"""Shared CLI plumbing: restoring serving weights from the port's
checkpoints."""

from __future__ import annotations

from typing import Dict

import torch


def restore_checkpoint_variables(module: torch.nn.Module, checkpoint_dir: str,
                                 ema: bool = False) -> Dict[str, torch.Tensor]:
    """The state dict of the latest checkpoint in ``checkpoint_dir`` for
    ``module``: its parameters (or, with ``ema``, its EMA of them) and its
    buffers, as host tensors for ``module.load_state_dict(strict=True)``.

    Fails loud (SystemExit) on a missing or empty directory (fresh random
    weights on a mistyped path would score plausible garbage), on ``ema``
    against a checkpoint trained without EMA, and on a checkpoint of
    another model, naming the keys that differ."""
    import os

    from shape_based_object_detection_torch.checkpoint import CheckpointManager

    step = (CheckpointManager(checkpoint_dir).latest_step()
            if os.path.isdir(checkpoint_dir) else None)
    if step is None:
        raise SystemExit(
            f"no checkpoint found in {checkpoint_dir!r} — check the path "
            "(omit --checkpoint-dir to use fresh-initialized weights "
            "deliberately)")
    snap = CheckpointManager(checkpoint_dir).read(step)
    if ema and snap["ema"] is None:
        raise SystemExit("--ema: checkpoint has no EMA weights (train with "
                         "--ema-decay > 0)")
    weights = {**(snap["ema"] if ema else snap["params"]), **snap["buffers"]}
    want = set(module.state_dict())
    if set(weights) != want:
        raise SystemExit(
            f"checkpoint in {checkpoint_dir!r} does not match the model: missing "
            f"{sorted(want - set(weights))[:8]}, unexpected "
            f"{sorted(set(weights) - want)[:8]}")
    return weights
