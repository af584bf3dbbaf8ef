"""Shared CLI plumbing: restoring serving weights from the port's
checkpoints, and the test-time augmentation flags."""

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


def enable_tta_hflip(cfg):
    """``cfg`` with ``model.detect.tta_hflip=True`` (the ``--tta-hflip``
    shortcut for ``--set model.detect.tta_hflip=true``)."""
    import dataclasses

    return dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model,
            detect=dataclasses.replace(cfg.model.detect, tta_hflip=True)))


def parse_scales(text: str) -> list:
    """``--tta-scales`` ("512,640") -> [512, 640]; SystemExit on anything
    else."""
    try:
        scales = [int(s) for s in text.split(",") if s.strip()]
    except ValueError:
        raise SystemExit(f"--tta-scales must be comma-separated integers "
                         f"(e.g. 512,640), got {text!r}")
    if not scales:
        raise SystemExit("--tta-scales named no scales")
    return scales
