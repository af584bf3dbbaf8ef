"""Checkpoint averaging ("model soup", SWA-style) over the retention window
(port of the JAX package's ``tools/average_checkpoints.py``).

Averages several retained checkpoints of one training run into a new
checkpoint directory that every surface loads unchanged (``eval_cli``,
``detect_cli``, ``serve_cli`` and ``tools/export_model`` with
``--checkpoint-dir``, and a ``train_cli`` resume):

    python -m shape_based_object_detection_torch.tools.average_checkpoints \\
        --config ckpt/run/resolved_config.json --checkpoint-dir ckpt/run \\
        --last 3 --out ckpt/run_avg

What is averaged: the parameters always; the EMA when every selected
checkpoint has one; the floating-point buffers (``train_bn``'s running
statistics). Each leaf is summed in float32 as ``0 + l0 + l1 + ...``, divided
by the count and cast back to its dtype, as the reference does. The other
buffers, the optimizer state, the generator and the step come from the
newest selected checkpoint, so the output also resumes.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch


def _mean(leaves: List[torch.Tensor]) -> torch.Tensor:
    ref = leaves[-1]
    if not ref.is_floating_point():
        return ref  # counts: the newest
    acc = sum(leaf.to(torch.float32) for leaf in leaves)
    return torch.div(acc, float(len(leaves))).to(ref.dtype)


def _mean_dicts(dicts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: _mean([d[k] for d in dicts]) for k in dicts[-1]}


def average_snapshots(snaps: List[dict]) -> dict:
    """The leaf-wise mean of checkpoint snapshots (``CheckpointManager.read``,
    host tensors, oldest first): see the module docstring for which parts
    take part. Raises SystemExit when some have an EMA and others not."""
    newest = snaps[-1]
    have_ema = [s["ema"] is not None for s in snaps]
    if any(have_ema) and not all(have_ema):
        raise SystemExit(
            "selected checkpoints disagree on EMA presence (a run whose "
            "--ema-decay changed mid-training?) — pass --steps to select a "
            "consistent subset")
    ema: Optional[dict] = _mean_dicts([s["ema"] for s in snaps]) if all(have_ema) else None
    return {**newest, "params": _mean_dicts([s["params"] for s in snaps]),
            "buffers": _mean_dicts([s["buffers"] for s in snaps]), "ema": ema}


def select_steps(retained: List[int], steps_arg: str, last: int, directory: str) -> List[int]:
    """The steps to average: ``--steps`` (default every retained step), then
    the newest ``--last``. SystemExit on an empty directory, a malformed or
    missing step, or fewer than two."""
    if not retained:
        raise SystemExit(f"no checkpoints in {directory!r}")
    if steps_arg:
        try:
            steps = sorted(int(s) for s in steps_arg.split(",") if s.strip())
        except ValueError:
            raise SystemExit(f"--steps must be comma-separated integers, got {steps_arg!r}")
        missing = [s for s in steps if s not in retained]
        if missing:
            raise SystemExit(f"steps {missing} not retained; available: {retained}")
    else:
        steps = retained
    if last:
        steps = steps[-last:]
    if len(steps) < 2:
        raise SystemExit(f"need >=2 checkpoints to average, selected {steps} "
                         f"(retained: {retained})")
    return steps


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True,
                   help="preset name or resolved_config.json path (the run's dumped "
                        "config — must match the checkpoints)")
    p.add_argument("--device", default="cuda",
                   help="where the template the average is applied to lives: 'cuda' "
                        "(the default) or 'cpu'")
    p.add_argument("--checkpoint-dir", required=True,
                   help="the training run's rolling checkpoint root")
    p.add_argument("--out", required=True,
                   help="directory for the averaged checkpoint (created; loadable by "
                        "eval_cli/detect_cli/serve_cli/export_model and a resume)")
    p.add_argument("--steps", default="",
                   help="comma-separated step numbers to average (default: every "
                        "retained step)")
    p.add_argument("--last", type=int, default=0,
                   help="average only the newest K retained steps")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="config overrides, as in train_cli")
    return p


def main(argv=None):
    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch import train as train_lib
    from shape_based_object_detection_torch.checkpoint import (
        CheckpointManager, apply_snapshot,
    )
    from shape_based_object_detection_torch.models.factory import build_model

    args = _parser().parse_args(argv)
    cfg = config_lib.resolve_config(args.config, args.set)
    mgr = CheckpointManager(args.checkpoint_dir)
    steps = select_steps(mgr.all_steps(), args.steps, args.last, args.checkpoint_dir)
    avg = average_snapshots([mgr.read(s) for s in steps])

    module, _ = build_model(cfg.model, args.device, train=True)
    template = train_lib.create_train_state(module, cfg, device=args.device)
    out = CheckpointManager(args.out, async_save=False)
    out.save(apply_snapshot(avg, template), step=steps[-1])
    out.close()
    print(f"averaged {len(steps)} checkpoints {steps} -> {args.out} (step {steps[-1]})")


if __name__ == "__main__":
    main()
