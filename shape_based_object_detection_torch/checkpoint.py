"""Checkpoint and resume (port of the JAX package's ``checkpoint.py``; the
reference uses orbax, the port writes ``torch.save`` files).

A checkpoint holds the whole ``TrainState``: the parameters, the buffers
(``train_bn``'s running statistics), the optimizer state (SGD momentum, or
AdamW's moments and count), the EMA, the step and the augmentation
generator's state. It is ``<directory>/<step>/state.pt``.

Saving is asynchronous: ``save`` snapshots the state to host memory on the
caller's thread (so the next step may update it in place) and a writer
thread writes the snapshot into a hidden temporary directory, which is then
renamed into place, so no partial checkpoint is ever visible; the newest
``keep`` are kept.

Under a process group (a ``parallel.Mesh`` with a group) every rank holds
the same state: rank 0 alone writes, ``wait`` (and a synchronous save)
ends with a barrier once its writes are in place, and ``restore_latest``
reads on every rank the step rank 0 finds newest, as the reference's one
orbax save across processes is restored alike on each.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from shape_based_object_detection_torch.parallel.mesh import (
    Mesh, barrier, broadcast_int,
)
from shape_based_object_detection_torch.train import TrainState

STATE_FILE = "state.pt"
_OPT_LISTS = ("trace", "mu", "nu", "acc")


def _host_copies(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host copies of ``tensors``: from the card through pinned memory with
    asynchronous copies (the caller synchronizes), else plain clones."""
    out = {}
    for k, t in tensors.items():
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out[k] = host.copy_(t, non_blocking=True)
        else:
            out[k] = t.clone()
    return out


def snapshot(state: TrainState) -> dict:
    """The state as a dict of host tensors and numbers, ready to write. Waits
    for the card's copies, so the caller may update the state afterwards."""
    module = state.module
    names = [n for n, _ in module.named_parameters()]
    opt = state.opt_state
    snap = {
        "step": int(state.step),
        "params": _host_copies(dict(module.named_parameters())),
        "buffers": _host_copies(dict(module.named_buffers())),
        "opt": {"count": int(opt.count), "mini_step": int(opt.mini_step),
                **{key: (None if getattr(opt, key) is None
                         else _host_copies(dict(zip(names, getattr(opt, key)))))
                   for key in _OPT_LISTS}},
        "ema": None if state.ema is None else _host_copies(state.ema),
        "generator": {"device": state.generator.device.type,
                      "state": state.generator.get_state()},
    }
    if any(p.is_cuda for p in module.parameters()):
        torch.cuda.current_stream(next(module.parameters()).device).synchronize()
    return snap


def _check_keys(what: str, saved: Optional[dict], want: Optional[dict]) -> List[str]:
    if saved is None or want is None:
        return [] if (saved is None) == (want is None) else [
            f"{what}: the checkpoint has {'none' if saved is None else 'some'}, "
            f"the model {'none' if want is None else 'some'}"]
    missing = sorted(set(want) - set(saved))
    unexpected = sorted(set(saved) - set(want))
    shapes = sorted(k for k in set(want) & set(saved)
                    if tuple(saved[k].shape) != tuple(want[k].shape))
    out = []
    if missing:
        out.append(f"{what} missing from the checkpoint: {missing[:8]}")
    if unexpected:
        out.append(f"{what} unexpected in the checkpoint: {unexpected[:8]}")
    if shapes:
        out.append(f"{what} of another shape: {shapes[:8]}")
    return out


def apply_snapshot(snap: dict, template: TrainState) -> TrainState:
    """Copy a snapshot into ``template`` (its module, optimizer state and
    generator, in place) and return it. The EMA is the checkpoint's: a
    dict on the module's device, or None when the checkpoint had none,
    whatever the template held. Raises ValueError naming the keys that do
    not match the template's model or optimizer."""
    module = template.module
    params = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    names = list(params)
    opt = template.opt_state
    errors = (_check_keys("parameters", snap["params"], params)
              + _check_keys("buffers", snap["buffers"], buffers))
    for key in _OPT_LISTS:
        want = getattr(opt, key)
        errors += _check_keys(f"optimizer {key}", snap["opt"][key],
                              None if want is None else dict(zip(names, want)))
    if snap["ema"] is not None:
        errors += _check_keys("EMA", snap["ema"], params)
    if errors:
        raise ValueError("checkpoint and template do not match: " + "; ".join(errors))
    with torch.no_grad():
        for src, dst in ((snap["params"], params), (snap["buffers"], buffers)):
            for k, t in dst.items():
                t.copy_(src[k])
        for key in _OPT_LISTS:
            if getattr(opt, key) is not None:
                for n, t in zip(names, getattr(opt, key)):
                    t.copy_(snap["opt"][key][n])
    ema = None
    if snap["ema"] is not None:
        ema = {n: snap["ema"][n].to(p.device, p.dtype) for n, p in params.items()}
    gen = template.generator
    # a generator's state is kept for its own kind of device: a card's
    # checkpoint restored on the CPU (eval) keeps the template's generator
    if snap["generator"]["device"] == gen.device.type:
        gen.set_state(snap["generator"]["state"])
    opt_state = dataclasses.replace(opt, count=snap["opt"]["count"],
                                    mini_step=snap["opt"]["mini_step"])
    return dataclasses.replace(template, step=snap["step"], opt_state=opt_state, ema=ema)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        self._pool = ThreadPoolExecutor(1) if async_save else None
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, state: TrainState, step: Optional[int] = None) -> None:
        """Snapshot ``state`` now and write it as checkpoint ``step``
        (default: ``state.step``) in the background; an existing checkpoint
        of that step is replaced. Under a group only rank 0 writes; a
        synchronous save returns on every rank once the write is done."""
        if self.writer:
            snap = snapshot(state)
            if step is not None:
                snap["step"] = int(step)
            step = snap["step"]
            if self._pool is None:
                self._write(snap, step)
            else:
                self._pending.append(self._pool.submit(self._write, snap, step))
        if self._pool is None:
            self._barrier()

    def _barrier(self) -> None:
        if self.mesh is not None:
            barrier(self.mesh)

    def _write(self, snap: dict, step: int) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}-{threading.get_ident()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(snap, os.path.join(tmp, STATE_FILE))
            with self._lock:
                final = self._path(step)
                if os.path.exists(final):
                    old = final + f".old-{os.getpid()}"
                    os.replace(final, old)
                    os.replace(tmp, final)
                    shutil.rmtree(old, ignore_errors=True)
                else:
                    os.replace(tmp, final)
                for s in self.all_steps()[:-self.keep] if self.keep > 0 else []:
                    shutil.rmtree(self._path(s), ignore_errors=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def all_steps(self) -> list:
        """Retained checkpoint steps, ascending (oldest to newest)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name,
                                                              STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read(self, step: int) -> dict:
        """Checkpoint ``step`` as written: a dict of host tensors."""
        return torch.load(os.path.join(self._path(step), STATE_FILE), map_location="cpu",
                          weights_only=True)

    def restore_latest(self, template: TrainState) -> Optional[TrainState]:
        """The newest checkpoint restored into ``template`` (see
        ``restore_step``), or None when there is none (a fresh start).
        Under a group, every rank restores the step rank 0 finds newest."""
        step = self.latest_step()
        if self.mesh is not None:
            step = broadcast_int(-1 if step is None else step, self.mesh)
            step = None if step < 0 else step
        return None if step is None else self.restore_step(step, template)

    def restore_step(self, step: int, template: TrainState) -> TrainState:
        """Checkpoint ``step`` restored into ``template``, in place. The EMA
        follows the checkpoint, whether or not the template has one (as the
        reference retries the other EMA structure): check ``restored.ema is
        None`` to learn what it held."""
        return apply_snapshot(self.read(step), template)

    def wait(self) -> None:
        """Wait for the writes in flight; raises a write's error. Under a
        group every rank returns once rank 0's writes are in place."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        self._barrier()

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()


class BestCheckpointKeeper:
    """Keeps the single best checkpoint by a metric to maximise (val mAP),
    apart from the rolling checkpoints, so a restart resumes the latest
    state while eval and serving can reach the best. The best value and
    step persist in ``best.json`` beside it. Under a group (``mesh``) every
    rank decides alike on the same value and rank 0 writes."""

    def __init__(self, directory: str, mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._meta_path = os.path.join(self.directory, "best.json")
        self._mgr = CheckpointManager(self.directory, keep=1, async_save=False, mesh=mesh)
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            self.best_value = float(meta["value"])
            self.best_step = int(meta["step"])
        else:
            self.best_value = float("-inf")
            self.best_step = -1

    def maybe_save(self, state: TrainState, step: int, value: float) -> bool:
        """Saves iff ``value`` beats the best so far; returns whether saved."""
        # a NaN must never become the best: it fails every comparison, so it
        # would save here and let any later value overwrite the true best
        if not math.isfinite(value) or value <= self.best_value:
            return False
        self.best_value = float(value)
        self.best_step = int(step)
        # the metadata first, atomically: a crash between the two writes
        # leaves best.json ahead of the weights (later bests are missed
        # until one beats it), never behind them (a worse value would evict
        # the true best)
        if self._mgr.writer:
            tmp = self._meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": self.best_step, "value": self.best_value}, f)
            os.replace(tmp, self._meta_path)
        self._mgr.save(state, step)
        return True

    def restore_best(self, template: TrainState) -> Optional[TrainState]:
        return self._mgr.restore_latest(template)

    def close(self) -> None:
        self._mgr.close()
