"""The reference's first training steps of a data-parallel job, worked out
on the job's global batch in row blocks small enough for one card.

The global batch of a step is the ranks' rows in rank order, each rank
taking every ``ranks``-th sample of the epoch's shuffle (``global_rows``).
The augmentation draws for all of its rows from one generator, matching
runs per image, and the positives are counted over the whole global batch
before any forward; then each block's loss (``ops.LOSSES``, which divides
by the block's own positives) is scaled to the global count, the blocks'
gradients are summed, and ``ops.sgd_step`` updates, as ``train.run_steps``
does for a batch taken whole.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import augment, models, ops
from benchmark.reference.precision import setting
from benchmark.reference.train import trainable


def global_rows(n: int, seed: int, ranks: int, per_rank: int, k: int) -> np.ndarray:
    """The indices into a pool of ``n`` of the ``k``-th global batch from
    the start of epoch 0, epochs shuffled as ``ops.epoch_order`` (``seed``):
    rank r takes every ``ranks``-th sample of an epoch's order from the
    r-th (the same number on every rank, whole batches of ``per_rank``),
    and its rows follow rank r - 1's."""
    steps = n // ranks // per_rank
    order = ops.epoch_order(n, seed, k // steps)
    order, k = order[:n - n % ranks], k % steps
    return np.concatenate([order[r::ranks][k * per_rank:(k + 1) * per_rank]
                           for r in range(ranks)])


def run_steps(params0: Dict[str, torch.Tensor], batches, draw_seed: int, cfg: dict,
              precision: str, device, block: int, head_rows: int) -> dict:
    """``len(batches)`` steps from ``params0`` on raw global batches
    (images uint8, boxes, labels, valid; on ``device``), the forward and
    backward in blocks of ``block`` rows. Returns what ``train.run_steps``
    returns: the losses, the momentum after the first step (``grad``), the
    parameters' change over all the steps (``delta``), and the first
    step's head outputs (``heads``) of its first ``head_rows`` rows."""
    m, dc, tc = cfg["model"], cfg["data"], cfg["train"]
    names = trainable(cfg)
    params = {n: t.detach().clone().float() for n, t in params0.items()}
    trace = {n: torch.zeros_like(params[n]) for n in names}
    anc = ops.anchors(m).to(device)
    gen = torch.Generator(device=device).manual_seed(draw_seed)
    loss_fn = ops.LOSSES[cfg["loss"]["kind"]]
    losses, first, heads = [], None, None
    for count, (images, boxes, labels, valid) in enumerate(batches):
        u, mode = augment.draw(gen, images.shape[0], device)
        x, boxes, labels, valid = augment.augment(u, mode, images, boxes, labels, valid,
                                                  dc, m["image_size"])
        cls_t, reg_t = [], []
        for i in range(x.shape[0]):
            c, r = ops.match_image(anc, boxes[i][valid[i]], labels[i][valid[i]], cfg["match"],
                                   m["anchors"]["variances"])
            cls_t.append(c)
            reg_t.append(r)
        cls_t, reg_t = torch.stack(cls_t), torch.stack(reg_t)
        n_all = max(int((cls_t > 0).sum()), 1)
        grads = {n: torch.zeros_like(params[n]) for n in names}
        total, parts = 0.0, []
        for lo in range(0, x.shape[0], block):
            hi = min(lo + block, x.shape[0])
            leaves = {n: params[n].requires_grad_(True) for n in names}
            ctx, quant = setting(precision, device)
            with ctx:
                cls, box = models.forward(params, x[lo:hi].permute(0, 3, 1, 2).contiguous(),
                                          cfg, quant)
            if count == 0 and lo < head_rows:
                keep = min(hi, head_rows) - lo
                parts.append((cls[:keep].detach().float(), box[:keep].detach().float()))
            # the block's loss over its own positives, as a share of the global batch's
            n_block = max(int((cls_t[lo:hi] > 0).sum()), 1)
            loss = loss_fn(cls.float(), box.float(), cls_t[lo:hi], reg_t[lo:hi],
                           cfg["loss"]) * (n_block / n_all)
            for n, g in zip(names, torch.autograd.grad(loss, list(leaves.values()))):
                grads[n] += g
            total += float(loss.detach())
            del cls, box, loss
        if count == 0:
            heads = tuple(torch.cat(t) for t in zip(*parts))
        with torch.no_grad():
            for n in names:
                params[n] = params[n].detach()
            ops.sgd_step(params, grads, trace, tc, count)
        losses.append(total)
        if first is None:
            first = {n: t.clone() for n, t in trace.items()}
    delta = {n: params[n] - params0[n].float() for n in names}
    return {"losses": losses, "grad": first, "delta": delta, "heads": heads}
