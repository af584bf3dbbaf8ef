"""The reference's first training steps: the same raw batches and the same
augmentation draws as the program's, then augmentation, forward, matching,
loss, gradients and the SGD update, all worked out here."""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import augment, models, ops
from benchmark.reference.precision import setting

BUFFER_KINDS = ("bn_mean", "bn_var")


def trainable(cfg: dict) -> List[str]:
    """The names of the trained tensors: all but BatchNorm's running
    statistics."""
    return [n for n, _, kind in models.param_specs(cfg) if kind not in BUFFER_KINDS]


def run_steps(params0: Dict[str, torch.Tensor], batches, draw_seed: int, cfg: dict,
              precision: str, device) -> dict:
    """``len(batches)`` steps from ``params0`` on raw batches (images
    uint8, boxes, labels, valid; on ``device``), the augmentation drawing
    from a generator seeded with ``draw_seed``. Returns the losses, the
    momentum after the first step (``grad``) and the parameters' change
    over all the steps (``delta``), and the first step's head outputs
    (``heads``: class logits and box offsets, float32)."""
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
        leaves = {n: params[n].requires_grad_(True) for n in names}
        ctx, quant = setting(precision, device)
        with ctx:
            cls, box = models.forward(params, x.permute(0, 3, 1, 2).contiguous(), cfg, quant)
        if heads is None:
            heads = (cls.detach().float(), box.detach().float())
        loss = loss_fn(cls.float(), box.float(), cls_t, reg_t, cfg["loss"])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for n in names:
                params[n] = params[n].detach()
            ops.sgd_step(params, dict(zip(names, grads)), trace, tc, count)
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: t.clone() for n, t in trace.items()}
    delta = {n: params[n] - params0[n].float() for n in names}
    return {"losses": losses, "grad": first, "delta": delta, "heads": heads}
