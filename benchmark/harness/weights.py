"""Weights made from the seed, on the device, in one draw.

A cell's file gives a recipe: per kind of tensor (``reference/models.py``'s
``param_specs``) a mean and either an absolute ``std`` or a ``gain`` over
sqrt(fan_in); ``log`` kinds are exp of their normal draw (a positive
variance); ``overrides`` set a kind's numbers for the tensors whose name
matches a regular expression. One ``torch.randn`` on the device's own
generator fills every tensor, so the same seed gives the same weights.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch

# the recipe when a cell gives none: the published initialisers (He-style
# lecun normal kernels, zero biases, N(0, 0.01) RetinaNet subnets with the
# focal prior on the classification bias, identity frozen BatchNorm, L2Norm
# at 20)
DEFAULT_RECIPE = {
    "conv": {"gain": 1.0},
    "bias": {"std": 0.0},
    "head_conv": {"std": 0.01},
    "cls_prior": {"mean": -math.log(99.0)},
    "bn_weight": {"mean": 1.0},
    "bn_bias": {"std": 0.0},
    "bn_mean": {"std": 0.0},
    "bn_var": {"log": True},
    "l2norm": {"mean": 20.0},
}


def _numbers(kind: str, name: str, shape, recipe: dict) -> Tuple[float, float, bool]:
    spec = dict(DEFAULT_RECIPE.get(kind, {}))
    spec.update(recipe.get("kinds", {}).get(kind, {}))
    for o in recipe.get("overrides", []):
        if re.search(o["match"], name):
            spec.update({k: v for k, v in o.items() if k != "match"})
    if "gain" in spec:
        fan_in = math.prod(shape[1:])
        std = spec["gain"] / math.sqrt(fan_in)
    else:
        std = spec.get("std", 0.0)
    return spec.get("mean", 0.0), std, bool(spec.get("log", False))


def make_weights(specs: List[Tuple[str, tuple, str]], recipe: dict, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``specs`` from ``seed`` on ``device``."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    nums = [_numbers(kind, name, shape, recipe) for name, shape, kind in specs]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=dev)
    counts = torch.tensor(sizes, device=dev)
    mean = torch.repeat_interleave(torch.tensor([n[0] for n in nums], device=dev), counts)
    std = torch.repeat_interleave(torch.tensor([n[1] for n in nums], device=dev), counts)
    log = torch.repeat_interleave(torch.tensor([n[2] for n in nums], device=dev), counts)
    flat = z * std + mean
    flat = torch.where(log, torch.exp(flat), flat)
    out, at = {}, 0
    for (name, shape, _), n in zip(specs, sizes):
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out
