"""JAX/flax variables -> the port's ``state_dict``.

The input is the flax variable tree as nested dicts of numpy arrays
(``{"params": ..., "batch_stats": ...}``). Module paths become dotted
attribute names (``backbone.layer2_0.conv2``, ``fpn.lateral_3``,
``cls_head.predict``), which the port's modules use, so the result loads
with ``load_state_dict(strict=True)``. Leaf mapping:

  Conv       kernel (kH, kW, I, O) -> weight (O, I, kH, kW); bias as is
  BatchNorm  scale, bias -> weight, bias; mean, var -> running_mean, running_var
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, value


def state_dict_from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Returns a ``state_dict`` of float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for (collection, *mods, leaf), value in _walk(variables):
        arr = np.asarray(value, dtype=np.float32)
        if collection == "params":
            names = _PARAM_LEAVES
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
        elif collection == "batch_stats":
            names = _STAT_LEAVES
        else:
            raise KeyError(f"unhandled collection {collection!r}")
        if leaf not in names:
            raise KeyError(f"unhandled leaf {leaf!r} at {'/'.join(mods)}")
        out[".".join([*mods, names[leaf]])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out
