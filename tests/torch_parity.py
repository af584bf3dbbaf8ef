"""Shared set-up for the tests that hold the PyTorch port against the JAX
package: the same weights and inputs, made with numpy from a seed, for
both."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from shape_based_object_detection_tpu.models.factory import build_module
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.utils.convert import (
    state_dict_from_jax_variables,
)


def with_detect(cfg, **changes):
    """``cfg`` (a ModelConfig) with DetectConfig fields replaced."""
    return dataclasses.replace(cfg, detect=dataclasses.replace(cfg.detect, **changes))


def jax_variables(cfg, seed: int = 0, cls_predict_scale: float = 4.0):
    """Random flax variables for ``cfg`` as nested dicts of numpy arrays,
    without running flax's initialisers (only the shapes are traced).

    Kernels are normal with variance 1/fan_in, biases small, BatchNorm
    statistics and affine terms away from identity so the conversion of
    every leaf matters. The classification head's final kernel is scaled
    up so scores spread away from the prior and detections separate."""
    module = build_module(cfg)
    size = cfg.image_size
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        names = [p.key for p in path]
        shape, name = leaf.shape, names[-1]
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            w = rng.normal(0.0, np.sqrt(1.0 / fan_in), shape)
            if names[-3:-1] == ["cls_head", "predict"]:
                w = w * cls_predict_scale
        elif name == "bias" and names[0] == "params" and "bn" not in names[-2]:
            w = rng.normal(0.0, 0.01, shape)
        elif name == "scale":
            w = rng.uniform(0.5, 1.0, shape)
        elif name == "bias":  # BatchNorm shift
            w = rng.normal(0.0, 0.1, shape)
        elif name == "mean":
            w = rng.normal(0.0, 0.1, shape)
        elif name == "var":
            w = rng.uniform(0.5, 1.5, shape)
        else:
            raise KeyError(f"unexpected leaf {names}")
        return np.asarray(w, np.float32)

    variables = jax.tree_util.tree_map_with_path(make, shapes)
    return module, variables


def port_model(cfg, variables):
    """The port's module for ``cfg`` on the CPU with the JAX variables
    loaded (strict), and its anchors."""
    module, anchors = build_model(cfg, device="cpu")
    module.load_state_dict(state_dict_from_jax_variables(variables), strict=True)
    return module, anchors


def nhwc_to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)
