"""VGG-16 fc6/fc7 -> SSD conv6/conv7 surgery (port of the JAX package's
``utils/vgg_surgery.py``).

A classification VGG-16 checkpoint ships fc6 (4096 x 512*7*7) and fc7
(4096 x 4096); SSD replaces them with a dilated 3x3 conv6 and a 1x1 conv7
(Liu et al. 2016 §3) by subsampling:

  fc6 weight (4096, 25088) -> (4096, 512, 7, 7) -> every 4th output, every
             3rd tap in 7x7 -> conv6 (1024, 512, 3, 3)
  fc7 weight (4096, 4096)  -> (4096, 4096, 1, 1) -> every 4th output and
             input -> conv7 (1024, 1024, 1, 1)

Biases decimate the same way. ``decimate`` and ``vgg_fc_to_ssd_convs`` keep
the reference's numpy interface and HWIO outputs;
``load_pretrained_vgg`` merges a torchvision-layout ``state_dict`` into the
port's SSD ``state_dict``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# torchvision's vgg16 ``features`` convolutions, in order
CONV_NAMES = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
              "conv3_3", "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2",
              "conv5_3")


def decimate(arr: np.ndarray, steps) -> np.ndarray:
    """Keep every ``steps[d]``-th entry along each dimension d (None keeps
    all)."""
    out = arr
    for d, s in enumerate(steps):
        if s is not None:
            out = np.take(out, np.arange(0, out.shape[d], s), axis=d)
    return out


def vgg_fc_to_ssd_convs(
    fc6_weight: np.ndarray,  # (4096, 25088), (out, in)
    fc6_bias: np.ndarray,  # (4096,)
    fc7_weight: np.ndarray,  # (4096, 4096)
    fc7_bias: np.ndarray,  # (4096,)
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Returns {'conv6': (kernel HWIO, bias), 'conv7': (kernel HWIO, bias)}."""
    in_ch = fc6_weight.shape[1] // 49  # 512 for VGG-16
    w6 = decimate(fc6_weight.reshape(fc6_weight.shape[0], in_ch, 7, 7), [4, None, 3, 3])
    w7 = fc7_weight.reshape(fc7_weight.shape[0], fc7_weight.shape[1], 1, 1)
    w7 = decimate(w7, [4, 4, None, None])
    return {
        "conv6": (np.transpose(w6, (2, 3, 1, 0)), decimate(fc6_bias, [4])),
        "conv7": (np.transpose(w7, (2, 3, 1, 0)), decimate(fc7_bias, [4])),
    }


def _layer_keys(sd: Mapping, prefix: str):
    """The layer names under ``prefix`` that have a weight, by position."""
    return sorted({k.rsplit(".", 1)[0] for k in sd
                   if k.startswith(prefix) and k.endswith(".weight")},
                  key=lambda s: int(s.split(".")[1]))


def load_pretrained_vgg(state_dict: Mapping, ssd_state_dict: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """Merges a torchvision-layout classification VGG-16 ``state_dict``
    (``features.*``, ``classifier.*``) into an SSD ``state_dict`` of the
    port: the 13 convolutions by position, fc6/fc7 through the decimation
    into ``vgg.conv6``/``vgg.conv7``. Layers it has no source for (L2Norm,
    extras, heads) keep their values. Returns a new dict; raises when the
    checkpoint has no fc6/fc7 (conv6/conv7 would stay random) or a shape
    differs."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
          for k, v in state_dict.items()}
    out = dict(ssd_state_dict)

    def put(name: str, weight: np.ndarray, bias: np.ndarray) -> None:
        for leaf, value in (("weight", weight), ("bias", bias)):
            key = f"vgg.{name}.{leaf}"
            if tuple(out[key].shape) != value.shape:
                raise ValueError(f"{key}: checkpoint shape {value.shape}, model "
                                 f"shape {tuple(out[key].shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(value)).to(out[key].dtype)

    for name, key in zip(CONV_NAMES, _layer_keys(sd, "features.")):
        put(name, sd[f"{key}.weight"], sd[f"{key}.bias"])
    fc_keys = _layer_keys(sd, "classifier.")
    if len(fc_keys) < 2:
        raise ValueError(
            "state_dict has no classifier.{0,3}.* fc6/fc7 keys: cannot run the "
            "fc -> conv decimation surgery, and conv6/conv7 would stay randomly "
            f"initialised (classifier keys found: {fc_keys})")
    surg = vgg_fc_to_ssd_convs(sd[f"{fc_keys[0]}.weight"], sd[f"{fc_keys[0]}.bias"],
                               sd[f"{fc_keys[1]}.weight"], sd[f"{fc_keys[1]}.bias"])
    for name, (kernel, bias) in surg.items():
        put(name, np.transpose(kernel, (3, 2, 0, 1)), bias)  # HWIO -> OIHW
    return out
