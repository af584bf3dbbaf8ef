"""Convert a PyTorch checkpoint into a model's initial weights (port of the
JAX package's ``tools/convert_checkpoint.py``).

Two input layouts:

- ``mirror``: a state dict in the port's own names (those of
  ``tests/golden/torch_models.py``, which the port's modules keep), loaded
  into the model with ``strict=True``;
- ``vgg_backbone``: a torchvision-layout classification VGG-16
  (``features.*``, ``classifier.*``) merged into an SSD: the 13
  convolutions, and fc6/fc7 decimated into conv6/conv7
  (``utils/vgg_surgery.load_pretrained_vgg``); every other layer keeps its
  initial value.

The output is the model's ``state_dict()`` written with ``torch.save``: the
file ``train_cli --init-params`` loads with ``strict=True`` into a model of
the same preset. (The reference writes an orbax directory.)

    python -m shape_based_object_detection_torch.tools.convert_checkpoint \\
        --model config3_ssd512_voc_train --torch-ckpt vgg16.pth \\
        --mode vgg_backbone --out vgg_init.pt
"""

from __future__ import annotations

import argparse


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="ssd300",
                   help="preset whose model the weights are for (train with the same "
                        "preset: SSD-300's heads do not load into SSD-512's)")
    p.add_argument("--device", default="cuda",
                   help="where the model is built and the weights loaded: 'cuda' (the "
                        "default) or 'cpu'")
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--mode", choices=["mirror", "vgg_backbone"], default="mirror")
    p.add_argument("--out", required=True)
    return p


def main(argv=None):
    import torch

    from shape_based_object_detection_torch import config as config_lib
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.utils.vgg_surgery import load_pretrained_vgg

    args = _parser().parse_args(argv)
    cfg = config_lib.get_config(args.model)
    if args.mode == "vgg_backbone" and cfg.model.family != "ssd":
        raise SystemExit(f"--mode vgg_backbone merges a VGG-16 into an SSD; {args.model!r} "
                         f"is a {cfg.model.family} model")
    module, _ = build_model(cfg.model, args.device, train=True)

    sd = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if args.mode == "vgg_backbone":
        sd = load_pretrained_vgg(sd, module.state_dict())
    module.load_state_dict(sd, strict=True)

    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
