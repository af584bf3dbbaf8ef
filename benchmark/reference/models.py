"""Plain PyTorch forwards of the benchmark's two architectures, written
from the papers and independent of the program under test.

- RetinaNet (Lin et al. 2017, arXiv:1708.02002): ResNet-50 v1 bottlenecks
  (stride in each stage's first 3x3) with frozen BatchNorm, an FPN over
  C3-C5 with P6 from C5 and P7 from ReLU(P6), and two 4-conv subnets of
  256 channels shared over P3-P7, 9 anchors per cell.
- SSD-512 (Liu et al. 2016, arXiv:1512.02325): VGG-16 with a ceil-mode
  pool3, a 3x3/1 pool5, dilated fc6 as a 3x3 conv, fc7 as a 1x1 conv,
  L2Norm on conv4_3 (scale 20), the extra layers conv8-conv12 and a 3x3
  loc and cls conv per feature map.

Each forward takes a flat dict of parameters, keyed by the names of the
state dict that the program loads (``param_specs`` lists them with their
shapes), and NCHW float images; it returns ``(cls_logits (B, A, K),
box_offsets (B, A, 4))`` with the anchors in the order level, row, column,
anchor of the cell. ``quant`` rounds every convolution's input and weight
and its output (the lower-precision controls of ``precision.py``); None
computes in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
SSD512_EXTRAS = [("conv8", 256, 512, 2, 1, 3), ("conv9", 128, 256, 2, 1, 3),
                 ("conv10", 128, 256, 2, 1, 3), ("conv11", 128, 256, 2, 1, 3),
                 ("conv12", 128, 256, 1, 1, 4)]
VGG_PLAN = [("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128),
            ("conv2_2", 128, 128), ("conv3_1", 128, 256), ("conv3_2", 256, 256),
            ("conv3_3", 256, 256), ("conv4_1", 256, 512), ("conv4_2", 512, 512),
            ("conv4_3", 512, 512), ("conv5_1", 512, 512), ("conv5_2", 512, 512),
            ("conv5_3", 512, 512)]


def _w(c: int, mult: float) -> int:
    return max(8, int(c * mult))


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
         dilation: int = 1, quant: Quant = None) -> torch.Tensor:
    w, b = p[name + ".weight"], p.get(name + ".bias")
    if quant is None:
        return F.conv2d(x, w, b, stride, padding, dilation)
    y = F.conv2d(quant(x), quant(w), None, stride, padding, dilation)
    if b is not None:
        y = y + b.view(1, -1, 1, 1)
    return quant.output(y)


def frozen_bn(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    scale = p[name + ".weight"] / torch.sqrt(p[name + ".running_var"] + 1e-5)
    shift = p[name + ".bias"] - p[name + ".running_mean"] * scale
    return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# RetinaNet
# ---------------------------------------------------------------------------


def resnet_layout(variant: str, mult: float = 1.0):
    """[(block name, in channels, width, stride)] and the stem's width."""
    widths = [_w(c, mult) for c in (64, 128, 256, 512)]
    blocks, cin = [], widths[0]
    for stage, (n, ch) in enumerate(zip(RESNET_BLOCKS[variant], widths)):
        for i in range(n):
            blocks.append((f"layer{stage + 1}_{i}", cin, ch,
                           2 if (i == 0 and stage > 0) else 1, stage))
            cin = ch * 4
    return blocks, widths


def retinanet_forward(p: Params, x: torch.Tensor, cfg: dict,
                      quant: Quant = None) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg["model"]
    q = dict(quant=quant)
    blocks, _ = resnet_layout(m["backbone"], m["width_mult"])
    x = F.relu(frozen_bn(p, "backbone.bn1", conv(p, "backbone.conv1", x, 2, 3, **q)))
    x = F.max_pool2d(x, 3, 2, 1)
    taps = {}
    for name, cin, ch, stride, stage in blocks:
        pre = f"backbone.{name}"
        y = F.relu(frozen_bn(p, pre + ".bn1", conv(p, pre + ".conv1", x, **q)))
        y = F.relu(frozen_bn(p, pre + ".bn2", conv(p, pre + ".conv2", y, stride, 1, **q)))
        y = frozen_bn(p, pre + ".bn3", conv(p, pre + ".conv3", y, **q))
        if pre + ".downsample.weight" in p:
            x = frozen_bn(p, pre + ".downsample_bn",
                          conv(p, pre + ".downsample", x, stride, **q))
        x = F.relu(y + x)
        taps[stage] = x
    c3, c4, c5 = taps[1], taps[2], taps[3]
    p5 = conv(p, "fpn.lateral_5", c5, **q)
    p4 = conv(p, "fpn.lateral_4", c4, **q) + F.interpolate(p5, size=c4.shape[-2:], mode="nearest")
    p3 = conv(p, "fpn.lateral_3", c3, **q) + F.interpolate(p4, size=c3.shape[-2:], mode="nearest")
    p3 = conv(p, "fpn.smooth_3", p3, 1, 1, **q)
    p4 = conv(p, "fpn.smooth_4", p4, 1, 1, **q)
    p5 = conv(p, "fpn.smooth_5", p5, 1, 1, **q)
    p6 = conv(p, "fpn.p6", c5, 2, 1, **q)
    p7 = conv(p, "fpn.p7", F.relu(p6), 2, 1, **q)
    b = x.shape[0]

    def head(name, feat, k):
        for i in range(m["head_depth"]):
            feat = F.relu(conv(p, f"{name}.conv_{i}", feat, 1, 1, **q))
        out = conv(p, f"{name}.predict", feat, 1, 1, **q)
        return out.permute(0, 2, 3, 1).reshape(b, -1, k)

    levels = [p3, p4, p5, p6, p7]
    k = m["num_classes"]
    cls = torch.cat([head("cls_head", f, k) for f in levels], 1)
    box = torch.cat([head("box_head", f, 4) for f in levels], 1)
    return cls, box


def retinanet_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the state dict; kind is
    conv, bias, head_conv, cls_prior, bn_weight, bn_bias, bn_mean, bn_var."""
    m = cfg["model"]
    mult, fc, k = m["width_mult"], m["fpn_channels"], m["num_classes"]
    a = 3 * len(m["anchors"]["octave_scales"])
    specs = []

    def cv(name, cin, cout, ksz, bias, kind="conv"):
        specs.append((name + ".weight", (cout, cin, ksz, ksz), kind))
        if bias:
            specs.append((name + ".bias", (cout,), "bias"))

    def bn(name, c):
        for suffix, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                             ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            specs.append((f"{name}.{suffix}", (c,), kind))

    blocks, widths = resnet_layout(m["backbone"], mult)
    cv("backbone.conv1", 3, widths[0], 7, False)
    bn("backbone.bn1", widths[0])
    for name, cin, ch, stride, _ in blocks:
        pre = f"backbone.{name}"
        cv(pre + ".conv1", cin, ch, 1, False)
        bn(pre + ".bn1", ch)
        cv(pre + ".conv2", ch, ch, 3, False)
        bn(pre + ".bn2", ch)
        cv(pre + ".conv3", ch, ch * 4, 1, False)
        bn(pre + ".bn3", ch * 4)
        if cin != ch * 4 or stride != 1:
            cv(pre + ".downsample", cin, ch * 4, 1, False)
            bn(pre + ".downsample_bn", ch * 4)
    c3, c4, c5 = (w * 4 for w in widths[1:])
    for i, c in ((3, c3), (4, c4), (5, c5)):
        cv(f"fpn.lateral_{i}", c, fc, 1, True)
    for i in (3, 4, 5):
        cv(f"fpn.smooth_{i}", fc, fc, 3, True)
    cv("fpn.p6", c5, fc, 3, True)
    cv("fpn.p7", fc, fc, 3, True)
    for head, outs in (("cls_head", k), ("box_head", 4)):
        for i in range(m["head_depth"]):
            cv(f"{head}.conv_{i}", fc, fc, 3, True, "head_conv")
        specs.append((f"{head}.predict.weight", (a * outs, fc, 3, 3), "head_conv"))
        specs.append((f"{head}.predict.bias", (a * outs,),
                      "cls_prior" if head == "cls_head" else "bias"))
    return specs


# ---------------------------------------------------------------------------
# SSD-512
# ---------------------------------------------------------------------------


def ssd_forward(p: Params, x: torch.Tensor, cfg: dict,
                quant: Quant = None) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg["model"]
    q = dict(quant=quant)

    def convs(x, *names):
        for name in names:
            x = F.relu(conv(p, f"vgg.{name}", x, 1, 1, **q))
        return x

    x = F.max_pool2d(convs(x, "conv1_1", "conv1_2"), 2, 2)
    x = F.max_pool2d(convs(x, "conv2_1", "conv2_2"), 2, 2)
    x = F.max_pool2d(convs(x, "conv3_1", "conv3_2", "conv3_3"), 2, 2, ceil_mode=True)
    conv4_3 = convs(x, "conv4_1", "conv4_2", "conv4_3")
    x = convs(F.max_pool2d(conv4_3, 2, 2), "conv5_1", "conv5_2", "conv5_3")
    x = F.max_pool2d(x, 3, 1, 1)
    x = F.relu(conv(p, "vgg.conv6", x, 1, 6, 6, **q))
    x = F.relu(conv(p, "vgg.conv7", x, **q))
    norm = torch.sqrt(conv4_3.square().sum(1, keepdim=True) + 1e-10)
    feats = [conv4_3 / norm * p["l2norm.weight"].view(1, -1, 1, 1), x]
    for name, _, _, stride, pad, _ in SSD512_EXTRAS:
        x = F.relu(conv(p, f"extras.{name}_1", x, **q))
        x = F.relu(conv(p, f"extras.{name}_2", x, stride, pad, **q))
        feats.append(x)
    b, k = x.shape[0], m["num_classes"] + 1
    cls, box = [], []
    for i, f in enumerate(feats):
        cls.append(conv(p, f"cls_{i}", f, 1, 1, **q).permute(0, 2, 3, 1).reshape(b, -1, k))
        box.append(conv(p, f"loc_{i}", f, 1, 1, **q).permute(0, 2, 3, 1).reshape(b, -1, 4))
    return torch.cat(cls, 1), torch.cat(box, 1)


def ssd_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    m = cfg["model"]
    mult, k = m["width_mult"], m["num_classes"] + 1
    specs = []

    def cv(name, cin, cout, ksz):
        specs.append((name + ".weight", (cout, cin, ksz, ksz), "conv"))
        specs.append((name + ".bias", (cout,), "bias"))

    for name, cin, cout in VGG_PLAN:
        cv(f"vgg.{name}", 3 if cin == 3 else _w(cin, mult), _w(cout, mult), 3)
    cv("vgg.conv6", _w(512, mult), _w(1024, mult), 3)
    cv("vgg.conv7", _w(1024, mult), _w(1024, mult), 1)
    specs.append(("l2norm.weight", (_w(512, mult),), "l2norm"))
    cin = _w(1024, mult)
    channels = [_w(512, mult), _w(1024, mult)]
    for name, c1, c2, _, _, ksz in SSD512_EXTRAS:
        cv(f"extras.{name}_1", cin, _w(c1, mult), 1)
        cv(f"extras.{name}_2", _w(c1, mult), _w(c2, mult), ksz)
        cin = _w(c2, mult)
        channels.append(cin)
    for i, (ch, ratios) in enumerate(zip(channels, m["anchors"]["aspect_ratios"])):
        a = len(ratios) + 1
        cv(f"loc_{i}", ch, a * 4, 3)
        cv(f"cls_{i}", ch, a * k, 3)
    return specs


FORWARDS = {"retinanet": retinanet_forward, "ssd": ssd_forward}
SPECS = {"retinanet": retinanet_specs, "ssd": ssd_specs}


def forward(p: Params, x: torch.Tensor, cfg: dict, quant: Quant = None):
    return FORWARDS[cfg["model"]["family"]](p, x, cfg, quant)


def param_specs(cfg: dict):
    return SPECS[cfg["model"]["family"]](cfg)
