"""Model FLOPs per image, from the configuration's published widths.

One function per architecture counts 2 x the multiply-adds of every
convolution at the configuration's input size (the models have no linear
layers). Elementwise work (BatchNorm, ReLU, pooling, upsampling, L2Norm)
is not counted, as is usual for a model FLOP count. The count is fixed by
the configuration, whatever module computes it; a training step counts 3x
the forward (forward, and the backward's two products per convolution), no
recomputation included.
"""

from __future__ import annotations

import math

RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def _out(n: int, k: int, s: int, p: int, d: int = 1, ceil: bool = False) -> int:
    span = n + 2 * p - d * (k - 1) - 1
    return (math.ceil(span / s) if ceil else span // s) + 1


def _w(c: int, mult: float) -> int:
    return max(8, int(c * mult))


def _conv(n: int, cin: int, cout: int, k: int) -> int:
    """Multiply-adds of a k x k convolution with an n x n output."""
    return n * n * cout * cin * k * k


def retinanet_macs(m: dict) -> int:
    """ResNet + FPN (P3-P7) + the two 4-conv subnets over every level."""
    mult, size = m["width_mult"], m["image_size"]
    widths = [_w(c, mult) for c in (64, 128, 256, 512)]
    n = _out(size, 7, 2, 3)
    macs = _conv(n, 3, widths[0], 7)
    n = _out(n, 3, 2, 1)
    cin, sides = widths[0], []
    for stage, (blocks, ch) in enumerate(zip(RESNET_BLOCKS[m["backbone"]], widths)):
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            out_n = _out(n, 3, stride, 1)
            macs += _conv(n, cin, ch, 1) + _conv(out_n, ch, ch, 3) + _conv(out_n, ch, ch * 4, 1)
            if cin != ch * 4 or stride != 1:
                macs += _conv(out_n, cin, ch * 4, 1)
            cin, n = ch * 4, out_n
        sides.append(n)
    fc = m["fpn_channels"]
    c3, c4, c5 = (w * 4 for w in widths[1:])
    n3, n4, n5 = sides[1:]
    for side, c in ((n3, c3), (n4, c4), (n5, c5)):
        macs += _conv(side, c, fc, 1) + _conv(side, fc, fc, 3)
    n6 = _out(n5, 3, 2, 1)
    n7 = _out(n6, 3, 2, 1)
    macs += _conv(n6, c5, fc, 3) + _conv(n7, fc, fc, 3)
    a = len(m["anchors"]["octave_scales"]) * len(m["anchors"]["aspect_ratios"][0])
    positions = sum(s * s for s in (n3, n4, n5, n6, n7))
    per_position = (2 * m["head_depth"] * fc * fc * 9
                    + fc * 9 * a * (m["num_classes"] + 4))
    return macs + positions * per_position


SSD512_EXTRAS = [(256, 512, 2, 1, 3), (128, 256, 2, 1, 3), (128, 256, 2, 1, 3),
                 (128, 256, 2, 1, 3), (128, 256, 1, 1, 4)]


def ssd512_macs(m: dict) -> int:
    """VGG-16 (conv6 dilated 3x3, conv7 1x1) + SSD-512's extras + a 3x3
    loc and cls conv per feature map."""
    mult, n = m["width_mult"], m["image_size"]
    w = lambda c: _w(c, mult)
    macs, cin, feats = 0, 3, []
    for stage, (convs, cout) in enumerate(((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))):
        for _ in range(convs):
            macs += _conv(n, cin, w(cout), 3)
            cin = w(cout)
        if stage == 3:
            feats.append((n, cin))
        if stage < 4:
            n = _out(n, 2, 2, 0, ceil=stage == 2)
    macs += _conv(n, cin, w(1024), 3) + _conv(n, w(1024), w(1024), 1)
    cin = w(1024)
    feats.append((n, cin))
    for c1, c2, stride, pad, k in SSD512_EXTRAS:
        macs += _conv(n, cin, w(c1), 1)
        n = _out(n, k, stride, pad)
        macs += _conv(n, w(c1), w(c2), k)
        cin = w(c2)
        feats.append((n, cin))
    k = m["num_classes"] + 1
    for (side, ch), ratios in zip(feats, m["anchors"]["aspect_ratios"]):
        a = len(ratios) + 1
        macs += _conv(side, ch, a * (4 + k), 3)
    return macs


def forward_flops(m: dict) -> float:
    """FLOPs of one image's forward: 2 x multiply-adds."""
    if m["family"] == "retinanet":
        return 2.0 * retinanet_macs(m)
    if m["family"] == "ssd" and m["image_size"] == 512:
        return 2.0 * ssd512_macs(m)
    raise ValueError(f"no FLOP count for {m['family']} at {m['image_size']} px")


def train_flops(m: dict) -> float:
    """FLOPs of one image's training step: 3 x the forward."""
    return 3.0 * forward_flops(m)
