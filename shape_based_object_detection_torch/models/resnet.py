"""ResNet-50/101 backbone (port of the JAX package's ``models/resnet.py``).

Bottleneck ResNet v1 with the stride in each stage's first 3x3, NCHW.
Returns C3, C4, C5 (strides 8, 16, 32) for the FPN. BatchNorm is frozen
(running statistics, eps 1e-5) unless ``train_bn`` is set and the call
passes ``train=True``, as the reference's ``nn.BatchNorm`` runs it.
Attribute names follow the flax module paths (``layer2_0.conv2``,
``downsample_bn``), so converted JAX weights load with ``strict=True``.

Under a row shard (``row_shard``, set on the whole detector by
``parallel/spatial.set_row_shard``) the input is this rank's rows of the
images: every convolution (``RowConv2d``) and the stem's max-pool fetch
the rows their windows read from the ranks that own them
(``parallel/spatial.py``; a stride-1 1x1 and frozen BatchNorm are
row-local), and trainable BatchNorm sums its statistics over the real
rows of its group, the world.

Where no autograd graph is recorded (detect, eval, export), a frozen
BatchNorm and what follows it (the ReLU, or a bottleneck's residual add and
ReLU) run as one op, ``sbd::frozen_bn_act`` or ``sbd::frozen_bn_add_relu``
(``ops/frozen_bn_cuda.py``): one kernel on the card, the plain composition
elsewhere, the same bits either way. Under autograd (training, remat's
recompute) the plain composition runs as layers.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from shape_based_object_detection_torch.ops import frozen_bn, frozen_bn_cuda
from shape_based_object_detection_torch.parallel.spatial import (
    RowConv2d, map_height, row_max_pool2d,
)
from shape_based_object_detection_torch.utils import metrics as trace

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


def round_channels(c: int, mult: float) -> int:
    """Channel width under ``width_mult``, as the reference rounds it."""
    return max(8, int(c * mult))


def run_segment(fn: Callable, *args, remat: bool = False):
    """``fn(*args)``; with ``remat``, as one segment of rematerialisation
    (the reference's ``nn.remat``): the forward keeps only the segment's
    inputs for backward and recomputes the rest there. Where no autograd
    graph is recorded (detect, eval) it runs plainly either way."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    # no layer draws random numbers, so the RNG state needs no saving
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW channels.

    Frozen (running statistics) unless ``train_bn`` and the call's ``train``
    are both set. Frozen, it computes in float32 in flax's order and rounds
    to the input's type once, so a bf16 output is bit-equal to flax's. With
    both set it normalises with the batch's mean and *biased* variance, in
    float32 as flax computes them (``max(E[x^2] - E[x]^2, 0)``), and keeps
    them in ``pending``: the
    train step folds them into the running statistics once, after backward
    (``apply_batch_stats``), as the reference's statistics leave its step
    once through the aux output. A forward recomputed under remat finds
    ``pending`` set and leaves it. The state has no ``num_batches_tracked``,
    so state dicts load strictly with either setting.

    Under a process group (``group``, set by the data-parallel train step
    through ``set_batch_stats_group``) the batch is the global batch, as in
    the reference's one program: the per-channel sums of x and x^2 and the
    count are summed over the ranks by an all-reduce that carries the
    gradient, so every rank normalises, and keeps in ``pending``, the same
    statistics. The means are the sums over the count in every case. Under
    a row shard (``row_shard``) a rank's sums and count take its real rows
    only, so the padding rows of an uneven split do not count."""

    row_shard = None

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9,
                 train_bn: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.train_bn = train_bn
        self.pending = None
        self.group = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not (self.train_bn and train):
            trace.count("bn.frozen")
            return frozen_bn.batch_norm(x, *self.stats(), self.eps)
        shape = (1, -1, 1, 1)
        xf = x.float()
        c = xf.shape[1]
        real = xf
        if self.row_shard is not None:
            real = xf[:, :, :self.row_shard.real(map_height(x, self.row_shard))]
        count = torch.full((1,), real.numel() // c, dtype=torch.float32, device=xf.device)
        sums = torch.cat([real.sum((0, 2, 3)), real.square().sum((0, 2, 3)), count])
        if self.group is not None:
            sums = dist_nn.all_reduce(sums, group=self.group)
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean.square(), min=0.0)
        if self.pending is None:
            self.pending = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)

    def stats(self) -> Tuple[torch.Tensor, ...]:
        """(running mean, running variance, scale, bias): the frozen
        branch's vectors."""
        return self.running_mean, self.running_var, self.weight, self.bias


def fuses(train: bool, x: torch.Tensor, *bns: BatchNorm) -> bool:
    """Whether ``bns`` applied to ``x`` (and what follows them) run as one
    op: each is frozen in this call, and no autograd graph is recorded
    (grad mode off, or nothing involved requires grad; ``x`` requires it
    wherever an earlier input or layer does)."""
    if any(bn.train_bn and train for bn in bns):
        return False
    if not torch.is_grad_enabled():
        return True
    return not (x.requires_grad
                or any(t.requires_grad for bn in bns for t in bn.stats()))


def conv_bn_relu(conv: nn.Module, bn: BatchNorm, x: torch.Tensor,
                 train: bool) -> torch.Tensor:
    """``relu(bn(conv(x)))``. The layers free the convolution's output
    before the ReLU allocates: the training step's peak memory depends on
    that order."""
    y = conv(x)
    if fuses(train, y, bn):
        return frozen_bn_cuda.frozen_bn_act_op(y, *bn.stats(), bn.eps, True)
    y = bn(y, train)
    return F.relu(y)


def set_batch_stats_group(module: nn.Module, group) -> None:
    """Make every BatchNorm of ``module`` take its batch statistics over
    ``group``'s global batch (None: the local batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def clear_batch_stats(module: nn.Module) -> None:
    """Drop every BatchNorm's pending batch statistics (before a forward)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.pending = None


@torch.no_grad()
def apply_batch_stats(module: nn.Module) -> None:
    """``running = momentum * running + (1 - momentum) * batch`` for every
    BatchNorm that normalised with batch statistics since the last
    ``clear_batch_stats``: once per train step, whatever remat recomputed."""
    for m in module.modules():
        if isinstance(m, BatchNorm) and m.pending is not None:
            for buf, stat in zip((m.running_mean, m.running_var), m.pending):
                buf.copy_(buf * m.momentum + stat * (1.0 - m.momentum))
            m.pending = None


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> RowConv2d:
    """k x k convolution padded (k - 1) // 2 on each side: the reference's
    explicit ((1, 1), (1, 1)) for 3x3, ((3, 3), (3, 3)) for 7x7, and SAME
    (no padding) for 1x1."""
    return RowConv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1, train_bn: bool = False):
        super().__init__()
        out_ch = channels * 4
        self.conv1 = conv(cin, channels, 1)
        self.bn1 = BatchNorm(channels, train_bn=train_bn)
        self.conv2 = conv(channels, channels, 3, stride)
        self.bn2 = BatchNorm(channels, train_bn=train_bn)
        self.conv3 = conv(channels, out_ch, 1)
        self.bn3 = BatchNorm(out_ch, train_bn=train_bn)
        if cin != out_ch or stride != 1:
            self.downsample = conv(cin, out_ch, 1, stride)
            self.downsample_bn = BatchNorm(out_ch, train_bn=train_bn)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv_bn_relu(self.conv1, self.bn1, x, train)
        y = conv_bn_relu(self.conv2, self.bn2, y, train)
        y = self.conv3(y)
        if self.downsample is None:
            if fuses(train, y, self.bn3):
                return frozen_bn_cuda.frozen_bn_add_relu_op(y, *self.bn3.stats(), self.bn3.eps, x)
            residual = x
        elif fuses(train, y, self.bn3, self.downsample_bn):
            return frozen_bn_cuda.frozen_bn_add_relu_op(
                y, *self.bn3.stats(), self.bn3.eps, self.downsample(x),
                *self.downsample_bn.stats(), self.downsample_bn.eps)
        # the layers in their order: bn3 frees conv3's output first
        y = self.bn3(y, train)
        if self.downsample is not None:
            residual = self.downsample_bn(self.downsample(x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Returns (C3, C4, C5) with strides (8, 16, 32). ``remat`` makes each
    bottleneck a segment of rematerialisation, as the reference's per-block
    ``nn.remat``."""

    row_shard = None

    def __init__(self, variant: str = "resnet50", width_mult: float = 1.0,
                 train_bn: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        widths = tuple(round_channels(c, width_mult) for c in (64, 128, 256, 512))
        self.conv1 = conv(3, widths[0], 7, stride=2)
        self.bn1 = BatchNorm(widths[0], train_bn=train_bn)
        self.stages = []
        cin = widths[0]
        for stage, (n_blocks, ch) in enumerate(zip(STAGE_BLOCKS[variant], widths)):
            names = []
            for blk in range(n_blocks):
                stride = 2 if (blk == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, Bottleneck(cin, ch, stride, train_bn))
                names.append(name)
                cin = ch * 4
            self.stages.append(names)
        self.out_channels = tuple(w * 4 for w in widths[1:])  # C3, C4, C5

    def forward(self, x: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor, ...]:
        x = conv_bn_relu(self.conv1, self.bn1, x, train)
        x = row_max_pool2d(x, 3, 2, 1, self.row_shard)
        taps = []
        for names in self.stages:
            for name in names:
                x = run_segment(getattr(self, name), x, train, remat=self.remat)
            taps.append(x)
        return taps[1], taps[2], taps[3]
