"""Image rows split across ranks: the collectives GSPMD inserts for the
reference's "model" mesh axis (``spatial_image_sharding``), written out.

Under a model axis of ``size`` ranks, rank ``index`` of a model group holds
rows ``[index * H / size, (index + 1) * H / size)`` of every feature map of
the same images. A layer that reads neighbouring rows gets them by a halo
exchange inside the model group (``halo_exchange``); ``row_conv2d`` and
``row_max_pool2d`` are the convolution and the stem's max-pool on a rank's
rows, equal to the unsplit layer's rows. ``gather_rows`` assembles the
heads' per-rank outputs into the whole image's, in the unsplit order.

Every exchange is an ``all_gather`` of each rank's boundary slab over the
model group: one primitive that NCCL, gloo on CUDA tensors (several ranks
sharing a card) and gloo on the CPU all serve. It moves ``size - 1`` slabs
into each rank where point-to-point would move two, and the slabs are a
few rows. Every rank takes part in every exchange, forward and backward,
the global edges included, so the collectives run in the same order on
every rank. A failed collective raises; nothing falls back to computing
the whole image.

The split is even: ``H`` must be divisible by the coarsest stride times
``size`` (``check_rows``), so each halo comes from one neighbour and each
stride-2 layer keeps its rank's rows aligned. GSPMD pads uneven shards; the
port raises for them (ROADMAP.md §1 item 8).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

ROADMAP_UNEVEN = "ROADMAP.md §1 item 8"
ROADMAP_TIERS = "ROADMAP.md §1 item 9"


def not_under_model_axis(what: str, item: str = ROADMAP_TIERS):
    """The error of a path that has no counterpart under a model axis."""
    return NotImplementedError(
        f"{what} under model_parallelism > 1 (image rows split across ranks) is not "
        f"ported ({item})")


def refuse_row_shard(module: nn.Module, what: str) -> None:
    """Raise ``not_under_model_axis(what)`` when ``module`` computes on a
    rank's rows (a row shard is set on it)."""
    if any(getattr(m, "row_shard", None) is not None for m in module.modules()):
        raise not_under_model_axis(what)


@dataclasses.dataclass(eq=False)
class RowShard:
    """This rank's place on the model axis: rank ``index`` of ``size`` in
    the model ``group``. ``exchanges`` and ``halo_bytes`` count the forward
    halo exchanges it took part in (recomputations under remat included)
    and the bytes of its neighbours' rows it received in them;
    ``moved_bytes`` the bytes the all-gathers brought into it (every other
    rank's slab)."""

    group: Optional[dist.ProcessGroup]
    index: int
    size: int
    exchanges: int = 0
    halo_bytes: int = 0
    moved_bytes: int = 0

    def rows(self, height: int) -> slice:
        """This rank's rows of a map of ``height`` rows."""
        if height % self.size:
            raise ValueError(f"{height} rows do not split evenly over {self.size} ranks "
                             f"({ROADMAP_UNEVEN})")
        n = height // self.size
        return slice(self.index * n, (self.index + 1) * n)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full NCHW tensor (a view)."""
        return x[:, :, self.rows(x.shape[2])]

    def reset_counts(self) -> None:
        self.exchanges = self.halo_bytes = self.moved_bytes = 0


def check_rows(image_size: int, coarsest_stride: int, size: int) -> None:
    """Raise ValueError unless ``image_size`` splits evenly over ``size``
    ranks at every stride up to ``coarsest_stride``."""
    if image_size % (coarsest_stride * size):
        raise ValueError(
            f"image_size {image_size} is not divisible by the coarsest stride "
            f"{coarsest_stride} times model_parallelism={size}: its rows do not split "
            f"evenly at every level ({ROADMAP_UNEVEN})")


def _exchange(first: torch.Tensor, last: torch.Tensor, shard: RowShard):
    """Every rank gives its ``first`` and ``last`` slabs (each (B, C, r, W),
    the same shapes on every rank); returns ``(the previous rank's last,
    the next rank's first)``, None past the global edges."""
    n_first = first.shape[2]
    slab = torch.cat([first, last], 2).contiguous()
    parts = [torch.empty_like(slab) for _ in range(shard.size)]
    dist.all_gather(parts, slab, group=shard.group)
    m = shard.index
    prev_last = parts[m - 1][:, :, n_first:] if m > 0 else None
    next_first = parts[m + 1][:, :, :n_first] if m + 1 < shard.size else None
    return prev_last, next_first


def _like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` in ``x``'s memory format (channels_last activations stay so)."""
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, shard, fill):
        h = x.shape[2]
        if h < max(top, bottom):
            raise ValueError(f"a halo of {max(top, bottom)} rows needs at least as many rows "
                             f"per rank; this rank holds {h} ({ROADMAP_UNEVEN})")
        ctx.top, ctx.bottom, ctx.shard = top, bottom, shard
        up, down = _exchange(x[:, :, :bottom], x[:, :, h - top:], shard)
        b, c, _, w = x.shape
        row_bytes = b * c * w * x.element_size()
        shard.exchanges += 1
        shard.moved_bytes += (shard.size - 1) * (top + bottom) * row_bytes
        shard.halo_bytes += ((up is not None) * top + (down is not None) * bottom) * row_bytes
        if up is None:
            up = x.new_full((b, c, top, w), fill)
        if down is None:
            down = x.new_full((b, c, bottom, w), fill)
        return _like(x, torch.cat([up, x, down], 2))

    @staticmethod
    def backward(ctx, g):
        top, bottom, shard = ctx.top, ctx.bottom, ctx.shard
        h = g.shape[2] - top - bottom
        g_up, g_mid, g_down = g.split([top, h, bottom], 2)
        # g_up belongs to the previous rank's last rows, g_down to the next
        # rank's first: each goes back to its owner, which adds it
        from_prev, from_next = _exchange(g_up, g_down, shard)
        grad = g_mid.clone()
        if from_prev is not None:  # the previous rank's g_down: my first rows
            grad[:, :, :bottom] += from_prev
        if from_next is not None:  # the next rank's g_up: my last rows
            grad[:, :, h - top:] += from_next
        return grad, None, None, None, None


def halo_exchange(x: torch.Tensor, top: int, bottom: int, shard: RowShard,
                  fill: float = 0.0) -> torch.Tensor:
    """``x`` (this rank's rows, NCHW) with the previous rank's last ``top``
    rows above it and the next rank's first ``bottom`` rows below; past the
    global edges ``fill`` rows (the layer's own padding). Its gradient goes
    back to the ranks that own those rows."""
    return _HaloExchange.apply(x, top, bottom, shard, fill)


def row_conv2d(conv: nn.Conv2d, x: torch.Tensor, shard: Optional[RowShard]) -> torch.Tensor:
    """``conv(x)`` on this rank's rows: a halo of ``p`` rows above and
    ``k - p - s`` below, then the convolution with no row padding. Equal to
    this rank's rows of the unsplit convolution when the rows split evenly
    at its stride. Without a shard, ``conv(x)``; a 1x1 is row-local."""
    if shard is None:
        return conv(x)
    if not isinstance(conv, nn.Conv2d):  # an int8 tier's convolution
        raise not_under_model_axis(type(conv).__name__)
    if conv.kernel_size[0] == 1:
        return conv(x)
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    if conv.dilation[0] != 1 or conv.padding_mode != "zeros" or k - p - s < 0:
        raise ValueError(f"row_conv2d takes zero-padded undilated convolutions with "
                         f"k - p - s >= 0; got {conv}")
    xp = halo_exchange(x, p, k - p - s, shard)
    return F.conv2d(xp, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                    conv.dilation, conv.groups)


def row_max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int,
                   shard: Optional[RowShard]) -> torch.Tensor:
    """``F.max_pool2d(x, kernel, stride, padding)`` on this rank's rows; the
    global top edge pads with -inf, as the pool's own padding."""
    if shard is None:
        return F.max_pool2d(x, kernel, stride=stride, padding=padding)
    xp = halo_exchange(x, padding, kernel - padding - stride, shard, fill=float("-inf"))
    return F.max_pool2d(xp, kernel, stride=stride, padding=(0, padding))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, *parts):
        ctx.shard, ctx.counts = shard, [p.shape[1] for p in parts]
        flat = torch.cat([p.reshape(-1) for p in parts])
        gathered = [torch.empty_like(flat) for _ in range(shard.size)]
        dist.all_gather(gathered, flat, group=shard.group)
        out, offset = [], 0
        for p in parts:
            n = p.numel()
            out.append(torch.cat([g[offset:offset + n].view(p.shape) for g in gathered], 1))
            offset += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        # every rank of the model group computes the same loss on the
        # gathered tensors, so each keeps its own block of the gradient:
        # a sum over the group would count it size times
        m = ctx.shard.index
        return (None, *(g[:, m * n:(m + 1) * n] for g, n in zip(grads, ctx.counts)))


def gather_rows(parts: Sequence[torch.Tensor], shard: RowShard) -> List[torch.Tensor]:
    """Each ``(B, n, ...)`` part (this rank's rows of a head output, in
    (row, column, anchor) order) concatenated along dim 1 with the other
    ranks' in rank order: the whole map's output, on every rank of the model
    group. One all-gather for all parts, which share one dtype. Backward
    keeps this rank's slice of each gradient."""
    if len({p.dtype for p in parts}) != 1:
        raise ValueError("gather_rows takes parts of one dtype")
    return list(_GatherRows.apply(shard, *parts))
