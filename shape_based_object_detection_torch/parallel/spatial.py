"""Image rows split across ranks: the collectives GSPMD inserts for the
reference's "model" mesh axis (``spatial_image_sharding``), written out.

Layout. Under a model axis of ``size`` ranks, a map of ``H`` rows gives
every rank ``c = ceil(H / size)`` rows, GSPMD's layout for shards that do
not split evenly: rank ``m``'s real rows are ``[m * c, min((m + 1) * c,
H))`` and the rest of its ``c`` rows are padding (a rank may hold padding
only, as P7's one row over four ranks). Every rank holds ``c`` rows, so
every all-gather moves tensors of one shape, which gloo and NCCL require.
The models' maps are square (``S x S`` images, the same kernel, stride and
padding on both axes) and the columns are never split, so a map's global
row count is its width: each op reads ``H`` from ``x.shape[3]`` and
checks that the rank holds ``ceil(H / size)`` rows.

Row fetch. A layer with kernel ``k``, stride ``s``, padding ``p`` and
dilation ``d`` computes a rank's real output rows ``[o_lo, o_hi)`` from
the input rows ``[o_lo * s - p, (o_hi - 1) * s - p + d * (k - 1) + 1)``.
``_plan`` works out, for every rank alike, which ranks own those rows
(several where the window is longer than ``c``, as SSD300's dilated conv6
on 19 rows over 4 ranks; others than the neighbours where the windows
drift from the rank's own rows, as stride-2 layers on padded maps) and
which rows lie past the global edges (the layer's padding: 0 for
convolutions, -inf for pools). ``_FetchRows`` then runs one ``all_gather``
of each rank's rows that others need, padded to one length, and assembles
the window; its backward sends each gradient row back to its owner, which
sums it, with one all-gather too. Every rank takes part in every fetch
that moves a row, forward and backward, in the same order, the global
edges and padding-only ranks included; a layer whose windows all lie in
their own rank's rows (a stride-2 1x1 on an aligned map) moves nothing and
runs no collective on any rank. A failed collective raises; nothing falls
back to computing the whole image.

Padding never leaks: a fetch reads real rows only, padding output rows
are zeros, trainable BatchNorm and the int8 abs-max count real rows only,
and ``gather_rows`` cuts each rank's padding before it concatenates, so
the heads' gathered outputs are the unsplit ones, in the same order.

``RowConv2d`` (the models' convolution), ``row_max_pool2d`` and
``row_upsample_nearest`` are the ops on a rank's rows; ``set_row_shard``
puts a shard on every module of a detector that splits.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(eq=False)
class RowShard:
    """This rank's place on the model axis: rank ``index`` of ``size`` in
    the model ``group``. ``exchanges`` and ``halo_bytes`` count the forward
    row fetches that ran a collective (recomputations under remat
    included) and the bytes of other ranks' rows they used; ``moved_bytes``
    the bytes the all-gathers brought into this rank (every other rank's
    slab, padded to one length)."""

    group: Optional[dist.ProcessGroup]
    index: int
    size: int
    exchanges: int = 0
    halo_bytes: int = 0
    moved_bytes: int = 0

    def per_rank(self, height: int) -> int:
        """The rows every rank holds of a map of ``height`` rows."""
        return _ceil_div(height, self.size)

    def rows(self, height: int, index: Optional[int] = None) -> slice:
        """Rank ``index``'s (default: this rank's) real rows of a map of
        ``height`` rows, in global row numbers; empty for a rank that holds
        padding only."""
        c, m = self.per_rank(height), self.index if index is None else index
        return slice(min(m * c, height), min((m + 1) * c, height))

    def real(self, height: int, index: Optional[int] = None) -> int:
        """How many of rank ``index``'s rows of a map of ``height`` rows are
        real."""
        r = self.rows(height, index)
        return r.stop - r.start

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full NCHW tensor: a view where the rows
        split evenly, else a copy padded with zero rows to ``per_rank``."""
        height = x.shape[2]
        part = x[:, :, self.rows(height)]
        pad = self.per_rank(height) - part.shape[2]
        return torch.cat([part, part.new_zeros((*part.shape[:2], pad, part.shape[3]))],
                         2) if pad else part

    def reset_counts(self) -> None:
        self.exchanges = self.halo_bytes = self.moved_bytes = 0


def map_height(x: torch.Tensor, shard: RowShard) -> int:
    """The global row count of the square map whose rows ``x`` (NCHW, this
    rank's) holds: its width. Raises ValueError unless ``x`` holds
    ``ceil(width / size)`` rows, as the layout gives every rank."""
    height = x.shape[3]
    if x.shape[2] != shard.per_rank(height):
        raise ValueError(
            f"under a row shard of {shard.size} ranks a rank holds "
            f"{shard.per_rank(height)} rows of a {height}-row map (RowShard.split), "
            f"not {x.shape[2]}")
    return height


def check_split_input(images: torch.Tensor, shard: Optional[RowShard],
                      image_size: int) -> None:
    """Raise ValueError unless ``images`` are this rank's rows of
    ``image_size``-pixel images (``RowShard.split``): a full tensor passed
    to a split forward fails here, before any collective."""
    if shard is not None and tuple(images.shape[2:]) != (shard.per_rank(image_size),
                                                          image_size):
        raise ValueError(f"under a row shard of {shard.size} ranks the forward takes "
                         f"{shard.per_rank(image_size)} rows of each {image_size}-px "
                         f"image (RowShard.split), not {tuple(images.shape[2:])}")


# ---------------------------------------------------------------------------
# The row fetch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Plan:
    """One fetch for every rank of a model group of ``size``: each rank's
    window as segments ``(source, start, stop)`` (source -1: fill rows,
    ``stop - start`` of them; this rank's index: its own local rows; another
    rank's index: rows of that rank's slab), the local ranges each rank
    sends (``send``) and the slab length ``width`` (0: no collective)."""

    segments: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    send: Tuple[Tuple[Tuple[int, int], ...], ...]
    width: int


@functools.lru_cache(maxsize=4096)
def _plan(height: int, size: int, windows: Tuple[Tuple[int, int], ...]) -> _Plan:
    """The fetch of global rows ``windows[m] = [lo, hi)`` into rank ``m``
    for a map of ``height`` rows in the ceil layout; rows outside ``[0,
    height)`` are fill."""
    c = _ceil_div(height, size)
    own = [(min(j * c, height), min((j + 1) * c, height)) for j in range(size)]
    wanted = [[] for _ in range(size)]  # per owner: the global ranges others need
    for i, (lo, hi) in enumerate(windows):
        for j, (a, b) in enumerate(own):
            a, b = max(lo, a), min(hi, b)
            if j != i and a < b:
                wanted[j].append((a, b))
    send, offsets = [], []
    for j, ranges in enumerate(wanted):
        merged = []
        for a, b in sorted(ranges):
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        at, table = 0, []
        for a, b in merged:
            table.append((a, b, at))
            at += b - a
        offsets.append(table)
        send.append(tuple((a - j * c, b - j * c) for a, b in merged))
    segments = []
    for i, (lo, hi) in enumerate(windows):
        segs, g = [], lo
        while g < hi:
            if g < 0 or g >= height:
                stop = min(hi, 0) if g < 0 else hi
                segs.append((-1, 0, stop - g))
            else:
                j = g // c
                stop = min(hi, own[j][1])
                if j == i:
                    segs.append((i, g - i * c, stop - i * c))
                else:
                    a, _, at = next(t for t in offsets[j] if t[0] <= g < t[1])
                    segs.append((j, at + g - a, at + stop - a))
            g = stop
        segments.append(tuple(segs))
    width = max(sum(b - a for a, b in s) for s in send)
    return _Plan(tuple(segments), tuple(send), width)


def _gather(slab: torch.Tensor, shard: RowShard) -> List[torch.Tensor]:
    parts = [torch.empty_like(slab) for _ in range(shard.size)]
    dist.all_gather(parts, slab.contiguous(), group=shard.group)
    return parts


def _slab(x: torch.Tensor, ranges, width: int) -> torch.Tensor:
    """``x``'s rows in ``ranges``, then zero rows up to ``width``."""
    rows = [x[:, :, a:b] for a, b in ranges]
    n = sum(b - a for a, b in ranges)
    if n < width:
        rows.append(x.new_zeros((*x.shape[:2], width - n, x.shape[3])))
    return torch.cat(rows, 2)


def _channels_last(x: torch.Tensor) -> bool:
    return x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
        memory_format=torch.channels_last)


def _like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` in ``x``'s memory format (channels_last activations stay so)."""
    return t.contiguous(memory_format=torch.channels_last) if _channels_last(x) else t


def _assemble(x: torch.Tensor, segments, parts, fill: float, m: int) -> torch.Tensor:
    """The window of ``segments`` from ``x`` (this rank's rows), the
    gathered ``parts`` and fill rows. Every window holds exactly one slice
    of ``x`` (empty where it reads none of its own rows), so the graph has
    the same nodes on every rank."""
    b, ch, _, w = x.shape
    pieces, own = [], None
    for src, a, z in segments:
        if src < 0:
            pieces.append(x.new_full((b, ch, z - a, w), fill))
        elif src == m:
            own = x[:, :, a:z]
            pieces.append(own)
        else:
            pieces.append(parts[src][:, :, a:z])
    if own is None:
        pieces.append(x[:, :, :0])
    return torch.cat(pieces, 2)


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, shard, fill):
        m, width = shard.index, plan.width
        ctx.plan, ctx.shard, ctx.x_shape = plan, shard, x.shape
        ctx.channels_last = _channels_last(x)
        parts = _gather(_slab(x, plan.send[m], width), shard)
        b, ch, _, w = x.shape
        row_bytes = b * ch * w * x.element_size()
        shard.exchanges += 1
        shard.halo_bytes += row_bytes * sum(z - a for src, a, z in plan.segments[m]
                                            if src not in (-1, m))
        shard.moved_bytes += (shard.size - 1) * width * row_bytes
        return _assemble(x, plan.segments[m], parts, fill, m)

    @staticmethod
    def backward(ctx, g):
        plan, shard = ctx.plan, ctx.shard
        m, width = shard.index, plan.width
        b, ch, _, w = g.shape
        fmt = torch.channels_last if ctx.channels_last else torch.contiguous_format
        grad = torch.empty(ctx.x_shape, dtype=g.dtype, device=g.device,
                           memory_format=fmt).zero_()
        # this rank's gradient of every rank's slab, in slab order
        outgoing = g.new_zeros((b, ch, shard.size * width, w))
        at = 0
        for src, a, z in plan.segments[m]:
            piece = g[:, :, at:at + z - a]
            at += z - a
            if src == m:
                grad[:, :, a:z] += piece
            elif src >= 0:
                outgoing[:, :, src * width + a:src * width + z] += piece
        received = _gather(outgoing, shard)
        back = sum(r[:, :, m * width:(m + 1) * width]
                   for i, r in enumerate(received) if i != m)
        at = 0
        for a, z in plan.send[m]:  # each rank's gradient of my rows, summed
            grad[:, :, a:z] += back[:, :, at:at + z - a]
            at += z - a
        return grad, None, None, None


def _fetch(x: torch.Tensor, height: int, windows, shard: RowShard,
           fill: float) -> torch.Tensor:
    """Global rows ``windows[shard.index]`` of the map whose rows ``x``
    holds, ``fill`` past its edges: one all-gather where any rank needs
    another's rows, none where every window lies in its own rank's rows."""
    plan = _plan(height, shard.size, windows)
    if plan.width == 0:
        return _like(x, _assemble(x, plan.segments[shard.index], None, fill, shard.index))
    return _like(x, _FetchRows.apply(x, plan, shard, fill))


def halo_exchange(x: torch.Tensor, top: int, bottom: int, shard: RowShard,
                  fill: float = 0.0) -> torch.Tensor:
    """``x`` (this rank's rows of a square NCHW map) with the ``top`` global
    rows above them and the ``bottom`` rows below, from whichever ranks own
    them; ``fill`` rows past the map's edges (its padding rows included).
    Its gradient goes back to the ranks that own those rows."""
    height = map_height(x, shard)
    c = shard.per_rank(height)
    windows = tuple((j * c - top, (j + 1) * c + bottom) for j in range(shard.size))
    return _fetch(x, height, windows, shard, fill)


# ---------------------------------------------------------------------------
# The row ops
# ---------------------------------------------------------------------------


def _out_rows(n: int, k: int, s: int, p: int, d: int = 1, ceil_mode: bool = False) -> int:
    """Output rows of a convolution or pool over ``n`` rows, as PyTorch
    counts them (in ceil mode the last window starts inside the input or
    its leading padding)."""
    span = n + 2 * p - d * (k - 1) - 1
    out = (_ceil_div(span, s) if ceil_mode else span // s) + 1
    if ceil_mode and (out - 1) * s >= n + p:
        out -= 1
    return out


@functools.lru_cache(maxsize=4096)
def _op_windows(height: int, size: int, k: int, s: int, p: int, d: int,
                ceil_mode: bool) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """The output rows and, per rank, the input rows its real output rows
    read; a rank with no real output row reads ``d * (k - 1) + 1`` fill
    rows (one output row, computed and dropped, so that every rank runs the
    same ops)."""
    h_out = _out_rows(height, k, s, p, d, ceil_mode)
    c_out = _ceil_div(h_out, size)
    span = d * (k - 1) + 1
    windows = []
    for j in range(size):
        lo, hi = j * c_out, min((j + 1) * c_out, h_out)
        windows.append((lo * s - p, (hi - 1) * s - p + span) if lo < hi
                       else (height, height + span))
    return h_out, tuple(windows)


def _pad_rows(y: torch.Tensor, real: int, rows: int) -> torch.Tensor:
    """``y``'s first ``real`` rows, then zero rows up to ``rows``: the same
    slice and concatenation on every rank."""
    y = y[:, :, :real]
    return torch.cat([y, y.new_zeros((*y.shape[:2], rows - real, y.shape[3]))], 2)


def row_apply(x: torch.Tensor, shard: RowShard, kernel: int, stride: int, padding: int,
              dilation: int, op, fill: float = 0.0, ceil_mode: bool = False) -> torch.Tensor:
    """A layer with this row geometry on this rank's rows: ``op`` (the
    layer with no row padding) on the window of the rank's real output
    rows, padded to the layout's rows with zeros. A stride-1 1x1 with no
    padding is row-local: ``op(x)``."""
    if (kernel, stride, padding) == (1, 1, 0):
        return op(x)
    height = map_height(x, shard)
    h_out, windows = _op_windows(height, shard.size, kernel, stride, padding, dilation,
                                 ceil_mode)
    y = op(_fetch(x, height, windows, shard, fill))
    return _pad_rows(y, shard.real(h_out), shard.per_rank(h_out))


def row_conv2d(conv: nn.Conv2d, x: torch.Tensor, shard: Optional[RowShard]) -> torch.Tensor:
    """``conv(x)`` (a zero-padded ``nn.Conv2d``) on this rank's rows: the
    unsplit convolution's rows of this rank, for any kernel, stride,
    padding and dilation. Without a shard, the plain convolution; a 1x1
    stride-1 convolution is row-local."""
    if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
        raise ValueError(f"row_conv2d takes explicitly zero-padded convolutions; got {conv}")
    if shard is None:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                        conv.dilation, conv.groups)
    return row_apply(
        x, shard, conv.kernel_size[0], conv.stride[0], conv.padding[0], conv.dilation[0],
        lambda win: F.conv2d(win, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                             conv.dilation, conv.groups))


class RowConv2d(nn.Conv2d):
    """The models' ``nn.Conv2d``: with ``row_shard`` set, ``row_conv2d``
    on this rank's rows (forward hooks see the rank's rows), else the
    plain convolution. The same parameters and state-dict names."""

    row_shard: Optional[RowShard] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_conv2d(self, x, self.row_shard)


def row_max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int,
                   shard: Optional[RowShard], ceil_mode: bool = False) -> torch.Tensor:
    """``F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)`` on
    this rank's rows; rows past the map's edges are -inf, as the pool's own
    padding."""
    if shard is None:
        return F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)
    return row_apply(x, shard, kernel, stride, padding, 1,
                     lambda win: F.max_pool2d(win, kernel, stride, (0, padding),
                                              ceil_mode=ceil_mode),
                     float("-inf"), ceil_mode)


@functools.lru_cache(maxsize=1024)
def _nearest_sources(n_in: int, n_out: int) -> Tuple[int, ...]:
    """The input row of each output row of a nearest-neighbour resize with
    half-pixel centres, as ``F.interpolate(mode="nearest-exact")`` picks
    it."""
    rows = torch.arange(n_in, dtype=torch.float32).view(1, 1, n_in, 1)
    picked = F.interpolate(rows, size=(n_out, 1), mode="nearest-exact")
    return tuple(int(v) for v in picked.flatten().tolist())


def row_upsample_nearest(x: torch.Tensor, h: int, w: int,
                         shard: Optional[RowShard]) -> torch.Tensor:
    """``F.interpolate(x, (h, w), mode="nearest-exact")`` on this rank's
    rows: the input rows its real output rows pick (from whichever ranks own
    them), then each output row's pick and the columns' resize."""
    if shard is None:
        return F.interpolate(x, size=(h, w), mode="nearest-exact")
    height = map_height(x, shard)
    src = _nearest_sources(height, h)
    rows = shard.rows(h)
    windows = []
    for j in range(shard.size):
        r = shard.rows(h, j)
        windows.append((src[r.start], src[r.stop - 1] + 1) if r.start < r.stop
                       else (height, height + 1))
    win = _fetch(x, height, tuple(windows), shard, 0.0)
    picks = ([src[i] - src[rows.start] for i in range(rows.start, rows.stop)]
             if rows.start < rows.stop else [0])
    y = win.index_select(2, torch.tensor(picks, device=x.device))
    # the rows are already at their size: nearest-exact keeps them
    y = F.interpolate(y, size=(len(picks), w), mode="nearest-exact")
    return _pad_rows(y, shard.real(h), shard.per_rank(h))


# ---------------------------------------------------------------------------
# The heads' outputs
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, *parts):
        ctx.shard, ctx.shapes = shard, [p.shape for p in parts]
        flat = torch.cat([p.reshape(-1) for p in parts])
        gathered = _gather(flat, shard)
        out, offset = [], 0
        for p in parts:
            height = p.shape[2]
            n = p.numel()
            out.append(torch.cat([
                g[offset:offset + n].view(p.shape)[:, :shard.real(height, j)]
                for j, g in enumerate(gathered)], 1))
            offset += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        # every rank of the model group computes the same loss on the
        # gathered tensors, so each keeps its own real rows' block of the
        # gradient (its padding rows get none): a sum over the group would
        # count it size times
        shard = ctx.shard
        out = []
        for g, shape in zip(grads, ctx.shapes):
            r = shard.rows(shape[2])
            block = g[:, r]
            pad = shape[1] - block.shape[1]
            out.append(torch.cat([block, block.new_zeros((shape[0], pad, *shape[2:]))], 1)
                       if pad else block)
        return (None, *out)


def gather_rows(parts: Sequence[torch.Tensor], shard: RowShard) -> List[torch.Tensor]:
    """Each ``(B, c, W, ...)`` part (this rank's rows of a square map, NHWC:
    a head's output before it is flattened) as the whole map ``(B, W, W,
    ...)``: every rank's real rows, in rank order, on every rank of the
    model group; padding rows are cut. One all-gather for all parts, which
    share one dtype. Backward keeps this rank's real rows of each
    gradient."""
    if len({p.dtype for p in parts}) != 1:
        raise ValueError("gather_rows takes parts of one dtype")
    for p in parts:
        if p.shape[1] != shard.per_rank(p.shape[2]):
            raise ValueError(f"a part of {p.shape[1]} rows is not a rank's rows of a "
                             f"{p.shape[2]}-row map over {shard.size} ranks")
    return list(_GatherRows.apply(shard, *parts))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def set_row_shard(module: nn.Module, shard: Optional[RowShard]) -> None:
    """Make ``module`` (a detector, float or int8) compute on one rank's
    rows of its images, with its rows fetched from the ranks of ``shard``'s
    model group (None: the whole images, as unsplit): every submodule that
    has a ``row_shard`` takes ``shard``."""
    for m in module.modules():
        if hasattr(m, "row_shard"):
            m.row_shard = shard


def row_shard_of(module: nn.Module) -> Optional[RowShard]:
    """The row shard set on ``module`` (None when it computes whole
    images)."""
    return next((m.row_shard for m in module.modules()
                 if getattr(m, "row_shard", None) is not None), None)


def copy_module(module: nn.Module, shard: Optional[RowShard] = None) -> nn.Module:
    """A deep copy of ``module`` whose row shard is ``shard`` (None: the
    unsplit module of the same weights). The shard, which holds a process
    group, is shared, not copied."""
    current = row_shard_of(module)
    memo = {} if current is None else {id(current): current}
    out = copy.deepcopy(module, memo)
    set_row_shard(out, shard)
    return out
