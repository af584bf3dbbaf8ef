"""Data parallelism and the model axis over a process group (port of the
JAX package's ``parallel/mesh.py``).

The reference lays a ``jax.sharding.Mesh`` over every device and lets XLA
insert the gradient all-reduce. The port runs one process per card, as
PyTorch does (``torchrun --nproc_per_node``), joined in a
``torch.distributed`` process group: NCCL on the card, gloo on the CPU.
A ``Mesh`` records the group, this process's rank, the world size and its
device. Each rank loads its rows of the global batch (the reference's
``batch_sharding``: the global batch is the ranks' batches in rank order,
as ``jax.make_array_from_process_local_data`` assembles it), every rank
starts from rank 0's state (``broadcast_state``, the reference's
``replicated_sharding``), and the train step all-reduces what the
reference's single program sums over the global batch: the gradients, the
number of positives and BatchNorm's batch statistics.

With ``MeshConfig.model_parallelism = mp > 1`` the ranks form the
reference's 2-D mesh ``reshape(world // mp, mp)``: rank ``r = d * mp + m``
has data index ``d`` and model index ``m``. The ``mp`` ranks of a data
index load the same images, and rank ``m`` computes rows ``[m * c, (m +
1) * c)`` of every feature map of ``H`` rows, ``c = ceil(H / mp)``, the
rows past ``H`` padding (``spatial_image_sharding``, the reference's
config #5 1024 px lever; the row exchanges GSPMD inserts are written out
in ``parallel/spatial.py``). The data group (ranks of one
``m``) sums what the data indexes share, the model group (ranks of one
``d``) exchanges rows, and the world sums the gradients and BatchNorm's
statistics.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from shape_based_object_detection_torch.config import MeshConfig, ModelConfig
from shape_based_object_detection_torch.parallel.spatial import RowShard
from shape_based_object_detection_torch.utils import metrics as trace
from shape_based_object_detection_torch.utils.device import resolve_device

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place in the group: ``group`` is None in a single
    process (no collective runs), else the world's process group, in which
    this process is ``rank`` of ``world`` and computes on ``device``. With
    a model axis (``model_parallelism`` > 1) ``data_group`` holds the ranks
    of this rank's model index (None when the data axis has one index) and
    ``model_group`` those of its data index."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device
    model_parallelism: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallelism

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallelism

    @property
    def data_size(self) -> int:
        """The data axis's size: the ranks that load different images."""
        return self.world // self.model_parallelism

    @property
    def data_axis_group(self) -> Optional[dist.ProcessGroup]:
        """The group over which the data indexes sum and gather: the world
        without a model axis, None when the data axis has one index."""
        return self.group if self.model_parallelism == 1 else self.data_group

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (the reference's
        ``batch_sharding``): the data indexes' slices in order; the ranks of
        one data index share its rows."""
        per_index = make_mesh_for_batch(global_batch, self,
                                        MeshConfig(model_parallelism=self.model_parallelism))
        return slice(self.data_index * per_index, (self.data_index + 1) * per_index)


def single_process(device=None) -> Mesh:
    """The mesh of a process that trains alone: no group, rank 0 of 1."""
    return Mesh(None, 0, 1, resolve_device(device))


def _local_rank(process_id: int) -> int:
    """The card of this process: torchrun's LOCAL_RANK, else the process id
    modulo the cards of this host (processes laid out host by host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(1, torch.cuda.device_count())


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S,
                         cfg: MeshConfig = MeshConfig()) -> Mesh:
    """Join the group and return this process's ``Mesh`` over it, with
    ``cfg.model_parallelism`` as its model axis (``make_mesh``).

    With ``num_processes > 1`` the group meets at ``tcp://{coordinator}``
    (``host:port``; process 0 listens there) as ``process_id``. Without it,
    under ``torchrun`` (``WORLD_SIZE`` and ``RANK`` in the environment), the
    group forms from torchrun's environment, at any world size, 1 included.
    Otherwise the process trains alone and no group forms.

    On the card (``device`` None or "cuda") the backend is NCCL and each
    process takes card ``LOCAL_RANK`` (else ``process_id`` modulo the
    host's cards) before the group forms; with ``device="cpu"`` it is gloo.
    A rank waits at most ``timeout_s`` for the others, to form the group
    and in each collective; past it the call raises. A group that cannot
    form raises: nothing falls back to a single process."""
    from_flags = num_processes is not None and num_processes > 1
    from_env = not from_flags and "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if not (from_flags or from_env):
        _model_axis(1, cfg)
        return single_process(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    dev = torch.device("cuda" if device is None else device)
    if from_flags:
        if not coordinator:
            raise ValueError("num_processes > 1 needs a coordinator address host:port")
        if process_id is None or not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
        rank, world = process_id, num_processes
        init = f"tcp://{coordinator}"
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    _model_axis(world, cfg)  # before the group forms: every rank raises alike
    if dev.type == "cuda":
        resolve_device("cuda")  # raises without a card
        torch.cuda.set_device(_local_rank(rank))
        dev = resolve_device("cuda")
        backend = "nccl"
    else:
        backend = "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return make_mesh(dev, cfg)


def shutdown(mesh: Mesh) -> None:
    """Leave the group ``initialize_multihost`` formed (no-op alone)."""
    if mesh.distributed and dist.is_initialized():
        dist.destroy_process_group()


def _model_axis(world: int, cfg: MeshConfig) -> int:
    """``cfg``'s model axis size, which must divide ``world`` (the
    reference asserts it; flooring would idle ranks)."""
    mp = max(1, cfg.model_parallelism)
    if world % mp:
        raise ValueError(f"model_parallelism={mp} does not divide the world size {world}")
    return mp


def make_mesh(device=None, cfg: MeshConfig = MeshConfig()) -> Mesh:
    """The mesh of this process over the initialized default group, if
    any, else a single process, with ``cfg.model_parallelism`` ranks on
    its model axis, laid out as the reference's ``reshape(world // mp,
    mp)``. Every rank must call it, in the same order as the others: with
    ``mp > 1`` it makes the data and model subgroups (``dist.new_group``
    for each, on every rank). Raises ValueError when ``mp`` does not
    divide the world."""
    if not dist.is_initialized():
        _model_axis(1, cfg)
        return single_process(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    mp = _model_axis(world, cfg)
    dev = resolve_device(device)
    if mp == 1:
        return Mesh(dist.group.WORLD, rank, world, dev)
    n_data = world // mp
    data_group = model_group = None
    for m in range(mp):  # the data groups: ranks of one model index
        g = dist.new_group([d * mp + m for d in range(n_data)])
        if m == rank % mp and n_data > 1:
            data_group = g
    for d in range(n_data):  # the model groups: ranks of one data index
        g = dist.new_group([d * mp + m for m in range(mp)])
        if d == rank // mp:
            model_group = g
    return Mesh(dist.group.WORLD, rank, world, dev, mp, data_group, model_group)


def make_mesh_for_batch(global_batch: int, mesh: Optional[Mesh] = None,
                        cfg: MeshConfig = MeshConfig()) -> int:
    """The per-data-index batch of ``global_batch`` over ``mesh`` (default:
    this process's) with ``cfg.model_parallelism`` ranks on the model axis:
    ``global_batch / (world / mp)``. Raises when the model axis does not
    divide the world, and when the data axis does not divide the global
    batch: the group cannot shrink across processes."""
    mesh = make_mesh() if mesh is None else mesh
    mp = _model_axis(mesh.world, cfg)
    n_data = mesh.world // mp
    if global_batch % n_data:
        raise ValueError(
            f"global batch {global_batch} is not divisible by the data-axis size {n_data} "
            f"(world size {mesh.world} / model_parallelism={mp}); adjust data.batch_size "
            "— the group cannot be shrunk across processes")
    return global_batch // n_data


def spatial_image_sharding(mesh: Mesh, cfg: MeshConfig = MeshConfig(),
                           model: Optional[ModelConfig] = None) -> RowShard:
    """The reference's images with the batch over "data" and the rows over
    "model": this rank's place on the model axis, whose ``split`` takes its
    rows of a full NCHW tensor. ``cfg`` names the axes in the reference and
    is not read here: the axis is the mesh's. Any image size splits (the
    ranks' last rows are padding where it does not split evenly); with
    ``model``, a size the model itself refuses raises, as SSD's
    ``ssd_feature_sizes`` does where a map would fall under one row."""
    if model is not None:
        from shape_based_object_detection_torch.ops import anchors as anchor_lib

        if model.family == "ssd":
            anchor_lib.ssd_feature_sizes(model.image_size)
    return RowShard(mesh.model_group, mesh.model_index, mesh.model_parallelism)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _memory_order(t: torch.Tensor) -> List[int]:
    """t's dimensions from the largest stride to the smallest: for a dense
    tensor (contiguous, channels_last, ...) ``t.permute(order)`` is
    contiguous, so it flattens without a copy."""
    return sorted(range(t.dim()), key=lambda d: -t.stride(d))


def all_reduce_(tensors: List[torch.Tensor], mesh: Mesh, data_axis: bool = False) -> None:
    """Sum ``tensors`` over the world (``data_axis``: over the data axis),
    in place, as one all-reduce of one flat buffer per dtype (a single
    process, or a data axis of one index: nothing to do). Each tensor is
    packed in its own memory order and unpacked by one multi-tensor copy, so
    the packing costs two copies of the bytes and a few launches. While
    tracing, the pack, the call and the unpack are the span
    ``comm.all_reduce``, and each flat buffer's bytes add to the counter
    ``comm.all_reduce_bytes``."""
    pg = mesh.data_axis_group if data_axis else mesh.group
    if pg is None or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with trace.span("comm.all_reduce"):
        for group in by_dtype.values():
            orders = [_memory_order(t) for t in group]
            flat = torch.cat([t.permute(o).reshape(-1) for t, o in zip(group, orders)])
            count_bytes(flat)
            dist.all_reduce(flat, group=pg)
            parts, offset = [], 0
            for t, o in zip(group, orders):
                shape = [t.shape[d] for d in o]
                back = sorted(range(t.dim()), key=o.__getitem__)
                parts.append(flat[offset:offset + t.numel()].view(shape).permute(back))
                offset += t.numel()
            torch._foreach_copy_(group, parts)


def count_bytes(t: torch.Tensor) -> None:
    """While tracing, add the bytes of ``t``, a buffer about to be
    all-reduced, to the counter ``comm.all_reduce_bytes``."""
    if trace.tracing():
        trace.count("comm.all_reduce_bytes", t.numel() * t.element_size())


def all_gather_rows(tensors: Iterable[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor's rows from every data index, concatenated in order: the
    reference's replicated output (``out_sharding``). Every rank passes
    tensors of the same shapes (the ranks of one data index the same
    values); bool tensors travel as uint8."""
    tensors = list(tensors)
    group = mesh.data_axis_group
    if group is None:
        return tensors
    out = []
    for t in tensors:
        x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.data_size)]
        dist.all_gather(parts, x, group=group)
        y = torch.cat(parts)
        out.append(y.bool() if t.dtype == torch.bool else y)
    return out


def all_gather_arrays(arrays: Iterable[np.ndarray], mesh: Mesh) -> List[np.ndarray]:
    """``all_gather_rows`` of host arrays (through the mesh's device, as
    NCCL gathers only tensors on the card)."""
    arrays = list(arrays)
    if mesh.data_axis_group is None:
        return arrays
    gathered = all_gather_rows((torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
                                for a in arrays), mesh)
    return [g.cpu().numpy() for g in gathered]


def broadcast_(tensors: Iterable[torch.Tensor], mesh: Mesh, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s."""
    if not mesh.distributed:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src, group=mesh.group)


def broadcast_int(value: int, mesh: Mesh, src: int = 0) -> int:
    """Rank ``src``'s ``value`` on every rank."""
    if not mesh.distributed:
        return int(value)
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, src, group=mesh.group)
    return int(t.item())


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        kw = {"device_ids": [mesh.device.index]} if mesh.device.type == "cuda" else {}
        dist.barrier(group=mesh.group, **kw)


def broadcast_state(state, mesh: Mesh, src: int = 0):
    """Every rank's train state made rank ``src``'s, in place: parameters,
    buffers, optimizer state, EMA, step and the augmentation generator's
    state (the reference's ``replicated_sharding`` of the state). Returns
    ``state``."""
    if not mesh.distributed:
        return state
    opt = state.opt_state
    tensors = list(state.module.parameters()) + list(state.module.buffers())
    for key in ("trace", "mu", "nu", "acc"):
        tensors += getattr(opt, key) or []
    tensors += list((state.ema or {}).values())
    broadcast_(tensors, mesh, src)
    state.step = broadcast_int(state.step, mesh, src)
    opt.count = broadcast_int(opt.count, mesh, src)
    opt.mini_step = broadcast_int(opt.mini_step, mesh, src)
    gen = state.generator.get_state().to(mesh.device)
    dist.broadcast(gen, src, group=mesh.group)
    state.generator.set_state(gen.cpu())
    return state
