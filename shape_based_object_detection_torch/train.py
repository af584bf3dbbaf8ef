"""Training step (port of the JAX package's ``train.py``).

``train_step(state, batch)`` is the whole hot path: augmentation on the
device -> forward -> matching (the CUDA kernel ``csrc/match_anchors.cu`` on
the card) -> loss -> backward -> optimizer update, all queued on the device
with no synchronisation with the host. The optimizer is the reference's
optax chain written out with PyTorch's multi-tensor (``_foreach``) ops:
global-norm clipping, weight decay on conv kernels only, SGD with momentum
(or AdamW) under a linear warmup and step decay at global steps, optionally
averaged over micro-batches (optax ``MultiSteps``), and an EMA of the
parameters counted per applied update.

Mixed precision follows the reference: parameters and optimizer state stay
float32, and with ``model.dtype == "bfloat16"`` the forward computes in bf16
under ``torch.autocast``. ``model.precision`` sets cuDNN's TF32 switch for
the forward *and* the backward convolutions.

``model.remat`` rematerialises the model's own segments (each bottleneck,
the FPN and each head application; the VGG stages and the extras);
``train.remat`` without it checkpoints the whole forward, as the
reference's legacy path does. With ``model.train_bn`` the training forward
normalises BatchNorm with batch statistics, and the running statistics
move once per step, after backward, however often remat recomputed them.

Given a ``parallel.Mesh`` with a process group, the step is data-parallel:
each rank feeds its rows of the global batch and the step computes what a
single process computes on the whole global batch, as the reference's
sharded step does. The augmentation draws for the global batch, the loss
and BatchNorm take their counts and statistics over the group, and after
backward one all-reduce of one flat buffer sums the gradients (and the
loss terms) before clipping, the optimizer and the EMA, which then run
alike on every rank.

With a model axis (``Mesh.model_parallelism`` > 1) the ranks of one data
index augment the same images, and each runs the forward on its rows of
them (``set_row_shard``): row fetches within the model group, BatchNorm's
statistics over the world's real rows, the heads' outputs gathered, so every rank of
the group matches the data index's images on the full anchors and computes
the same loss. The positives and the loss terms sum over the data group,
and the gradients, each rank's rows' share, over the world.

While a ``torch.profiler`` session records, the step's phases are spans
(``utils/metrics``): ``train.step`` (with the step's number) around
``train.augment``, ``train.forward``, ``train.match`` (in ``match_batch``),
``train.loss``, ``train.backward`` and ``train.update``, and under a process
group ``train.allreduce`` inside ``train.update`` around the gradients'
all-reduce (``parallel/mesh.all_reduce_``: the span ``comm.all_reduce``, its
bytes on the counter ``comm.all_reduce_bytes``, as the loss's count of
positives adds its own); at its end the step adds the caching allocator's
device segments created since the last step to ``mem.device_allocs``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shape_based_object_detection_torch.config import ExperimentConfig, TrainConfig
from shape_based_object_detection_torch.data.augment import augment_batch
from shape_based_object_detection_torch.losses import detection_loss
from shape_based_object_detection_torch.models.resnet import (
    apply_batch_stats, clear_batch_stats, run_segment, set_batch_stats_group,
)
from shape_based_object_detection_torch.models.retinanet import conv_precision
from shape_based_object_detection_torch.ops.boxes import true_div
from shape_based_object_detection_torch.ops.matching import match_batch
from shape_based_object_detection_torch.parallel.mesh import (
    Mesh, all_gather_rows, all_reduce_, single_process, spatial_image_sharding,
)
from shape_based_object_detection_torch.parallel.spatial import set_row_shard
from shape_based_object_detection_torch.utils import image as image_lib
from shape_based_object_detection_torch.utils import metrics as trace
from shape_based_object_detection_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Learning-rate schedule, weight-decay mask, optimizer
# ---------------------------------------------------------------------------


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warmup from 0, then piecewise-constant decay. ``lr_decay_steps``
    are GLOBAL step numbers (the reference shifts them by the warmup inside
    optax's ``join_schedules``). Computed in float32 in optax's order."""
    warmup = max(1, cfg.warmup_steps)
    bad = [int(s) for s in cfg.lr_decay_steps if int(s) <= warmup]
    if bad:
        raise ValueError(
            f"lr_decay_steps {bad} fall at or before warmup_steps={warmup}; "
            "decay boundaries are GLOBAL step numbers and must be greater "
            "than the warmup length")
    f32 = np.float32
    base = f32(cfg.base_lr)
    bounds = sorted((int(s) - warmup, f32(cfg.lr_decay_factor))
                    for s in cfg.lr_decay_steps)

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1.0) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - cfg.base_lr) * frac + base)
        value, n = base, count - warmup
        for boundary, scale in bounds:
            on = f32(1.0) if boundary - n > 0 else f32(0.0)
            value = value * on + (f32(1.0) - on) * scale * value
        return float(value)

    return schedule


def decay_mask(module: nn.Module) -> Dict[str, bool]:
    """True for convolution kernels only (the reference's flax ``kernel``
    leaves with ndim >= 2): conv biases and the BatchNorm scale and shift
    get no weight decay."""
    return {name: name.rsplit(".", 1)[-1] == "weight" and p.dim() >= 2
            for name, p in module.named_parameters()}


@dataclasses.dataclass
class OptState:
    """The optimizer's state. ``count`` counts applied updates (optax's
    schedule count), ``mini_step`` the micro-batches since the last one."""

    count: int = 0
    mini_step: int = 0
    trace: Optional[List[torch.Tensor]] = None  # SGD momentum
    mu: Optional[List[torch.Tensor]] = None  # AdamW moments
    nu: Optional[List[torch.Tensor]] = None
    acc: Optional[List[torch.Tensor]] = None  # mean of the micro-gradients


class Optimizer:
    """optax ``chain(clip_by_global_norm, add_decayed_weights(mask), sgd)``
    or ``chain(clip_by_global_norm, adamw(mask))``, wrapped in ``MultiSteps``
    when ``grad_accum_steps > 1``. Updates the parameters in place."""

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.accum = max(1, cfg.grad_accum_steps)
        self.trace_dtype = (getattr(torch, cfg.momentum_dtype)
                            if cfg.momentum_dtype else None)

    def init(self, params: List[torch.Tensor]) -> OptState:
        zeros = lambda dtype=None: [torch.zeros_like(p, dtype=dtype) for p in params]
        state = OptState()
        if self.cfg.optimizer == "sgd":
            state.trace = zeros(self.trace_dtype)
        else:
            state.mu, state.nu = zeros(), zeros()
        if self.accum > 1:
            state.acc = zeros()
        return state

    @torch.no_grad()
    def apply(self, state: OptState, params: List[torch.Tensor],
              grads: List[torch.Tensor], mask: List[bool]) -> bool:
        """One call per micro-batch; returns whether the parameters moved.
        ``grads`` may be overwritten."""
        if self.accum > 1:
            n = state.mini_step
            # acc + (g - acc) / (n + 1), the running mean of MultiSteps
            delta = torch._foreach_sub(grads, state.acc)
            delta = [true_div(d, n + 1) for d in delta]
            torch._foreach_add_(state.acc, delta)
            state.mini_step = (n + 1) % self.accum
            if state.mini_step != 0:
                return False
            grads = [a.clone() for a in state.acc]
            for a in state.acc:
                a.zero_()
        self._clip(grads)
        lr = self.schedule(state.count)
        cfg = self.cfg
        decayed = [i for i, m in enumerate(mask) if m]
        if cfg.optimizer == "sgd":
            if cfg.weight_decay:
                torch._foreach_add_([grads[i] for i in decayed],
                                    [params[i] for i in decayed],
                                    alpha=cfg.weight_decay)
            if self.trace_dtype in (None, params[0].dtype):
                torch._foreach_mul_(state.trace, cfg.momentum)
                torch._foreach_add_(state.trace, grads)
                updates = state.trace
            else:
                # the trace is stored in another type: as optax's
                # accumulator_dtype, momentum * trace is taken in that type
                # (the momentum rounded to it too) and the update uses the
                # float32 sum before it is cast back
                m = float(torch.tensor(cfg.momentum, dtype=self.trace_dtype))
                updates = [g + t * m for g, t in zip(grads, state.trace)]
                state.trace = [u.to(self.trace_dtype) for u in updates]
        else:
            updates = self._adam(state, grads)
            if cfg.weight_decay:
                torch._foreach_add_([updates[i] for i in decayed],
                                    [params[i] for i in decayed],
                                    alpha=cfg.weight_decay)
        torch._foreach_add_(params, updates, alpha=-lr)
        state.count += 1
        return True

    def _clip(self, grads: List[torch.Tensor]) -> None:
        """optax.clip_by_global_norm: ``g / norm * max_norm`` when ``norm >=
        max_norm`` (no epsilon), unchanged below; decided on the device."""
        norm = global_norm(grads)
        below = norm < self.cfg.grad_clip_norm
        torch._foreach_div_(grads, torch.where(below, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(below, 1.0, self.cfg.grad_clip_norm))

    def _adam(self, state: OptState, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.scale_by_adam (b1 0.9, b2 0.999, eps 1e-8)."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        f32, count = np.float32, np.float32(state.count + 1)
        c1 = float(f32(1) - f32(b1) ** count)  # bias corrections, in float32
        c2 = float(f32(1) - f32(b2) ** count)
        out = []
        for g, m, v in zip(grads, state.mu, state.nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            out.append(true_div(m, c1) / (torch.sqrt(true_div(v, c2)) + eps))
        return out


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


# ---------------------------------------------------------------------------
# State, loss, step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    step: int
    module: nn.Module  # the trainable parameters (float32) and BN statistics
    opt_state: OptState
    generator: torch.Generator  # on the module's device; the augmentation's
    ema: Optional[Dict[str, torch.Tensor]] = None  # EMA of the parameters


def _on_device(module: nn.Module, anchors: Optional[torch.Tensor], device):
    dev = resolve_device(device)
    param = next(module.parameters())
    if param.device != dev or (anchors is not None and anchors.device != dev):
        raise ValueError(
            f"training on {dev} needs the module and anchors there; they are "
            f"on {param.device} and {None if anchors is None else anchors.device}")
    return dev


def create_train_state(module: nn.Module, cfg: ExperimentConfig, device=None,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """The state for training ``module`` (from ``build_model(...,
    train=True)``) in place. ``device`` as ``build_model``'s: the card
    unless ``device="cpu"``. The augmentation's generator is seeded with
    ``cfg.train.seed`` on that device unless one is given."""
    dev = _on_device(module, None, device)
    not_f32 = [n for n, p in module.named_parameters() if p.dtype != torch.float32]
    if not_f32:
        raise ValueError(
            f"training needs float32 parameters (bf16 compute runs under "
            f"autocast); {not_f32[0]} is not: build the model with train=True")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    params = list(module.parameters())
    ema = ({n: p.detach().clone() for n, p in module.named_parameters()}
           if cfg.train.ema_decay > 0 else None)
    return TrainState(step=0, module=module,
                      opt_state=make_optimizer(cfg.train).init(params),
                      generator=generator, ema=ema)


def _autocast(cfg: ExperimentConfig, device: torch.device):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=cfg.model.dtype == "bfloat16")


def make_loss_fn(module: nn.Module, anchors: torch.Tensor, cfg: ExperimentConfig,
                 group=None, row_shard=None):
    """``loss_fn(images_nchw, boxes, labels, valid) -> (loss, metrics)``,
    the differentiable core of the train step: the training forward
    (``train=True``: batch statistics in BatchNorm where ``train_bn`` is
    set), then matching and the loss. ``train.remat`` on a module built
    without ``model.remat`` checkpoints the whole forward. Under a process
    ``group`` the loss is this rank's share of the global batch's. With a
    ``row_shard`` (set on ``module`` too) the forward takes this rank's
    rows of the images."""
    variances = cfg.model.anchors.variances
    device = anchors.device
    whole_remat = cfg.train.remat and not module.cfg.remat

    def forward(images):
        if row_shard is not None:
            images = row_shard.split(images)
        return module(images, train=True)

    def loss_fn(images, boxes, labels, valid):
        with trace.span("train.forward"), _autocast(cfg, device):
            cls_logits, box_offsets = run_segment(forward, images, remat=whole_remat)
        with torch.no_grad():
            match = match_batch(anchors, boxes, labels, valid, cfg.match, variances)
        with trace.span("train.loss"):
            return detection_loss(cls_logits.float(), box_offsets.float(), match,
                                  cfg.loss, group)

    return loss_fn


# the loss terms a data index computes as its share of the global batch's
SUMMED_METRICS = ("loss", "loss_cls", "loss_box")


def _grad_and_update(loss_fn, opt: Optimizer, mask: List[bool],
                     cfg: ExperimentConfig, state: TrainState, images, boxes,
                     labels, valid, mesh: Mesh) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """forward + backward -> BatchNorm statistics -> the group's sum of the
    gradients -> optimizer -> EMA: the shared tail of the step."""
    params = list(state.module.parameters())
    for p in params:
        p.grad = None
    clear_batch_stats(state.module)
    # TF32 for the backward convolutions too, which run after forward returns.
    # Holding the precision lock across backward is also what makes remat
    # safe: a forward recomputed inside backward runs on autograd's thread
    # and skips the lock (conv_precision). Keep every backward of a model
    # inside this context (tests/test_torch_server.py checks it).
    with conv_precision(cfg.model.precision):
        loss, metrics = loss_fn(images, boxes, labels, valid)
        with trace.span("train.backward"):
            loss.backward()
    with trace.span("train.update"):
        # the batch statistics of the forward, once, as the reference's aux
        apply_batch_stats(state.module)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        metrics = {k: v.detach() for k, v in metrics.items()}
        summed = [metrics[k] for k in SUMMED_METRICS]
        # one coalesced all-reduce: the ranks' gradients of their shares sum to
        # the global batch's gradient, their loss terms to its loss. Under a
        # model axis the ranks of a data index hold the same loss terms: those
        # sum over the data axis alone
        with trace.span("train.allreduce") if mesh.distributed else contextlib.nullcontext():
            if mesh.model_parallelism == 1:
                all_reduce_(grads + summed, mesh)
            else:
                all_reduce_(grads, mesh)
                all_reduce_(summed, mesh, data_axis=True)
        metrics["grad_norm"] = global_norm(grads)
        applied = opt.apply(state.opt_state, [p.data for p in params], grads, mask)
        d = cfg.train.ema_decay
        if d > 0 and applied:
            # EMA follows optimizer updates, not micro-batches
            ema = list(state.ema.values())
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - d)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics


def _batch_on(batch: Batch, dev: torch.device):
    return tuple(torch.as_tensor(batch[k]).to(dev, non_blocking=True)
                 for k in ("images", "boxes", "labels", "valid"))


def _row_shard(module: nn.Module, cfg: ExperimentConfig, mesh: Mesh):
    """The mesh's row shard set on ``module`` (None, and cleared, without a
    model axis)."""
    shard = (spatial_image_sharding(mesh, cfg.mesh, cfg.model)
             if mesh.model_parallelism > 1 else None)
    set_row_shard(module, shard)
    return shard


def _step_parts(module: nn.Module, anchors: torch.Tensor, cfg: ExperimentConfig,
                device, mesh: Optional[Mesh]):
    """The device, mesh, optimizer, loss function and decay mask of a train
    step; BatchNorm takes its statistics over the mesh's group (the world),
    the loss its positives over the data axis."""
    if mesh is None:
        mesh = single_process(device)
    dev = _on_device(module, anchors, mesh.device if device is None else device)
    if dev != mesh.device:
        raise ValueError(f"the step's device {dev} is not its mesh's {mesh.device}")
    set_batch_stats_group(module, mesh.group)
    shard = _row_shard(module, cfg, mesh)
    return (dev, mesh, make_optimizer(cfg.train),
            make_loss_fn(module, anchors, cfg, mesh.data_axis_group, shard),
            list(decay_mask(module).values()))


def make_train_step(module: nn.Module, anchors: torch.Tensor,
                    cfg: ExperimentConfig, augment: bool = True, device=None,
                    mesh: Optional[Mesh] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: images (B, S, S, 3) uint8, boxes (B, G, 4) normalized xyxy,
    labels (B, G) int32 (1-based), valid (B, G) bool; tensors already on the
    device are used in place. The state is updated in place and returned;
    the metrics are 0-d tensors on the device (reading one waits for the
    step). With a ``mesh`` whose group is set, ``batch`` is this rank's
    rows of the global batch (``mesh.rows``: under a model axis its data
    index's rows, the same on every rank of the model group), every rank
    calls the step, and the metrics are the global batch's."""
    dev, mesh, opt, loss_fn, mask = _step_parts(module, anchors, cfg, device, mesh)

    def train_step(state: TrainState, batch: Batch):
        with trace.span("train.step", step=state.step):
            with trace.span("train.augment"):
                images, boxes, labels, valid = _batch_on(batch, dev)
                if augment:
                    images, boxes, labels, valid = augment_batch(
                        state.generator, images, boxes, labels, valid, cfg.data,
                        cfg.model.image_size, mesh.data_index, mesh.data_size)
                else:
                    images = image_lib.normalize_images(images, cfg.data.mean, cfg.data.std)
            x = images.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
            out = _grad_and_update(loss_fn, opt, mask, cfg, state, x, boxes,
                                   labels, valid, mesh)
        trace.count_device_allocs(dev)
        return out

    return train_step


class Carry(NamedTuple):
    """An augmented batch waiting for its step: normalized NHWC images,
    boxes, labels, valid, and (on the card) the side stream's event after
    which they are ready. A plain 4-tuple is a carry that is ready."""

    images: torch.Tensor
    boxes: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
    ready: Optional[torch.cuda.Event] = None


def make_train_step_pipelined(module: nn.Module, anchors: torch.Tensor,
                              cfg: ExperimentConfig, device=None,
                              mesh: Optional[Mesh] = None):
    """The software-pipelined step: augmentation runs one batch ahead.

    Returns ``(prime, step)``:
      ``prime(state, batch) -> (state, carry)`` augments batch 0;
      ``step(state, carry, next_batch) -> (state, carry', metrics)`` runs
      grad+update on ``carry`` and augments ``next_batch`` into ``carry'``.

    Feed batch i+1 to step i; the last step may be fed any batch. The
    augmentation draws from ``state.generator`` in the plain step's order
    (batch 0, 1, 2, ...), so the losses equal ``make_train_step``'s on the
    same batches and generator. On the card the augmentation runs on a
    second CUDA stream: every draw is made there, in that order, and the
    main stream waits on the carry's event before it consumes it; the
    tensors that cross streams are ``record_stream``-ed so the caching
    allocator does not hand their memory out early. A ``mesh`` as
    ``make_train_step``'s."""
    dev, mesh, opt, loss_fn, mask = _step_parts(module, anchors, cfg, device, mesh)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def augment(state: TrainState, batch: Batch) -> Carry:
        if side is None:
            return Carry(*augment_batch(state.generator, *_batch_on(batch, dev),
                                        cfg.data, cfg.model.image_size, mesh.data_index,
                                        mesh.data_size))
        main = torch.cuda.current_stream(dev)
        # the batch may have been written on the main stream (an upload)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            raw = _batch_on(batch, dev)
            out = augment_batch(state.generator, *raw, cfg.data, cfg.model.image_size,
                                mesh.data_index, mesh.data_size)
            ready = torch.cuda.Event()
            ready.record(side)
        for t in raw:
            t.record_stream(side)
        for t in out:
            t.record_stream(main)
        return Carry(*out, ready)

    def prime(state: TrainState, batch: Batch) -> Tuple[TrainState, Carry]:
        with trace.span("train.augment"):
            return state, augment(state, batch)

    def step(state: TrainState, carry, next_batch: Batch):
        with trace.span("train.step", step=state.step):
            images, boxes, labels, valid = (torch.as_tensor(t).to(dev) for t in carry[:4])
            ready = carry.ready if isinstance(carry, Carry) else None
            # the next batch's augmentation is queued first, so the side stream
            # runs it while the main stream takes this step's grad and update
            with trace.span("train.augment"):
                new_carry = augment(state, next_batch)
            if ready is not None:
                torch.cuda.current_stream(dev).wait_event(ready)
            x = images.permute(0, 3, 1, 2)
            state, metrics = _grad_and_update(loss_fn, opt, mask, cfg, state, x, boxes,
                                              labels, valid, mesh)
        trace.count_device_allocs(dev)
        return state, new_carry, metrics

    return prime, step


def make_eval_step(module: nn.Module, anchors: torch.Tensor, cfg: ExperimentConfig,
                   use_ema: bool = False, device=None, mesh: Optional[Mesh] = None):
    """Returns ``eval_step(state, images) -> Detections``: forward with the
    state's parameters (or its EMA) and postprocess, for validation.
    BatchNorm normalises with its running statistics (the module's buffers,
    with the EMA too). With a ``mesh`` whose group is set, ``images`` are
    this rank's rows (its data index's) and every rank gets the global
    batch's detections in rank order (the reference's replicated
    ``out_sharding``); under a model axis each rank runs the forward on its
    rows of the images and the model group's ranks postprocess the gathered
    outputs alike."""
    from shape_based_object_detection_torch.detection import postprocess
    from shape_based_object_detection_torch.ops.nms import Detections

    if mesh is None:
        mesh = single_process(device)
    dev = _on_device(module, anchors, mesh.device if device is None else device)
    shard = _row_shard(module, cfg, mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, images):
        if use_ema and state.ema is None:
            raise ValueError(
                "use_ema=True but this TrainState has no EMA parameters: train "
                "with TrainConfig.ema_decay > 0")
        x = torch.as_tensor(images).to(dev, non_blocking=True)
        x = image_lib.normalize_images(x, cfg.data.mean, cfg.data.std)
        x = x.permute(0, 3, 1, 2)
        if shard is not None:
            x = shard.split(x)
        with conv_precision(cfg.model.precision), _autocast(cfg, dev):
            if use_ema:
                weights = {**dict(state.module.named_buffers()), **state.ema}
                cls_logits, box_offsets = torch.func.functional_call(
                    state.module, weights, (x,))
            else:
                cls_logits, box_offsets = state.module(x)
        det = postprocess(cls_logits.float(), box_offsets.float(), anchors, cfg.model)
        return Detections(*all_gather_rows(det, mesh)) if mesh.distributed else det

    return eval_step
