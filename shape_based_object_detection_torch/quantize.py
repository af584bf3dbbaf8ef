"""The int8 serving tiers (port of the JAX package's ``quantize.py``).

Two tiers on top of the float one:

- **weights** (weight-only int8): every ``nn.Conv2d`` whose weight holds at
  least ``min_size`` elements keeps its weight as per-output-channel
  symmetric int8 plus a float32 scale (``QTensor``), resident on the card,
  and dequantizes it inside its forward, ``(q.float() * scale).to(dtype)``,
  ahead of the usual convolution: a quarter of float32's weight bytes (half
  of bf16's).
- **full** (weights and activations): those convolutions, apart from the
  final prediction convolutions (RetinaNet's ``predict``, SSD's ``loc_*`` /
  ``cls_*``, which stay in float on their int8 weights), run as s8×s8 → s32
  products. The activation scale is per image, ``max(amax, 1e-6) / 127``
  from the image's own abs-max (dynamic), or a calibrated constant
  (static, ``calibrate_activation_scales``); the weight scale per output
  channel; the epilogue ``out.float() * (ls * ws)``, cast to the module's
  type, then ``+ bias`` in that type, as flax adds it.

The reference intercepts flax's convolution with a thread-local hook; the
port swaps each eligible ``nn.Conv2d`` for an ``Int8Conv2d`` in a copy of
the model (``quantize_module``). The s8×s8 → s32 product is the op
``sbd::int8_conv2d``: on the card an int8 im2col in NHWC and
``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM; the reference leaves
this product to XLA, not to a Pallas kernel), elsewhere the plain version,
a float64 convolution of the int8 values, which is exact (every partial sum
is an integer below 2^53). Both give the same int32, bit for bit.

Under a row shard (image rows split over a model axis, ``row_shard`` set
on every ``Int8Conv2d`` by ``parallel/spatial.set_row_shard``) each int8
convolution fetches the rows its window reads, as the float one does, and
a per-image dynamic scale is the MAX over the model group of every rank's
real rows' abs-max, so every rank quantizes with the unsplit scale; the
static and weight-only tiers need no collective. Calibration on a
row-split module reduces its abs-maxes the same way.

Calibrated scales are keyed by flax module path (``backbone/layer1_0/conv1``;
a head convolution shared by every pyramid level has one key), so a scales
file saved by the JAX package loads here, and the reverse.

Each step is one IEEE operation in the reference's order, as the
reference computes op by op (eagerly), so the two agree bit for bit. Every
division goes through ``ops/boxes.true_div`` or divides by a tensor: on
the card ``x / 127.0`` is a product with the reciprocal, which moves ``q``
by one where the reference's division does not. (Inside jit, XLA on the
CPU turns a division by a constant into that product and contracts
multiply-adds into FMAs: last-bit differences, which the full tier's
quantizers can amplify, as any float difference ahead of them.)
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from shape_based_object_detection_torch.ops.boxes import true_div
from shape_based_object_detection_torch.parallel import spatial
from shape_based_object_detection_torch.utils.device import resolve_device

# Calls of torch._int_mm since the process started (or the last reset by a
# caller that counts the int8 products of a run): one per full-int8
# convolution applied on the card.
launches = 0


class QTensor(NamedTuple):
    """A per-output-channel symmetric int8 tensor: ``w ~= q * scale``.
    ``q``: int8, the weight's shape (OIHW). ``scale``: float32, (O, 1, 1, 1)."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequantize(self) -> torch.Tensor:
        return self.q.to(self.scale.dtype) * self.scale


def quantize_tensor(w: torch.Tensor, channel_axis: int = 0) -> QTensor:
    """Symmetric int8 quantization, one scale per output channel (axis 0 of
    a PyTorch OIHW weight; the reference's HWIO kernels keep it last)."""
    w32 = w.detach().float()
    dims = tuple(i for i in range(w32.dim()) if i != channel_axis % w32.dim())
    amax = w32.abs().amax(dim=dims, keepdim=True)
    scale = true_div(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return QTensor(q=q.to(torch.int8), scale=scale)


def _eligible_convs(module: nn.Module, min_size: int):
    """(qualified name, conv) of every ``nn.Conv2d`` whose weight holds at
    least ``min_size`` elements: selected by module type (a BatchNorm's
    scale is also called ``weight``)."""
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, nn.Conv2d) and m.weight.numel() >= min_size]


def quantize_params(module: nn.Module, min_size: int = 1024) -> Dict[str, object]:
    """``module``'s state dict with the weight of every eligible convolution
    as a ``QTensor``; everything else (biases, BatchNorm, L2Norm) as is."""
    out: Dict[str, object] = dict(module.state_dict())
    for name, conv in _eligible_convs(module, min_size):
        out[f"{name}.weight"] = quantize_tensor(conv.weight)
    return out


def dequantize_params(qparams: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params` (lossy): QTensor -> float32."""
    return {k: v.dequantize() if isinstance(v, QTensor) else v for k, v in qparams.items()}


def quantized_bytes(qparams: Dict[str, object]) -> int:
    """Parameter bytes as stored (int8 + scales + the float tensors)."""
    return sum(sum(t.nbytes for t in v) if isinstance(v, QTensor) else v.nbytes
               for v in qparams.values())


def normalize_quantize_mode(mode) -> str:
    """A user-facing quantize mode as "" | "weights" | "full": False, None
    and "" are off, True and "weights" weight-only int8, "full" weights and
    activations. Anything else raises: a misspelled mode must not serve
    another tier."""
    if mode in (False, None, ""):
        return ""
    if mode in (True, "weights"):
        return "weights"
    if mode == "full":
        return "full"
    raise ValueError(f"unknown quantize mode {mode!r}: expected False/True, 'weights', "
                     "or 'full'")


def default_int8_skip(name: str) -> bool:
    """The final prediction convolutions stay float in the full tier."""
    last = name.rsplit(".", 1)[-1]
    return last == "predict" or last.startswith(("loc_", "cls_"))


def module_path_key(name: str) -> str:
    """A convolution's calibration key: its flax module path."""
    return name.replace(".", "/")


# ---------------------------------------------------------------------------
# The s8 x s8 -> s32 convolution
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _out_size(n: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, stride: List[int],
                      padding: List[int], dilation: List[int]) -> torch.Tensor:
    """The plain version: (B, H, W, C) int8 x (O, kH, kW, C) int8 -> (B, Ho,
    Wo, O) int32, as a float64 convolution of the int8 values (exact)."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(),
                 None, tuple(stride), tuple(padding), tuple(dilation))
    return y.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def im2col_nhwc(xq: torch.Tensor, kh: int, kw: int, stride: List[int],
                padding: List[int], dilation: List[int]) -> torch.Tensor:
    """The product's A: (B, H, W, C) int8 -> (M, K) rows of (kh, kw, c)
    patches, from padded strided slices (``F.unfold`` has no int8 kernel),
    M = B * Ho * Wo padded with zero rows to at least 17 and K = kh * kw * C
    with zero columns to a multiple of 8, as ``_int_mm`` wants on the card;
    zeros add nothing to the sums. A 1x1 stride-1 convolution needs no
    copy unless K is padded."""
    b, h, w, c = xq.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho, wo = _out_size(h, kh, sh, ph, dh), _out_size(w, kw, sw, pw, dw)
    m, k = b * ho * wo, kh * kw * c
    kp = _round_up(k, 8)
    xq = xq.contiguous()
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0) and kp == k:
        a = xq.reshape(m, k)
    else:
        xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
        cols = [xp[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
                   j * dw:j * dw + (wo - 1) * sw + 1:sw, :]
                for i in range(kh) for j in range(kw)]
        if kp > k:
            cols.append(xq.new_zeros((b, ho, wo, kp - k)))
        a = torch.cat(cols, dim=3).reshape(m, kp)
    return F.pad(a, (0, 0, 0, 17 - m)) if m < 17 else a


def gemm_weight(wq: torch.Tensor) -> torch.Tensor:
    """The product's B, transposed: (O, kH, kW, C) int8 -> (N, K), padded
    with zeros to multiples of 8 in both."""
    o = wq.shape[0]
    bmat = wq.reshape(o, -1)
    k = bmat.shape[1]
    if k % 8 or o % 8:
        bmat = F.pad(bmat, (0, _round_up(k, 8) - k, 0, _round_up(o, 8) - o))
    return bmat


def int8_conv2d_cuda(xq: torch.Tensor, wq: torch.Tensor, stride: List[int],
                     padding: List[int], dilation: List[int]) -> torch.Tensor:
    """The card's route: ``im2col_nhwc`` and one ``torch._int_mm``
    (cuBLASLt's int8 tensor-core GEMM) against ``gemm_weight``; the zero
    padding is cut from the (B, Ho, Wo, O) int32 result. CUDA tensors
    only; a shape ``_int_mm`` refuses raises."""
    global launches
    if not (xq.is_cuda and wq.is_cuda):
        raise ValueError("int8_conv2d_cuda takes CUDA tensors only; run "
                         "int8_conv2d_plain for tensors on the CPU")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8 operands expected, got {xq.dtype} and {wq.dtype}")
    b, h, w, c = xq.shape
    o, kh, kw, cw = wq.shape
    if c != cw:
        raise ValueError(f"input has {c} channels, the weight {cw}")
    ho = _out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = _out_size(w, kw, stride[1], padding[1], dilation[1])
    m = b * ho * wo
    out = torch._int_mm(im2col_nhwc(xq, kh, kw, stride, padding, dilation),
                        gemm_weight(wq).t())
    launches += 1
    if out.shape != (m, o):
        out = out[:m, :o].contiguous()
    return out.reshape(b, ho, wo, o)


@torch.library.custom_op("sbd::int8_conv2d", mutates_args=())
def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride: List[int],
                padding: List[int], dilation: List[int]) -> torch.Tensor:
    """``sbd::int8_conv2d``: (B, H, W, C) int8 x (O, kH, kW, C) int8 ->
    (B, Ho, Wo, O) int32. This body is the implementation for every device
    but CUDA: the plain version."""
    return int8_conv2d_plain(xq, wq, stride, padding, dilation)


@int8_conv2d.register_kernel("cuda")
def _int8_conv2d_cuda(xq, wq, stride, padding, dilation):
    return int8_conv2d_cuda(xq, wq, stride, padding, dilation)


@int8_conv2d.register_fake
def _int8_conv2d_fake(xq, wq, stride, padding, dilation):
    b, h, w, _ = xq.shape
    o, kh, kw, _ = wq.shape
    return xq.new_empty((b, _out_size(h, kh, stride[0], padding[0], dilation[0]),
                         _out_size(w, kw, stride[1], padding[1], dilation[1]), o),
                        dtype=torch.int32)


class Int8Conv2d(nn.Module):
    """An ``nn.Conv2d`` with int8 weights, in one of three modes:

    - "weights": keeps ``q`` and ``scale``; dequantizes in the forward and
      runs the float convolution (also the full tier's skipped convolutions);
    - "dynamic" / "static": the s8×s8 → s32 product with a per-image or a
      calibrated activation scale.

    For the two int8 modes it reproduces the reference's weight chain: its
    interceptor sees the dequantized kernel after flax cast it to the
    convolution's type, and derives its int8 weight and scale from that
    (in bf16 they are not ``q`` and ``scale``). The chain depends only on
    the weights, so it runs once here; the result, ``wq`` in OHWI (the
    rows of the product's B) and ``ws`` per output channel, is what stays
    on the card. Under a row shard (``row_shard``) it computes on the
    rank's rows."""

    row_shard: Optional[spatial.RowShard] = None

    def __init__(self, conv: nn.Conv2d, mode: str, act_amax: Optional[float] = None):
        super().__init__()
        if mode not in ("weights", "dynamic", "static"):
            raise ValueError(f"unknown Int8Conv2d mode {mode!r}")
        if (mode == "static") != (act_amax is not None):
            raise ValueError("a calibrated abs-max is given exactly in mode 'static'")
        if conv.groups != 1 or conv.padding_mode != "zeros" or isinstance(conv.padding, str):
            raise ValueError("Int8Conv2d takes ungrouped convolutions with explicit "
                             "zero padding")
        self.mode = mode
        self.kernel_size = conv.kernel_size[0]
        self.stride, self.padding, self.dilation = (
            list(conv.stride), list(conv.padding), list(conv.dilation))
        self.bias = None if conv.bias is None else nn.Parameter(
            conv.bias.detach().clone(), requires_grad=False)
        qt = quantize_tensor(conv.weight)
        if mode == "weights":
            self.register_buffer("q", qt.q)
            self.register_buffer("scale", qt.scale)
            return
        w = qt.dequantize().to(conv.weight.dtype).float()
        ws = true_div(torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12), 127.0)
        wq = torch.clamp(torch.round(w / ws.view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
        self.register_buffer("wq", wq.permute(0, 2, 3, 1).contiguous())
        self.register_buffer("ws", ws)
        if mode == "static":
            self.register_buffer("act_scale", torch.tensor(
                max(float(act_amax), 1e-6) / 127.0, dtype=torch.float32,
                device=conv.weight.device))

    def input_scale(self, x: torch.Tensor) -> torch.Tensor:
        """The activation scale of ``x`` (B, C, H, W): per image (B, 1, 1, 1)
        in "dynamic", from the image's abs-max (under a row shard the MAX
        over the model group of each rank's real rows'), the calibrated ()
        in "static"."""
        if self.mode != "dynamic":
            return self.act_scale
        shard = self.row_shard
        xf = x.float()
        if shard is not None:
            xf = xf[:, :, :shard.real(spatial.map_height(x, shard))]
        # per image, so a batch's mix cannot move it
        amax = (xf.abs().amax(dim=(1, 2, 3), keepdim=True) if xf.numel()
                else xf.new_zeros((xf.shape[0], 1, 1, 1)))
        if shard is not None:
            dist.all_reduce(amax, dist.ReduceOp.MAX, group=shard.group)
        return true_div(torch.clamp(amax, min=1e-6), 127.0)

    def quantize_input(self, x: torch.Tensor, ls: Optional[torch.Tensor] = None):
        """(B, C, H, W) float -> (the int8 input in NHWC, its scale
        ``input_scale(x)`` unless ``ls`` is given)."""
        if ls is None:
            ls = self.input_scale(x)
        xq = torch.clamp(torch.round(x.float() / ls), -127, 127).to(torch.int8)
        return xq.permute(0, 2, 3, 1), ls

    def dequantize_output(self, acc: torch.Tensor, ls: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
        """The epilogue: (B, Ho, Wo, O) int32 -> (B, O, Ho, Wo) ``dtype``,
        ``acc * (ls * ws)`` in float32 (NHWC: the reference's (B, 1, 1, O)
        scale), cast, then ``+ bias`` in ``dtype``."""
        y = (acc.float() * (ls.view(-1, 1, 1, 1) * self.ws)).to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "weights":
            w = (self.q.to(torch.float32) * self.scale).to(x.dtype)

            def conv(z, padding):
                return F.conv2d(z, w, self.bias, self.stride, padding, self.dilation)
        else:
            ls = self.input_scale(x)

            def conv(z, padding):
                xq, _ = self.quantize_input(z, ls)
                acc = torch.ops.sbd.int8_conv2d(xq, self.wq, self.stride, padding,
                                                self.dilation)
                return self.dequantize_output(acc, ls, z.dtype)
        if self.row_shard is None:
            return conv(x, self.padding)
        # the rows the window reads, as they are; the columns padded here
        return spatial.row_apply(
            x, self.row_shard, self.kernel_size, self.stride[0], self.padding[0],
            self.dilation[0], lambda win: conv(win, [0, self.padding[1]]))


def _quantized_copy(module: nn.Module, mode: str, activation_scales=None,
                    min_size: int = 1024,
                    skip_fn: Optional[Callable[[str], bool]] = None) -> nn.Module:
    mode = normalize_quantize_mode(mode)
    if not mode:
        raise ValueError("quantize_module needs mode 'weights' or 'full'")
    if isinstance(activation_scales, str):
        activation_scales = load_activation_scales(activation_scales)
    if activation_scales is not None and mode != "full":
        raise ValueError("activation_scales only applies to quantize mode 'full'")
    skip = skip_fn if skip_fn is not None else default_int8_skip
    shard = spatial.row_shard_of(module)
    qmodule = spatial.copy_module(module, shard)  # a row-split module stays split
    for name, conv in _eligible_convs(qmodule, min_size):
        if mode == "weights" or skip(name):
            swapped = Int8Conv2d(conv, "weights")
        elif activation_scales is None:
            swapped = Int8Conv2d(conv, "dynamic")
        else:
            key = module_path_key(name)
            if key not in activation_scales:
                raise ValueError(
                    f"no calibrated activation scale for conv {key!r}: re-run "
                    "calibrate_activation_scales on this model (the scales file "
                    "does not match the model or its skip set)")
            swapped = Int8Conv2d(conv, "static", activation_scales[key])
        swapped.row_shard = shard
        parent, _, child = name.rpartition(".")
        setattr(qmodule.get_submodule(parent), child, swapped)
    return qmodule


def quantize_module(module: nn.Module, mode, activation_scales=None, min_size: int = 1024,
                    skip_fn: Optional[Callable[[str], bool]] = None,
                    device=None) -> nn.Module:
    """A copy of ``module`` in the int8 tier ``mode`` ("weights" or "full"):
    every eligible ``nn.Conv2d`` (``min_size`` weight elements or more) is
    an ``Int8Conv2d``. ``activation_scales`` (a dict from
    :func:`calibrate_activation_scales`, or the path of its JSON) makes
    "full" static; a convolution it lacks raises, naming it. ``skip_fn``
    (a module's qualified name -> bool, default ``default_int8_skip``)
    keeps convolutions in float in "full". ``module`` must be on ``device``
    (default: the card). The copy of a module split by rows over a model
    axis computes on the same rank's rows."""
    dev = resolve_device(device)
    param = next(module.parameters())
    if param.device != dev:
        raise ValueError(f"quantize_module on {dev} needs the module there; it is on "
                         f"{param.device}")
    return _quantized_copy(module, mode, activation_scales, min_size, skip_fn)


# ---------------------------------------------------------------------------
# Calibration of static activation scales
# ---------------------------------------------------------------------------


def calibrate_activation_scales(module: nn.Module, batches, data_cfg=None,
                                skip_fn: Optional[Callable[[str], bool]] = None,
                                min_size: int = 1024) -> Dict[str, float]:
    """One-time PTQ calibration: the float forward of ``module`` over
    ``batches`` ((B, H, W, 3) uint8 arrays), recording each eligible
    convolution's input abs-max with forward pre-hooks, on the module's
    device, read back once per batch; reduced over all batches. A
    row-split ``module`` runs on this rank's rows of the batches' images:
    each convolution's input counts its real rows, and one MAX all-reduce
    over the model group per batch makes the abs-maxes the whole images',
    on every rank alike. Returns a JSON-able ``{flax module path:
    abs_max}``."""
    from shape_based_object_detection_torch.utils import image as image_lib

    mean = data_cfg.mean if data_cfg else image_lib.IMAGENET_MEAN
    std = data_cfg.std if data_cfg else image_lib.IMAGENET_STD
    skip = skip_fn if skip_fn is not None else default_int8_skip
    dev = next(module.parameters()).device
    shard = spatial.row_shard_of(module)
    records: Dict[str, torch.Tensor] = {}

    def recorder(key):
        def hook(mod, args):
            x = args[0].detach()
            if shard is not None:  # this rank's real rows (none: padding only)
                x = x[:, :, :shard.real(spatial.map_height(x, shard))]
            amax = (x.abs().amax().float() if x.numel()
                    else x.new_zeros((), dtype=torch.float32))
            prev = records.get(key)
            records[key] = amax if prev is None else torch.maximum(prev, amax)

        return hook

    hooks = [conv.register_forward_pre_hook(recorder(module_path_key(name)))
             for name, conv in _eligible_convs(module, min_size) if not skip(name)]
    amaxes: Dict[str, float] = {}
    n_batches = 0
    try:
        for images in batches:
            n_batches += 1
            records.clear()
            with torch.inference_mode():
                x = image_lib.normalize_images(torch.as_tensor(images).to(dev), mean, std)
                x = x.permute(0, 3, 1, 2)
                module(x if shard is None else shard.split(x))
            keys = list(records)
            if keys:
                values = torch.stack([records[k] for k in keys])
                if shard is not None:
                    dist.all_reduce(values, dist.ReduceOp.MAX, group=shard.group)
                values = values.tolist()  # one readback
                for k, v in zip(keys, values):
                    amaxes[k] = max(amaxes.get(k, 0.0), v)
    finally:
        for h in hooks:
            h.remove()
    if n_batches == 0:
        raise ValueError("calibration received no batches — check the data feed (e.g. "
                         "a dataset smaller than the batch size yields zero full batches)")
    if not amaxes:
        raise ValueError("calibration saw no eligible convs — check the model/skip_fn/"
                         "min_size")
    return amaxes


def save_activation_scales(path: str, amaxes) -> None:
    """Calibration output as JSON (the tools' and CLIs' format, shared with
    the JAX package)."""
    with open(path, "w") as f:
        json.dump(amaxes, f, indent=1, sort_keys=True)


def load_activation_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        scales = json.load(f)
    if not isinstance(scales, dict) or not scales:
        raise ValueError(f"{path} is not an activation-scales dict")
    return {str(k): float(v) for k, v in scales.items()}


# ---------------------------------------------------------------------------
# Detect in a tier
# ---------------------------------------------------------------------------


def make_quantized_detect_fn(module, anchors_cxcywh, cfg, data_cfg=None, device=None,
                             int8_activations: bool = False, activation_scales=None):
    """``detect(images) -> Detections`` over an int8 copy of ``module``:
    weight-only, or with ``int8_activations`` the full tier (dynamic, or
    static with ``activation_scales``)."""
    from shape_based_object_detection_torch.detection import make_detect_fn

    qmodule = quantize_module(module, "full" if int8_activations else "weights",
                              activation_scales, device=device)
    return make_detect_fn(qmodule, anchors_cxcywh, cfg, data_cfg, device)


def make_serving_detect(module, anchors_cxcywh, cfg, data_cfg, mode, device=None,
                        activation_scales=None, mesh=None):
    """The serving construction shared by Predictor and the CLIs: returns
    ``(detect_fn, serving_module)`` for quantize ``mode`` ("" is the float
    tier, then ``serving_module`` is ``module``). ``activation_scales``
    (dict, or a JSON path) makes "full" static. A ``mesh`` with a model
    axis splits the images' rows (``make_detect_fn``)."""
    from shape_based_object_detection_torch.detection import make_detect_fn

    mode = normalize_quantize_mode(mode)
    if activation_scales is not None and mode != "full":
        raise ValueError("activation_scales only applies to quantize mode 'full'")
    if mode:
        module = quantize_module(module, mode, activation_scales, device=device)
    return make_detect_fn(module, anchors_cxcywh, cfg, data_cfg, device, mesh), module
