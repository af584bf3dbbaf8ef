"""Frozen BatchNorm with its ReLU, or with a bottleneck's residual add and
ReLU, in one pass on the card: the wrapper of the hand-written CUDA kernel
``csrc/frozen_bn.cu`` (K3).

It replaces no Pallas kernel: on the TPU, XLA fuses flax's frozen
``nn.BatchNorm`` and the jnp arithmetic after it into the neighbouring
operations. In PyTorch the plain composition (``ops/frozen_bn.py``) is a
chain of elementwise kernels, four float32 passes per BatchNorm and one
more per ReLU or add, each reading and writing the whole activation. The
kernel is bound by bytes; it reads each input byte once (the activation,
and the residual or the downsample branch's activation) and writes each
output byte once: in bf16, 4 bytes per element where the chain moved 32,
and 6 at a bottleneck's end where it moved 38, or 66 with the downsample
branch's BatchNorm. Each thread keeps the per-channel factors of its
fixed channels in registers (see the source's header). Its outputs equal
the plain composition's on the card bit for bit.

CUDA tensors only: a CPU tensor raises. The activations are bf16 or
float32 and dense, channels-last (the vector route) or NCHW (the scalar
route, also taken where C is not a multiple of the 16-byte vector); any
other layout or type raises. Nothing here falls back. The kernel is built
at first use (``utils/native.py``); importing this module needs neither
nvcc nor a card.

Importing it also registers the PyTorch ops ``sbd::frozen_bn_act`` and
``sbd::frozen_bn_add_relu``, which dispatch by device: the kernel for CUDA
tensors, the plain composition for the others. ``models/resnet.py`` calls
them where no autograd graph is recorded, and a traced program
(``torch.export``) records each as one node. Each application of a frozen
BatchNorm adds 1 to the tracer's counter ``bn.frozen`` and, when the kernel
makes it, to ``bn.fused`` (``utils/metrics``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from shape_based_object_detection_torch.ops import frozen_bn
from shape_based_object_detection_torch.utils import metrics as trace
from shape_based_object_detection_torch.utils import native

# Launches of the kernel since the process started (or the last reset by a
# caller that wants to see whether a run went through it).
launches = 0

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}  # the launch's bf16 flag
_TAIL_NONE, _TAIL_RESIDUAL, _TAIL_DOWNSAMPLE = 0, 1, 2


def _lib() -> ctypes.CDLL:
    lib = native.load("frozen_bn")
    if not getattr(lib, "_sbd_typed", False):
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.frozen_bn_launch.argtypes = [i, i, i, p, i, p, p, p, p, f, p, i, p, p, p, p, f,
                                         p, ll, i, ll, p]
        lib.frozen_bn_launch.restype = i
        lib.frozen_bn_route.argtypes = [i, i, i, i, i, p, p, p]
        lib.frozen_bn_route.restype = i
        lib._sbd_typed = True
    return lib


def _nhwc(name: str, t: torch.Tensor) -> int:
    """1 for a channels-last tensor, 0 for an NCHW-contiguous one (a tensor
    that is both has the same memory order either way)."""
    if t.dim() != 4:
        raise ValueError(f"{name} must be (N, C, H, W), got {tuple(t.shape)}")
    if t.is_contiguous(memory_format=torch.channels_last):
        return 1
    if t.is_contiguous():
        return 0
    raise ValueError(f"{name} must be channels-last or NCHW-contiguous, got strides "
                     f"{t.stride()} for shape {tuple(t.shape)}")


def _stats(name: str, vectors: Sequence[torch.Tensor], x: torch.Tensor):
    """A BatchNorm's (mean, var, weight, bias) as float32 vectors of C
    entries on x's device (float32 contiguous vectors pass as they are)."""
    c = x.shape[1]
    out = []
    for v in vectors:
        if v.device != x.device or v.shape != (c,):
            raise ValueError(f"{name}'s statistics must be ({c},) on {x.device}, got "
                             f"{tuple(v.shape)} on {v.device}")
        out.append(v.float().contiguous())
    return out


def _launch(a: torch.Tensor, stats_a, eps: float, tail: int, relu: bool,
            r: Optional[torch.Tensor] = None, stats_d=None, d_eps: float = 0.0) -> torch.Tensor:
    global launches
    if not a.is_cuda or (r is not None and not r.is_cuda):
        raise ValueError("the frozen BatchNorm kernel takes CUDA tensors only; run "
                         "ops.frozen_bn for tensors on the CPU")
    if a.dtype not in _DTYPES:
        raise ValueError(f"the frozen BatchNorm kernel takes bf16 or float32, got {a.dtype}")
    a_nhwc = _nhwc("the input", a)
    r_nhwc = 0
    if r is not None:
        if r.shape != a.shape or r.dtype != a.dtype or r.device != a.device:
            raise ValueError(f"the residual {tuple(r.shape)} {r.dtype} on {r.device} must "
                             f"match the input {tuple(a.shape)} {a.dtype} on {a.device}")
        r_nhwc = _nhwc("the residual", r)
    mean, var, weight, bias = _stats("the BatchNorm", stats_a, a)
    d = (_stats("the downsample BatchNorm", stats_d, a) if stats_d is not None
         else (None,) * 4)
    _, c, h, w = a.shape
    out = torch.empty_like(a)  # a's layout
    if a.numel() == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.frozen_bn_launch(
            _DTYPES[a.dtype], tail, int(relu), a.data_ptr(), a_nhwc, mean.data_ptr(),
            var.data_ptr(), weight.data_ptr(), bias.data_ptr(), float(eps), ptr(r), r_nhwc,
            *(ptr(t) for t in d), float(d_eps), out.data_ptr(), a.numel(), c, h * w, stream)
    if err != 0:
        raise RuntimeError(f"frozen_bn kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def route(a: torch.Tensor, r: Optional[torch.Tensor] = None) -> str:
    """The kernel's route for input ``a`` (and residual ``r``): "vector" or
    "scalar", as the launch chooses it (builds the kernel)."""
    # a fresh output is aligned, as the null pointer passed for it
    return ("vector", "scalar")[_lib().frozen_bn_route(
        _DTYPES[a.dtype], _TAIL_NONE if r is None else _TAIL_RESIDUAL, _nhwc("the input", a),
        0 if r is None else _nhwc("the residual", r), a.shape[1], a.data_ptr(),
        None if r is None else r.data_ptr(), None)]


def frozen_bn_act_cuda(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor, eps: float,
                       relu: bool) -> torch.Tensor:
    """``frozen_bn.bn_act`` in one launch on the current stream."""
    return _launch(x, (mean, var, weight, bias), eps, _TAIL_NONE, relu)


def frozen_bn_add_relu_cuda(a: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor, eps: float,
                            residual: torch.Tensor, d_mean: Optional[torch.Tensor] = None,
                            d_var: Optional[torch.Tensor] = None,
                            d_weight: Optional[torch.Tensor] = None,
                            d_bias: Optional[torch.Tensor] = None,
                            d_eps: float = 1e-5) -> torch.Tensor:
    """``frozen_bn.bn_add_relu`` in one launch on the current stream: with
    the downsample BatchNorm's ``d_*``, its BatchNorm of ``residual`` is
    computed in the same launch."""
    if d_mean is None:
        return _launch(a, (mean, var, weight, bias), eps, _TAIL_RESIDUAL, True, residual)
    return _launch(a, (mean, var, weight, bias), eps, _TAIL_DOWNSAMPLE, True, residual,
                   (d_mean, d_var, d_weight, d_bias), d_eps)


@torch.library.custom_op("sbd::frozen_bn_act", mutates_args=())
def frozen_bn_act_op(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     relu: bool) -> torch.Tensor:
    """``sbd::frozen_bn_act``: ``relu(bn(x))`` (or ``bn(x)``). This body is
    the implementation for every device but CUDA: the plain composition."""
    trace.count("bn.frozen")
    return frozen_bn.bn_act(x, mean, var, weight, bias, eps, relu)


@frozen_bn_act_op.register_kernel("cuda")
def _frozen_bn_act_op_cuda(x, mean, var, weight, bias, eps, relu):
    out = frozen_bn_act_cuda(x, mean, var, weight, bias, eps, relu)
    trace.count("bn.frozen")
    trace.count("bn.fused")
    return out


@frozen_bn_act_op.register_fake
def _frozen_bn_act_op_fake(x, mean, var, weight, bias, eps, relu):
    return torch.empty_like(x)


@torch.library.custom_op("sbd::frozen_bn_add_relu", mutates_args=())
def frozen_bn_add_relu_op(a: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor, eps: float,
                          residual: torch.Tensor, d_mean: Optional[torch.Tensor] = None,
                          d_var: Optional[torch.Tensor] = None,
                          d_weight: Optional[torch.Tensor] = None,
                          d_bias: Optional[torch.Tensor] = None,
                          d_eps: float = 1e-5) -> torch.Tensor:
    """``sbd::frozen_bn_add_relu``: ``relu(bn(a) + r)``, r the residual or,
    given ``d_*``, its downsample BatchNorm. This body is the implementation
    for every device but CUDA: the plain composition."""
    trace.count("bn.frozen", 1 if d_mean is None else 2)
    return frozen_bn.bn_add_relu(a, mean, var, weight, bias, eps, residual, d_mean, d_var,
                                 d_weight, d_bias, d_eps)


@frozen_bn_add_relu_op.register_kernel("cuda")
def _frozen_bn_add_relu_op_cuda(a, mean, var, weight, bias, eps, residual, d_mean=None,
                                d_var=None, d_weight=None, d_bias=None, d_eps=1e-5):
    out = frozen_bn_add_relu_cuda(a, mean, var, weight, bias, eps, residual, d_mean, d_var,
                                  d_weight, d_bias, d_eps)
    n = 1 if d_mean is None else 2
    trace.count("bn.frozen", n)
    trace.count("bn.fused", n)
    return out


@frozen_bn_add_relu_op.register_fake
def _frozen_bn_add_relu_op_fake(a, mean, var, weight, bias, eps, residual, d_mean=None,
                                d_var=None, d_weight=None, d_bias=None, d_eps=1e-5):
    return torch.empty_like(a)
