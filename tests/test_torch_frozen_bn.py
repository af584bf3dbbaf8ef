"""The frozen BatchNorm ops (``sbd::frozen_bn_act``, ``sbd::frozen_bn_add_relu``)
and the ResNet's dispatch to them, on the CPU.

Where no autograd graph is recorded the ResNet runs each frozen BatchNorm
with what follows it as one op; the op's CPU body is the plain composition,
so its bits are the module's before the ops existed (written out below as
``parent_*``), in bf16 and float32, in both layouts, at odd C. Under
autograd the layers run as before and the gradients are the parent's, bit
for bit. An exported detect records the ops as nodes and runs them on the
CPU. The kernel itself is held to the same bits on the card
(``tests/test_torch_cuda.py``)."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from shape_based_object_detection_torch import config, export
from shape_based_object_detection_torch.detection import make_detect_fn
from shape_based_object_detection_torch.models import resnet
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.ops import frozen_bn, frozen_bn_cuda
from shape_based_object_detection_torch.utils import metrics
from tests.torch_kernel_cases import FROZEN_BN_FORMS, bits_equal, frozen_bn_inputs

EPS = 1e-5


def parent_bn(x, mean, var, weight, bias, eps=EPS):
    """The frozen branch of ``BatchNorm.forward`` before the ops."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var.float() + eps) * weight.float()
    y = (x - mean.float().view(shape)) * mul.view(shape) + bias.float().view(shape)
    return y.to(x.dtype)


def parent_form(form, x, s, r=None, d=None):
    """Each form as the module composed it: ``F.relu(bn(x))``, ``bn(x)``,
    and a bottleneck's ``F.relu(bn3(a) + residual)``."""
    if form in ("act", "bn"):
        y = parent_bn(x, *s)
        return F.relu(y) if form == "act" else y
    residual = r if d is None else parent_bn(r, *d)
    return F.relu(parent_bn(x, *s) + residual)


def op_form(form, x, s, r=None, d=None):
    if form in ("act", "bn"):
        return frozen_bn_cuda.frozen_bn_act_op(x, *s, EPS, form == "act")
    d = (None,) * 4 if d is None else d
    return frozen_bn_cuda.frozen_bn_add_relu_op(x, *s, EPS, r, *d, EPS)


@pytest.fixture(autouse=True)
def fresh_tracer():
    metrics.reset()
    yield
    metrics.reset()


@pytest.mark.parametrize("c", [8, 19, 256])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("form", FROZEN_BN_FORMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_op_on_the_cpu_equals_the_module_composition(dtype, form, layout, c):
    """The op's CPU body: the parent's composition bit for bit, NaN, +-inf
    and the type's largest values included, in the input's layout; one count
    of ``bn.frozen`` per BatchNorm and none of ``bn.fused``."""
    x, s, r, d = frozen_bn_inputs(form, (2, c, 6, 5), dtype, c, (layout, layout), edge=True,
                                  device="cpu")
    with torch.no_grad():
        got = op_form(form, x, s, r, d)
    want = parent_form(form, x, s, r, d)
    assert bits_equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last) == (layout == "nhwc")
    assert metrics.counters() == {"bn.frozen": 2 if form == "downsample" else 1}


def _block(cin, ch, stride, seed):
    """A Bottleneck with its BatchNorms away from identity."""
    gen = torch.Generator().manual_seed(seed)
    block = resnet.Bottleneck(cin, ch, stride)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, (1.0 / m.weight[0].numel()) ** 0.5, generator=gen)
            elif isinstance(m, resnet.BatchNorm):
                n = m.weight.shape[0]
                for t, v in zip(m.stats(), (torch.randn(n, generator=gen) * 0.2,
                                            torch.rand(n, generator=gen) + 0.5,
                                            torch.rand(n, generator=gen) + 0.5,
                                            torch.randn(n, generator=gen) * 0.2)):
                    t.copy_(v)
    return block


def parent_bottleneck(block, x):
    """``Bottleneck.forward`` before the ops, frozen."""
    def bn(m, y):
        return parent_bn(y, *m.stats())
    y = F.relu(bn(block.bn1, block.conv1(x)))
    y = F.relu(bn(block.bn2, block.conv2(y)))
    y = bn(block.bn3, block.conv3(y))
    residual = x if block.downsample is None else bn(block.downsample_bn, block.downsample(x))
    return F.relu(y + residual)


BLOCKS = {"identity": (32, 8, 1), "downsample": (16, 8, 2), "odd-c": (19, 5, 1)}


def refuse_ops(monkeypatch):
    """The ops raise if called: a run that finishes did not use them."""
    def refuse(*args):
        raise AssertionError("the fused op ran under autograd")

    monkeypatch.setattr(frozen_bn_cuda, "frozen_bn_act_op", refuse)
    monkeypatch.setattr(frozen_bn_cuda, "frozen_bn_add_relu_op", refuse)


@pytest.fixture
def ops_refused(monkeypatch):
    refuse_ops(monkeypatch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_autograd_runs_the_layers_with_the_parents_gradients(kind, dtype, ops_refused):
    """Under autograd (the training forward) the block runs its layers, not
    the ops: output, input gradient and every parameter's gradient equal the
    parent's formula's bit for bit; each BatchNorm counts once."""
    cin, ch, stride = BLOCKS[kind]
    block = _block(cin, ch, stride, seed=cin).to(dtype)
    for m in block.modules():  # BatchNorm computes in float32 from float32 vectors
        if isinstance(m, resnet.BatchNorm):
            m.float()
    x = torch.randn(2, cin, 9, 7, generator=torch.Generator().manual_seed(1)).to(dtype)
    runs = []
    for forward in (block, lambda z: parent_bottleneck(block, z)):
        xi = x.clone().requires_grad_(True)
        y = forward(xi)
        grads = torch.autograd.grad(y.float().square().sum(),
                                    [xi, *block.parameters()])
        runs.append((y.detach(), *grads))
    for got, want in zip(*runs):
        assert bits_equal(got, want)
    assert metrics.counters() == {"bn.frozen": 4 if block.downsample is not None else 3}


@pytest.mark.parametrize("grad_mode", ["no_grad", "inference_mode", "nothing_requires_grad"])
def test_without_autograd_the_block_runs_the_ops(grad_mode, monkeypatch):
    """With no autograd graph recorded the block makes one op call per
    bn1, bn2 and end, and its output is the parent's, bit for bit."""
    block = _block(16, 8, 2, seed=3)
    x = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(2))
    calls = []
    for name in ("frozen_bn_act_op", "frozen_bn_add_relu_op"):
        op = getattr(frozen_bn_cuda, name)
        monkeypatch.setattr(frozen_bn_cuda, name,
                            lambda *a, op=op, name=name: calls.append(name) or op(*a))
    if grad_mode == "nothing_requires_grad":
        block.requires_grad_(False)
        got = block(x)
    else:
        with getattr(torch, grad_mode)():
            got = block(x)
    assert calls == ["frozen_bn_act_op", "frozen_bn_act_op", "frozen_bn_add_relu_op"]
    with torch.no_grad():
        assert bits_equal(got, parent_bottleneck(block, x))


@pytest.mark.parametrize("train_bn,train,grad,want", [
    (False, False, False, True), (False, True, False, True), (True, False, False, True),
    (True, True, False, False), (False, False, True, False), (True, True, True, False),
])
def test_fuses_decides_from_what_the_call_observes(train_bn, train, grad, want):
    """One op only for frozen BatchNorm (trainable BatchNorm in a training
    call normalises with batch statistics) with no autograd graph."""
    bn = resnet.BatchNorm(8, train_bn=train_bn)
    x = torch.randn(1, 8, 2, 2)
    with torch.set_grad_enabled(grad):
        assert resnet.fuses(train, x, bn) is want


def test_the_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's functions take CUDA tensors only: the CPU runs the op's
    plain body, chosen by the dispatcher, never a fallback."""
    x, s, _, _ = frozen_bn_inputs("act", (1, 8, 2, 2), torch.float32, 0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        frozen_bn_cuda.frozen_bn_act_cuda(x, *s, EPS, True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        frozen_bn_cuda.frozen_bn_add_relu_cuda(x, *s, EPS, x)


@pytest.fixture(scope="module")
def tiny():
    cfg = config.resolve_config("tiny_retinanet", ["model.detect.score_threshold=0.0"])
    module, anchors = build_model(cfg.model, device="cpu")
    return cfg, module, anchors


def test_a_detect_forward_counts_every_frozen_batchnorm(tiny):
    """A no-grad forward of the tiny RetinaNet (a ResNet-50 at a fraction
    of its widths): 53 frozen BatchNorms in 49 op calls, none fused on the
    CPU; building a model (its shape pass on the meta device) counts none."""
    build_model(tiny[0].model, device="cpu")
    assert metrics.counters() == {}
    cfg, module, _ = tiny
    x = torch.rand(1, 3, cfg.model.image_size, cfg.model.image_size)
    with torch.no_grad():
        module(x)
    assert metrics.counters() == {"bn.frozen": 53}


def test_export_records_the_ops_and_runs_them_on_the_cpu(tiny, monkeypatch):
    """``torch.export`` of the tiny RetinaNet's detect records the stem's and
    each bottleneck's bn1 and bn2 as ``sbd::frozen_bn_act`` (33) and each
    bottleneck's end as ``sbd::frozen_bn_add_relu`` (16); the loaded program
    runs their CPU bodies and equals live detect."""
    cfg, module, anchors = tiny
    blob = export.export_detect(module, anchors, cfg.model, cfg.data, 2, "cpu")
    loaded = export.load_detect(blob, "cpu")
    targets = [n.target for n in loaded.program.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.sbd.frozen_bn_act.default) == 33
    assert targets.count(torch.ops.sbd.frozen_bn_add_relu.default) == 16
    calls = []
    for name in ("bn_act", "bn_add_relu"):
        plain = getattr(frozen_bn, name)
        monkeypatch.setattr(frozen_bn, name,
                            lambda *a, plain=plain, name=name: calls.append(name) or plain(*a))
    images = torch.randint(0, 256, (2, cfg.model.image_size, cfg.model.image_size, 3),
                           dtype=torch.uint8, generator=torch.Generator().manual_seed(4))
    got = loaded(images.numpy())
    assert calls.count("bn_act") == 33 and calls.count("bn_add_relu") == 16
    live = make_detect_fn(module, anchors, cfg.model, cfg.data, "cpu")(images.numpy())
    assert all(torch.equal(a, b) for a, b in zip(got, live))


def test_train_bn_training_forward_keeps_batch_statistics(monkeypatch):
    """Trainable BatchNorm in a training call never takes the ops, with
    grad mode off too: it normalises with the batch's statistics."""
    cfg = config.get_config("tiny_retinanet").model
    module, _ = build_model(dataclasses.replace(cfg, train_bn=True), device="cpu", train=True)
    x = torch.rand(2, 3, cfg.image_size, cfg.image_size)
    refuse_ops(monkeypatch)
    with torch.no_grad():
        module.backbone(x, train=True)
    assert "bn.frozen" not in metrics.counters()
