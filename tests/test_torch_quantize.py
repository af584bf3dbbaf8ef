"""The port's int8 serving tiers (``quantize.py``) against the JAX package's,
following ``tests/test_quantize.py``: ``quantize_params`` bit-equal, one
``Int8Conv2d`` bit-equal to the JAX interceptor (dynamic and static scales,
float32 and bf16, 3x3 stride 1 and 2, 1x1, the 7x7 stem, a dilated 3x3),
the whole tiny RetinaNet and SSD in each tier against JAX in the same tier,
calibration (keys, values, a JSON saved by JAX, static = dynamic at batch
1), the multi-scale detector in an int8 tier, the Predictor's tiers, and
the errors."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu import detection as jax_det
from shape_based_object_detection_tpu import quantize as jax_q
from shape_based_object_detection_tpu.ops.anchors import anchors_for_model as jax_anchors
from shape_based_object_detection_tpu.utils import image as jax_image
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch import quantize as q_lib
from shape_based_object_detection_torch.detection import make_detect_fn
from shape_based_object_detection_torch.serving import Predictor
from shape_based_object_detection_torch.utils import image as image_lib
from tests.torch_parity import (  # noqa: F401
    assert_matched, jax_variables, one_torch_thread, port_model, with_detect,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the port against JAX in the same tier: a tenth of the JAX package's own
# int8-vs-float bars (tests/test_quantize.py: max 0.2, mean 0.02)
MAX_ERR, MEAN_ERR = 0.02, 0.002
# The whole-model tier tests quantize every convolution, as the default
# min_size (1024 elements) does at full width, where the smallest R50, FPN
# and SSD convolution holds 1728 (SSD's conv1_1). The tiny presets' 8-channel
# convolutions fall under 1024 and would stay float; a float convolution
# whose last bit depends on the order of its sums (XLA's and PyTorch's
# differ) ahead of an int8 quantizer flips int8 levels, and the flips
# cascade: the JAX package's own full tier on the tiny RetinaNet moves by
# 0.18 under a 1e-7 relative perturbation of its input. That configuration
# exists only in the tiny presets.
WHOLE_MODEL_MIN_SIZE = 1
TIERS = [("weights", None), ("full", None), ("full", "static")]


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """float32 values that bf16 holds exactly: the port stores a bf16
    model's convolution weights in bf16, so both sides start from the same
    numbers."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module", params=["retinanet", "ssd"])
def tiny(request):
    """A tiny model of both packages on the same weights, score threshold 0,
    a batch of images, and scales calibrated by JAX on it."""
    jcfg = with_detect(jax_config.tiny_test_model(request.param), score_threshold=0.0)
    tcfg = with_detect(torch_config.tiny_test_model(request.param), score_threshold=0.0)
    module, variables = jax_variables(jcfg, seed=1)
    port, anchors = port_model(tcfg, variables)
    size = jcfg.image_size
    images = np.random.default_rng(2).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    scales = jax_q.calibrate_activation_scales(module, variables, [images],
                                               min_size=WHOLE_MODEL_MIN_SIZE)
    # quantized outside jit, as make_serving_detect does
    qvariables = jax_q.quantize_params(variables, min_size=WHOLE_MODEL_MIN_SIZE)
    return dict(family=request.param, jcfg=jcfg, tcfg=tcfg, module=module,
                variables=variables, qvariables=qvariables, port=port, anchors=anchors,
                images=images, scales=scales)


def test_quantize_params_equals_jax(tiny):
    """The same convolutions quantized, q bit-equal (HWIO -> OIHW) and
    scale bit-equal; the stored bytes under half of float32's."""
    jq = jax_q.quantize_params(tiny["variables"])
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jq, is_leaf=lambda x: isinstance(x, jax_q.QTensor))[0]:
        if isinstance(leaf, jax_q.QTensor):
            want[".".join(p.key for p in path[1:-1]) + ".weight"] = leaf
    got = q_lib.quantize_params(tiny["port"])
    quantized = {k: v for k, v in got.items() if isinstance(v, q_lib.QTensor)}
    assert set(quantized) == set(want) and len(want) > 10
    for key, qt in quantized.items():
        ref = want[key]
        assert qt.q.dtype == torch.int8
        np.testing.assert_array_equal(qt.q.numpy(), np.asarray(ref.q).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(qt.scale.numpy().reshape(-1),
                                      np.asarray(ref.scale).reshape(-1))
    float_bytes = sum(t.nbytes for t in tiny["port"].state_dict().values())
    assert q_lib.quantized_bytes(got) < 0.5 * float_bytes
    deq = q_lib.dequantize_params(got)
    for key, qt in quantized.items():
        assert torch.equal(deq[key], qt.q.float() * qt.scale)


# (kernel, stride, padding, dilation, in channels, out channels, input size)
CONVS = {"3x3": (3, 1, 1, 1, 8, 16, 12), "3x3_stride2": (3, 2, 1, 1, 8, 16, 13),
         "1x1": (1, 1, 0, 1, 32, 16, 9), "7x7_stem": (7, 2, 3, 1, 3, 16, 20),
         "3x3_dilated": (3, 1, 6, 6, 8, 16, 16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("conv", list(CONVS))
def test_int8_conv_equals_jax_interceptor(conv, static, dtype):
    """One Int8Conv2d against the JAX interceptor on the same input and
    dequantized weights, op by op (eagerly, as the JAX package's own
    interceptor tests run it): bit-equal (the int8 operands, the int32
    product, the epilogue and the bias order all match)."""
    k, s, p, d, c, o, h = CONVS[conv]
    rng = np.random.default_rng(hash(conv) % 1000)
    x = rng.uniform(-2, 2, (2, h, h + 1, c)).astype(np.float32)
    w = rng.normal(0, (1.0 / (k * k * c)) ** 0.5, (k, k, c, o)).astype(np.float32)
    b = rng.normal(0, 0.1, (o,)).astype(np.float32)
    if dtype == "bfloat16":
        x, w, b = _bf16_exact(x), _bf16_exact(w), _bf16_exact(b)
    amax = float(np.abs(x).max())

    class M(nn.Module):
        @nn.compact
        def __call__(self, y):
            return nn.Conv(o, (k, k), strides=(s, s), padding=((p, p), (p, p)),
                           kernel_dilation=(d, d), dtype=getattr(jnp, dtype), name="c")(y)

    qv = jax_q.quantize_params({"params": {"c": {"kernel": w, "bias": b}}}, min_size=1)
    interceptor = jax_q.int8_conv_interceptor(
        min_size=1, activation_scales={"c": amax} if static else None)
    with nn.intercept_methods(interceptor):
        want = np.asarray(M().apply(jax_q.dequantize_params(qv), jnp.asarray(x))
                          .astype(jnp.float32))

    tdtype = getattr(torch, dtype)
    tconv = torch.nn.Conv2d(c, o, k, stride=s, padding=p, dilation=d).to(tdtype)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        tconv.bias.copy_(torch.from_numpy(b))
    qconv = q_lib.Int8Conv2d(tconv, "static" if static else "dynamic",
                             amax if static else None)
    with torch.inference_mode():
        got = qconv(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdtype))
    assert got.dtype == tdtype
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


def test_int8_product_plain_is_exact_at_the_extremes():
    """The plain int8 product (float64) equals an integer convolution at
    the largest magnitudes: every operand -127 or 127."""
    rng = np.random.default_rng(0)
    xq = torch.from_numpy(rng.choice([-127, 127], (1, 6, 6, 512)).astype(np.int8))
    wq = torch.from_numpy(rng.choice([-127, 127], (8, 3, 3, 512)).astype(np.int8))
    got = q_lib.int8_conv2d_plain(xq, wq, [1, 1], [1, 1], [1, 1])
    want = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2).long(),
                                      wq.permute(0, 3, 1, 2).long(), padding=1)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), want.permute(0, 2, 3, 1))


def test_dynamic_scale_is_per_image():
    """An image's int8 result does not depend on what it is batched with."""
    rng = np.random.default_rng(3)
    conv = torch.nn.Conv2d(4, 8, 3, padding=1)
    qconv = q_lib.Int8Conv2d(conv, "dynamic")
    a = torch.from_numpy(rng.uniform(-1, 1, (1, 4, 8, 8)).astype(np.float32))
    big = 100.0 * torch.from_numpy(rng.uniform(-1, 1, (1, 4, 8, 8)).astype(np.float32))
    with torch.inference_mode():
        alone = qconv(torch.cat([a, torch.zeros_like(a)]))
        mixed = qconv(torch.cat([a, big]))
    assert torch.equal(alone[0], mixed[0])


@functools.lru_cache(maxsize=None)
def _jax_postprocess(cfg):
    return jax.jit(functools.partial(jax_det.postprocess, anchors_cxcywh=jax_anchors(cfg),
                                     cfg=cfg, use_pallas=False))


def _lists(det):
    out = []
    for i in range(det.valid.shape[0]):
        v = np.asarray(det.valid[i])
        out.append(tuple(np.asarray(t[i])[v] for t in (det.boxes, det.scores, det.labels)))
    return out


@pytest.mark.parametrize("mode,static", TIERS)
def test_tier_forward_and_detect_equal_jax(tiny, mode, static):
    """The whole tiny model in each tier against JAX in the same tier on the
    same weights (and, static, the scales JAX calibrated), every
    convolution eligible (WHOLE_MODEL_MIN_SIZE): logits and offsets within
    MAX_ERR / MEAN_ERR, detections matched at the repo's bar (box IoU 0.99,
    score 1e-3)."""
    scales = tiny["scales"] if static else None
    ms = WHOLE_MODEL_MIN_SIZE

    def jax_forward(qvariables, x):
        qv = jax_q.dequantize_params(qvariables)
        if mode == "weights":
            return tiny["module"].apply(qv, x)
        with nn.intercept_methods(jax_q.int8_conv_interceptor(min_size=ms,
                                                              activation_scales=scales)):
            return tiny["module"].apply(qv, x)

    # the full tiers op by op: inside jit XLA on the CPU contracts
    # multiply-adds into FMAs and turns a division by a constant into a
    # product with its reciprocal, last-bit differences the tiers' quantizers
    # amplify (quantize.py); the weight-only tier has no quantizer, so jit
    if mode == "weights":
        jax_forward = jax.jit(jax_forward)

    want = jax_forward(tiny["qvariables"],
                       jax_image.normalize_images(jnp.asarray(tiny["images"])))
    qmodule = q_lib.quantize_module(tiny["port"], mode, scales, min_size=ms, device="cpu")
    with torch.inference_mode():
        got = qmodule(image_lib.normalize_images(torch.from_numpy(tiny["images"]))
                      .permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        err = np.abs(g.numpy() - np.asarray(w))
        assert err.max() <= MAX_ERR and err.mean() <= MEAN_ERR, (err.max(), err.mean())
    want_det = _jax_postprocess(tiny["jcfg"])(*want)
    got_det = make_detect_fn(qmodule, tiny["anchors"], tiny["tcfg"], device="cpu")(
        tiny["images"])
    size = float(tiny["jcfg"].image_size)
    assert_matched(_lists(got_det), _lists(want_det), [size] * len(tiny["images"]))


def test_calibration_equals_jax(tiny, tmp_path):
    """The port's calibration keys are JAX's, values within 1e-5 relative;
    a JSON saved by JAX loads into the port's static tier, bit-equal to
    the tier built from the same scales in memory (which
    test_tier_forward_and_detect_equal_jax holds against JAX)."""
    got = q_lib.calibrate_activation_scales(tiny["port"], [tiny["images"]])
    want = jax_q.calibrate_activation_scales(tiny["module"], tiny["variables"],
                                             [tiny["images"]])
    assert set(got) == set(want) and len(want) > 5
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-5 * abs(value), key
    path = str(tmp_path / "jax_scales.json")
    jax_q.save_activation_scales(path, want)
    assert q_lib.load_activation_scales(path) == want
    from_jax = q_lib.quantize_module(tiny["port"], "full", path, device="cpu")
    in_memory = q_lib.quantize_module(tiny["port"], "full", want, device="cpu")
    x = image_lib.normalize_images(torch.from_numpy(tiny["images"])).permute(0, 3, 1, 2)
    with torch.inference_mode():
        assert all(torch.equal(u, v) for u, v in zip(from_jax(x), in_memory(x)))
    # reduced over batches: a subset never exceeds the union
    sub = q_lib.calibrate_activation_scales(tiny["port"], [tiny["images"][:1]])
    assert sub.keys() == got.keys()
    assert all(sub[k] <= got[k] * (1 + 1e-5) for k in sub)  # batch 1 sums round alike


@pytest.mark.parametrize("conv", ["3x3", "7x7_stem"])
def test_static_equals_dynamic_at_batch_1(conv):
    """At batch 1 a dynamic per-image scale is the input's abs-max, so a
    static scale calibrated on that exact input reproduces the dynamic
    convolution bit for bit (the reference's strongest check of its static
    tier), the scale taken through calibrate_activation_scales."""
    k, s, p, d, _, o, h = CONVS[conv]
    model = torch.nn.Sequential()
    model.add_module("c", torch.nn.Conv2d(3, o, k, stride=s, padding=p, dilation=d))
    image = np.random.default_rng(7).integers(0, 256, (1, h, h, 3), dtype=np.uint8)
    scales = q_lib.calibrate_activation_scales(model, [image], min_size=1)
    assert set(scales) == {"c"}
    x = image_lib.normalize_images(torch.from_numpy(image)).permute(0, 3, 1, 2)
    dyn = q_lib.quantize_module(model, "full", min_size=1, device="cpu")
    sta = q_lib.quantize_module(model, "full", scales, min_size=1, device="cpu")
    with torch.inference_mode():
        assert torch.equal(dyn(x), sta(x))


def test_full_tier_keeps_the_heads_in_float(tiny):
    """In "full" the prediction convolutions dequantize and run in float;
    every other eligible convolution is an int8 product; small convolutions
    stay nn.Conv2d."""
    qmodule = q_lib.quantize_module(tiny["port"], "full", device="cpu")
    modes = {name: m.mode for name, m in qmodule.named_modules()
             if isinstance(m, q_lib.Int8Conv2d)}
    heads = {n for n in modes if q_lib.default_int8_skip(n)}
    assert heads and all(modes[n] == "weights" for n in heads)
    assert all(modes[n] == "dynamic" for n in set(modes) - heads)
    assert set(modes) == {n for n, m in tiny["port"].named_modules()
                          if isinstance(m, torch.nn.Conv2d) and m.weight.numel() >= 1024}


def test_predictor_tiers(tmp_path):
    """Predictor in each tier answers a request; its module holds int8
    tensors; a scales JSON path works as the dict does."""
    cfg = torch_config.resolve_config("tiny_retinanet", ["model.detect.score_threshold=0.0"])
    image = np.random.default_rng(4).integers(0, 256, (97, 133, 3), dtype=np.uint8)
    float_pred = Predictor(cfg, batch_size=2, device="cpu")
    path = str(tmp_path / "s.json")
    q_lib.save_activation_scales(path, q_lib.calibrate_activation_scales(
        float_pred.module, [np.stack([np.asarray(image[:128, :128])] * 2)]))
    for quantize, scales in (("weights", None), (True, None), ("full", None), ("full", path)):
        pred = Predictor(cfg, batch_size=2, device="cpu", quantize=quantize,
                         activation_scales=scales)
        out = pred.predict([image])
        assert len(out) == 1 and out[0].boxes.shape[1] == 4 and len(out[0].scores) > 0
        kinds = {m.mode for m in pred.module.modules() if isinstance(m, q_lib.Int8Conv2d)}
        assert kinds == ({"weights"} if quantize in (True, "weights")
                         else {"weights", "static" if scales else "dynamic"})


def test_mode_validation_and_errors(tiny, monkeypatch):
    port = tiny["port"]
    assert q_lib.normalize_quantize_mode(True) == "weights"
    assert q_lib.normalize_quantize_mode("full") == "full"
    assert q_lib.normalize_quantize_mode(False) == ""
    with pytest.raises(ValueError, match="unknown quantize mode"):
        q_lib.normalize_quantize_mode("Full")
    with pytest.raises(ValueError, match="only applies to quantize mode"):
        q_lib.make_serving_detect(port, tiny["anchors"], tiny["tcfg"], None, "weights",
                                  "cpu", activation_scales={"c": 1.0})
    with pytest.raises(ValueError, match="needs mode"):
        q_lib.quantize_module(port, "", device="cpu")
    missing = dict(tiny["scales"])
    key = sorted(missing)[0]
    del missing[key]
    with pytest.raises(ValueError, match=f"no calibrated activation scale for conv '{key}'"):
        q_lib.quantize_module(port, "full", missing, min_size=WHOLE_MODEL_MIN_SIZE,
                              device="cpu")
    with pytest.raises(ValueError, match="no batches"):
        q_lib.calibrate_activation_scales(port, [])
    with pytest.raises(ValueError, match="no eligible convs"):
        q_lib.calibrate_activation_scales(port, [tiny["images"]], min_size=10**9)
    # the card unless told otherwise: without one, the device rule's error
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        q_lib.quantize_module(port, "weights")


def test_int8_route_refuses_cpu_tensors():
    """The card's route takes CUDA tensors only and counts nothing when it
    refuses."""
    before = q_lib.launches
    xq = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        q_lib.int8_conv2d_cuda(xq, torch.zeros(8, 1, 1, 8, dtype=torch.int8), [1, 1],
                               [0, 0], [1, 1])
    assert q_lib.launches == before


def test_im2col_layout_matches_the_plain_product():
    """The card's A and B (zero padding of M, K and N included) give the
    plain version's product when multiplied in int64 on the CPU: the
    layout is right before any card runs it."""
    rng = np.random.default_rng(5)
    for k, s, p, d, c, o, h in CONVS.values():
        xq = torch.from_numpy(rng.integers(-127, 128, (1, h, h + 1, c)).astype(np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (o + 3, k, k, c)).astype(np.int8))
        a = q_lib.im2col_nhwc(xq, k, k, [s, s], [p, p], [d, d])
        bmat = q_lib.gemm_weight(wq)
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and bmat.shape[0] % 8 == 0
        prod = a.long() @ bmat.long().t()
        want = q_lib.int8_conv2d_plain(xq, wq, [s, s], [p, p], [d, d])
        ho, wo = want.shape[1:3]
        got = prod[:ho * wo, :o + 3].reshape(1, ho, wo, o + 3)
        assert torch.equal(got, want.long())


@pytest.mark.parametrize("mode,static", TIERS)
def test_multiscale_detector_in_an_int8_tier(monkeypatch, mode, static):
    """The tiny RetinaNet at scales (128, 160) in an int8 tier: the weights
    are quantized once (every other scale's module takes the base's int8
    tensors), the base scale's detections equal the tier's detect, and the
    other scale's equal the tier's detect of a model built at 160 on the
    same weights, fed the batch resized on the device."""
    from shape_based_object_detection_torch import detection as det_lib
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = torch_config.resolve_config("tiny_retinanet", ["model.detect.score_threshold=0.0"])
    port, anchors = build_model(cfg.model, device="cpu")
    images = np.random.default_rng(6).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    scales = q_lib.calibrate_activation_scales(port, [images]) if static else None
    real = []
    quantize_tensor = q_lib.quantize_tensor

    def counted(w, *a):
        if w.device.type != "meta":
            real.append(w.shape)
        return quantize_tensor(w, *a)

    monkeypatch.setattr(q_lib, "quantize_tensor", counted)
    ms = det_lib.MultiScaleBatchDetector(cfg.model, port, [128, 160], device="cpu",
                                         quantize=mode, activation_scales=scales)
    eligible = [m for m in port.modules()
                if isinstance(m, torch.nn.Conv2d) and m.weight.numel() >= 1024]
    assert len(real) == len(eligible)
    monkeypatch.setattr(q_lib, "quantize_tensor", quantize_tensor)
    base, other = ms.scale_detections(images)
    want = q_lib.make_serving_detect(port, anchors, cfg.model, None, mode, "cpu", scales)[0]
    assert all(torch.equal(a, b) for a, b in zip(base, want(images)))
    big_cfg = dataclasses.replace(cfg.model, image_size=160)
    big, big_anchors = build_model(big_cfg, device="cpu")
    big.load_state_dict(port.state_dict())
    want = q_lib.make_serving_detect(big, big_anchors, big_cfg, None, mode, "cpu", scales)[0]
    resized = image_lib.resize_images(torch.from_numpy(images).float() / 255.0, 160)
    assert all(torch.equal(a, b) for a, b in zip(other, want(resized)))
    assert ms(images).valid.any()
