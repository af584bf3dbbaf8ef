"""Test-time augmentation and the device-side resize of the port against the
JAX package's, following ``tests/test_tta.py``: the mirror, the hflip merge
and its equivariance, hflip detect, ``MultiScaleBatchDetector`` and
``MultiScaleDetector`` (letterbox too) on the same weights at two tiny
scales, SSD's plan check, ``resize_images``/``letterbox_images`` against
``jax.image.resize``, and ``boxes_to_original``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu import config as jax_config
from shape_based_object_detection_tpu import detection as jax_det
from shape_based_object_detection_tpu.ops import anchors as jax_anchors
from shape_based_object_detection_tpu.ops import boxes as jax_boxes
from shape_based_object_detection_tpu.utils import image as jax_image
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch import detection as det_lib
from shape_based_object_detection_torch.models.factory import build_model
from shape_based_object_detection_torch.ops import boxes as box_ops
from shape_based_object_detection_torch.utils import image as image_lib
from tests.torch_parity import (  # noqa: F401
    assert_matched, jax_variables, one_torch_thread, port_model, with_detect,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SCALES = (128, 160)


@pytest.fixture(scope="module")
def tiny():
    """The tiny RetinaNet of both packages on the same weights, at score
    threshold 0 so a fresh model detects."""
    jcfg = jax_config.get_config("tiny_retinanet")
    tcfg = torch_config.get_config("tiny_retinanet")
    jmodel = with_detect(jcfg.model, score_threshold=0.0)
    tmodel = with_detect(tcfg.model, score_threshold=0.0)
    module, variables = jax_variables(jmodel, seed=1)
    port, anchors = port_model(tmodel, variables)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, tmodel=tmodel, module=module,
                variables=variables, port=port, anchors=anchors)


def _lists(det):
    """Fixed-size Detections -> per image (boxes, scores, labels) of the
    valid slots."""
    out = []
    for i in range(det.valid.shape[0]):
        v = np.asarray(det.valid[i])
        out.append(tuple(np.asarray(t[i])[v] for t in (det.boxes, det.scores, det.labels)))
    return out


def test_mirror_boxes_is_involution():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 0.8, (32, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 0.2, (32, 2))], 1).astype(np.float32)
    m = det_lib.mirror_boxes_x(torch.from_numpy(boxes))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jax_det.mirror_boxes_x(boxes)))
    assert (m[:, 0] <= m[:, 2]).all()
    np.testing.assert_allclose((m[:, 2] - m[:, 0]).numpy(), boxes[:, 2] - boxes[:, 0],
                               atol=1e-6)
    np.testing.assert_allclose(det_lib.mirror_boxes_x(m).numpy(), boxes, atol=1e-6)


def _toy(seed):
    """Logits, offsets and anchors for postprocess alone, sigmoid scoring."""
    cfg = with_detect(torch_config.tiny_test_model("retinanet"), use_sigmoid=True,
                      pre_nms_top_k=8, max_detections=8, score_threshold=0.05)
    rng = np.random.default_rng(seed)
    a = 64
    anchors = np.concatenate([rng.uniform(0.2, 0.8, (a, 2)),
                              rng.uniform(0.05, 0.2, (a, 2))], 1).astype(np.float32)
    logits = rng.normal(0, 2, (2, a, 3)).astype(np.float32)
    offsets = rng.normal(0, 0.5, (2, a, 4)).astype(np.float32)
    return (torch.from_numpy(t) for t in (logits, offsets, anchors)), cfg


@pytest.mark.parametrize("empty", ["flipped", "original"])
def test_tta_merge_with_an_empty_half(empty):
    """A half that scores nothing above the threshold adds nothing: the
    merge equals the plain postprocess of the other half (mirrored back
    when that is the flipped one; a mirror keeps every IoU)."""
    (logits, offsets, anchors), cfg = _toy(3)
    dead = torch.full_like(logits, -30.0)
    halves = [logits, dead] if empty == "flipped" else [dead, logits]
    tta = det_lib.postprocess_tta_hflip(torch.cat(halves), torch.cat([offsets, offsets]),
                                        anchors, cfg)
    plain = det_lib.postprocess(logits, offsets, anchors, cfg)
    v = plain.valid
    assert torch.equal(tta.valid, v) and v.any()
    boxes = plain.boxes if empty == "flipped" else det_lib.mirror_boxes_x(plain.boxes)
    np.testing.assert_allclose(tta.boxes[v].numpy(), boxes[v].numpy(), atol=1e-6)
    np.testing.assert_allclose(tta.scores[v].numpy(), plain.scores[v].numpy(), atol=1e-6)
    assert torch.equal(tta.labels[v], plain.labels[v])


def test_tta_detect_flip_equivariant(tiny):
    """detect(hflip(x)) is the mirror of detect(x), slot by slot."""
    cfg = with_detect(tiny["tmodel"], tta_hflip=True)
    detect = det_lib.make_detect_fn(tiny["port"], tiny["anchors"], cfg, device="cpu")
    x = np.random.default_rng(4).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    det = detect(x)
    det_f = detect(np.ascontiguousarray(x[:, :, ::-1]))
    v = det.valid
    assert torch.equal(det_f.valid, v) and v.any()
    np.testing.assert_allclose(det_f.boxes[v].numpy(),
                               det_lib.mirror_boxes_x(det.boxes)[v].numpy(), atol=2e-5)
    np.testing.assert_allclose(det_f.scores[v].numpy(), det.scores[v].numpy(), atol=2e-5)
    assert torch.equal(det_f.labels[v], det.labels[v])
    assert det.boxes.shape == (2, cfg.detect.max_detections, 4)


def test_tta_on_a_symmetric_image(tiny):
    """A mirror-symmetric image is its own flip: the flipped half of the
    doubled batch gives the same scores and classes as the original half,
    and its boxes, mirrored back, are the original half's mirror images;
    detect gives the same answer for the image and its flip."""
    cfg = with_detect(tiny["tmodel"], tta_hflip=True)
    x = np.random.default_rng(11).integers(0, 256, (1, 128, 128, 3), dtype=np.uint8)
    x[:, :, 64:] = x[:, :, :64][:, :, ::-1]
    flipped = np.ascontiguousarray(x[:, :, ::-1])
    assert (flipped == x).all()
    normalized = image_lib.normalize_images(torch.from_numpy(x))
    both = torch.cat([normalized, normalized.flip(2)]).permute(0, 3, 1, 2)
    with torch.no_grad():
        boxes, scores, classes, valid = det_lib.tta_hflip_candidates(
            *tiny["port"](both), tiny["anchors"], cfg)
    k = cfg.detect.pre_nms_top_k
    assert boxes.shape == (1, 2 * k, 4)
    assert torch.equal(scores[:, :k], scores[:, k:]) and torch.equal(classes[:, :k], classes[:, k:])
    np.testing.assert_allclose(boxes[:, k:].numpy(),
                               det_lib.mirror_boxes_x(boxes[:, :k]).numpy(), atol=1e-6)
    detect = det_lib.make_detect_fn(tiny["port"], tiny["anchors"], cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(detect(x), detect(flipped)))


def test_tta_detect_equals_jax(tiny):
    """hflip detect, the port against JAX's detect_tta on the same weights:
    every detection matched (label, box IoU >= 0.99, score within 1e-3)."""
    jcfg, tcfg = (with_detect(tiny[k], tta_hflip=True) for k in ("jmodel", "tmodel"))
    jax_detect = jax_det.make_detect_fn(tiny["module"], jax_anchors.anchors_for_model(jcfg),
                                        jcfg, use_pallas=False)
    detect = det_lib.make_detect_fn(tiny["port"], tiny["anchors"], tcfg, device="cpu")
    images = np.random.default_rng(5).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    assert_matched(_lists(detect(images)),
                   _lists(jax_detect(tiny["variables"], jnp.asarray(images))), [1.0, 1.0])


def test_tta_detect_above_4096_candidates_equals_jax(tiny):
    """hflip detect with pre_nms_top_k 2100: its merge holds 4200 candidates
    per image, above the bitmask route of the card's kernel. The port
    against JAX's detect_tta on the same weights, at the parity bars."""
    jcfg, tcfg = (with_detect(tiny[k], tta_hflip=True, pre_nms_top_k=2100)
                  for k in ("jmodel", "tmodel"))
    jax_detect = jax_det.make_detect_fn(tiny["module"], jax_anchors.anchors_for_model(jcfg),
                                        jcfg, use_pallas=False)
    detect = det_lib.make_detect_fn(tiny["port"], tiny["anchors"], tcfg, device="cpu")
    images = np.random.default_rng(15).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    normalized = image_lib.normalize_images(torch.from_numpy(images))
    with torch.no_grad():
        merged = det_lib.tta_hflip_candidates(
            *tiny["port"](torch.cat([normalized, normalized.flip(2)]).permute(0, 3, 1, 2)),
            tiny["anchors"], tcfg)
    assert merged[1].shape == (2, 4200)
    assert_matched(_lists(detect(images)),
                   _lists(jax_detect(tiny["variables"], jnp.asarray(images))), [1.0, 1.0])


def test_multiscale_batch_detector_equals_jax(tiny):
    """Two scales (the base and an on-device resize to 160) merged by one
    NMS, against the JAX package's MultiScaleBatchDetector."""
    want = jax_det.MultiScaleBatchDetector(tiny["jmodel"], tiny["variables"], SCALES,
                                           tiny["jcfg"].data, use_pallas=False)
    got = det_lib.MultiScaleBatchDetector(tiny["tmodel"], tiny["port"], SCALES,
                                          tiny["tcfg"].data, device="cpu")
    images = np.random.default_rng(6).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    parts = got.scale_detections(images)
    assert len(parts) == 2 and all(p.valid.any() for p in parts)
    assert_matched(_lists(got(images)),
                   _lists(want(tiny["variables"], jnp.asarray(images))), [1.0, 1.0])


@pytest.mark.parametrize("letterbox", [False, True])
def test_multiscale_detector_equals_jax(tiny, letterbox):
    """One odd-sized image at two scales, host-resized (or letterboxed, with
    the per-scale rounding correction), against JAX's MultiScaleDetector:
    boxes in original pixels matched within IoU 0.99 (corners within
    1e-4 of the image's size for a box clipped flat)."""
    scales = (128, 96)
    want = jax_det.MultiScaleDetector(tiny["jmodel"], tiny["variables"], scales,
                                      tiny["jcfg"].data, use_pallas=False,
                                      letterbox=letterbox)
    got = det_lib.MultiScaleDetector(tiny["tmodel"], tiny["port"], scales,
                                     tiny["tcfg"].data, device="cpu", letterbox=letterbox)
    image = np.random.default_rng(7).integers(0, 256, (101, 143, 3), dtype=np.uint8)
    assert_matched([got(image)], [want(image)], [143.0])


def test_multiscale_single_scale_is_plain_detect(tiny):
    """One scale, the base: the batch detector is the plain detect, and the
    per-image one equals detect_single_image (a second NMS over survivors
    changes nothing)."""
    images = np.random.default_rng(8).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    detect = det_lib.make_detect_fn(tiny["port"], tiny["anchors"], tiny["tmodel"],
                                    device="cpu")
    ms = det_lib.MultiScaleBatchDetector(tiny["tmodel"], tiny["port"], [128], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(ms(images), detect(images)))
    one = det_lib.MultiScaleDetector(tiny["tmodel"], tiny["port"], [128], device="cpu")
    image = images[0, :100]
    got, want = one(image), det_lib.detect_single_image(detect, image, 128)
    assert len(want[1]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_multiscale_rejects_a_scale_that_changes_the_ssd_plan():
    """SSD's extras and heads depend on the image size: 512 cannot share
    SSD300's weights, and both detectors say so when built."""
    cfg = torch_config.get_config("tiny_ssd")
    module, anchors = build_model(cfg.model, device="cpu")
    for cls in (det_lib.MultiScaleBatchDetector, det_lib.MultiScaleDetector):
        with pytest.raises(ValueError, match="not scale-agnostic"):
            cls(cfg.model, module, [300, 512], cfg.data, device="cpu")
    # the int8 tiers compose (at one scale here): the weight-only detector
    # equals that tier's detect
    from shape_based_object_detection_torch.quantize import make_serving_detect

    ms = det_lib.MultiScaleBatchDetector(cfg.model, module, [300], device="cpu",
                                         quantize="weights")
    images = np.random.default_rng(9).integers(0, 256, (1, 300, 300, 3), dtype=np.uint8)
    detect, _ = make_serving_detect(module, anchors, cfg.model, cfg.data, "weights", "cpu")
    assert all(torch.equal(a, b) for a, b in zip(ms(images), detect(images)))


@pytest.mark.parametrize("h,w,out", [(512, 512, 640), (512, 512, 384), (128, 128, 128),
                                     (600, 400, 500), (400, 600, 500), (500, 700, 500),
                                     (500, 300, 500)])
def test_resize_images_equals_jax(h, w, out):
    """On-device bilinear resize against jax.image.resize, up and down
    (antialiased as JAX's on the way down), within 1e-5 on [0, 1] pixels;
    also where one axis shrinks and the other grows or keeps its size."""
    x = np.random.default_rng(h * w + out).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax_image.resize_images(jnp.asarray(x), out))
    got = image_lib.resize_images(torch.from_numpy(x), out)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,size", [(300, 500, 640), (300, 500, 384), (40, 3000, 64),
                                      (120, 100, 96), (600, 2, 512), (600, 1, 512),
                                      (1, 600, 512)])
def test_letterbox_images_equals_jax(h, w, size):
    """The canvas and scale of letterbox_images against JAX's, within 1e-5;
    a short side that would round to 0 keeps one pixel, and a short side
    that rounds to its own size keeps it while the long side shrinks."""
    x = np.random.default_rng(h * w).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    want, want_scale = jax_image.letterbox_images(jnp.asarray(x), size)
    got, scale = image_lib.letterbox_images(torch.from_numpy(x), size)
    assert scale == pytest.approx(float(want_scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("letterboxed", [False, True])
def test_boxes_to_original_equals_jax(letterboxed):
    """Normalized boxes, some beyond the image, to original pixels, clipped
    per coordinate, for a scalar size and for per-image sizes."""
    rng = np.random.default_rng(9)
    boxes = rng.uniform(-0.2, 1.2, (3, 5, 4)).astype(np.float32)
    sizes = [(97, 133)]
    if not letterboxed:  # per-image sizes (the reference's letterbox takes one)
        sizes.append((np.array([[50.0], [97.0], [300.0]]), np.array([[80.0], [40.0], [300.0]])))
    for h, w in sizes:
        want = np.asarray(jax_boxes.boxes_to_original(
            jnp.asarray(boxes), jnp.asarray(h, jnp.float32),
            jnp.asarray(w, jnp.float32), letterboxed))
        got = box_ops.boxes_to_original(torch.from_numpy(boxes), torch.as_tensor(h),
                                        torch.as_tensor(w), letterboxed)
        np.testing.assert_array_equal(got.numpy(), want)
    assert jax.devices()[0].platform == "cpu"


def test_tta_through_predictor(tiny):
    """The Predictor takes tta_hflip from the config: a mirrored image
    comes back with mirrored pixel boxes."""
    from shape_based_object_detection_torch.serving import Predictor
    from shape_based_object_detection_torch.utils.convert import (
        state_dict_from_jax_variables,
    )

    cfg = dataclasses.replace(tiny["tcfg"], model=with_detect(tiny["tmodel"], tta_hflip=True))
    pred = Predictor(cfg, state_dict_from_jax_variables(tiny["variables"]), batch_size=2,
                     device="cpu")
    img = np.random.default_rng(10).integers(0, 256, (96, 160, 3), dtype=np.uint8)
    out, out_f = pred.predict([img, np.ascontiguousarray(img[:, ::-1])])
    assert len(out.boxes) and len(out.boxes) == len(out_f.boxes)
    w = img.shape[1]
    mirrored = np.stack([w - out.boxes[:, 2], out.boxes[:, 1],
                         w - out.boxes[:, 0], out.boxes[:, 3]], 1)
    np.testing.assert_allclose(out_f.boxes, mirrored, atol=0.05)
    np.testing.assert_allclose(out_f.scores, out.scores, atol=2e-5)
