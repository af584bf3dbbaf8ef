"""Soft-NMS of the port against the JAX package's (``ops/nms.py``
soft_nms), the reference's "matrix" backend name (``ops/nms_matrix.py``
there; greedy NMS here), and ``detection.run_nms``'s routing."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu.ops import nms as jax_nms
from shape_based_object_detection_tpu.ops.nms_matrix import (
    batched_class_aware_nms_matrix as jax_matrix,
)
from shape_based_object_detection_torch import config as torch_config
from shape_based_object_detection_torch.detection import run_nms
from shape_based_object_detection_torch.ops import nms


def _candidates(seed, b, n, classes=4, pad=7):
    """Overlapping boxes in [0, 1], scores with exact ties, a few classes
    and padding rows at the end."""
    rng = np.random.default_rng(seed)
    cxcy = rng.uniform(0.2, 0.8, (b, n, 2))
    wh = rng.uniform(0.05, 0.4, (b, n, 2))
    boxes = np.clip(np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1), 0, 1)
    scores = rng.uniform(0.01, 1.0, (b, n))
    scores[:, 5:15] = scores[:, 2:3]  # ties, broken toward the lower index
    cls = rng.integers(0, classes, (b, n))
    valid = np.ones((b, n), bool)
    valid[:, n - pad:] = False
    return (boxes.astype(np.float32), scores.astype(np.float32),
            cls.astype(np.int32), valid)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("sigma,threshold,m", [(0.5, 0.05, 30), (0.1, 0.2, 64), (0.5, 0.5, 64)])
def test_soft_nms_equals_jax(sigma, threshold, m):
    """Per image against JAX's soft_nms on the class-offset boxes: every
    slot's index and valid equal, scores within 1e-6; then the class-aware
    batch against batched_class_aware_soft_nms."""
    boxes, scores, cls, valid = _candidates(1, 3, 64)
    shifted = np.array(jax_nms.class_offset_boxes(jnp.asarray(boxes), jnp.asarray(cls)))
    got = nms.soft_nms(*_torch(shifted, scores, valid), sigma, threshold, m)
    assert got.valid.any()
    for i in range(boxes.shape[0]):
        want = jax_nms.soft_nms(jnp.asarray(shifted[i]), jnp.asarray(scores[i]),
                                jnp.asarray(valid[i]), sigma, threshold, m)
        np.testing.assert_array_equal(got.indices[i].numpy(), np.asarray(want.indices))
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_allclose(got.scores[i].numpy(), np.asarray(want.scores),
                                   rtol=0, atol=1e-6)

    det = nms.batched_class_aware_soft_nms(*_torch(boxes, scores, cls, valid),
                                           sigma, threshold, m)
    ref = jax_nms.batched_class_aware_soft_nms(
        *(jnp.asarray(a) for a in (boxes, scores, cls, valid)), sigma=sigma,
        score_threshold=threshold, max_detections=m)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(det.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(det.boxes.numpy(), np.asarray(ref.boxes))
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=1e-6)


def test_soft_nms_padding_invariance():
    """Padding rows, however high their scores, change nothing."""
    boxes, scores, _, _ = _candidates(2, 1, 30, pad=0)
    pad_boxes = np.concatenate([boxes, np.zeros((1, 10, 4), np.float32)], 1)
    pad_scores = np.concatenate([scores, np.full((1, 10), 9.0, np.float32)], 1)
    pad_valid = np.arange(40)[None] < 30
    a = nms.soft_nms(*_torch(boxes, scores, np.ones((1, 30), bool)), 0.5, 0.05, 30)
    b = nms.soft_nms(*_torch(pad_boxes, pad_scores, pad_valid), 0.5, 0.05, 30)
    assert torch.equal(a.valid, b.valid)
    assert torch.equal(a.indices[a.valid], b.indices[b.valid])
    assert torch.equal(a.scores, b.scores)


def test_soft_nms_keeps_other_classes_undecayed():
    """The same box in two classes: both kept, neither score decayed."""
    boxes = torch.tensor([[[0.2, 0.2, 0.6, 0.6], [0.2, 0.2, 0.6, 0.6]]])
    det = nms.batched_class_aware_soft_nms(
        boxes, torch.tensor([[0.9, 0.8]]), torch.tensor([[0, 1]], dtype=torch.int32),
        torch.ones(1, 2, dtype=torch.bool), 0.5, 0.05, 2)
    assert det.valid.all()
    assert det.scores.tolist() == [[pytest.approx(0.9), pytest.approx(0.8)]]


def _matrix(boxes, scores, cls, valid, t, m):
    """The port's "matrix" backend through run_nms."""
    cfg = torch_config.tiny_test_model("retinanet")
    cfg = dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, nms_backend="matrix", nms_iou_threshold=t, max_detections=m))
    return run_nms(*_torch(boxes, scores, cls, valid), cfg)


@pytest.mark.parametrize("b,n,m,t", [(2, 64, 30, 0.5), (3, 200, 100, 0.45), (1, 50, 50, 0.3)])
def test_matrix_nms_equals_jax_and_greedy(b, n, m, t):
    """nms_backend="matrix" against JAX's matrix backend: valid equal, and
    on the valid slots kept boxes, labels and score bits equal, exact ties
    included; every slot equal to the port's plain greedy NMS, which picks
    the same candidates by index."""
    boxes, scores, cls, valid = _candidates(b * n, b, n)
    got = _matrix(boxes, scores, cls, valid, t, m)
    ref = jax_matrix(*(jnp.asarray(a) for a in (boxes, scores, cls, valid)),
                     iou_threshold=t, max_detections=m)
    v = got.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(ref.valid))
    assert v.any()
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy()[v], np.asarray(r)[v])

    greedy = nms.batched_class_aware_nms(*_torch(boxes, scores, cls, valid), t, m)
    assert all(torch.equal(g, r) for g, r in zip(got, greedy))
    res = nms.greedy_nms(nms.class_offset_boxes(*_torch(boxes, cls)),
                         *_torch(scores, valid), t, m)
    picked = torch.from_numpy(boxes).gather(
        1, res.indices.long()[..., None].expand(-1, -1, 4))
    assert torch.equal(got.boxes[got.valid], picked[got.valid])


def test_matrix_nms_all_ties_and_all_invalid():
    """Identical boxes and scores: only the lowest index survives each
    class, as in JAX's matrix backend. No valid row: nothing is kept."""
    boxes = np.tile(np.float32([[[0.1, 0.1, 0.5, 0.5]]]), (1, 6, 1))
    scores = np.full((1, 6), 0.7, np.float32)
    cls = np.int32([[0, 1, 0, 1, 0, 1]])
    valid = np.ones((1, 6), bool)
    got = _matrix(boxes, scores, cls, valid, 0.5, 4)
    ref = jax_matrix(*(jnp.asarray(a) for a in (boxes, scores, cls, valid)),
                     iou_threshold=0.5, max_detections=4)
    assert got.valid.tolist() == [[True, True, False, False]]
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.labels[got.valid].numpy(),
                                  np.asarray(ref.labels)[np.asarray(ref.valid)])
    assert not _matrix(boxes, scores, cls, ~valid, 0.5, 4).valid.any()


def test_matrix_backend_follows_greedy_on_a_zero_area_box():
    """The one deliberate difference from the reference's matrix backend: a
    zero-area box (IoU 0 with itself) is picked again by greedy NMS, as the
    JAX package's greedy NMS does, where the reference's rounds keep it
    once."""
    boxes = np.float32([[[0.2, 0.2, 0.2, 0.6], [0.1, 0.1, 0.5, 0.5], [0.3, 0.3, 0.7, 0.7]]])
    scores = np.float32([[0.9, 0.8, 0.7]])
    cls, valid = np.zeros((1, 3), np.int32), np.ones((1, 3), bool)
    got = _matrix(boxes, scores, cls, valid, 0.5, 3)
    args = [jnp.asarray(a) for a in (boxes, scores, cls, valid)]
    greedy = jax_nms.batched_class_aware_nms(*args, 0.5, 3)
    rounds = jax_matrix(*args, iou_threshold=0.5, max_detections=3)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(greedy.scores))
    assert got.scores.tolist() == [[pytest.approx(0.9)] * 3]
    assert np.asarray(rounds.scores).tolist() == [[pytest.approx(0.9), pytest.approx(0.8),
                                                  pytest.approx(0.7)]]


def test_matrix_config_loads_and_detects_as_greedy():
    """A config naming the reference's "matrix" backend loads, and its
    detect equals the default backend's bit for bit."""
    from shape_based_object_detection_torch.detection import make_detect_fn
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = torch_config.get_config("tiny_retinanet")
    cfg = torch_config.apply_overrides(cfg, ["model.detect.nms_backend=matrix",
                                             "model.detect.score_threshold=0.0"])
    assert cfg.model.detect.nms_backend == "matrix"
    module, anchors = build_model(cfg.model, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    auto = dataclasses.replace(cfg.model, detect=dataclasses.replace(
        cfg.model.detect, nms_backend="auto"))
    size = cfg.model.image_size
    images = np.random.default_rng(0).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    got = make_detect_fn(module, anchors, cfg.model, device="cpu")(images)
    want = make_detect_fn(module, anchors, auto, device="cpu")(images)
    assert bool(want.valid.any())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_run_nms_routes_soft_and_matrix():
    """soft_nms_sigma > 0 runs Soft-NMS whatever the backend; "matrix"
    runs as "auto", the plain version on CPU tensors; "cuda" raises on CPU
    tensors."""
    boxes, scores, cls, valid = _torch(*_candidates(3, 2, 160))
    cfg = torch_config.tiny_test_model("retinanet")

    def with_detect(**changes):
        return dataclasses.replace(cfg, detect=dataclasses.replace(cfg.detect, **changes))

    det = cfg.detect
    soft = with_detect(soft_nms_sigma=0.5)
    want = nms.batched_class_aware_soft_nms(boxes, scores, cls, valid, 0.5,
                                            det.score_threshold, det.max_detections)
    for backend in (None, "plain", "matrix", "cuda"):
        got = run_nms(boxes, scores, cls, valid, soft, backend=backend)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    matrix = run_nms(boxes, scores, cls, valid, with_detect(nms_backend="matrix"))
    plain = run_nms(boxes, scores, cls, valid, cfg, backend="plain")
    assert all(torch.equal(a, b) for a, b in zip(matrix, plain))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        run_nms(boxes, scores, cls, valid, cfg, backend="cuda")
    with pytest.raises(ValueError, match="unknown nms_backend"):
        run_nms(boxes, scores, cls, valid, cfg, backend="bogus")
