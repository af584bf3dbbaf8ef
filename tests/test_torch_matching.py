"""The port's box geometry for matching and its matcher against the JAX
package: ``iou_matrix``, ``encode_boxes``, ``shape_similarity``, and
``match_batch`` (the plain route, and the kernel route's epilogue fed the
plain reductions) against the reference's ``backend="jnp"`` and
``backend="pallas"`` (the Pallas kernel in interpret mode on the CPU).

Tolerances: assignments (indices, labels, positive masks) are equal.
Qualities agree to 1e-6 absolute and offsets to 1e-5 absolute: both sides
compute in float32 with the same operation order, but XLA and PyTorch may
round ``exp``/``log`` differently in the last bits (offsets reach ~10 in
magnitude, so 1e-5 is a few ulp)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu.config import MatchConfig as JaxMatchConfig
from shape_based_object_detection_tpu.ops import boxes as jax_boxes
from shape_based_object_detection_tpu.ops import matching as jax_matching
from shape_based_object_detection_torch.config import MatchConfig
from shape_based_object_detection_torch.ops import boxes, matching


# the reference's matcher, compiled once per shape and config (op-by-op it
# takes seconds a call on the CPU)
jax_match_batch = jax.jit(jax_matching.match_batch, static_argnums=(4, 5))


def _random_case(seed, b, a, g, valid_frac=0.6):
    """Anchors in cxcywh, GT boxes in xyxy with some invalid rows; image 1
    (when B > 1) has no valid GT; GT 1 repeats GT 0 in every image."""
    rng = np.random.default_rng(seed)
    anchors = np.stack([
        rng.uniform(0.1, 0.9, (a,)), rng.uniform(0.1, 0.9, (a,)),
        rng.uniform(0.02, 0.5, (a,)), rng.uniform(0.02, 0.5, (a,)),
    ], axis=1).astype(np.float32)
    gt = np.sort(rng.uniform(0, 1, (b, g, 2, 2)), axis=2)
    gt = gt.transpose(0, 1, 3, 2).reshape(b, g, 4).astype(np.float32)
    if g > 1:
        gt[:, 1] = gt[:, 0]
    labels = rng.integers(1, 21, (b, g)).astype(np.int32)
    valid = rng.uniform(size=(b, g)) < valid_frac
    valid[:, :2] = True
    if b > 1:
        valid[1] = False
    return anchors, gt, labels, valid


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(x)) for x in arrays)


def _assert_match_equal(got, want):
    for field in ("matched_gt_idx", "cls_targets", "positive"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.quality.numpy(), np.asarray(want.quality),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.reg_targets.numpy(),
                               np.asarray(want.reg_targets), rtol=0, atol=1e-5)


def test_iou_encode_shape_similarity_match_jax():
    anchors, gt, _, _ = _random_case(0, 3, 97, 13)
    a_xyxy = np.asarray(jax_boxes.cxcywh_to_xyxy(jnp.asarray(anchors)))
    ta, tg, txy = _torch(anchors, gt, a_xyxy)
    np.testing.assert_array_equal(boxes.cxcywh_to_xyxy(ta).numpy(), a_xyxy)
    np.testing.assert_allclose(
        boxes.iou_matrix(txy, tg).numpy(),
        np.asarray(jax_boxes.iou_matrix(jnp.asarray(a_xyxy), jnp.asarray(gt))),
        rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        boxes.pairwise_intersection(txy, tg).numpy(),
        np.asarray(jax_boxes.pairwise_intersection(jnp.asarray(a_xyxy),
                                                   jnp.asarray(gt))),
        rtol=0, atol=1e-7)
    gt_c = np.asarray(jax_boxes.xyxy_to_cxcywh(jnp.asarray(gt)))
    for tau in (1.0, 0.7):
        np.testing.assert_allclose(
            boxes.shape_similarity(ta, torch.from_numpy(gt_c), tau).numpy(),
            np.asarray(jax_boxes.shape_similarity(jnp.asarray(anchors),
                                                  jnp.asarray(gt_c), tau)),
            rtol=0, atol=1e-6)
    for variances in ((0.1, 0.2), (1.0, 1.0)):
        np.testing.assert_allclose(
            boxes.encode_boxes(torch.from_numpy(gt_c[:, :1]).expand(3, 97, 4),
                               ta, variances).numpy(),
            np.asarray(jax_boxes.encode_boxes(
                jnp.broadcast_to(jnp.asarray(gt_c[:, :1]), (3, 97, 4)),
                jnp.asarray(anchors), variances)),
            rtol=1e-6, atol=1e-5)


def test_true_div_is_a_division():
    x = torch.tensor([1.0, 3.0, 7.0, 0.1])
    np.testing.assert_array_equal(boxes.true_div(x, 0.2).numpy(),
                                  (x.numpy() / np.float32(0.2)))


CASES = [
    # (shape_weight, force_match, allow_low_quality, b, a, g)
    (0.0, True, False, 2, 300, 17),
    (0.6, True, False, 3, 250, 23),
    (0.0, False, True, 2, 300, 17),
    (0.6, False, False, 2, 200, 9),
    (0.0, False, False, 1, 150, 5),
    # more GTs than anchors can separate: force-match claims collide
    (0.0, True, False, 2, 40, 30),
    (0.6, False, True, 2, 40, 30),
]


@pytest.mark.parametrize("sw,force,low,b,a,g", CASES)
def test_match_batch_matches_jax(sw, force, low, b, a, g):
    """The port's plain route against the reference's jnp and pallas
    backends, and the kernel route's epilogue (fed the plain reductions)
    against the reference's pallas backend."""
    anchors, gt, labels, valid = _random_case(b * a + g, b, a, g)
    kw = dict(pos_threshold=0.5, neg_threshold=0.4, shape_weight=sw,
              shape_tau=1.5, force_match_for_each_gt=force,
              allow_low_quality=low)
    variances = (0.1, 0.2)
    jargs = tuple(jnp.asarray(x) for x in (anchors, gt, labels, valid))
    targs = _torch(anchors, gt, labels, valid)
    want = {bk: jax_match_batch(*jargs, JaxMatchConfig(**kw, backend=bk), variances)
            for bk in ("jnp", "pallas")}
    got = matching.match_batch(*targs, MatchConfig(**kw, backend="plain"), variances)
    _assert_match_equal(got, want["jnp"])
    _assert_match_equal(got, want["pallas"])
    # "auto" on CPU tensors is the plain route, bit for bit
    auto = matching.match_batch(*targs, MatchConfig(**kw), variances)
    for x, y in zip(auto, got):
        assert torch.equal(x, y)

    outs = matching.match_reductions_plain(*targs, shape_weight=sw, tau=1.5,
                                           variances=variances)
    via_epilogue = matching._assemble_kernel_outputs(
        *targs, *outs, MatchConfig(**kw), variances)
    _assert_match_equal(via_epilogue, want["pallas"])
    for field in ("matched_gt_idx", "cls_targets", "positive", "quality"):
        assert torch.equal(getattr(via_epilogue, field), getattr(got, field)), field


@pytest.mark.parametrize("sw", [0.0, 0.6])
def test_plain_reductions_match_pallas_kernel(sw):
    """``match_reductions_plain`` (the kernel's plain version) against the
    Pallas kernel's raw outputs in interpret mode."""
    from shape_based_object_detection_tpu.ops.matching_pallas import (
        match_reductions_pallas,
    )

    anchors, gt, labels, valid = _random_case(5, 3, 333, 21)
    ref = match_reductions_pallas(*(jnp.asarray(x) for x in (anchors, gt, labels, valid)),
                                  shape_weight=sw, tau=2.0, variances=(0.1, 0.2),
                                  interpret=True)
    got = matching.match_reductions_plain(*_torch(anchors, gt, labels, valid),
                                          shape_weight=sw, tau=2.0,
                                          variances=(0.1, 0.2))
    bq, bg, ga, lbl, reg = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(got[0].numpy(), bq, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), bg)
    np.testing.assert_array_equal(got[2].numpy()[valid], ga[valid])
    np.testing.assert_array_equal(got[3].numpy(), lbl)
    np.testing.assert_allclose(got[4].numpy(), reg, rtol=0, atol=1e-5)


def test_ties_pick_the_first_index():
    """Duplicate anchors and duplicate GTs: every maximum is tied; the
    first GT wins per anchor and the first anchor per GT, as jnp.argmax."""
    anchors = np.tile(np.array([[0.5, 0.5, 0.2, 0.2]], np.float32), (64, 1))
    gt = np.tile(np.array([[[0.4, 0.4, 0.6, 0.6]]], np.float32), (1, 10, 1))
    labels = np.arange(1, 11, dtype=np.int32)[None]
    valid = np.ones((1, 10), bool)
    for sw in (0.0, 0.5):
        cfg = dict(shape_weight=sw, pos_threshold=0.5, neg_threshold=0.4)
        got = matching.match_batch(*_torch(anchors, gt, labels, valid),
                                   MatchConfig(**cfg, backend="plain"))
        want = jax_match_batch(
            *(jnp.asarray(x) for x in (anchors, gt, labels, valid)),
            JaxMatchConfig(**cfg, backend="jnp"), (0.1, 0.2))
        _assert_match_equal(got, want)
        # force-match: the last GT claims anchor 0; the others keep GT 0
        assert int(got.matched_gt_idx[0, 0]) == 9
        assert (got.matched_gt_idx[0, 1:] == 0).all()


def test_match_anchors_single_image():
    anchors, gt, labels, valid = _random_case(9, 1, 120, 7)
    cfg = dict(pos_threshold=0.5, neg_threshold=0.4, shape_weight=0.3)
    got = matching.match_anchors(*_torch(anchors, gt[0], labels[0], valid[0]),
                                 MatchConfig(**cfg))
    want = jax.jit(jax_matching.match_anchors, static_argnums=(4,))(
        *(jnp.asarray(x) for x in (anchors, gt[0], labels[0], valid[0])),
        JaxMatchConfig(**cfg))
    _assert_match_equal(got, want)


def test_claimed_gt_per_anchor_later_gt_wins_and_drops_invalid():
    best_a = torch.tensor([[3, 1, 3, 0, 3]], dtype=torch.int32)
    valid = torch.tensor([[True, True, True, True, False]])
    claim = matching._claimed_gt_per_anchor(best_a, valid, 5)
    assert claim.tolist() == [[3, 1, -1, 2, -1]]
    ref = jax_matching._claimed_gt_per_anchor(jnp.asarray(best_a.numpy()[0]),
                                              jnp.asarray(valid.numpy()[0]), 5)
    np.testing.assert_array_equal(claim.numpy()[0], np.asarray(ref))


def test_unknown_backend_raises():
    anchors, gt, labels, valid = _random_case(1, 1, 10, 3)
    with pytest.raises(ValueError, match="unknown match backend"):
        matching.match_batch(*_torch(anchors, gt, labels, valid),
                             dataclasses.replace(MatchConfig(), backend="tpu"))


def _reductions_over_valid_rows(anchors, gt, labels, valid, sw, tau, variances):
    """``match_reductions_plain`` over each image's valid GT rows only, as
    the kernel (``csrc/match_anchors.cu``) compacts them: indices mapped back
    to the full rows, and an image with no valid GT given best_q -1, GT 0,
    GT 0's label and offsets, and gt_a 0 on padding rows."""
    b, g = valid.shape
    outs = [[] for _ in range(5)]
    for i in range(b):
        rows = torch.nonzero(valid[i]).flatten()
        if len(rows) == 0:
            # the no-valid-GT rule: best GT 0 at quality -1
            best_g = torch.zeros(anchors.shape[0], dtype=torch.int32)
            best_q = torch.full((anchors.shape[0],), -1.0)
            label = labels[i, best_g.long()]
            reg = boxes.encode_boxes(boxes.xyxy_to_cxcywh(gt[i, best_g.long()]),
                                     anchors, variances)
            gt_a = torch.zeros(g, dtype=torch.int32)
        else:
            bq, bg, ga, label, reg = matching.match_reductions_plain(
                anchors, gt[i, rows][None], labels[i, rows][None],
                torch.ones(1, len(rows), dtype=torch.bool), sw, tau, variances)
            best_q, label, reg = bq[0], label[0], reg[0]
            best_g = rows[bg[0].long()].to(torch.int32)
            gt_a = torch.zeros(g, dtype=torch.int32).index_copy_(0, rows, ga[0])
        for out, x in zip(outs, (best_q, best_g, gt_a, label, reg)):
            out.append(x)
    return tuple(torch.stack(x) for x in outs)


@pytest.mark.parametrize("sw", [0.0, 0.3, 1.0])
def test_valid_rows_only_equal_all_rows(sw):
    """The kernel's premise: looping over the valid GT rows only (compacted
    in their order) gives the same reductions, bit for bit, as the plain
    version over all rows, for 0 <= shape_weight <= 1 (every valid quality
    is >= 0 > -1, a padding row's quality). Image 1 has no valid GT; GT 1
    repeats GT 0 (duplicates tie)."""
    anchors, gt, labels, valid = _torch(*_random_case(21, 3, 400, 19))
    variances = (0.1, 0.2)
    want = matching.match_reductions_plain(anchors, gt, labels, valid, sw, 1.0, variances)
    got = _reductions_over_valid_rows(anchors, gt, labels, valid, sw, 1.0, variances)
    assert not valid[1].any() and valid[0].sum() > 2
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  want[0].numpy().view(np.int32))
    for x, y in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(got[4].numpy().view(np.int32),
                                  want[4].numpy().view(np.int32))
    assert (want[0][1] == -1).all() and (want[1][1] == 0).all()
