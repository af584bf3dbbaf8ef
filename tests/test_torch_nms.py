"""The port's plain NMS and candidate selection against the JAX package's
scan and its Pallas kernel (interpret mode)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shape_based_object_detection_tpu.ops import nms as jax_nms
from shape_based_object_detection_tpu.ops.nms_pallas import (
    batched_class_aware_nms_pallas, greedy_nms_pallas,
)
from shape_based_object_detection_torch.ops import nms as torch_nms
from tests.test_nms_pallas import _candidates
from tests.torch_kernel_cases import nms_edge_cases, nms_large_cases


def _nms_inputs(rng, b, n, classes=4):
    """Candidates with padding rows, forced score ties (also across
    classes) and a few zero-width boxes."""
    boxes, scores = _candidates(rng, b, n)
    scores[:, 10:20] = scores[:, 3:4]
    boxes[:, ::17, 2] = boxes[:, ::17, 0]
    cls = rng.integers(0, classes, (b, n)).astype(np.int32)
    valid = np.ones((b, n), bool)
    valid[:, -n // 8:] = False
    return boxes, scores, cls, valid


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("b,n,k", [(3, 128, 20), (2, 96, 120)])
def test_greedy_nms_bit_equal_to_scan_and_pallas(rng, b, n, k):
    """idx, valid and score bits equal (tolerance 0): same float ops in the
    same order. k > n exercises the invalid tail slots."""
    boxes, scores, _, valid = _nms_inputs(rng, b, n)
    got = torch_nms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                               torch.from_numpy(valid), 0.5, k)
    p_idx, p_sc, p_ok = greedy_nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.5, k,
        interpret=True)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(p_idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(p_ok))
    np.testing.assert_array_equal(_bits(got.scores), _bits(p_sc))
    for i in range(b):
        ref = jax_nms.greedy_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                 jnp.asarray(valid[i]), 0.5, k)
        np.testing.assert_array_equal(got.indices[i].numpy(), np.asarray(ref.indices))
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(_bits(got.scores[i]), _bits(ref.scores))
    assert got.indices.dtype == torch.int32 and got.valid.dtype == torch.bool


@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_class_aware_nms_bit_equal(rng, threshold):
    b, n, k = 2, 160, 60
    boxes, scores, cls, valid = _nms_inputs(rng, b, n)
    args = [jnp.asarray(a) for a in (boxes, scores, cls, valid)]
    ref = jax_nms.batched_class_aware_nms(*args, threshold, k)
    pal = batched_class_aware_nms_pallas(*args, threshold, k, interpret=True)
    got = torch_nms.batched_class_aware_nms(
        *(torch.from_numpy(a) for a in (boxes, scores, cls, valid)), threshold, k)
    for want in (ref, pal):
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        np.testing.assert_array_equal(_bits(got.boxes), _bits(want.boxes))
        np.testing.assert_array_equal(_bits(got.scores), _bits(want.scores))


@pytest.mark.parametrize("two_stage", [True, False])
@pytest.mark.parametrize("sigmoid", [True, False])
def test_select_top_candidate_pairs_bit_equal(rng, two_stage, sigmoid):
    """Tie-laden scores (values drawn from a few levels): the stable sort
    must order ties toward the lower index, as lax.top_k does."""
    b, a, c, k = 2, 300, 5, 100
    scores = rng.integers(0, 6, (b, a, c)).astype(np.float32) / 4.0 - 0.5
    activation = (jax.nn.sigmoid, torch.sigmoid) if sigmoid else (None, None)
    got = torch_nms.select_top_candidate_pairs(
        torch.from_numpy(scores), 0.1, k, activation=activation[1],
        two_stage=two_stage)
    for i in range(b):
        want = jax_nms.select_top_candidate_pairs(
            jnp.asarray(scores[i]), 0.1, k, activation=activation[0],
            two_stage=two_stage)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3][i].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-6)



# -- the kernel's formulation (csrc/nms_greedy.cu) as a test-side model ----

_WORD = 64


def _iou_ge(c, p, t):
    """IoU(c, p) >= t for candidates c (K, 4) against one pick p (4,), in
    float32 with the plain version's operations in its order."""
    f = np.float32
    area_c = (np.maximum(c[:, 2] - c[:, 0], f(0)) * np.maximum(c[:, 3] - c[:, 1], f(0)))
    area_p = np.maximum(p[2] - p[0], f(0)) * np.maximum(p[3] - p[1], f(0))
    iw = np.maximum(np.minimum(c[:, 2], p[2]) - np.maximum(c[:, 0], p[0]), f(0))
    ih = np.maximum(np.minimum(c[:, 3], p[3]) - np.maximum(c[:, 1], p[1]), f(0))
    inter = iw * ih
    iou = inter / np.maximum(area_c + area_p - inter, f(1e-8))
    return iou >= f(t)


def sort_mask_sweep(boxes, scores, valid, t, m):
    """Greedy NMS as the kernel computes it: sort the live candidates by
    (score descending, index ascending, -0 as +0), build the IoU bitmask of
    each sorted row against the columns from it on (64-bit words), then
    sweep word by word; a pick whose own bit is clear (IoU(p, p) < t) fills
    every remaining slot. Returns (idx int32, scores float32, valid bool),
    each (B, m)."""
    b, n = scores.shape
    idx_out = np.zeros((b, m), np.int32)
    score_out = np.zeros((b, m), np.float32)
    ok_out = np.zeros((b, m), bool)
    for i in range(b):
        s = scores[i].astype(np.float32)
        live = np.flatnonzero(valid[i] & (s > np.float32(-5e9)))
        folded = np.where(s[live] == 0, np.float32(0), s[live])
        order = live[np.lexsort((live, -folded))]
        sb = boxes[i, order].astype(np.float32)
        count = len(order)
        nw = -(-count // _WORD)
        mask = np.zeros((count, nw), np.uint64)
        for r in range(count):
            bits = np.zeros(nw * _WORD, bool)
            bits[r:count] = _iou_ge(sb[r:], sb[r], t)
            mask[r] = np.packbits(bits.reshape(nw, _WORD)[:, ::-1], axis=1,
                                  bitorder="big").view(">u8").ravel()
        kept, fill = [], None
        for w in range(nw):
            if len(kept) >= m or fill is not None:
                break
            removed = 0
            for p in kept:
                removed |= int(mask[p, w])
            cnt = min(_WORD, count - w * _WORD)
            in_range = (1 << cnt) - 1
            cand = in_range & ~removed
            while cand and len(kept) < m:
                k = (cand & -cand).bit_length() - 1
                row = int(mask[w * _WORD + k, w])
                if not (row >> k) & 1:
                    fill = w * _WORD + k
                    break
                kept.append(w * _WORD + k)
                removed |= row
                cand = in_range & ~removed
        picks = kept + [fill] * (m - len(kept)) if fill is not None else kept
        for slot, pos in enumerate(picks):
            idx_out[i, slot] = order[pos]
            score_out[i, slot] = s[order[pos]]
            ok_out[i, slot] = True
    return idx_out, score_out, ok_out


EDGE_CASES = list(nms_edge_cases())


def _assert_model_equals_references(boxes, scores, valid, t, m, signed_zero=False):
    got = sort_mask_sweep(boxes, scores, valid, t, m)
    plain = torch_nms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(valid), t, m)
    np.testing.assert_array_equal(got[0], plain.indices.numpy())
    np.testing.assert_array_equal(got[2], plain.valid.numpy())
    np.testing.assert_array_equal(_bits(got[1]), _bits(plain.scores))
    pal = greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                            t, m, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(pal[0]))
    np.testing.assert_array_equal(got[2], np.asarray(pal[2]))
    if signed_zero:
        # the Pallas kernel writes the row max, where XLA's max of -0 and +0
        # is +0; the port and the scan write the pick's own score: equal as
        # values, tolerance 0
        np.testing.assert_array_equal(got[1], np.asarray(pal[1]))
    else:
        np.testing.assert_array_equal(_bits(got[1]), _bits(pal[1]))
    return got


@pytest.mark.parametrize("name", EDGE_CASES)
def test_sort_mask_sweep_edge_cases(name):
    """The kernel's formulation equals ``greedy_nms`` and the Pallas kernel
    (interpret mode) with tolerance 0 on each edge case."""
    boxes, scores, valid, t, m = nms_edge_cases()[name]
    got = _assert_model_equals_references(boxes, scores, valid, t, m,
                                          signed_zero=name == "signed_zero_ties")
    if name in ("zero_area_fill", "area_1e-9_fill"):
        # boxes [[0.1, 0.1, 0.1, 0.5], [0.2, 0.2, 0.6, 0.6], [0.21, 0.2, 0.6,
        # 0.6], [0.7, 0.7, 0.9, 0.9]] (box 0 of area 0 or ~1e-9), scores
        # [0.5 or 0.7, 0.9, 0.8, 0.3], t = 0.5, M = 5
        assert got[0][0].tolist() == [1, 0, 0, 0, 0] and got[2].all()
    if name == "threshold_above_1":
        # the first pick never suppresses itself: it fills every slot
        first = np.argmax(np.where(valid, scores, -np.inf), 1)
        assert (got[0] == first[:, None]).all() and got[2].all()
    if name == "all_invalid":
        assert not got[2].any() and not got[0].any() and not _bits(got[1]).any()
    if name == "signed_zero_ties":
        assert np.signbit(got[1][got[2]]).any()  # a -0.0 pick keeps its bits


@pytest.mark.parametrize("b,n,m,seed", [(1, 2000, 100, 0), (3, 37, 64, 1),
                                         (2, 300, 120, 2), (2, 130, 40, 3)])
def test_sort_mask_sweep_random(b, n, m, seed):
    """Random class-offset candidates with padding, ties and zero-width
    boxes, N not a multiple of 64: equal to both references, tolerance 0."""
    boxes, scores, cls, valid = _nms_inputs(np.random.default_rng(seed), b, n)
    shifted = np.asarray(torch_nms.class_offset_boxes(torch.from_numpy(boxes),
                                                      torch.from_numpy(cls)))
    _assert_model_equals_references(shifted, scores, valid, 0.5, m)


@pytest.mark.parametrize("name", list(nms_edge_cases()))
def test_greedy_nms_op_equals_both_routes(name):
    """The op sbd::greedy_nms on CPU tensors is the plain version, bit for
    bit, on the kernel's edge cases; the "cuda" route (the kernel) refuses
    CPU tensors; run_nms's "auto" goes through the op."""
    from shape_based_object_detection_torch import config
    from shape_based_object_detection_torch.detection import run_nms
    from shape_based_object_detection_torch.ops import nms_cuda

    boxes, scores, valid, t, m = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                  for a in nms_edge_cases()[name])
    got = torch.ops.sbd.greedy_nms(boxes, scores, valid, t, m)
    want = torch_nms.greedy_nms(boxes, scores, valid, t, m)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [a.dtype for a in got] == [torch.int32, torch.float32, torch.bool]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nms_cuda.greedy_nms_cuda(boxes, scores, valid, t, m)
    cfg = config.tiny_test_model("retinanet")
    cfg = config.dataclasses.replace(cfg, detect=config.dataclasses.replace(
        cfg.detect, nms_iou_threshold=t, max_detections=m))
    classes = torch.zeros(scores.shape, dtype=torch.int32)
    auto = run_nms(boxes, scores, classes, valid, cfg, backend="auto")
    plain = run_nms(boxes, scores, classes, valid, cfg, backend="plain")
    assert all(torch.equal(a, b) for a, b in zip(auto, plain))


def sort_walk(boxes, scores, valid, t, m):
    """Greedy NMS as the kernel's walk route (N > 4096) computes it: the
    same sort, then words of 64 sorted candidates, each tested against the
    picks kept so far, its own 64 x 64 diagonal tile resolved serially as
    the sweep does. Returns (idx int32, scores float32, valid bool), each
    (B, m)."""
    b, n = scores.shape
    idx_out = np.zeros((b, m), np.int32)
    score_out = np.zeros((b, m), np.float32)
    ok_out = np.zeros((b, m), bool)
    for i in range(b):
        s = scores[i].astype(np.float32)
        live = np.flatnonzero(valid[i] & (s > np.float32(-5e9)))
        folded = np.where(s[live] == 0, np.float32(0), s[live])
        order = live[np.lexsort((live, -folded))]
        sb = boxes[i, order].astype(np.float32)
        kept, fill = [], None
        for r0 in range(0, len(order), _WORD):
            if len(kept) >= m or fill is not None:
                break
            word = sb[r0:r0 + _WORD]
            removed = np.zeros(len(word), bool)
            for p in kept:
                removed |= _iou_ge(word, sb[p], t)
            for k in range(len(word)):
                if len(kept) >= m:
                    break
                if removed[k]:
                    continue
                row = np.zeros(len(word), bool)
                row[k:] = _iou_ge(word[k:], word[k], t)
                if not row[k]:
                    fill = r0 + k
                    break
                kept.append(r0 + k)
                removed |= row
        picks = kept + [fill] * (m - len(kept)) if fill is not None else kept
        for slot, pos in enumerate(picks):
            idx_out[i, slot] = order[pos]
            score_out[i, slot] = s[order[pos]]
            ok_out[i, slot] = True
    return idx_out, score_out, ok_out


@pytest.mark.parametrize("name", list(nms_large_cases()))
def test_sort_walk_above_4096_equals_plain(name):
    """The walk route's formulation equals ``greedy_nms`` with tolerance 0
    on the edge cases above 4096 candidates per image (fills after a first
    pick that removes 63 words, ties at -0/+0, fewer live than M, sorted
    input at 8192 and 20000, more than 4096 picks)."""
    boxes, scores, valid, t, m = nms_large_cases()[name]
    got = sort_walk(boxes, scores, valid, t, m)
    plain = torch_nms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(valid), t, m)
    np.testing.assert_array_equal(got[0], plain.indices.numpy())
    np.testing.assert_array_equal(got[2], plain.valid.numpy())
    np.testing.assert_array_equal(_bits(got[1]), _bits(plain.scores))
    if name == "zero_area_fill":
        # the first pick removes its 3999 copies; the zero-area box then
        # fills every remaining slot
        assert len(set(got[0][0, 1:].tolist())) == 1 and got[2].all()


@pytest.mark.parametrize("b,n", [(1, 4097), (2, 8192)])
def test_greedy_nms_above_4096_equals_jax(b, n):
    """Above the bitmask route's 4096 candidates per image: the port's
    plain version equals the JAX package's scan (tolerance 0), and the
    Pallas kernel in interpret mode at 4097."""
    from tests.torch_kernel_cases import nms_inputs

    boxes, scores, cls, valid = nms_inputs(np.random.default_rng(n), b, n)
    shifted = np.asarray(torch_nms.class_offset_boxes(torch.from_numpy(boxes),
                                                      torch.from_numpy(cls)))
    got = torch_nms.greedy_nms(torch.from_numpy(shifted), torch.from_numpy(scores),
                               torch.from_numpy(valid), 0.5, 100)
    for i in range(b):
        ref = jax_nms.greedy_nms(jnp.asarray(shifted[i]), jnp.asarray(scores[i]),
                                 jnp.asarray(valid[i]), 0.5, 100)
        np.testing.assert_array_equal(got.indices[i].numpy(), np.asarray(ref.indices))
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(_bits(got.scores[i]), _bits(ref.scores))
    if n == 4097:
        p_idx, p_sc, p_ok = greedy_nms_pallas(jnp.asarray(shifted), jnp.asarray(scores),
                                              jnp.asarray(valid), 0.5, 100, interpret=True)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(p_idx))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(p_ok))
        np.testing.assert_array_equal(got.scores.numpy(), np.asarray(p_sc))
