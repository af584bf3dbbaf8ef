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

