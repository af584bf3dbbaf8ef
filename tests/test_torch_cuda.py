"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one. They import neither JAX
nor the JAX package, so they also run where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from shape_based_object_detection_torch.ops import nms


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from shape_based_object_detection_torch.ops import nms_cuda

    return nms_cuda


def _inputs(seed, b, n, classes=80):
    """Class-offset candidates with padding rows, tied scores and zero-width
    boxes, on the card."""
    rng = np.random.default_rng(seed)
    cxcy = rng.uniform(0.0, 1.0, (b, n, 2))
    wh = rng.uniform(0.02, 0.4, (b, n, 2))
    boxes = np.clip(np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1), 0, 1)
    boxes = boxes.astype(np.float32)
    boxes[:, ::29, 2] = boxes[:, ::29, 0]
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    scores[:, 10:30] = scores[:, 3:4]
    cls = rng.integers(0, classes, (b, n)).astype(np.int32)
    valid = np.ones((b, n), bool)
    valid[:, -n // 8:] = False
    boxes, scores, cls, valid = (torch.from_numpy(a).cuda()
                                 for a in (boxes, scores, cls, valid))
    return nms.class_offset_boxes(boxes, cls), scores, cls, valid


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(16, 1000, 100), (16, 400, 200), (8, 2000, 100),
                                   (3, 37, 64)])
def test_nms_kernel_bit_equal_to_plain(b, n, m):
    """idx, valid and score bits equal (tolerance 0), one launch."""
    nms_cuda = _cuda()
    shifted, scores, _, valid = _inputs(b * n + m, b, n)
    before = nms_cuda.launches
    got = nms_cuda.greedy_nms_cuda(shifted, scores, valid, 0.5, m)
    want = nms.greedy_nms(shifted, scores, valid, 0.5, m)
    assert nms_cuda.launches == before + 1
    assert torch.equal(got.indices, want.indices)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.scores.view(torch.int32), want.scores.view(torch.int32))


@pytest.mark.cuda
def test_nms_kernel_takes_strided_and_refuses_oversized_inputs():
    nms_cuda = _cuda()
    shifted, scores, _, valid = _inputs(0, 4, 300)
    strided = torch.cat([shifted, shifted], -1)[..., 4:]  # not contiguous
    got = nms_cuda.greedy_nms_cuda(strided, scores, valid, 0.45, 50)
    want = nms.greedy_nms(shifted, scores, valid, 0.45, 50)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    big = torch.zeros(1, 20000, 4, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        nms_cuda.greedy_nms_cuda(big, big[..., 0], big[..., 0] > 0, 0.5, 10)
