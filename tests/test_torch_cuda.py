"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one. They import neither JAX
nor the JAX package, so they also run where JAX is not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from shape_based_object_detection_torch.ops import nms
from tests.torch_kernel_cases import (
    match_check, match_edge_cases, nms_bit_equal, nms_edge_cases,
)


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
    limit = nms_cuda.MAX_CANDIDATES
    assert limit >= 2000
    full, scores, _, valid = _inputs(1, 1, limit)  # the largest N it takes
    same, _, kept = nms_bit_equal(full, scores, valid, 0.5, 100)
    assert same and kept == 100
    for n in (limit + 1, 20000):
        big = torch.zeros(1, n, 4, device="cuda")
        with pytest.raises(ValueError, match="shared memory"):
            nms_cuda.greedy_nms_cuda(big, big[..., 0], big[..., 0] > 0, 0.5, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(nms_edge_cases()))
def test_nms_kernel_edge_cases(name):
    """The self-IoU fill (a zero-area box, an area of 1e-9, t = 1.5), all
    candidates invalid, N < M and -0/+0 ties: idx, valid and score bits
    equal to the plain version, one launch."""
    nms_cuda = _cuda()
    boxes, scores, valid, t, m = (torch.from_numpy(x).cuda() if isinstance(x, np.ndarray)
                                  else x for x in nms_edge_cases()[name])
    same, _, _ = nms_bit_equal(boxes, scores, valid, t, m)
    assert same


def _match_case(seed, b, a, g):
    rng = np.random.default_rng(seed)
    anchors = np.concatenate([rng.uniform(0.05, 0.95, (a, 2)),
                              rng.uniform(0.01, 0.6, (a, 2))], 1).astype(np.float32)
    xy = rng.uniform(0, 0.8, (b, g, 2))
    gt = np.clip(np.concatenate([xy, xy + rng.uniform(0.01, 0.5, (b, g, 2))], -1),
                 0, 1).astype(np.float32)
    if g > 1:
        gt[:, 1] = gt[:, 0]  # duplicate GTs
    labels = rng.integers(1, 81, (b, g)).astype(np.int32)
    valid = rng.uniform(size=(b, g)) < 0.7
    valid[0] = False  # an image with no valid GT
    return [torch.from_numpy(x).cuda() for x in (anchors, gt, labels, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,a,g,sw", [(4, 5000, 64, 0.0), (3, 3001, 100, 0.3),
                                      (2, 257, 1, 0.0)])
def test_match_kernel_equals_plain(b, a, g, sw):
    """Assignments and qualities bit-equal at shape_weight 0; at 0.3 the
    quality within 4 ulp (expf/logf); one launch."""
    _cuda()
    import dataclasses

    from shape_based_object_detection_torch.config import MatchConfig
    from shape_based_object_detection_torch.ops import matching, matching_cuda

    anchors, gt, labels, valid = _match_case(b * a + g, b, a, g)
    before = matching_cuda.launches
    got = matching_cuda.match_reductions_cuda(anchors, gt, labels, valid, sw, 1.0,
                                              (0.1, 0.2))
    want = matching.match_reductions_plain(anchors, gt, labels, valid, sw, 1.0,
                                           (0.1, 0.2))
    assert matching_cuda.launches == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    assert torch.equal(got[2][valid], want[2][valid])
    if sw == 0.0:
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    else:
        torch.testing.assert_close(got[0], want[0], rtol=4 * 2 ** -23, atol=0)
    torch.testing.assert_close(got[4], want[4], rtol=1e-6, atol=1e-6)
    cfg = MatchConfig(pos_threshold=0.5, neg_threshold=0.4, allow_low_quality=True,
                      shape_weight=sw)
    kern = matching.match_batch(anchors, gt, labels, valid,
                                dataclasses.replace(cfg, backend="cuda"))
    plain = matching.match_batch(anchors, gt, labels, valid,
                                 dataclasses.replace(cfg, backend="plain"))
    for field in ("matched_gt_idx", "cls_targets", "positive"):
        assert torch.equal(getattr(kern, field), getattr(plain, field)), field
    torch.testing.assert_close(kern.reg_targets, plain.reg_targets, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(match_edge_cases()))
def test_match_kernel_edge_cases(name):
    """G = 1, G = 100 with 0 to 100 valid rows, every row valid,
    shape_weight 0.3 and 1.5, and bench_train.py's all-ties batch against
    the R50-FPN-512 anchors: assignments bit-equal, best_q bit-equal at
    shape_weight 0 (within 4 ulp where exp enters), one launch."""
    _cuda()
    from shape_based_object_detection_torch import config
    from shape_based_object_detection_torch.ops.anchors import anchors_for_model

    model = config.get_config("retinanet_r50_fpn").model
    gt, labels, valid, sw = match_edge_cases()[name]
    passed, _, line = match_check(
        anchors_for_model(model).cuda(),
        *(torch.from_numpy(x).cuda() for x in (gt, labels, valid)), sw,
        model.anchors.variances)
    assert passed, line


@pytest.mark.cuda
def test_bf16_train_step_on_the_card():
    """One bf16 train step of the tiny RetinaNet with augmentation: finite
    loss, float32 parameters and momentum, the matching kernel launched."""
    _cuda()
    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching_cuda

    cfg = config.get_config("tiny_retinanet")
    cfg = config.dataclasses.replace(
        cfg, model=config.dataclasses.replace(cfg.model, dtype="bfloat16"))
    module, anchors = build_model(cfg.model, train=True)
    state = train.create_train_state(module, cfg)
    step = train.make_train_step(module, anchors, cfg)
    rng = np.random.default_rng(0)
    s, g = cfg.model.image_size, cfg.data.max_boxes
    xy = rng.uniform(0, 0.6, (2, g, 2))
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (2, s, s, 3), dtype=np.uint8)),
             "boxes": torch.from_numpy(np.concatenate([xy, xy + 0.3], -1).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(1, 5, (2, g)).astype(np.int32)),
             "valid": torch.ones(2, g, dtype=torch.bool)}
    before = matching_cuda.launches
    state, metrics = step(state, batch)
    assert matching_cuda.launches == before + 1
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert all(p.dtype == torch.float32 for p in module.parameters())
    assert all(t.dtype == torch.float32 for t in state.opt_state.trace)


def _tiny_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    s, g = cfg.model.image_size, cfg.data.max_boxes
    xy = rng.uniform(0, 0.6, (2, g, 2))
    return {"images": torch.from_numpy(rng.integers(0, 256, (2, s, s, 3), dtype=np.uint8)),
            "boxes": torch.from_numpy(np.concatenate([xy, xy + 0.3], -1).astype(np.float32)),
            "labels": torch.from_numpy(rng.integers(1, cfg.model.num_classes + 1,
                                                    (2, g)).astype(np.int32)),
            "valid": torch.ones(2, g, dtype=torch.bool)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_detect_on_the_card(dtype):
    """The tiny SSD's detect on the card: one K1 launch per call, the
    result equal to the plain version on the same candidates."""
    nms_cuda = _cuda()
    from shape_based_object_detection_torch import config, detection
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = config.dataclasses.replace(config.tiny_test_model("ssd"), dtype=dtype)
    module, anchors = build_model(cfg)
    images = np.random.default_rng(1).integers(0, 256, (4, 300, 300, 3), dtype=np.uint8)
    before = nms_cuda.launches
    det = detection.make_detect_fn(module, anchors, cfg)(images)
    assert nms_cuda.launches == before + 1 and bool(det.valid.any())
    with torch.inference_mode():
        x = detection.image_lib.normalize_images(
            torch.from_numpy(images).cuda()).permute(0, 3, 1, 2)
        cands = detection.select_candidates(*module(x), anchors, cfg)
        got = detection.run_nms(*cands, cfg, backend="cuda")
        want = detection.run_nms(*cands, cfg, backend="plain")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_ssd_train_step_with_shape_matching_on_the_card():
    """One bf16 step of the tiny SSD with augmentation, multibox loss and
    shape_weight 0.3, with model.remat: K2 launched once, finite loss."""
    _cuda()
    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching_cuda

    cfg = config.get_config("tiny_ssd")
    cfg = config.dataclasses.replace(
        cfg, model=config.dataclasses.replace(cfg.model, dtype="bfloat16", remat=True),
        match=config.dataclasses.replace(cfg.match, shape_weight=0.3))
    module, anchors = build_model(cfg.model, train=True)
    state = train.create_train_state(module, cfg)
    before = matching_cuda.launches
    state, metrics = train.make_train_step(module, anchors, cfg)(state, _tiny_batch(cfg, 2))
    assert matching_cuda.launches == before + 1
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


@pytest.mark.cuda
def test_train_bn_statistics_move_once_under_remat_on_the_card():
    """The tiny RetinaNet in bf16 with train_bn: the running statistics after
    one step with model.remat equal those without (within 1e-6), and moved."""
    _cuda()
    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.models.factory import build_model

    base = config.get_config("tiny_retinanet")
    batch = _tiny_batch(base, 3)
    stats = {}
    for remat in (False, True):
        cfg = config.dataclasses.replace(base, model=config.dataclasses.replace(
            base.model, dtype="bfloat16", train_bn=True, remat=remat))
        module, anchors = build_model(cfg.model, train=True,
                                      generator=torch.Generator().manual_seed(4))
        state = train.create_train_state(module, cfg)
        train.make_train_step(module, anchors, cfg)(state, batch)
        stats[remat] = dict(module.named_buffers())
    for name, want in stats[False].items():
        torch.testing.assert_close(stats[True][name], want, rtol=0, atol=1e-6)
    assert not torch.equal(stats[False]["backbone.bn1.running_mean"],
                           torch.zeros_like(stats[False]["backbone.bn1.running_mean"]))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["retinanet", "ssd"])
def test_pipelined_step_equals_plain_on_the_card(family):
    """The pipelined step on the card (augmentation on a second stream):
    losses equal to the plain step's on the same batches and a CUDA
    generator of the same seed, within 1e-6 relative; K2 once per step."""
    _cuda()
    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching_cuda

    cfg = config.get_config(f"tiny_{family}")
    batches = [_tiny_batch(cfg, 20 + i) for i in range(4)]
    losses = {}
    for pipelined in (False, True):
        module, anchors = build_model(cfg.model, train=True,
                                      generator=torch.Generator().manual_seed(5))
        state = train.create_train_state(module, cfg)
        before = matching_cuda.launches
        if pipelined:
            prime, step = train.make_train_step_pipelined(module, anchors, cfg)
            state, carry = prime(state, batches[0])
            out = []
            for nxt in batches[1:] + batches[:1]:
                state, carry, m = step(state, carry, nxt)
                out.append(float(m["loss"]))
        else:
            step = train.make_train_step(module, anchors, cfg)
            out = [float(step(state, b)[1]["loss"]) for b in batches]
        assert matching_cuda.launches == before + 4
        losses[pipelined] = out
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_device_batches_staged_pinned_on_the_card():
    """Loader.device_batches: batches on the card equal to the host
    batches; pin_batch stages every field in pinned memory."""
    _cuda()
    from shape_based_object_detection_torch.data.pipeline import Loader, pin_batch
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

    loader = Loader(SyntheticDetection(size=64, num_images=10), 4, 6, seed=3, workers=2)
    host = list(loader.batches(0))
    assert all(t.is_pinned() for t in pin_batch(host[0]))
    dev = list(loader.device_batches(0))
    assert len(dev) == len(host) == 2
    for h, d in zip(host, dev):
        for a, b in zip(h, d):
            assert b.is_cuda and np.array_equal(a, b.cpu().numpy())


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """A card's train state (train_bn buffers, momentum, EMA, the CUDA
    generator) round-trips bit-equal."""
    _cuda()
    from shape_based_object_detection_torch import checkpoint, config, train
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = config.get_config("tiny_retinanet")
    cfg = config.dataclasses.replace(
        cfg, model=config.dataclasses.replace(cfg.model, train_bn=True),
        train=config.dataclasses.replace(cfg.train, ema_decay=0.9, warmup_steps=1))
    module, anchors = build_model(cfg.model, train=True)
    state = train.create_train_state(module, cfg)
    step = train.make_train_step(module, anchors, cfg)
    for i in range(2):
        state, _ = step(state, _tiny_batch(cfg, 30 + i))
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(state)
    mgr.wait()
    other, _ = build_model(cfg.model, train=True, generator=torch.Generator().manual_seed(8))
    restored = mgr.restore_latest(train.create_train_state(other, cfg))
    assert restored.step == 2 and restored.generator.device.type == "cuda"
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    for (n, a), b in zip(module.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(state.opt_state.trace, restored.opt_state.trace):
        assert torch.equal(a, b)
    for n, e in state.ema.items():
        assert torch.equal(e, restored.ema[n]), n


@pytest.mark.cuda
def test_train_cli_on_the_card(tmp_path, capsys):
    """train_cli on the tiny SSD with shape matching and a val eval: K2 once
    per step, K1 once per eval batch, a checkpoint, a finite loss."""
    nms_cuda = _cuda()
    from shape_based_object_detection_torch.cli import train_cli
    from shape_based_object_detection_torch.ops import matching_cuda

    k1, k2 = nms_cuda.launches, matching_cuda.launches
    train_cli.main(["--config", "tiny_ssd", "--steps", "4", "--log-every", "2",
                    "--checkpoint-dir", str(tmp_path / "ckpt"), "--workers", "2",
                    "--set", "match.shape_weight=0.3", "--eval-every", "4",
                    "--val-root", "synthetic://val", "--val-batches", "2"])
    out = capsys.readouterr().out
    assert "done at step 4" in out and "voc-mAP(val)=" in out
    assert matching_cuda.launches - k2 == 4 and nms_cuda.launches - k1 == 2
    loss = float(out.split("loss=")[1].split()[0])
    assert np.isfinite(loss)
