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
    match_check, match_edge_cases, nms_bit_equal, nms_edge_cases, nms_large_cases,
    torchvision_vgg16,
)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from shape_based_object_detection_torch.ops import nms_cuda

    return nms_cuda


def _inputs(seed, b, n, classes=80, zero_width=True):
    """Class-offset candidates with padding rows, tied scores and (unless
    ``zero_width`` is False) zero-width boxes, on the card."""
    rng = np.random.default_rng(seed)
    cxcy = rng.uniform(0.0, 1.0, (b, n, 2))
    wh = rng.uniform(0.02, 0.4, (b, n, 2))
    boxes = np.clip(np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1), 0, 1)
    boxes = boxes.astype(np.float32)
    if zero_width:
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
def test_nms_kernel_takes_strided_inputs_and_any_n():
    """A strided input; the bitmask route's largest N; the walk route above
    it at N = 4097, 8192 (keys in shared memory) and 20000 (keys in global
    scratch): idx, valid and score bits equal to the plain version, one
    launch each, with scratch linear in N on the walk route."""
    nms_cuda = _cuda()
    shifted, scores, _, valid = _inputs(0, 4, 300)
    strided = torch.cat([shifted, shifted], -1)[..., 4:]  # not contiguous
    got = nms_cuda.greedy_nms_cuda(strided, scores, valid, 0.45, 50)
    want = nms.greedy_nms(shifted, scores, valid, 0.45, 50)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    limit = nms_cuda.BITMASK_MAX_CANDIDATES
    assert limit >= 2000 and nms_cuda.route(limit) == "bitmask"
    for n in (limit, limit + 1, 8192, 20000):
        full, scores, _, valid = _inputs(n, 1, n)
        same, _, kept = nms_bit_equal(full, scores, valid, 0.5, 100)
        assert same and kept == 100, n
        if n > limit:
            assert nms_cuda.route(n) == "walk"
            # sorted boxes, order, keys (padded to a power of two), counts,
            # the kept picks
            assert nms_cuda.scratch_bytes(1, n, 100) <= 40 * n + 4096


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(nms_large_cases()))
def test_nms_kernel_large_cases(name):
    """The walk route on the traps above 4096 candidates (a fill after 63
    removed words, -0/+0 ties, fewer live than M, sorted input with its
    keys in shared memory and in global scratch, more than 4096 picks):
    idx, valid and score bits equal to the plain version, one launch."""
    _cuda()
    boxes, scores, valid, t, m = (torch.from_numpy(x).cuda() if isinstance(x, np.ndarray)
                                  else x for x in nms_large_cases()[name])
    same, _, _ = nms_bit_equal(boxes, scores, valid, t, m)
    assert same


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


def _merged(seed, b, k, zero_width=True):
    """Two candidate sets, each sorted by score as ``select_candidates``
    returns them, concatenated as the hflip merge sends them to NMS: 2k
    candidates per image, out of order."""
    shifted, scores, cls, valid = _inputs(seed, b, 2 * k, zero_width=zero_width)
    halves = []
    for lo in (0, k):
        order = torch.sort(scores[:, lo:lo + k], dim=-1, descending=True, stable=True)[1] + lo
        halves.append(order)
    order = torch.cat(halves, 1)
    return (shifted.gather(1, order[..., None].expand(-1, -1, 4)), scores.gather(1, order),
            cls.gather(1, order), valid.gather(1, order))


@pytest.mark.cuda
def test_nms_kernel_bit_equal_on_an_unsorted_tta_merge():
    """(16, 2000, 100) as hflip TTA merges two top-1000 sets: the candidates
    arrive out of order, so the kernel's sort runs; idx, valid and score
    bits equal to the plain version."""
    _cuda()
    shifted, scores, _, valid = _merged(5, 16, 1000)
    assert bool((scores[:, 1:] > scores[:, :-1]).any())
    same, _, kept = nms_bit_equal(shifted, scores, valid, 0.5, 100)
    assert same and kept > 0


@pytest.mark.cuda
def test_matrix_backend_runs_the_kernel():
    """The reference's "matrix" backend name on CUDA tensors launches the
    kernel once and returns its result."""
    nms_cuda = _cuda()
    from shape_based_object_detection_torch import config, detection

    shifted, scores, cls, valid = _merged(3, 16, 1000, zero_width=False)
    boxes = shifted - cls.float()[..., None] * 2.0  # back into [0, 1]
    cfg = config.get_config("tiny_retinanet").model
    cfg = config.dataclasses.replace(cfg, detect=config.dataclasses.replace(
        cfg.detect, nms_backend="matrix"))
    before = nms_cuda.launches
    got = detection.run_nms(boxes, scores, cls, valid, cfg)
    assert nms_cuda.launches == before + 1
    want = detection.run_nms(boxes, scores, cls, valid, cfg, backend="cuda")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_soft_nms_on_the_card_equals_the_cpu():
    """Soft-NMS (sigma 0.5) on the card against its run on the CPU: valid
    and indices equal, scores within 1e-6."""
    _cuda()
    shifted, scores, cls, valid = _merged(7, 4, 500)
    boxes = shifted - cls.float()[..., None] * 2.0
    got = nms.batched_class_aware_soft_nms(boxes, scores, cls, valid, 0.5, 0.05, 100)
    want = nms.batched_class_aware_soft_nms(boxes.cpu(), scores.cpu(), cls.cpu(),
                                            valid.cpu(), 0.5, 0.05, 100)
    assert torch.equal(got.valid.cpu(), want.valid) and torch.equal(got.labels.cpu(),
                                                                    want.labels)
    assert torch.equal(got.boxes.cpu(), want.boxes)
    assert float((got.scores.cpu() - want.scores).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_tta_merge_above_4096_equals_plain():
    """hflip TTA with pre_nms_top_k 2100 merges 4200 candidates per image,
    above the bitmask route: detect launches the kernel once, and the
    kernel equals the plain version bit for bit on the merge."""
    nms_cuda = _cuda()
    from shape_based_object_detection_torch import config, detection
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = config.get_config("tiny_retinanet").model
    cfg = config.dataclasses.replace(cfg, detect=config.dataclasses.replace(
        cfg.detect, score_threshold=0.0, tta_hflip=True, pre_nms_top_k=2100))
    module, anchors = build_model(cfg)
    images = np.random.default_rng(9).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    before = nms_cuda.launches
    det = detection.make_detect_fn(module, anchors, cfg)(images)
    torch.cuda.synchronize()
    assert nms_cuda.launches == before + 1 and bool(det.valid.any())
    x = detection.image_lib.normalize_images(torch.from_numpy(images).cuda())
    with torch.inference_mode():
        boxes, scores, cls, valid = detection.tta_hflip_candidates(
            *module(torch.cat([x, x.flip(2)]).permute(0, 3, 1, 2)), anchors, cfg)
    assert scores.shape == (2, 4200)
    same, _, kept = nms_bit_equal(nms.class_offset_boxes(boxes, cls), scores, valid,
                                  cfg.detect.nms_iou_threshold, cfg.detect.max_detections)
    assert same and kept > 0


@pytest.mark.cuda
def test_tta_detect_and_server_on_the_card():
    """The tiny RetinaNet with hflip TTA on the card: one K1 launch per
    detect, detections matched to the CPU's; then a bucketed Predictor
    behind the HTTP server answers a request."""
    nms_cuda = _cuda()
    import io
    import json
    import urllib.request

    from PIL import Image

    from shape_based_object_detection_torch import config, detection
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.server import DetectionServer
    from shape_based_object_detection_torch.serving import Predictor

    cfg = config.get_config("tiny_retinanet")
    model = config.dataclasses.replace(cfg.model, detect=config.dataclasses.replace(
        cfg.model.detect, score_threshold=0.0, tta_hflip=True))
    cpu_module, cpu_anchors = build_model(model, device="cpu")
    module, anchors = build_model(model)
    images = np.random.default_rng(3).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    before = nms_cuda.launches
    got = detection.make_detect_fn(module, anchors, model)(images)
    assert nms_cuda.launches == before + 1
    want = detection.make_detect_fn(cpu_module, cpu_anchors, model, device="cpu")(images)
    assert torch.equal(got.valid.cpu(), want.valid) and bool(want.valid.any())
    v = want.valid
    assert float((got.scores.cpu()[v] - want.scores[v]).abs().max()) <= 1e-3

    pred = Predictor(config.dataclasses.replace(cfg, model=model), batch_size=4,
                     bucket_sizes=(1, 2, 4))
    pred.warmup()
    server = DetectionServer(pred, port=0)
    server.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(images[0, :90]).save(buf, format="PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/detect",
                                     data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["detections"] and (out["height"], out["width"]) == (90, 128)
    finally:
        server.close()


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(nms_edge_cases()))
def test_greedy_nms_op_runs_the_kernel(name):
    """sbd::greedy_nms on CUDA tensors is the kernel: one launch, equal to
    the plain version."""
    nms_cuda = _cuda()
    boxes, scores, valid, t, m = (torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                                  else a for a in nms_edge_cases()[name])
    before = nms_cuda.launches
    got = torch.ops.sbd.greedy_nms(boxes, scores, valid, t, m)
    torch.cuda.synchronize()
    assert nms_cuda.launches - before == 1
    want = nms.greedy_nms(boxes, scores, valid, t, m)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,p,d,c,o,b,h", [
    (3, 1, 1, 1, 64, 64, 2, 33), (3, 2, 1, 1, 128, 256, 1, 17), (1, 1, 0, 1, 256, 512, 1, 4),
    (7, 2, 3, 1, 3, 64, 1, 64), (3, 1, 6, 6, 64, 128, 1, 19), (1, 2, 0, 1, 64, 256, 2, 16),
    (3, 1, 1, 1, 20, 12, 1, 3)])
def test_int8_product_on_the_card_equals_plain(k, s, p, d, c, o, b, h):
    """The card's int8 product (im2col + torch._int_mm, M, K and N padded)
    bit-equal to the plain float64 product, at extreme operands too; one
    _int_mm per call."""
    _cuda()
    from shape_based_object_detection_torch import quantize

    rng = np.random.default_rng(k * 100 + c)
    for lo, hi in ((-127, 128), (127, 128)):
        xq = torch.from_numpy(rng.integers(lo, hi, (b, h, h + 2, c)).astype(np.int8)).cuda()
        wq = torch.from_numpy(rng.integers(lo, hi, (o, k, k, c)).astype(np.int8)).cuda()
        before = quantize.launches
        got = torch.ops.sbd.int8_conv2d(xq, wq, [s, s], [p, p], [d, d])
        assert quantize.launches - before == 1
        with torch.backends.cudnn.flags(enabled=False):
            want = quantize.int8_conv2d_plain(xq, wq, [s, s], [p, p], [d, d])
        assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,static", [("weights", False), ("full", False), ("full", True)])
def test_int8_tiers_on_the_card(mode, static, tmp_path):
    """The tiny RetinaNet's int8 tiers on the card: every int8 product's
    convolution (the full tier's) equal to the CPU's on the card's input,
    detect once through K1; an artifact exported on the CPU runs on the
    card through K1 and equals the card's live detect of the same tier."""
    nms_cuda = _cuda()
    from shape_based_object_detection_torch import config, export, quantize
    from shape_based_object_detection_torch.models.factory import build_model

    cfg = config.resolve_config("tiny_retinanet", ["model.detect.score_threshold=0.0"])
    images = np.random.default_rng(3).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    cpu, _ = build_model(cfg.model, device="cpu")
    scales = quantize.calibrate_activation_scales(cpu, [images]) if static else None
    gpu, anchors = build_model(cfg.model, device="cuda")
    detect, qg = quantize.make_serving_detect(gpu, anchors, cfg.model, cfg.data, mode,
                                              "cuda", scales)
    qc = quantize.quantize_module(cpu, mode, scales, device="cpu")
    cpu_mods = dict(qc.named_modules())
    seen = {}
    hooks = [m.register_forward_hook(  # int8 products; float convs sum in other orders
        lambda mod, a, out, n=n: seen.setdefault(n, (a[0], out)) and None)
        for n, m in qg.named_modules()
        if isinstance(m, quantize.Int8Conv2d) and m.mode != "weights"]
    before = nms_cuda.launches
    live = detect(images)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert nms_cuda.launches - before == 1 and bool(seen) == (mode == "full")
    with torch.inference_mode():
        for n, (x, y) in seen.items():
            assert torch.equal(cpu_mods[n](x.cpu()), y.cpu()), n
    blob = export.export_from_config(cfg, batch_size=2, quantize=mode != "",
                                     int8_activations=mode == "full",
                                     activation_scales=scales, device="cpu")
    loaded = export.load_detect(blob)
    assert loaded.device.type == "cuda"
    before = nms_cuda.launches
    det = loaded(images)
    torch.cuda.synchronize()
    assert nms_cuda.launches - before == 1
    for a, b in zip(det, live):
        assert a.device.type == "cuda"
        if a.dtype.is_floating_point:
            assert torch.allclose(a, b, rtol=0, atol=1e-5)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("family,train_bn", [("retinanet", True), ("ssd", False)])
def test_nccl_world_one_step_bit_equal_to_plain(tmp_path, family, train_bn):
    """A data-parallel step in an NCCL group of one (the all-reduces of the
    gradients, the positives and BatchNorm's statistics run, over one rank)
    equals the plain step bit for bit, two steps with augmentation, with
    cuDNN's deterministic algorithms; K2 once per step."""
    _cuda()
    import dataclasses

    import torch.distributed as dist

    from shape_based_object_detection_torch import config, train
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.ops import matching_cuda
    from shape_based_object_detection_torch.parallel import make_mesh

    cfg = config.get_config(f"tiny_{family}")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, train_bn=train_bn,
                                                             remat=True))
    batches = [_tiny_batch(cfg, 30 + i) for i in range(2)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh()
        assert mesh.distributed and mesh.world == 1
        runs = {}
        for m in (None, mesh):
            module, anchors = build_model(cfg.model, train=True,
                                          generator=torch.Generator().manual_seed(5))
            state = train.create_train_state(module, cfg)
            step = train.make_train_step(module, anchors, cfg, mesh=m)
            before = matching_cuda.launches
            metrics = [{k: v.clone() for k, v in step(state, b)[1].items()} for b in batches]
            assert matching_cuda.launches == before + 2
            runs[m is None] = (metrics, module.state_dict())
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    (dp_metrics, dp_state), (metrics, state) = runs[False], runs[True]
    for got, want in zip(dp_metrics, metrics):
        assert all(torch.equal(got[k], want[k]) for k in want), (got, want)
    assert all(torch.equal(dp_state[k], v) for k, v in state.items())


@pytest.mark.cuda
def test_device_cache_loader_on_the_card_equals_cache_loader(tmp_path):
    """The cache staged on the card: every batch gathered there equals
    CacheLoader's host batch, and batches_padded's images stay on the card
    with the host annotations and the tail's n_valid."""
    _cuda()
    from shape_based_object_detection_torch.data.cache import (
        CacheLoader, DeviceCacheLoader, MemmapDetection, build_cache,
    )
    from shape_based_object_detection_torch.data.synthetic import SyntheticDetection

    build_cache(SyntheticDetection(size=64, num_images=10), str(tmp_path), max_boxes=6)
    mm = MemmapDetection(str(tmp_path))
    host = CacheLoader(mm, 4, 6, seed=3)
    dev = DeviceCacheLoader(mm, 4, 6, seed=3)
    pairs = list(zip(dev.device_batches(1), host.batches(1), strict=True))
    assert len(pairs) == 2
    for d, h in pairs:
        for a, b in zip(d, h):
            assert a.is_cuda and np.array_equal(a.cpu().numpy(), b)
    padded = list(dev.batches_padded())
    assert [n for _, n in padded] == [4, 4, 2]
    for (d, n), (h, m) in zip(padded, host.batches_padded()):
        assert d.images.is_cuda and np.array_equal(d.images.cpu().numpy(), h.images)
        assert np.array_equal(d.boxes, h.boxes) and n == m


def _row_ops_rank(rank, store, outs):
    """One of two gloo ranks sharing card 0: each op on its half of the
    rows against the unsplit op's rows (forward, and the input's gradient
    through the halo exchange's backward), relative to the largest value."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from shape_based_object_detection_torch.parallel import RowShard, row_conv2d, row_max_pool2d

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        shard = RowShard(dist.group.WORLD, rank, 2)
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(2, 16, 64, 40, generator=gen).cuda()
        errs = {}
        for k, s, p in ((7, 2, 3), (3, 2, 1), (3, 1, 1), (1, 2, 0), ("pool", 2, 1)):
            if k == "pool":
                op = lambda z, sh: row_max_pool2d(z, 3, s, p, sh)  # noqa: E731
                plain = lambda z: F.max_pool2d(z, 3, s, p)  # noqa: E731
            else:
                conv = torch.nn.Conv2d(16, 8, k, s, p)
                with torch.no_grad():
                    for t in conv.parameters():
                        t.copy_(torch.randn(t.shape, generator=gen))
                conv = conv.cuda()
                op = lambda z, sh: row_conv2d(conv, z, sh)  # noqa: E731
                plain = lambda z: F.conv2d(z, conv.weight, conv.bias, s, p)  # noqa: E731
            full = x.clone().requires_grad_()
            want = plain(full)
            w = torch.randn(want.shape, generator=gen).cuda()
            (want * w).sum().backward()
            part = shard.split(x).clone().requires_grad_()
            got = op(part, shard)
            (got * shard.split(w)).sum().backward()
            errs[f"{k}/{s}"] = (
                float((got - shard.split(want)).abs().max() / want.abs().max()),
                float((part.grad - shard.split(full.grad)).abs().max() / full.grad.abs().max()))
        torch.save(errs, outs[rank])
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_row_ops_on_the_card_equal_the_unsplit_ops(tmp_path):
    """``row_conv2d`` (7x7/2, 3x3/2, 3x3/1, 1x1/2) and ``row_max_pool2d``
    on two gloo ranks sharing the card, each on half of the rows, against
    ``F.conv2d`` / ``F.max_pool2d`` on the whole tensor: forward and input
    gradient within 1e-5 of the largest value (float32, TF32 off; cuDNN
    picks its algorithm per shape, so the sums' order may differ)."""
    _cuda()
    import time

    import torch.multiprocessing as mp

    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    ctx = mp.start_processes(_row_ops_rank, args=(str(tmp_path / "store"), outs),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish in time"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    for path in outs:
        errs = torch.load(path)
        assert len(errs) == 5
        for name, (fwd, grad) in errs.items():
            assert fwd <= 1e-5 and grad <= 1e-5, (name, fwd, grad)


@pytest.mark.cuda
def test_average_checkpoints_on_the_card(tmp_path, capsys):
    """tools/average_checkpoints on a card run's last three checkpoints:
    equal to the host average of the same snapshots to the bit; eval_cli
    restores the result (K1 once per batch) and train_cli resumes from it
    (K2 once per step)."""
    nms_cuda = _cuda()
    from shape_based_object_detection_torch.checkpoint import CheckpointManager
    from shape_based_object_detection_torch.cli import eval_cli, train_cli
    from shape_based_object_detection_torch.ops import matching_cuda
    from shape_based_object_detection_torch.tools import average_checkpoints

    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "avg")
    train = ["--config", "tiny_retinanet", "--workers", "0", "--set",
             "train.checkpoint_every=1", "--set", "train.ema_decay=0.9"]
    train_cli.main([*train, "--steps", "3", "--checkpoint-dir", ckpt])
    average_checkpoints.main(["--config", "tiny_retinanet", "--checkpoint-dir", ckpt,
                              "--out", out, "--last", "3", "--set", "train.ema_decay=0.9"])
    mgr = CheckpointManager(ckpt)
    want = average_checkpoints.average_snapshots([mgr.read(s) for s in (1, 2, 3)])
    got = CheckpointManager(out).read(3)
    for part in ("params", "buffers", "ema"):
        assert all(torch.equal(got[part][k], v) for k, v in want[part].items()), part
    capsys.readouterr()
    k1 = nms_cuda.launches
    eval_cli.main(["--config", "tiny_retinanet", "--checkpoint-dir", out, "--max-batches", "2"])
    assert nms_cuda.launches - k1 == 2 and "mAP" in capsys.readouterr().out
    k2 = matching_cuda.launches
    train_cli.main([*train, "--steps", "4", "--checkpoint-dir", out])
    printed = capsys.readouterr().out
    assert "restored checkpoint at step 3" in printed and "done at step 4" in printed
    assert matching_cuda.launches - k2 == 1


@pytest.mark.cuda
def test_convert_checkpoint_on_the_card(tmp_path, capsys):
    """tools/convert_checkpoint --mode vgg_backbone on the card (a synthetic
    torchvision VGG-16 at the tiny SSD's widths), then two train_cli steps
    from the file with --init-params (K2 once per step)."""
    _cuda()
    from shape_based_object_detection_torch.cli import train_cli
    from shape_based_object_detection_torch.ops import matching_cuda
    from shape_based_object_detection_torch.tools import convert_checkpoint

    sd = torchvision_vgg16(np.random.default_rng(4), width=64, fc=512)
    torch.save(sd, tmp_path / "vgg16.pth")
    out = str(tmp_path / "init.pt")
    convert_checkpoint.main(["--model", "tiny_ssd", "--torch-ckpt",
                             str(tmp_path / "vgg16.pth"), "--mode", "vgg_backbone",
                             "--out", out])
    got = torch.load(out, weights_only=True)
    assert torch.equal(got["vgg.conv1_1.weight"], sd["features.0.weight"])
    k2 = matching_cuda.launches
    train_cli.main(["--config", "tiny_ssd", "--steps", "2", "--workers", "0",
                    "--checkpoint-dir", str(tmp_path / "ckpt"), "--init-params", out])
    printed = capsys.readouterr().out
    assert "initialized params from" in printed and "done at step 2" in printed
    assert matching_cuda.launches - k2 == 2


@pytest.mark.cuda
def test_examples_on_the_card(tmp_path, capsys):
    """Both examples on the card: the demo's steps run K2 and its eval K1;
    the quickstart's Predictors and artifact run K1."""
    nms_cuda = _cuda()
    from shape_based_object_detection_torch.examples import demo, serving_quickstart
    from shape_based_object_detection_torch.ops import matching_cuda

    k1, k2 = nms_cuda.launches, matching_cuda.launches
    demo.main(["--steps", "5", "--out", str(tmp_path)])
    assert matching_cuda.launches - k2 == 5 and nms_cuda.launches - k1 == 1
    assert (tmp_path / "demo_1.png").exists()
    k1 = nms_cuda.launches
    serving_quickstart.main([])
    printed = capsys.readouterr().out
    assert "voc mAP@0.5:" in printed and "output boxes (2, 100, 4)" in printed
    assert nms_cuda.launches > k1
