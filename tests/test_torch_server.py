"""The port's HTTP detection server on the CPU, following
``tests/test_server.py``: endpoints, dynamic batching into buckets, answers
equal to ``Predictor.predict`` of the same images, error isolation (400,
404, 413, 504) and shutdown; and the process-wide precision switch held by
one forward at a time. Requests go over a real socket; every wait is
bounded by 30 s."""

import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from shape_based_object_detection_torch import config
from shape_based_object_detection_torch.server import MAX_BODY_BYTES, DetectionServer, _Batcher
from shape_based_object_detection_torch.serving import Predictor, default_bucket_sizes
from tests.torch_parity import gt_batch, one_torch_thread, tiny_configs  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TIMEOUT = 30


def _encoded(rng, h=97, w=133, fmt="JPEG"):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


def _cfg():
    cfg = config.get_config("tiny_retinanet")
    return config.dataclasses.replace(
        cfg, model=config.dataclasses.replace(cfg.model, detect=config.dataclasses.replace(
            cfg.model.detect, score_threshold=0.0)),
        data=config.dataclasses.replace(cfg.data, decode_backend="pil"))


@pytest.fixture(scope="module")
def server(one_torch_thread):  # noqa: F811
    pred = Predictor(_cfg(), batch_size=4, device="cpu",
                     bucket_sizes=default_bucket_sizes(4))
    pred.warmup()
    srv = DetectionServer(pred, port=0, batch_window_ms=200.0,
                          request_timeout_s=TIMEOUT)
    srv.start()
    yield srv
    srv.close()


def _post(port, body, query="min_score=0.0"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/detect?{query}", data=body,
                                 headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return r.status, r.read()


def _in_threads(fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


def _recording(pred):
    """The batches ``pred.submit`` receives from here on; undo with the
    returned function."""
    batches = []
    orig = pred.submit

    def recording(images):
        batches.append(list(images))
        return orig(images)

    pred.submit = recording
    return batches, lambda: setattr(pred, "submit", orig)


def test_healthz(server):
    assert _get(server.port, "/healthz") == (200, b"ok")


def test_detect_schema(server):
    status, out = _post(server.port, _encoded(np.random.default_rng(0)))
    assert status == 200 and (out["width"], out["height"]) == (133, 97)
    assert out["detections"]
    for d in out["detections"]:
        assert len(d["box"]) == 4 and isinstance(d["label"], int)
        assert 0.0 <= d["score"] <= 1.0
        x0, y0, x1, y1 = d["box"]  # pixels of the original image
        assert 0 <= x0 <= x1 <= 133 and 0 <= y0 <= y1 <= 97


def test_min_score_filters(server):
    body = _encoded(np.random.default_rng(1))
    _, everything = _post(server.port, body, "min_score=0.0")
    _, none = _post(server.port, body, "min_score=1.0")
    assert len(none["detections"]) == 0 < len(everything["detections"])
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, body, "min_score=high")
    assert e.value.code == 400


def test_concurrent_requests_are_batched_and_answered_as_predict(server):
    """Three near-simultaneous requests (JPEG and PNG) ride one batch,
    padded to the bucket of 4; each answer equals Predictor.predict of the
    same decoded images in the same batch, within the JSON's rounding (boxes
    to 0.01 px, scores to 1e-5)."""
    from shape_based_object_detection_torch.utils.image import decode_image_host

    pred = server.predictor
    rng = np.random.default_rng(2)
    bodies = [_encoded(rng, 90 + 20 * i, 120 - 10 * i, fmt) for i, fmt in
              enumerate(("JPEG", "PNG", "JPEG"))]
    results = [None] * 3
    batches, undo = _recording(pred)
    try:
        _in_threads([lambda i=i: results.__setitem__(i, _post(server.port, bodies[i]))
                     for i in range(3)])
    finally:
        undo()
    assert all(r is not None and r[0] == 200 for r in results)
    assert max(len(b) for b in batches) >= 2, f"no batch of several requests: {batches}"
    for batch in batches:
        # the server's pre-resized items, back to the request they came from
        shapes = [size for _, size in batch]
        order = [next(i for i, r in enumerate(results)
                      if (r[1]["height"], r[1]["width"]) == size) for size in shapes]
        want = pred.predict([decode_image_host(bodies[i]) for i in order])
        for i, det in zip(order, want):
            got = results[i][1]["detections"]
            assert len(got) == len(det.scores) > 0
            np.testing.assert_allclose([d["box"] for d in got], det.boxes, rtol=0, atol=0.01)
            np.testing.assert_allclose([d["score"] for d in got], det.scores, rtol=0,
                                       atol=1e-5)
            assert [d["label"] for d in got] == det.labels.tolist()


def test_bad_image_400_does_not_poison_batch(server):
    """An undecodable upload fails alone with 400; a good request racing it
    is answered."""
    results = {}

    def bad():
        try:
            _post(server.port, b"not an image at all")
            results["bad"] = 200
        except urllib.error.HTTPError as e:
            results["bad"] = e.code

    def good():
        results["good"] = _post(server.port, _encoded(np.random.default_rng(3)))[0]

    _in_threads([bad, good])
    assert results == {"bad": 400, "good": 200}


def test_unknown_path_404(server):
    for path in ("/nope", "/detect"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.port, path)
        assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{server.port}/other", data=b"x"), timeout=TIMEOUT)
    assert e.value.code == 404


def test_oversized_body_rejected_before_buffering(server):
    """A Content-Length above the limit is refused with 413 at once, before
    any of the body is sent."""
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
    try:
        conn.putrequest("POST", "/detect")
        conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413
    finally:
        conn.close()


def test_stats_endpoint(server):
    _post(server.port, _encoded(np.random.default_rng(4)))
    status, body = _get(server.port, "/stats")
    s = json.loads(body)
    assert status == 200
    assert s["requests"] >= s["batches"] >= 1 and s["mean_batch_occupancy"] >= 1.0
    assert s["batch_size"] == 4 and s["bucket_sizes"] == [1, 2, 4]


class _StubPredictor:
    """A Predictor's surface without a model: ``poll`` waits ``delay_s``."""

    batch_size, bucket_sizes = 2, [2]
    size, letterbox, decode_backend = 32, False, "pil"

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.pending = []

    def submit(self, images):
        self.pending.append(len(images))

    def poll(self):
        time.sleep(self.delay_s)
        return [None] * self.pending.pop(0)


def test_timeout_504():
    """A request not answered within request_timeout_s gets 504."""
    srv = DetectionServer(_StubPredictor(delay_s=3.0), port=0, batch_window_ms=1.0,
                          request_timeout_s=0.5)
    srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, _encoded(np.random.default_rng(5)))
        assert e.value.code == 504
    finally:
        srv.close()


def test_close_fails_queued_requests_fast():
    """Requests still queued at shutdown fail at once instead of holding
    their handler threads for the request timeout."""
    class Refusing(_StubPredictor):
        def submit(self, images):
            raise RuntimeError("never launched in this test")

    b = _Batcher(Refusing(), window_s=0.001)
    b._stop.set()  # the loop ends before it can take anything
    b._thread.join(timeout=5)
    req = b.submit(object())  # queued after the loop ended
    b._thread = threading.Thread(target=b._loop, daemon=True)  # its drain path
    b._thread.start()
    b.close()
    assert req.event.wait(timeout=5)
    assert req.error == "server shutting down"


def test_precision_switch_held_by_one_forward_at_a_time():
    """Two threads forward models of different precision at once. Every
    convolution of each forward runs under its own model's TF32 setting:
    the process-wide switch is held for the whole forward."""
    from shape_based_object_detection_torch.models.factory import build_model

    seen = {"highest": set(), "default": set()}
    models = {}
    for precision in seen:
        cfg = config.dataclasses.replace(config.tiny_test_model("retinanet"),
                                         precision=precision, image_size=64)
        module, _ = build_model(cfg, device="cpu")
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.register_forward_pre_hook(
                    lambda mod, args, p=precision: seen[p].add(torch.backends.cudnn.allow_tf32))
        models[precision] = module
    x = torch.zeros(1, 3, 64, 64)
    start = threading.Barrier(2)

    def run(precision):
        start.wait(timeout=TIMEOUT)
        with torch.no_grad():
            for _ in range(20):
                models[precision](x)

    before = torch.backends.cudnn.allow_tf32
    _in_threads([lambda p=p: run(p) for p in seen])
    assert seen == {"highest": {False}, "default": {True}}
    assert torch.backends.cudnn.allow_tf32 == before


@pytest.mark.parametrize("train_remat", [False, True])
def test_backward_runs_under_the_precision_lock(train_remat):
    """The train step holds the precision lock around its backward: every
    convolution's gradient is computed by a thread that owns the lock, under
    the model's TF32 setting. With ``train.remat`` the forward recomputed
    inside the backward skips the lock, which is safe only because of this."""
    from shape_based_object_detection_torch import train
    from shape_based_object_detection_torch.models.factory import build_model
    from shape_based_object_detection_torch.models.retinanet import _PRECISION_LOCK

    _, cfg = tiny_configs("retinanet", model=dict(precision="highest", image_size=64),
                          loss=dict(kind="focal"), train=dict(remat=train_remat))
    model = cfg.model
    module, anchors = build_model(model, device="cpu")
    seen = []

    def track(mod, args, out):
        out.register_hook(lambda g: seen.append(
            (_PRECISION_LOCK._is_owned(), torch.backends.cudnn.allow_tf32)))

    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(track)
    state = train.create_train_state(module, cfg, device="cpu")
    step = train.make_train_step(module, anchors, cfg, augment=False, device="cpu")
    before = torch.backends.cudnn.allow_tf32
    step(state, gt_batch(3, 2, 4, 64, model.num_classes))
    assert seen and set(seen) == {(True, False)}
    assert torch.backends.cudnn.allow_tf32 == before
