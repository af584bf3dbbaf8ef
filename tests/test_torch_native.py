"""The port's host C++ (``csrc/ap_matcher.cpp``, ``csrc/jpeg_decoder.cpp``,
built by ``utils/native.py`` into ``_build/``) and the host image helpers
against the JAX package's: the AP matcher equal to the reference's library
and to the numpy matching on the same inputs; the JPEG decoder byte-equal
to the reference's; ``load_resized_image_host``, ``boxes_px_to_input_norm``
and ``serving.prepare_batch`` equal to the reference's on paths, bytes and
arrays."""

import io

import numpy as np
import pytest
from PIL import Image

from shape_based_object_detection_tpu.utils import image as ref_image
from shape_based_object_detection_tpu.utils import native as ref_native
from shape_based_object_detection_torch.eval import ap as port_ap
from shape_based_object_detection_torch.utils import image, native


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 0.3) % 256, (y * 0.5) % 256, ((x + y) * 0.2) % 256], -1)
    return np.clip(img + rng.integers(-15, 15, img.shape), 0, 255).astype(np.uint8)


def _encode(img, fmt="JPEG"):
    b = io.BytesIO()
    Image.fromarray(img).save(b, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return b.getvalue()


def _match_inputs(seed, n=40, m=12, k=1):
    rng = np.random.default_rng(seed)
    gt_xy = rng.uniform(0, 0.7, (m, 2))
    gt = np.concatenate([gt_xy, gt_xy + rng.uniform(0.05, 0.3, (m, 2))], 1)
    det = gt[rng.integers(0, m, n)] + rng.normal(0, 0.03, (n, 4))
    return (det.astype(np.float32), rng.integers(0, 4, n).astype(np.int32),
            (rng.uniform(size=(k, n)) < 0.2).astype(np.uint8),
            gt.astype(np.float32), rng.integers(0, 4, m).astype(np.int32),
            (rng.uniform(size=m) < 0.2).astype(np.uint8),
            (rng.uniform(size=(k, m)) < 0.3).astype(np.uint8),
            np.linspace(0.5, 0.95, 10).astype(np.float32))


def test_libraries_build_into_the_port_build_dir():
    for name in ("ap_matcher", "jpeg_decoder"):
        path = native.build(name)
        assert path.parent == native.BUILD_DIR and path == native.library_path(name)
        assert path.name.startswith(f"lib{name}-") and path.exists()
    # the sources are the reference's, copied
    for name in ("ap_matcher.cpp", "jpeg_decoder.cpp"):
        ref = (native.PACKAGE_DIR.parent / "csrc" / name).read_bytes()
        assert (native.CSRC_DIR / name).read_bytes() == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_class_native_equals_reference(seed):
    args = _match_inputs(seed)
    single = (args[0], args[1], args[2][0], *args[3:6], args[6][0], args[7])
    got = native.match_class_native(*single)
    want = ref_native.match_class_native(*single)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,k", [(3, 1), (4, 4), (5, 4)])
def test_match_class_strata_native_equals_reference(seed, k):
    args = _match_inputs(seed, k=k)
    got = native.match_class_strata_native(*args)
    want = ref_native.match_class_strata_native(*args)
    assert got[0].shape == (k, 10, 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [6, 7])
def test_native_matcher_equals_numpy_matching(seed):
    """The port's ``_match_class_strata``: the C++ and numpy matchers give
    the same tp/ignore matrices, over every area range and threshold."""
    rng = np.random.default_rng(seed)
    dets, gts, crowd, ignore = [], {}, {}, {}
    for img in range(5):
        g = int(rng.integers(1, 6))
        xy = rng.uniform(0, 0.7, (g, 2))
        gts[img] = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (g, 2))], 1)
        crowd[img] = rng.uniform(size=g) < 0.25
        ignore[img] = rng.uniform(size=g) < 0.2
        for _ in range(int(rng.integers(1, 8))):
            box = gts[img][rng.integers(0, g)] + rng.normal(0, 0.04, 4)
            dets.append((img, box.astype(np.float32), float(rng.uniform())))
    ranges = [(0.0, 1e10), (0.0, 32 ** 2), (32 ** 2, 96 ** 2), (96 ** 2, 1e10)]
    factors = {img: 512.0 ** 2 for img in gts}
    out = {m: port_ap._match_class_strata(dets, gts, port_ap.COCO_IOU_THRESHOLDS, ranges,
                                          crowd=crowd, max_det=100, area_factors=factors,
                                          ignore=ignore, matcher=m)
           for m in ("native", "numpy")}
    (nat, s_n, r_n), (npy, s_p, r_p) = out["native"], out["numpy"]
    np.testing.assert_array_equal(s_n, s_p)
    np.testing.assert_array_equal(r_n, r_p)
    for (tp_a, ig_a, n_a), (tp_b, ig_b, n_b) in zip(nat, npy):
        np.testing.assert_array_equal(tp_a, tp_b)
        np.testing.assert_array_equal(ig_a, ig_b)
        assert n_a == n_b
    assert any(tp.any() for tp, _, _ in nat)


@pytest.mark.parametrize("h,w,size,letterbox", [(400, 600, 128, False), (400, 600, 128, True),
                                                (90, 130, 300, False), (333, 211, 64, True)])
def test_decode_jpeg_resize_native_byte_equal_to_reference(h, w, size, letterbox):
    data = _encode(_photo(h, w, h + w))
    got = native.decode_jpeg_resize_native(data, size, letterbox)
    want = ref_native.decode_jpeg_resize_native(data, size, letterbox)
    assert got[1:] == want[1:] == (h, w)
    assert got[0].dtype == np.uint8 and got[0].shape == (size, size, 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert native.decode_jpeg_resize_native(b"\xff\xd8not a jpeg", size, letterbox) is None


@pytest.mark.parametrize("fmt,backend,letterbox", [
    ("JPEG", "auto", False), ("JPEG", "native", True), ("JPEG", "pil", False),
    ("PNG", "auto", True), ("PNG", "pil", False)])
def test_load_resized_image_host_equals_reference(tmp_path, fmt, backend, letterbox):
    img = _photo(120, 170, 9)
    data = _encode(img, fmt)
    path = tmp_path / f"img.{fmt.lower()}"
    path.write_bytes(data)
    for item in (data, str(path)):
        got = image.load_resized_image_host(item, 96, letterbox, backend=backend)
        want = ref_image.load_resized_image_host(item, 96, letterbox, backend=backend)
        assert got[1:] == want[1:] == (120, 170)
        np.testing.assert_array_equal(got[0], want[0])


def test_effective_decode_backend(monkeypatch):
    assert image.effective_decode_backend("pil") == "pil"
    assert image.effective_decode_backend("native") == "native"
    assert image.effective_decode_backend("auto") == "native"
    with pytest.raises(ValueError, match="auto|native|pil"):
        image.effective_decode_backend("turbo")

    def broken():
        raise RuntimeError("building jpeg_decoder.cpp failed")

    monkeypatch.setattr(native, "load_image_lib", broken)
    with pytest.raises(RuntimeError, match="jpeg_decoder"):
        image.effective_decode_backend("native")
    monkeypatch.setattr(image, "_auto_backend", None)
    assert image.effective_decode_backend("auto") == "pil"
    assert "jpeg_decoder" in image.AUTO_BACKEND_REASON


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output;
    nothing falls back."""
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "ap_matcher.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="ap_matcher.cpp failed"):
        native.build("ap_matcher")


@pytest.mark.parametrize("letterbox", [False, True])
def test_boxes_px_to_input_norm_equals_reference(letterbox):
    rng = np.random.default_rng(10)
    boxes = rng.uniform(-20, 700, (9, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        image.boxes_px_to_input_norm(boxes, 480, 640, letterbox),
        ref_image.boxes_px_to_input_norm(boxes, 480, 640, letterbox))


@pytest.mark.parametrize("letterbox", [False, True])
def test_prepare_batch_takes_paths_and_bytes(tmp_path, letterbox):
    from shape_based_object_detection_tpu import serving as ref_serving
    from shape_based_object_detection_torch import serving

    jpg, png = _encode(_photo(150, 100, 11)), _encode(_photo(70, 90, 12), "PNG")
    (tmp_path / "a.jpg").write_bytes(jpg)
    items = [str(tmp_path / "a.jpg"), png, _photo(60, 80, 13)]
    got = serving.prepare_batch(items, 64, 4, letterbox, "auto")
    want = ref_serving.prepare_batch(items, 64, 4, letterbox, "auto")
    assert got[1] == want[1] == [(150, 100), (70, 90), (60, 80)]
    np.testing.assert_array_equal(got[0], want[0])


def test_matcher_checks_its_argument_shapes():
    args = list(_match_inputs(8, k=2))
    with pytest.raises(ValueError, match="shapes"):
        native.match_class_native(*args)  # (K, N) flags where (N,) belong
    args[6] = args[6][:, :-1]
    with pytest.raises(ValueError, match="shapes"):
        native.match_class_strata_native(*args)
