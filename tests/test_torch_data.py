"""The port's datasets and Loader against the JAX package's: the same
arrays from ``SyntheticDetection``, ``VOCDetection`` (a VOCdevkit fixture
tree written here), ``CocoDetection`` (a small instances JSON), and the same
batches from ``Loader.batches``, ``batches_padded`` and ``steps_per_epoch``
at the same seed; ``device_batches`` on the CPU yields the host batches as
tensors, raises the producer's error and stops when the consumer does."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from shape_based_object_detection_tpu.data import coco as ref_coco
from shape_based_object_detection_tpu.data import pipeline as ref_pipeline
from shape_based_object_detection_tpu.data import synthetic as ref_synthetic
from shape_based_object_detection_tpu.data import voc as ref_voc
from shape_based_object_detection_torch.data import coco, pipeline, synthetic, voc


def _same_samples(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        assert len(sa) == len(sb)
        for x, y in zip(sa, sb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(size=64, num_images=6),
    dict(size=128, num_images=5, max_objects=8, num_classes=20, seed=3, aspect_std=0.6,
         color_jitter=0.1),
    dict(size=96, num_images=4, num_classes=7, seed=5, aspect_std=0.3, area_lo=0.0005,
         area_hi=0.0035, class_aspect=1.0),
])
def test_synthetic_equals_reference(kw):
    _same_samples(synthetic.SyntheticDetection(**kw), ref_synthetic.SyntheticDetection(**kw))


def _voc_tree(root):
    (root / "JPEGImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    (root / "ImageSets" / "Main").mkdir(parents=True)
    rng = np.random.default_rng(0)
    objects = {"a": [("dog", 10, 12, 80, 90, 0), ("person", 5, 5, 40, 60, 1)],
               "b": [("car", 20, 30, 150, 100, 0), ("unknown", 1, 1, 5, 5, 0)],
               "c": [("cat", 2, 3, 60, 70, 1)]}
    for name, objs in objects.items():
        h, w = int(rng.integers(80, 140)), int(rng.integers(100, 170))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{name}.jpg", quality=90)
        body = "".join(
            f"<object><name>{n}</name><difficult>{d}</difficult><bndbox><xmin>{x0}</xmin>"
            f"<ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>"
            for n, x0, y0, x1, y1, d in objs)
        (root / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height></size>{body}"
            "</annotation>")
    (root / "ImageSets" / "Main" / "train.txt").write_text("a\nb\nc\n")


@pytest.mark.parametrize("difficult,letterbox,backend", [
    (False, False, "auto"), (True, True, "native"), (True, False, "pil")])
def test_voc_equals_reference(tmp_path, difficult, letterbox, backend):
    _voc_tree(tmp_path)
    kw = dict(split="train", image_size=64, include_difficult=difficult,
              letterbox=letterbox, decode_backend=backend)
    got, want = voc.VOCDetection(str(tmp_path), **kw), ref_voc.VOCDetection(str(tmp_path), **kw)
    assert got.decode_backend == want.decode_backend
    _same_samples(got, want)
    path = str(tmp_path / "Annotations" / "a.xml")
    for g, w in zip(voc.parse_voc_xml(path, difficult), ref_voc.parse_voc_xml(path, difficult)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _coco_tree(root):
    rng = np.random.default_rng(1)
    images = [{"id": 11, "file_name": "a.jpg", "height": 100, "width": 160},
              {"id": 12, "file_name": "b.png", "height": 120, "width": 80},
              {"id": 13, "file_name": "missing.jpg", "height": 50, "width": 50}]
    for im in images[:2]:
        Image.fromarray(rng.integers(0, 255, (im["height"], im["width"], 3),
                                     dtype=np.uint8)).save(root / im["file_name"])
    ann = {"images": images,
           "categories": [{"id": c, "name": f"c{c}"} for c in (1, 5, 7, 90)],
           "annotations": [
               {"id": 1, "image_id": 11, "category_id": 5, "bbox": [10, 10, 40, 40],
                "iscrowd": 0},
               {"id": 2, "image_id": 11, "category_id": 90, "bbox": [0, 0, 200, 20],
                "iscrowd": 1},
               {"id": 3, "image_id": 12, "category_id": 1, "bbox": [5, 5, 30, 60],
                "iscrowd": 0},
               {"id": 4, "image_id": 12, "category_id": 7, "bbox": [5, 5, 0, 60],
                "iscrowd": 0}]}
    (root / "ann.json").write_text(json.dumps(ann))
    return str(root / "ann.json")


@pytest.mark.parametrize("crowd,letterbox", [(False, False), (True, True)])
def test_coco_equals_reference(tmp_path, crowd, letterbox):
    ann = _coco_tree(tmp_path)
    kw = dict(image_size=64, letterbox=letterbox, include_crowd=crowd)
    got = coco.CocoDetection(str(tmp_path), ann, **kw)
    want = ref_coco.CocoDetection(str(tmp_path), ann, **kw)
    assert len(got) == 2
    assert got.coco.label_to_cat_id == want.coco.label_to_cat_id
    _same_samples(got, want)


def _loaders(n=11, batch=3, **kw):
    ds = synthetic.SyntheticDetection(size=32, num_images=n, max_objects=6)
    ref_ds = ref_synthetic.SyntheticDetection(size=32, num_images=n, max_objects=6)
    return pipeline.Loader(ds, batch, 4, **kw), ref_pipeline.Loader(ref_ds, batch, 4, **kw)


def _same_batch(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=7, workers=3),
                                dict(shuffle=False), dict(seed=2, host_id=1, num_hosts=2)])
def test_loader_equals_reference(kw):
    got, want = _loaders(**kw)
    assert got.steps_per_epoch() == want.steps_per_epoch()
    for epoch in (0, 1):
        gb, wb = list(got.batches(epoch)), list(want.batches(epoch))
        assert len(gb) == len(wb) == got.steps_per_epoch()
        for a, b in zip(gb, wb):
            _same_batch(a, b)
        gp, wp = list(got.batches_padded(epoch)), list(want.batches_padded(epoch))
        assert [n for _, n in gp] == [n for _, n in wp]
        for (a, _), (b, _) in zip(gp, wp):
            _same_batch(a, b)
    got.close()
    with pytest.raises(ValueError, match="batch_size"):
        next(_loaders(n=2, batch=3)[0].batches())


@pytest.mark.parametrize("max_boxes,g", [(4, 2), (3, 5), (5, 0)])
def test_pad_annotations_equals_reference(max_boxes, g):
    rng = np.random.default_rng(g)
    boxes, labels = rng.uniform(size=(g, 4)).astype(np.float32), np.arange(1, g + 1)
    flags = rng.uniform(size=g) < 0.5
    for f in (None, flags):
        for a, b in zip(pipeline.pad_annotations(boxes, labels, max_boxes, f),
                        ref_pipeline.pad_annotations(boxes, labels, max_boxes, f)):
            np.testing.assert_array_equal(a, b)


def test_device_batches_on_the_cpu():
    loader = _loaders(seed=4, workers=2)[0]
    host = list(loader.batches(1))
    dev = list(loader.device_batches(1, device="cpu"))
    assert len(dev) == len(host)
    for h, d in zip(host, dev):
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in d)
        _same_batch(d, h)
    # a consumer that stops early stops the producer
    it = loader.device_batches(0, device="cpu")
    next(it)
    it.close()


def test_device_batches_raise_the_producers_error():
    class Broken(synthetic.SyntheticDetection):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable sample 5")
            return super().__getitem__(i)

    loader = pipeline.Loader(Broken(size=32, num_images=9), 3, 4, shuffle=False)
    with pytest.raises(OSError, match="sample 5"):
        list(loader.device_batches(0, device="cpu"))


def test_device_batches_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(_loaders()[0].device_batches(0))

