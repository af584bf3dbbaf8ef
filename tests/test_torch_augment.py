"""The port's augmentation against the JAX package's (``data/augment.py``).

The two frameworks draw different random numbers from one seed, so the
full-pipeline test takes the raw draws from JAX's key tree (a helper that
repeats ``_augment_one``'s splits) and feeds them to the port's
``apply_augment``. Tolerances: HSV and the warp agree to 1e-5 absolute in
float32 (sums in another order, ``%`` and division in the last bit);
normalized images to 1e-4 (the 1/std scale); boxes to 1e-6; masks and
labels exactly."""

import colorsys
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_object_detection_tpu.config import DataConfig as JaxDataConfig
from shape_based_object_detection_tpu.data import augment as jax_aug
from shape_based_object_detection_torch.config import DataConfig
from shape_based_object_detection_torch.data import augment


def jax_draws(rng, batch: int) -> augment.AugmentDraws:
    """The raw uniforms and the crop mode that the reference's
    ``augment_batch(rng, ...)`` draws, by the same key splits."""
    rows = []
    for key in jax.random.split(rng, batch):
        k = jax.random.split(key, 4)
        kp = jax.random.split(k[0], 8)
        kw = jax.random.split(k[1], 6)
        kwh, kxy = jax.random.split(kw[4])
        rows.append(dict(
            photo_apply=jax.random.uniform(kp[0], (4,)),
            photo_values=jnp.stack([jax.random.uniform(kp[i], ()) for i in (1, 2, 3, 4)]),
            expand_ratio=jax.random.uniform(kw[0], ()),
            expand_offset=jax.random.uniform(kw[1], (2,)),
            expand_use=jax.random.uniform(kw[2], ()),
            crop_mode=jax.random.randint(kw[3], (), 0, len(augment.CROP_MIN_IOUS)),
            crop_wh=jax.random.uniform(kwh, (augment.NUM_CROP_TRIALS, 2)),
            crop_xy=jax.random.uniform(kxy, (augment.NUM_CROP_TRIALS, 2)),
            flip=jax.random.uniform(k[2], ()),
        ))
    fields = {}
    for name in augment.AugmentDraws._fields:
        stacked = np.stack([np.asarray(r[name]) for r in rows])
        fields[name] = torch.from_numpy(stacked.astype(
            np.int64 if name == "crop_mode" else np.float32))
    return augment.AugmentDraws(**fields)


def _batch(seed, b, size, g):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    xy = rng.uniform(0.0, 0.7, (b, g, 2))
    wh = rng.uniform(0.05, 0.5, (b, g, 2))
    boxes = np.clip(np.concatenate([xy, xy + wh], -1), 0, 1).astype(np.float32)
    labels = rng.integers(1, 5, (b, g)).astype(np.int32)
    valid = rng.uniform(size=(b, g)) < 0.7
    valid[:, 0] = True
    boxes[~valid] = 0.0
    return images, boxes, labels, valid


def test_hsv_roundtrip_and_match_jax():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    rgb[:20] = rgb[:20, :1]  # greys: d = 0
    rgb[20:30, 1] = rgb[20:30, 0]  # ties between channels
    rgb[30] = 0.0
    hsv = augment.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jax_aug.rgb_to_hsv(jnp.asarray(rgb))),
                               rtol=0, atol=1e-6)
    for i in (40, 41, 42):
        ref = colorsys.rgb_to_hsv(*rgb[i])
        np.testing.assert_allclose(hsv[i].numpy(), ref, atol=1e-5)
    back = augment.hsv_to_rgb(hsv)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_aug.hsv_to_rgb(jnp.asarray(hsv.numpy()))),
        rtol=0, atol=1e-6)


# (window, input height, input width, output size): identity, expanded
# (zoom-out, partly outside the image), cropped, at odd sizes
WINDOWS = [
    ((0.0, 0.0, 1.0, 1.0), 37, 53, 29),
    ((0.0, 0.0, 1.0, 1.0), 24, 24, 24),
    ((-0.7, -0.3, 1.9, 2.1), 31, 45, 33),
    ((0.13, 0.27, 0.71, 0.9), 41, 39, 35),
    ((0.13, 0.27, 0.71, 0.9), 17, 23, 40),
]


@pytest.mark.parametrize("window,h,w,out", WINDOWS)
def test_warp_matches_scale_and_translate(window, h, w, out):
    rng = np.random.default_rng(h * w + out)
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    fill = np.asarray([0.485, 0.456, 0.406], np.float32)
    want = jax_aug._warp_image(jnp.asarray(img), jnp.asarray(window, jnp.float32),
                               out, jnp.asarray(fill))
    got = augment._warp_image(torch.from_numpy(img)[None],
                              torch.tensor([window], dtype=torch.float32), out,
                              torch.from_numpy(fill))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_transform_boxes_and_window_sampling_match_jax():
    _, boxes, _, valid = _batch(1, 6, 8, 9)
    windows = np.array([[0.0, 0.0, 1.0, 1.0], [0.2, 0.1, 0.8, 0.7],
                        [-0.5, -0.2, 1.5, 2.0], [0.4, 0.4, 0.5, 0.5],
                        [0.0, 0.3, 0.6, 1.0], [0.05, 0.05, 0.95, 0.95]],
                       np.float32)
    got_b, got_v = augment._transform_boxes(torch.from_numpy(boxes),
                                            torch.from_numpy(valid),
                                            torch.from_numpy(windows))
    for i in range(len(windows)):
        want_b, want_v = jax_aug._transform_boxes(
            jnp.asarray(boxes[i]), jnp.asarray(valid[i]), jnp.asarray(windows[i]))
        np.testing.assert_array_equal(got_v[i].numpy(), np.asarray(want_v))
        np.testing.assert_allclose(got_b[i].numpy(), np.asarray(want_b), atol=1e-6)

    draws = jax_draws(jax.random.PRNGKey(3), 6)
    for expand, crop in ((True, True), (False, True), (True, False)):
        got = augment._sample_window(draws, torch.from_numpy(boxes),
                                     torch.from_numpy(valid), expand, crop)
        keys = jax.random.split(jax.random.PRNGKey(3), 6)
        for i, key in enumerate(keys):
            want = jax_aug._sample_window(jax.random.split(key, 4)[1],
                                          jnp.asarray(boxes[i]),
                                          jnp.asarray(valid[i]), expand, crop)
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-6)


def test_hflip_boxes_keep_padding_zero():
    images, boxes, labels, valid = _batch(2, 2, 16, 5)
    cfg = DataConfig(photometric=False, expand=False, random_crop=False, hflip=True)
    draws = jax_draws(jax.random.PRNGKey(0), 2)._replace(flip=torch.tensor([0.1, 0.9]))
    img, out_b, _, out_v = augment.apply_augment(
        draws, torch.from_numpy(images), torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(valid), cfg, 16)
    b0 = boxes[0][valid[0]]
    np.testing.assert_allclose(out_b[0][out_v[0]].numpy(),
                               np.stack([1 - b0[:, 2], b0[:, 1], 1 - b0[:, 0], b0[:, 3]], 1),
                               atol=1e-6)
    np.testing.assert_allclose(out_b[1][out_v[1]].numpy(), boxes[1][valid[1]], atol=1e-6)
    assert (out_b[~out_v] == 0).all()
    unflipped = augment.apply_augment(
        draws._replace(flip=torch.tensor([0.9, 0.9])), torch.from_numpy(images),
        torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(valid),
        cfg, 16)[0]
    np.testing.assert_allclose(img[0].numpy(), unflipped[0].flip(1).numpy(), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_batch_with_jax_draws_matches_jax(seed):
    """The whole pipeline (photometric, expand, crop, warp, flip,
    normalize) on the reference's own draws."""
    images, boxes, labels, valid = _batch(seed + 10, 4, 48, 6)
    key = jax.random.PRNGKey(seed)
    jcfg = JaxDataConfig()
    want = jax_aug.augment_batch(key, jnp.asarray(images), jnp.asarray(boxes),
                                 jnp.asarray(labels), jnp.asarray(valid), jcfg, 40)
    got = augment.apply_augment(jax_draws(key, 4), torch.from_numpy(images),
                                torch.from_numpy(boxes), torch.from_numpy(labels),
                                torch.from_numpy(valid), DataConfig(), 40)
    w_img, w_boxes, w_labels, w_valid = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[3].numpy(), w_valid)
    np.testing.assert_array_equal(got[2].numpy(), w_labels)
    np.testing.assert_allclose(got[1].numpy(), w_boxes, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), w_img, rtol=0, atol=1e-4)
    assert got[0].shape == (4, 40, 40, 3) and got[0].dtype == torch.float32


def test_draws_are_seeded_and_in_range():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    d1, d2 = augment.draw_augment(g1, 3), augment.draw_augment(g2, 3)
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    assert d1.crop_wh.shape == (3, augment.NUM_CROP_TRIALS, 2)
    assert ((d1.crop_mode >= 0) & (d1.crop_mode < 7)).all()
    assert all(((t >= 0) & (t < 1)).all() for n, t in d1._asdict().items()
               if n != "crop_mode")
    images, boxes, labels, valid = _batch(0, 3, 32, 4)
    out = augment.augment_batch(g1, torch.from_numpy(images), torch.from_numpy(boxes),
                                torch.from_numpy(labels), torch.from_numpy(valid),
                                dataclasses.replace(DataConfig(), augment_dtype="float32"),
                                24)
    assert out[0].shape == (3, 24, 24, 3) and torch.isfinite(out[0]).all()
