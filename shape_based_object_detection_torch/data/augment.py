"""Train-time augmentation on the device (port of the JAX package's
``data/augment.py``), batched over the images.

1. photometric distortion: brightness, contrast, saturation, hue, each
   applied with probability 0.5 (branchless HSV);
2. geometry: zoom-out "expand" and the SSD IoU-constrained random crop
   composed into one sampling window per image, applied by one bilinear
   warp (two per-axis weight matrices, as ``jax.image.scale_and_translate``
   builds them, contracted with the image);
3. horizontal flip with probability 0.5;
4. normalization (ImageNet mean/std).

Each random step is split in two: ``draw_augment`` takes the raw uniforms
and integers from a ``torch.Generator`` into one ``AugmentDraws`` per batch,
and ``apply_augment`` is deterministic given the draws. A test can so feed
it the draws that the reference's key tree gives (JAX's threefry and
PyTorch's generators give different numbers from one seed). Images keep the
reference's (B, H, W, 3) layout; boxes are normalized xyxy, padded to G.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

from shape_based_object_detection_torch.config import DataConfig
from shape_based_object_detection_torch.ops import boxes as box_ops
from shape_based_object_detection_torch.ops.boxes import true_div
from shape_based_object_detection_torch.utils.device import constant

NUM_CROP_TRIALS = 16
# SSD sampling modes: the min-IoU constraint of each; -1 = no crop
CROP_MIN_IOUS = (-1.0, 0.0, 0.1, 0.3, 0.5, 0.7, 0.9)


class AugmentDraws(NamedTuple):
    """The random numbers of one batch's augmentation, raw: uniforms in
    [0, 1) before they are scaled to their ranges, and the crop mode."""

    photo_apply: torch.Tensor  # (B, 4) gates of brightness, contrast, saturation, hue
    photo_values: torch.Tensor  # (B, 4) the same four amounts
    expand_ratio: torch.Tensor  # (B,)
    expand_offset: torch.Tensor  # (B, 2)
    expand_use: torch.Tensor  # (B,)
    crop_mode: torch.Tensor  # (B,) int64 in [0, len(CROP_MIN_IOUS))
    crop_wh: torch.Tensor  # (B, T, 2)
    crop_xy: torch.Tensor  # (B, T, 2)
    flip: torch.Tensor  # (B,)


def draw_augment(generator: torch.Generator, batch: int,
                 device=None) -> AugmentDraws:
    """One batch's draws from ``generator`` (two launches on its device)."""
    device = generator.device if device is None else device
    t = NUM_CROP_TRIALS
    u = torch.rand((batch, 13 + 4 * t), generator=generator, device=device)
    mode = torch.randint(0, len(CROP_MIN_IOUS), (batch,), generator=generator,
                         device=device)
    return AugmentDraws(
        photo_apply=u[:, 0:4], photo_values=u[:, 4:8], expand_ratio=u[:, 8],
        expand_offset=u[:, 9:11], expand_use=u[:, 11], crop_mode=mode,
        crop_wh=u[:, 13:13 + 2 * t].reshape(batch, t, 2),
        crop_xy=u[:, 13 + 2 * t:].reshape(batch, t, 2), flip=u[:, 12])


def _scaled(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """A [0, 1) uniform scaled to [lo, hi) as ``jax.random.uniform`` does:
    ``max(lo, u * (hi - lo) + lo)`` in float32."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi32 - lo32) + float(lo32), min=float(lo32))


def _bcast(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) against ``like``."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


# ---------------------------------------------------------------------------
# Color: branchless HSV <-> RGB
# ---------------------------------------------------------------------------


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) in [0, 1] -> (h, s, v) with h in [0, 1)."""
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn
    safe_d = torch.where(d > 0, d, 1.0)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe_d, 6.0),
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0))
    h = torch.where(d > 0, h / 6.0, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    h6 = torch.remainder(h, 1.0) * 6.0
    c = v * s
    x = c * (1.0 - (torch.remainder(h6, 2.0) - 1.0).abs())
    m = v - c
    i = torch.remainder(torch.floor(h6).to(torch.int32), 6)
    # sector table (r, g, b): 0:(c,x,0) 1:(x,c,0) 2:(0,c,x) 3:(0,x,c)
    # 4:(x,0,c) 5:(c,0,x), as masked selects
    zero = torch.zeros_like(c)

    def in_(k0, k1):
        return (i == k0) | (i == k1)

    r = torch.where(in_(0, 5), c, torch.where(in_(1, 4), x, zero))
    g = torch.where(in_(1, 2), c, torch.where(in_(0, 3), x, zero))
    b = torch.where(in_(3, 4), c, torch.where(in_(2, 5), x, zero))
    return torch.stack([r + m, g + m, b + m], dim=-1)


def photometric_distort(img: torch.Tensor, apply: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, 3) in [0, 1]; ``apply`` and ``values`` (B, 4) raw
    uniforms. The amounts are scaled in float32, then cast to the image's
    type, as the reference samples them."""
    dt = img.dtype
    on = apply < 0.5
    delta = _scaled(values[:, 0], -32.0 / 255, 32.0 / 255).to(dt)
    alpha_c = _scaled(values[:, 1], 0.5, 1.5).to(dt)
    alpha_s = _scaled(values[:, 2], 0.5, 1.5).to(dt)
    dh = _scaled(values[:, 3], -18.0 / 360, 18.0 / 360).to(dt)
    img = torch.where(_bcast(on[:, 0], img), img + _bcast(delta, img), img)
    img = torch.where(_bcast(on[:, 1], img), img * _bcast(alpha_c, img), img)
    img = img.clamp(0.0, 1.0)
    hsv = rgb_to_hsv(img)
    hue, sat = hsv[..., 0], hsv[..., 1]
    sat = torch.where(_bcast(on[:, 2], sat),
                      (sat * _bcast(alpha_s, sat)).clamp(0, 1), sat)
    hue = torch.where(_bcast(on[:, 3], hue),
                      torch.remainder(hue + _bcast(dh, hue), 1.0), hue)
    img = hsv_to_rgb(torch.stack([hue, sat, hsv[..., 2]], dim=-1))
    return img.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# Geometry: expand + IoU-crop as one window, one warp
# ---------------------------------------------------------------------------


def _sample_window(draws: AugmentDraws, boxes: torch.Tensor, valid: torch.Tensor,
                   do_expand: bool, do_crop: bool) -> torch.Tensor:
    """(B, 4) windows (x0, y0, x1, y1) in normalized source coordinates: a
    window beyond [0, 1] is a zoom-out (filled with the mean color), one
    inside it a crop; identity is (0, 0, 1, 1)."""
    b = boxes.shape[0]
    window = constant((0.0, 0.0, 1.0, 1.0), boxes.dtype, boxes.device).expand(b, 4)

    if do_expand:
        # zoom out by a ratio r in [1, 4] with probability 0.5
        r = _scaled(draws.expand_ratio, 1.0, 4.0)
        off = draws.expand_offset * (r - 1.0)[:, None]
        expanded = torch.stack([-off[:, 0], -off[:, 1], r - off[:, 0],
                                r - off[:, 1]], dim=-1)
        window = torch.where((draws.expand_use < 0.5)[:, None], expanded, window)

    if do_crop:
        # the SSD IoU-constrained crop over T trials at once; the first
        # trial that satisfies the constraints wins
        min_iou = constant(CROP_MIN_IOUS, torch.float32,
                           boxes.device)[draws.crop_mode]
        wh = _scaled(draws.crop_wh, 0.3, 1.0)  # (B, T, 2)
        ratio = wh[..., 0] / wh[..., 1]
        ar_ok = (ratio > 0.5) & (ratio < 2.0)
        xy0 = draws.crop_xy * (1.0 - wh)
        cand = torch.cat([xy0, xy0 + wh], dim=-1)  # (B, T, 4)

        # the candidates live in window space (they compose onto the
        # possibly expanded window), so the GT boxes are mapped there too
        w0 = window[:, None, :2]
        wsz = window[:, None, 2:] - window[:, None, :2]
        boxes_w = (boxes - torch.cat([w0, w0], -1)) / torch.cat([wsz, wsz], -1)

        # max IoU(crop, any valid GT) >= min_iou and some valid GT centre
        # inside the crop
        iou = box_ops.iou_matrix(cand, boxes_w)  # (B, T, G)
        iou = torch.where(valid[:, None, :], iou, -1.0)
        centers = (boxes_w[..., :2] + boxes_w[..., 2:]) / 2.0  # (B, G, 2)
        inside = ((centers[:, None] > cand[:, :, None, :2]).all(-1)
                  & (centers[:, None] < cand[:, :, None, 2:]).all(-1))
        inside = inside & valid[:, None, :]
        ok = ar_ok & (iou.amax(-1) >= min_iou[:, None]) & inside.any(-1)
        first = ok.to(torch.uint8).argmax(-1)  # the first satisfying trial
        crop = cand.gather(1, first[:, None, None].expand(b, 1, 4))[:, 0]
        use_crop = (draws.crop_mode != 0) & ok.any(-1)
        w0, wsz = window[:, :2], window[:, 2:] - window[:, :2]
        composed = torch.cat([w0 + crop[:, :2] * wsz, w0 + crop[:, 2:] * wsz], -1)
        window = torch.where(use_crop[:, None], composed, window)
    return window


@contextlib.contextmanager
def _float32_matmul():
    """Matrix products in full float32 (no TF32) while the warp runs."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _linear_weights(in_size: int, out_size: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """(B, in, out) weights of the triangle kernel without antialiasing, as
    ``jax.image.scale_and_translate`` computes them for one axis: normalized
    by each output's sum, so samples in [-0.5, 0) take the edge pixel, and 0
    for samples outside [-0.5, in - 0.5]."""
    dev = scale.device
    inv_scale = (1.0 / scale)[:, None]
    out_f = torch.arange(out_size, dtype=scale.dtype, device=dev)[None]
    sample = (out_f + 0.5) * inv_scale - translation[:, None] * inv_scale - 0.5
    in_f = torch.arange(in_size, dtype=scale.dtype, device=dev)[None, :, None]
    weights = (1.0 - (sample[:, None, :] - in_f).abs()).clamp(min=0.0)
    total = weights.sum(1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def _warp_image(img: torch.Tensor, window: torch.Tensor, out_size: int,
                fill: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, out, out, 3): sample each image's window onto the
    canvas bilinearly; regions outside the image get ``fill``."""
    _, h, w, _ = img.shape
    # output pixel o maps to input pixel (o / out) * win_size * dim + win0 * dim
    win_w = (window[:, 2] - window[:, 0]) * w
    win_h = (window[:, 3] - window[:, 1]) * h
    scale_y = torch.full_like(win_h, out_size) / win_h
    scale_x = torch.full_like(win_w, out_size) / win_w
    wy = _linear_weights(h, out_size, scale_y, -window[:, 1] * h * scale_y)
    wx = _linear_weights(w, out_size, scale_x, -window[:, 0] * w * scale_x)
    x = img - fill
    with _float32_matmul():
        rows = torch.einsum("bhwc,bhy->bywc", x, wy.to(x.dtype))
        warped = torch.einsum("bywc,bwx->byxc", rows, wx.to(x.dtype))
    return warped + fill


def _transform_boxes(boxes: torch.Tensor, valid: torch.Tensor,
                     window: torch.Tensor):
    """Map (B, G, 4) boxes through the windows; drop a box whose centre
    leaves its window or whose clipped extent is below 1e-3."""
    w0 = torch.cat([window[:, :2], window[:, :2]], -1)[:, None]
    wsz = (window[:, 2:] - window[:, :2]).repeat(1, 2)[:, None]
    out = (boxes - w0) / wsz
    centers = (out[..., :2] + out[..., 2:]) / 2.0
    inside = (centers > 0.0).all(-1) & (centers < 1.0).all(-1)
    out = out.clamp(0.0, 1.0)
    wh = out[..., 2:] - out[..., :2]
    nonempty = (wh > 1e-3).all(-1)
    new_valid = valid & inside & nonempty
    return torch.where(new_valid[..., None], out, 0.0), new_valid


def apply_augment(
    draws: AugmentDraws,
    images_u8: torch.Tensor,  # (B, H, W, 3) uint8, already at a static size
    boxes: torch.Tensor,  # (B, G, 4) normalized xyxy, padded
    labels: torch.Tensor,  # (B, G) int32
    valid: torch.Tensor,  # (B, G) bool
    cfg: DataConfig,
    out_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The deterministic part of the augmentation. Returns normalized
    images (B, out, out, 3) in ``cfg.augment_dtype``, boxes, labels and the
    updated valid mask."""
    dtype = getattr(torch, cfg.augment_dtype)
    dev = images_u8.device
    img = true_div(images_u8.to(dtype), 255.0)
    if cfg.photometric:
        img = photometric_distort(img, draws.photo_apply, draws.photo_values)

    mean = constant(tuple(cfg.mean), dtype, dev)
    window = _sample_window(draws, boxes, valid, cfg.expand, cfg.random_crop)
    img = _warp_image(img, window, out_size, mean)
    boxes, valid = _transform_boxes(boxes, valid, window)

    if cfg.hflip:
        flip = draws.flip < 0.5
        img = torch.where(_bcast(flip, img), img.flip(2), img)
        flipped = torch.stack([1.0 - boxes[..., 2], boxes[..., 1],
                               1.0 - boxes[..., 0], boxes[..., 3]], dim=-1)
        boxes = torch.where(flip[:, None, None], flipped, boxes)
        # the flip turns zeroed padding rows into (1, 0, 1, 0): zero them again
        boxes = torch.where(valid[..., None], boxes, 0.0)

    std = constant(tuple(cfg.std), dtype, dev)
    return (img - mean) / std, boxes, labels, valid


def augment_batch(
    generator: torch.Generator,
    images_u8: torch.Tensor,
    boxes: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    cfg: DataConfig,
    out_size: int,
    rank: int = 0,
    world: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw from ``generator`` (on the images' device) and apply. With
    ``world > 1`` the images are rank ``rank``'s rows of a global batch of
    ``world`` times as many: the draws are the global batch's, and this
    rank keeps its rows, so its images are augmented as in a single
    process's step on the global batch and every rank's generator stays in
    step with the others'."""
    b = images_u8.shape[0]
    draws = draw_augment(generator, b * world, images_u8.device)
    if world > 1:
        draws = AugmentDraws(*(d[rank * b:(rank + 1) * b] for d in draws))
    return apply_augment(draws, images_u8, boxes, labels, valid, cfg, out_size)
