"""Plain PyTorch training augmentation (the SSD recipe of Liu et al. 2016
§2.2, as the configuration's ``data`` block switches it): photometric
distortion in HSV, zoom-out "expand" by up to 4x filled with the mean
colour, the IoU-constrained random crop over 16 trials, a bilinear
resample of the chosen window onto the square canvas, a horizontal flip,
then ImageNet normalisation.

The random numbers are the inputs both sides share: they are drawn from a
``torch.Generator`` that the benchmark seeds alike for the program and for
this reference, in the layout the configuration's augmentation takes them
(per image 4 gates and 4 amounts of the photometric steps, the expand
ratio, its 2 offsets and its gate, the flip gate, 16 crop sizes and 16
crop corners, then one crop mode per image). Everything else is worked out
here, image by image.
"""

from __future__ import annotations

import numpy as np
import torch

TRIALS = 16
CROP_MIN_IOUS = (-1.0, 0.0, 0.1, 0.3, 0.5, 0.7, 0.9)


def draw(gen: torch.Generator, batch: int, device):
    u = torch.rand((batch, 13 + 4 * TRIALS), generator=gen, device=device)
    mode = torch.randint(0, len(CROP_MIN_IOUS), (batch,), generator=gen, device=device)
    return u, mode


def _scaled(u, lo: float, hi: float):
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi32 - lo32) + float(lo32), min=float(lo32))


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    mx, mn = rgb.max(-1).values, rgb.min(-1).values
    d = mx - mn
    dd = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(mx == r, torch.remainder((g - b) / dd, 6.0),
                    torch.where(mx == g, (b - r) / dd + 2.0, (r - g) / dd + 4.0)) / 6.0
    h = torch.where(d > 0, h, torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)), torch.zeros_like(mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    h6 = torch.remainder(h, 1.0) * 6.0
    c = v * s
    x = c * (1.0 - (torch.remainder(h6, 2.0) - 1.0).abs())
    m = v - c
    sector = torch.remainder(torch.floor(h6), 6).long()
    z = torch.zeros_like(c)
    table = torch.stack([torch.stack(t, -1) for t in
                         ((c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x))], 0)
    rgb = table.gather(0, sector[None, ..., None].expand(1, *sector.shape, 3))[0]
    return rgb + m[..., None]


def _axis_weights(n: int, out: int, lo: float, hi: float, device):
    """Bilinear taps along one axis for the window [lo, hi] (fractions of
    the axis): output pixel o samples source coordinate (o + 0.5) * (hi -
    lo) * n / out + lo * n - 0.5. Returns the two source indices and their
    weights, renormalised over the taps inside the image; an output whose
    sample lies outside [-0.5, n - 0.5] gets no weight (the fill shows)."""
    o = torch.arange(out, dtype=torch.float32, device=device)
    s = (o + 0.5) * ((hi - lo) * n / out) + (lo * n - 0.5)
    i0 = torch.floor(s)
    f = s - i0
    idx = torch.stack([i0, i0 + 1], -1)
    w = torch.stack([1.0 - f, f], -1)
    inside = (idx >= 0) & (idx <= n - 1)
    w = torch.where(inside, w, torch.zeros_like(w))
    total = w.sum(-1, keepdim=True)
    w = torch.where(total > 1000.0 * float(np.finfo(np.float32).eps), w / total,
                    torch.zeros_like(w))
    w = torch.where(((s >= -0.5) & (s <= n - 0.5))[:, None], w, torch.zeros_like(w))
    return idx.clamp(0, n - 1).long(), w


def _resample(img, window, out: int, fill):
    """(H, W, 3) -> (out, out, 3) from the window (x0, y0, x1, y1)."""
    h, w, _ = img.shape
    x = img - fill
    iy, wy = _axis_weights(h, out, float(window[1]), float(window[3]), img.device)
    x = x[iy[:, 0]] * wy[:, 0, None, None] + x[iy[:, 1]] * wy[:, 1, None, None]
    ix, wx = _axis_weights(w, out, float(window[0]), float(window[2]), img.device)
    x = x[:, ix[:, 0]] * wx[None, :, 0, None] + x[:, ix[:, 1]] * wx[None, :, 1, None]
    return x + fill


def _window(u, mode, boxes, valid, dc):
    """The sampling window (x0, y0, x1, y1) of one image, in fractions of
    the source: beyond [0, 1] a zoom-out, inside it a crop."""
    dev = boxes.device
    win = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    if dc["expand"] and float(u[11]) < 0.5:
        r = _scaled(u[8], 1.0, 4.0)
        off = u[9:11] * (r - 1.0)
        win = torch.stack([-off[0], -off[1], r - off[0], r - off[1]])
    if not dc["random_crop"] or int(mode) == 0:
        return win
    wh = _scaled(u[13:13 + 2 * TRIALS].reshape(TRIALS, 2), 0.3, 1.0)
    xy = u[13 + 2 * TRIALS:].reshape(TRIALS, 2) * (1.0 - wh)
    crops = torch.cat([xy, xy + wh], -1)
    size = win[2:] - win[:2]
    gt = (boxes[valid] - win[:2].repeat(2)) / size.repeat(2)
    if gt.shape[0] == 0:
        return win
    from benchmark.reference.ops import iou

    best = iou(crops, gt).max(-1).values
    centre = (gt[:, :2] + gt[:, 2:]) / 2
    inside = ((centre[None] > crops[:, None, :2]) & (centre[None] < crops[:, None, 2:])).all(-1)
    ratio = wh[:, 0] / wh[:, 1]
    ok = (ratio > 0.5) & (ratio < 2.0) & (best >= CROP_MIN_IOUS[int(mode)]) & inside.any(-1)
    hits = torch.nonzero(ok).flatten()
    if hits.numel() == 0:
        return win
    c = crops[int(hits[0])]
    return torch.cat([win[:2] + c[:2] * size, win[:2] + c[2:] * size])


def augment(u, mode, images_u8, boxes, labels, valid, dc: dict, out: int):
    """One batch: (B, S, S, 3) uint8 and its padded GTs -> normalized
    (B, out, out, 3) float32 images, boxes and the new valid mask."""
    mean = torch.tensor(dc["mean"], device=images_u8.device)
    std = torch.tensor(dc["std"], device=images_u8.device)
    imgs, out_boxes, out_valid = [], [], []
    for i in range(images_u8.shape[0]):
        ui = u[i]
        img = images_u8[i].float() / 255.0
        if dc["photometric"]:
            on = ui[0:4] < 0.5
            if on[0]:
                img = img + _scaled(ui[4], -32.0 / 255, 32.0 / 255)
            if on[1]:
                img = img * _scaled(ui[5], 0.5, 1.5)
            h, s, v = _rgb_to_hsv(img.clamp(0.0, 1.0))
            if on[2]:
                s = (s * _scaled(ui[6], 0.5, 1.5)).clamp(0.0, 1.0)
            if on[3]:
                h = torch.remainder(h + _scaled(ui[7], -18.0 / 360, 18.0 / 360), 1.0)
            img = _hsv_to_rgb(h, s, v).clamp(0.0, 1.0)
        win = _window(ui, mode[i], boxes[i], valid[i], dc)
        img = _resample(img, win, out, mean)
        size = (win[2:] - win[:2]).repeat(2)
        b = (boxes[i] - win[:2].repeat(2)) / size
        centre = (b[:, :2] + b[:, 2:]) / 2
        ok = valid[i] & (centre > 0).all(-1) & (centre < 1).all(-1)
        b = b.clamp(0.0, 1.0)
        ok &= ((b[:, 2:] - b[:, :2]) > 1e-3).all(-1)
        b = torch.where(ok[:, None], b, torch.zeros_like(b))
        if dc["hflip"] and float(ui[12]) < 0.5:
            img = img.flip(1)
            b = torch.stack([1.0 - b[:, 2], b[:, 1], 1.0 - b[:, 0], b[:, 3]], -1)
            b = torch.where(ok[:, None], b, torch.zeros_like(b))
        imgs.append((img - mean) / std)
        out_boxes.append(b)
        out_valid.append(ok)
    return torch.stack(imgs), torch.stack(out_boxes), labels, torch.stack(out_valid)
