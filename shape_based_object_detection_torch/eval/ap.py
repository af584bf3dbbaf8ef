"""Average-precision evaluation (the port's copy of the JAX package's
``eval/ap.py``).

pycocotools is not a dependency (SURVEY.md §7), so this is a
first-party vectorized numpy implementation of the COCOeval 'bbox' protocol:

- COCO-style AP: greedy score-ordered matching per class at IoU thresholds
  .50:.05:.95, 101-point interpolated precision, mean over thresholds and
  classes; crowd GT act as ignore regions (a detection matched to a crowd is
  neither TP nor FP, and crowd IoU is intersection / det-area); AP is also
  reported area-stratified (APsmall/APmedium/APlarge) and average recall at
  1/10/100 detections per image (AR1/AR10/AR100) plus area-stratified AR
  (ARsmall/ARmedium/ARlarge at maxDets=100) — the full 12-metric summary.
- VOC-style AP: 11-point interpolated (VOC2007) or continuous (VOC2010+) at
  IoU 0.5.

Inputs are plain numpy per-image records, so the device produces padded
Detections, the host strips padding via the validity mask and accumulates.
The per-class greedy matching loop — the host-side hot spot at COCO scale —
runs in native C++ (the port's csrc/ap_matcher.cpp, built at first use;
``matcher="native"``, the default) or in numpy (``matcher="numpy"``, the
plain version the tests hold the C++ matcher against); both give the same
matches.

Area thresholds follow COCO (32^2 / 96^2 in ORIGINAL-image pixels, like
pycocotools' ann['area']): give each GroundTruthRecord a per-image
``area_factor`` (original px^2 per unit of normalized box area — W*H for a
square resize, max(W, H)^2 for letterbox; Evaluator.add_batch's
``area_factors``). ``area_scale`` remains as a uniform fallback for callers
whose images are natively the network input size (synthetic data, tests).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

COCO_IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
# COCO area strata in pixel^2: (name, lo, hi)
COCO_AREA_RANGES = (
    ("small", 0.0, 32.0 ** 2),
    ("medium", 32.0 ** 2, 96.0 ** 2),
    ("large", 96.0 ** 2, 1e10),
)


@dataclasses.dataclass
class DetectionRecord:
    image_id: int
    boxes: np.ndarray  # (N, 4) xyxy
    scores: np.ndarray  # (N,)
    labels: np.ndarray  # (N,) int


@dataclasses.dataclass
class GroundTruthRecord:
    image_id: int
    boxes: np.ndarray  # (G, 4) xyxy
    labels: np.ndarray  # (G,) int
    crowd: Optional[np.ndarray] = None  # (G,) bool; None = no crowd regions
    # px^2 per unit of _box_areas(boxes) for THIS image. pycocotools strata
    # use annotation areas in ORIGINAL-image pixels, so normalized boxes on a
    # resized canvas need the per-image original area back: W*H for a square
    # resize, max(W, H)^2 for letterbox. 1.0 when boxes are already in
    # original pixels.
    area_factor: float = 1.0
    # (G,) bool: ignore WITHOUT crowd-IoU semantics (VOC "difficult"): the GT
    # matches by normal IoU but counts in neither n_gt nor FP. Crowd implies
    # ignore too, additionally switching its IoU to intersection/det-area.
    ignore: Optional[np.ndarray] = None


def _iou_matrix_np(a: np.ndarray, b: np.ndarray,
                   b_crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise IoU; columns flagged in b_crowd use intersection / area(a)
    (the pycocotools crowd convention — a crowd covers the detection)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    if b_crowd is not None and b_crowd.any():
        union = np.where(b_crowd[None, :], area_a[:, None], union)
    return inter / np.maximum(union, 1e-9)


def _box_areas(boxes: np.ndarray) -> np.ndarray:
    return (np.clip(boxes[:, 2] - boxes[:, 0], 0, None)
            * np.clip(boxes[:, 3] - boxes[:, 1], 0, None))


def _match_class_strata(
    dets: List[Tuple[int, np.ndarray, float]],  # (image_id, box, score)
    gts: Dict[int, np.ndarray],  # image_id -> (G, 4)
    iou_thresholds: np.ndarray,
    area_ranges: Sequence[Optional[Tuple[float, float]]],  # px^2 (None = all)
    crowd: Optional[Dict[int, np.ndarray]] = None,  # image_id -> (G,) bool
    max_det: Optional[int] = None,  # per image (per class)
    area_factors: Optional[Dict[int, float]] = None,  # image_id -> px^2/unit
    ignore: Optional[Dict[int, np.ndarray]] = None,  # ignore w/o crowd-IoU
    matcher: str = "native",  # "native" (C++) or "numpy"
) -> Tuple[List[Tuple[np.ndarray, np.ndarray, int]], np.ndarray, np.ndarray]:
    """COCOeval-protocol greedy matching for one class over ALL area strata.

    One call evaluates every range in ``area_ranges``: detection sorting,
    GT grouping, pairwise IoUs, and the native-matcher marshaling happen
    once and are shared (pycocotools likewise computes IoUs once per
    (image, class) and reuses them across areaRngs); only the greedy scans
    — whose claiming depends on each range's ignore flags — repeat.

    Returns ``(per_range, scores, ranks)`` where per_range[k] is
    ``(tp (T, N), ignore (T, N), n_gt)`` for area_ranges[k], detections
    score-sorted descending, and ranks[i] is detection i's per-image score
    rank (0-based; greedy matching in score order means a smaller-max_det
    result is EXACTLY the columns with rank < md, the truncation
    pycocotools uses in accumulate()).

    Per range: a GT is *ignored* if crowd, plain-ignore, or out of the
    range; ignored GTs don't count in n_gt, and a detection matched to one
    is excluded from both TP and FP. An unmatched detection outside the
    range is likewise ignored. Greedy order and tie-breaking mirror
    pycocotools: per detection (score order), scan GTs non-ignored-first,
    claimed non-crowd GTs skipped, best-IoU wins with ties going to the
    later GT, and the scan stops at the first ignored GT once a non-ignored
    match is held.
    """
    if matcher not in ("native", "numpy"):
        raise ValueError(f"matcher must be 'native' or 'numpy', got {matcher!r}")

    def _factor(img: int) -> float:
        return (area_factors.get(img, 1.0)
                if area_factors is not None else 1.0)

    k_count = len(area_ranges)
    # per-image GT state; per-range ignore flags and scan orders
    gt_state = {}
    n_gts = [0] * k_count
    for img, boxes in gts.items():
        boxes = np.asarray(boxes, np.float32)
        cr = (np.asarray(crowd[img], bool)
              if crowd is not None and img in crowd and crowd[img] is not None
              else np.zeros(len(boxes), bool))
        base_gig = cr.copy()
        if (ignore is not None and img in ignore
                and ignore[img] is not None):
            base_gig |= np.asarray(ignore[img], bool)
        areas = _box_areas(boxes) * _factor(img)
        gigs, orders = [], []
        for k, rng in enumerate(area_ranges):
            gig = base_gig.copy()
            if rng is not None:
                gig |= (areas < rng[0]) | (areas > rng[1])
            n_gts[k] += int((~gig).sum())
            gigs.append(gig)
            # scan order: non-ignored GTs first (stable within groups)
            orders.append(np.argsort(gig, kind="stable"))
        gt_state[img] = (boxes, cr, gigs, orders)

    t_count = len(iou_thresholds)
    thr_arr = np.asarray(iou_thresholds, np.float32)
    if not dets:
        empty = [(np.zeros((t_count, 0), np.float32),
                  np.zeros((t_count, 0), bool), n_gts[k])
                 for k in range(k_count)]
        return empty, np.zeros(0), np.zeros(0, np.int32)

    dets = sorted(dets, key=lambda d: -d[2])
    if max_det is not None:
        seen: Dict[int, int] = {}
        kept = []
        for d in dets:
            c = seen.get(d[0], 0)
            if c < max_det:
                kept.append(d)
                seen[d[0]] = c + 1
        dets = kept
    ranks = np.empty(len(dets), np.int32)
    _rank_seen: Dict[int, int] = {}
    for i, d in enumerate(dets):
        r = _rank_seen.get(d[0], 0)
        ranks[i] = r
        _rank_seen[d[0]] = r + 1
    scores = np.asarray([d[2] for d in dets])
    n = len(dets)

    det_boxes = np.stack([np.asarray(d[1], np.float32) for d in dets])
    det_imgs = np.asarray([d[0] for d in dets], np.int32)
    da = _box_areas(det_boxes)
    if area_factors is not None:
        da = da * np.asarray([_factor(int(i)) for i in det_imgs])
    det_oob = np.zeros((k_count, n), np.uint8)
    for k, rng in enumerate(area_ranges):
        if rng is not None:
            det_oob[k] = (da < rng[0]) | (da > rng[1])

    if gt_state and matcher == "native":
        # csrc/ap_matcher.cpp, the numpy scan below in C++
        from shape_based_object_detection_torch.utils.native import (
            match_class_strata_native,
        )

        gt_img_ids = np.concatenate(
            [np.full(len(s[0]), img, np.int32) for img, s in gt_state.items()])
        gt_flat = np.concatenate([s[0] for s in gt_state.values()]).astype(
            np.float32).reshape(-1, 4)
        gt_crowd_flat = np.concatenate(
            [s[1] for s in gt_state.values()]).astype(np.uint8)
        gt_ignore_flat = np.stack([
            np.concatenate([s[2][k] for s in gt_state.values()])
            for k in range(k_count)
        ]).astype(np.uint8)
        tp_n, ig_n = match_class_strata_native(
            det_boxes, det_imgs, det_oob, gt_flat, gt_img_ids,
            gt_crowd_flat, gt_ignore_flat, thr_arr)  # (K, T, N)
        return ([(tp_n[k].astype(np.float32), ig_n[k].astype(bool),
                  n_gts[k]) for k in range(k_count)], scores, ranks)

    tp = np.zeros((k_count, t_count, n), np.float32)
    ig = np.zeros((k_count, t_count, n), bool)
    claimed = {
        img: np.zeros((k_count, t_count, len(s[0])), bool)
        for img, s in gt_state.items()
    }
    for i, (img, box, _) in enumerate(dets):
        box = np.asarray(box, np.float32)
        state = gt_state.get(img)
        if state is None or len(state[0]) == 0:
            ig[:, :, i] = det_oob[:, i, None]
            continue
        gt_boxes, cr, gigs, orders = state
        ious = _iou_matrix_np(box[None], gt_boxes, cr)[0]  # once per det
        for k in range(k_count):
            gig, order = gigs[k], orders[k]
            for t in range(t_count):
                thr = thr_arr[t]
                best = -1
                best_iou = float(thr)
                for g in order:
                    if claimed[img][k, t, g] and not cr[g]:
                        continue
                    if best > -1 and not gig[best] and gig[g]:
                        break  # holding a real match; only ignored GTs remain
                    if ious[g] < best_iou:
                        continue
                    best_iou = float(ious[g])
                    best = int(g)
                if best >= 0:
                    claimed[img][k, t, best] = True
                    if gig[best]:
                        ig[k, t, i] = True
                    else:
                        tp[k, t, i] = 1.0
                else:
                    ig[k, t, i] = bool(det_oob[k, i])
    return ([(tp[k], ig[k], n_gts[k]) for k in range(k_count)],
            scores, ranks)


def _match_class(
    dets: List[Tuple[int, np.ndarray, float]],  # (image_id, box, score)
    gts: Dict[int, np.ndarray],  # image_id -> (G, 4)
    iou_thresholds: np.ndarray,
    crowd: Optional[Dict[int, np.ndarray]] = None,  # image_id -> (G,) bool
    area_range: Optional[Tuple[float, float]] = None,  # in px^2
    max_det: Optional[int] = None,  # per image (per class)
    area_factors: Optional[Dict[int, float]] = None,  # image_id -> px^2/unit
    ignore: Optional[Dict[int, np.ndarray]] = None,  # ignore w/o crowd-IoU
    return_ranks: bool = False,
    matcher: str = "native",
) -> Tuple[np.ndarray, ...]:
    """Single-range wrapper over :func:`_match_class_strata` (semantics and
    return layout unchanged: (tp, ig, scores, n_gt[, ranks]))."""
    per_range, scores, ranks = _match_class_strata(
        dets, gts, iou_thresholds, [area_range], crowd=crowd,
        max_det=max_det, area_factors=area_factors, ignore=ignore,
        matcher=matcher)
    tp, ig, n_gt = per_range[0]
    return (tp, ig, scores, n_gt, ranks) if return_ranks else (
        tp, ig, scores, n_gt)


def _ap_from_tp(tp: np.ndarray, n_gt: int, interpolation: str,
                ig: Optional[np.ndarray] = None) -> np.ndarray:
    """tp: (T, N) score-sorted hits -> (T,) AP values. ``ig`` marks
    detections excluded from both TP and FP (crowd / out-of-area matches)."""
    t_count, n = tp.shape
    if n_gt == 0:
        return np.full((t_count,), np.nan)
    if n == 0:
        return np.zeros((t_count,))
    aps = np.zeros((t_count,))
    for t in range(t_count):
        tp_t = tp[t] if ig is None else tp[t][~ig[t]]
        if len(tp_t) == 0:
            aps[t] = 0.0
            continue
        cum_tp = np.cumsum(tp_t)
        cum_fp = np.cumsum(1.0 - tp_t)
        recall = cum_tp / n_gt
        p = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
        r = recall
        # monotone precision envelope
        p_env = np.maximum.accumulate(p[::-1])[::-1]
        if interpolation == "101point":  # COCO
            grid = np.linspace(0, 1, 101)
            idx = np.searchsorted(r, grid, side="left")
            aps[t] = np.where(
                idx < len(p_env), p_env[np.minimum(idx, len(p_env) - 1)], 0.0
            ).mean()
        elif interpolation == "11point":  # VOC2007
            grid = np.linspace(0, 1, 11)
            ap = 0.0
            for g in grid:
                mask = r >= g
                ap += p_env[mask].max() if mask.any() else 0.0
            aps[t] = ap / 11.0
        else:  # continuous (VOC2010+ / area under PR)
            r_ext = np.concatenate([[0.0], r, [r[-1]]])
            p_ext = np.concatenate([[0.0], p_env, [0.0]])
            aps[t] = np.sum((r_ext[1:-1] - r_ext[:-2]) * p_ext[1:-1])
    return aps


def _recall_from_tp(tp: np.ndarray, n_gt: int,
                    ig: Optional[np.ndarray] = None) -> np.ndarray:
    """(T,) recall at the end of the (non-ignored) detection list."""
    t_count = tp.shape[0]
    if n_gt == 0:
        return np.full((t_count,), np.nan)
    out = np.zeros((t_count,))
    for t in range(t_count):
        tp_t = tp[t] if ig is None else tp[t][~ig[t]]
        out[t] = tp_t.sum() / n_gt
    return out


def _group_by_class(
    detections: Sequence[DetectionRecord],
    ground_truth: Sequence[GroundTruthRecord],
):
    classes = set()
    for g in ground_truth:
        classes.update(np.unique(g.labels).tolist())
    dets_by_class: Dict[int, List] = {c: [] for c in classes}
    gts_by_class: Dict[int, Dict[int, np.ndarray]] = {c: {} for c in classes}
    crowd_by_class: Dict[int, Dict[int, np.ndarray]] = {c: {} for c in classes}
    ig_by_class: Dict[int, Dict[int, np.ndarray]] = {c: {} for c in classes}
    for d in detections:
        for box, score, label in zip(d.boxes, d.scores, d.labels):
            if int(label) in dets_by_class:
                dets_by_class[int(label)].append(
                    (d.image_id, np.asarray(box), float(score)))
    for g in ground_truth:
        cr = (np.asarray(g.crowd, bool) if g.crowd is not None
              else np.zeros(len(g.labels), bool))
        gi = (np.asarray(g.ignore, bool) if g.ignore is not None
              else np.zeros(len(g.labels), bool))
        for c in classes:
            m = g.labels == c
            if m.any():
                # several records may share an image_id (e.g. one record per
                # COCO annotation): merge, never overwrite
                prev = gts_by_class[c].get(g.image_id)
                if prev is None:
                    gts_by_class[c][g.image_id] = np.asarray(g.boxes)[m]
                    crowd_by_class[c][g.image_id] = cr[m]
                    ig_by_class[c][g.image_id] = gi[m]
                else:
                    gts_by_class[c][g.image_id] = np.concatenate(
                        [prev, np.asarray(g.boxes)[m]])
                    crowd_by_class[c][g.image_id] = np.concatenate(
                        [crowd_by_class[c][g.image_id], cr[m]])
                    ig_by_class[c][g.image_id] = np.concatenate(
                        [ig_by_class[c][g.image_id], gi[m]])
    return (sorted(classes), dets_by_class, gts_by_class, crowd_by_class,
            ig_by_class)


def coco_map(
    detections: Sequence[DetectionRecord],
    ground_truth: Sequence[GroundTruthRecord],
    area_scale: float = 1.0,
    max_dets: Tuple[int, ...] = (1, 10, 100),
    matcher: str = "native",
) -> Dict[str, float]:
    """Full COCOeval-bbox metric suite.

    Returns the full 12-metric COCOeval summary: {'mAP', 'AP50', 'AP75',
    'APsmall', 'APmedium', 'APlarge', 'AR1', 'AR10', 'AR100', 'ARsmall',
    'ARmedium', 'ARlarge', 'per_class'} (area-stratified AR at
    maxDets=max(max_dets), as pycocotools' summarize does).

    Area strata follow pycocotools: 32^2/96^2 thresholds against annotation
    areas in ORIGINAL-image pixels. The per-image conversion comes from each
    GroundTruthRecord's ``area_factor`` (times ``area_scale``^2, a uniform
    fallback for callers whose boxes are normalized to a square canvas of
    known size and whose images were natively that size)."""
    (classes, dets_by_class, gts_by_class, crowd_by_class,
     ig_by_class) = _group_by_class(detections, ground_truth)
    s2 = float(area_scale) ** 2
    area_factors = {g.image_id: float(g.area_factor) * s2
                    for g in ground_truth}
    strata = list(COCO_AREA_RANGES)  # px^2
    md_max = max(max_dets)

    per_class: Dict[int, np.ndarray] = {}
    all_aps, strat_aps = [], {name: [] for name, _, _ in strata}
    recalls = {md: [] for md in max_dets}
    strat_ars = {name: [] for name, _, _ in strata}
    # one matching pass per class covers ALL area ranges (IoUs, sorting, and
    # marshaling shared; see _match_class_strata) — the 'all' range first
    ranges = [(0.0, 1e10)] + [(lo, hi) for _, lo, hi in strata]
    for c in classes:
        dets, gts, crs = dets_by_class[c], gts_by_class[c], crowd_by_class[c]
        per_range, scores, ranks = _match_class_strata(
            dets, gts, COCO_IOU_THRESHOLDS, ranges, crowd=crs,
            max_det=md_max, area_factors=area_factors, ignore=ig_by_class[c],
            matcher=matcher)
        tp, ig, n_gt = per_range[0]
        aps = _ap_from_tp(tp, n_gt, "101point", ig)
        per_class[c] = aps
        all_aps.append(aps)
        recalls[md_max].append(_recall_from_tp(tp, n_gt, ig))
        for md in max_dets:
            if md == md_max:
                continue
            # smaller max_det = per-image truncation of the md_max match
            # (greedy score order; see _match_class_strata docstring)
            keep = ranks < md
            recalls[md].append(
                _recall_from_tp(tp[:, keep], n_gt, ig[:, keep]))
        for (name, _, _), (tp_a, ig_a, n_gt_a) in zip(strata, per_range[1:]):
            strat_aps[name].append(_ap_from_tp(tp_a, n_gt_a, "101point", ig_a))
            # ARsmall/medium/large at maxDets=md_max (pycocotools summarize
            # rows 10-12 use maxDets=100)
            strat_ars[name].append(_recall_from_tp(tp_a, n_gt_a, ig_a))

    if not all_aps:
        out = {"mAP": 0.0, "AP50": 0.0, "AP75": 0.0, "per_class": {}}
        for name, _, _ in strata:
            out[f"AP{name}"] = 0.0
            out[f"AR{name}"] = 0.0
        for md in max_dets:
            out[f"AR{md}"] = 0.0
        return out

    def _nanmean(arr, axis=None):
        # NaN marks "no GT in this class/stratum" (pycocotools -1); an
        # all-NaN slice stays NaN, minus numpy's empty-slice warning
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return np.nanmean(np.asarray(arr, float), axis=axis)

    stacked = np.stack(all_aps)  # (C, T)
    mean_per_t = _nanmean(stacked, axis=0)
    out = {
        "mAP": float(_nanmean(stacked)),
        "AP50": float(mean_per_t[0]),
        "AP75": float(mean_per_t[5]),
    }
    for name, _, _ in strata:
        out[f"AP{name}"] = float(_nanmean(np.stack(strat_aps[name])))
        out[f"AR{name}"] = float(_nanmean(np.stack(strat_ars[name])))
    for md in max_dets:
        out[f"AR{md}"] = float(_nanmean(np.stack(recalls[md])))
    out["per_class"] = {c: float(_nanmean(a)) for c, a in per_class.items()}
    return out


def voc_map(
    detections: Sequence[DetectionRecord],
    ground_truth: Sequence[GroundTruthRecord],
    iou_threshold: float = 0.5,
    use_11point: bool = True,
    matcher: str = "native",
) -> Dict[str, float]:
    (classes, dets_by_class, gts_by_class, crowd_by_class,
     ig_by_class) = _group_by_class(detections, ground_truth)
    per_class = {}
    for c in classes:
        tp, ig, scores, n_gt = _match_class(
            dets_by_class[c], gts_by_class[c], np.asarray([iou_threshold]),
            crowd=crowd_by_class[c], ignore=ig_by_class[c], matcher=matcher,
        )
        ap = _ap_from_tp(tp, n_gt, "11point" if use_11point else "continuous",
                         ig)[0]
        # NaN = AP undefined (no countable GT, e.g. all-crowd): exclude the
        # class from per_class and the mean, matching coco_map's nanmean
        # (pycocotools -1) instead of deflating mAP with a fake 0.0
        if np.isfinite(ap):
            per_class[c] = float(ap)
    vals = [v for v in per_class.values()]
    return {
        "mAP": float(np.mean(vals)) if vals else 0.0,
        "per_class": per_class,
    }


class Evaluator:
    """Accumulates device Detections batches (padded + masked) into records.

    ``area_scale`` (e.g. the network input size, for normalized boxes) feeds
    the COCO area strata; leave 1.0 when boxes are already in pixels.
    ``matcher`` picks the C++ ("native") or numpy greedy matching."""

    def __init__(self, area_scale: float = 1.0, matcher: str = "native"):
        self.detections: List[DetectionRecord] = []
        self.ground_truth: List[GroundTruthRecord] = []
        self.area_scale = area_scale
        self.matcher = matcher
        self._next_id = 0

    def add_batch(self, det, gt_boxes, gt_labels, gt_valid,
                  gt_crowd=None, area_factors=None, gt_ignore=None) -> None:
        """det: ops.nms.Detections (tensors on any device, or numpy);
        gt_*: (B, G, ...).
        ``gt_crowd`` (B, G) bool marks crowd GT regions (ignored AND matched
        with the crowd intersection/det-area IoU). ``gt_ignore`` (B, G) bool
        marks plain ignore regions matched by normal IoU (VOC "difficult").
        ``area_factors`` (B,): original-image px^2 per normalized box-area
        unit (W*H for square resize, max(W, H)^2 for letterbox) — feeds the
        COCOeval area strata in true annotation pixels. When omitted, the
        uniform ``area_scale``^2 fallback applies."""
        boxes = _host(det.boxes)
        scores = _host(det.scores)
        labels = _host(det.labels)
        valid = _host(det.valid)
        gt_boxes = _host(gt_boxes)
        gt_labels = _host(gt_labels)
        gt_valid = _host(gt_valid)
        gt_crowd = None if gt_crowd is None else _host(gt_crowd)
        gt_ignore = None if gt_ignore is None else _host(gt_ignore)
        for b in range(boxes.shape[0]):
            img_id = self._next_id
            self._next_id += 1
            v = valid[b]
            self.detections.append(
                DetectionRecord(img_id, boxes[b][v], scores[b][v], labels[b][v])
            )
            gv = gt_valid[b]
            self.ground_truth.append(
                GroundTruthRecord(
                    img_id, gt_boxes[b][gv], gt_labels[b][gv],
                    None if gt_crowd is None else gt_crowd[b][gv],
                    area_factor=(float(area_factors[b])
                                 if area_factors is not None else 1.0),
                    ignore=(None if gt_ignore is None else gt_ignore[b][gv]))
            )

    def coco(self) -> Dict[str, float]:
        return coco_map(self.detections, self.ground_truth,
                        area_scale=self.area_scale, matcher=self.matcher)

    def voc(self, iou_threshold: float = 0.5) -> Dict[str, float]:
        return voc_map(self.detections, self.ground_truth, iou_threshold,
                       matcher=self.matcher)


def _host(x) -> np.ndarray:
    """A numpy array of ``x``: a tensor (read back from the card if it is
    there) or anything ``np.asarray`` takes."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
