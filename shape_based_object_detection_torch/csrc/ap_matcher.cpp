// Native greedy detection<->GT matcher for AP evaluation (component C19).
//
// The pycocotools role in the reference stack (its only C extension used by
// this pipeline) is fast COCO evaluation; this is the TPU-framework
// equivalent: the per-class COCOeval-protocol greedy matching loop —
// O(n_det * gt_per_image * n_thresholds), the host-side eval hot spot at
// COCO scale (5k images x 80 classes x 10 IoU thresholds) — in C++, exposed
// through a plain C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC -o libap_matcher.so ap_matcher.cpp
//
// Semantics are identical to eval/ap.py::_match_class (greedy, score order,
// per-threshold independent claiming, crowd IoU = intersection/det-area,
// non-ignored GTs scanned first, best-IoU wins with ties to the later GT,
// ignored detections excluded from TP and FP) and are cross-checked in
// tests/test_native_ap.py.
//
// The strata entry point evaluates ALL area ranges of one class in a single
// call: pairwise IoUs, GT grouping, and the Python->C marshaling happen once
// instead of once per range (pycocotools likewise computes computeIoU once
// per (image, class) and reuses it across areaRngs). Only the greedy scans —
// whose claiming genuinely depends on each range's ignore flags — repeat.

#include <cstdint>
#include <vector>
#include <algorithm>
#include <unordered_map>

namespace {

// IoU of det a against gt b; crowd gts use intersection / area(a)
// (pycocotools convention: a crowd region covers the detection).
inline float iou(const float* a, const float* b, bool b_crowd) {
  const float x0 = std::max(a[0], b[0]);
  const float y0 = std::max(a[1], b[1]);
  const float x1 = std::min(a[2], b[2]);
  const float y1 = std::min(a[3], b[3]);
  const float iw = std::max(0.0f, x1 - x0);
  const float ih = std::max(0.0f, y1 - y0);
  const float inter = iw * ih;
  const float area_a =
      std::max(0.0f, a[2] - a[0]) * std::max(0.0f, a[3] - a[1]);
  const float area_b =
      std::max(0.0f, b[2] - b[0]) * std::max(0.0f, b[3] - b[1]);
  const float uni = b_crowd ? area_a : area_a + area_b - inter;
  return uni > 1e-9f ? inter / uni : 0.0f;
}

struct ImgGT {
  std::vector<int32_t> base;                // global GT indices of this image
  std::vector<std::vector<int32_t>> order;  // per stratum: positions into
                                            // `base`, non-ignored first
};

}  // namespace

extern "C" {

// COCOeval-protocol matcher over n_strata area ranges at once. det_* are
// pre-sorted by descending score (and pre-truncated to maxDet per image by
// the caller). det_oob is (n_strata, n_det): detection outside stratum s's
// area range (ignored if unmatched there). gt_crowd (n_gt,) marks crowd GTs
// (never exhausted by a match); gt_ignore is (n_strata, n_gt): GT excluded
// from scoring in stratum s (crowd / plain-ignore / out-of-area — matching
// one ignores the detection). Outputs tp_out / ig_out are
// (n_strata, n_thr, n_det) row-major uint8.
void sbd_match_class_strata(
    const float* det_boxes, const int32_t* det_img_ids,
    const uint8_t* det_oob, int32_t n_det,
    const float* gt_boxes, const int32_t* gt_img_ids,
    const uint8_t* gt_crowd, const uint8_t* gt_ignore,
    int32_t n_gt, int32_t n_strata,
    const float* thresholds, int32_t n_thr,
    uint8_t* tp_out, uint8_t* ig_out) {
  // group GT indices by image once; per stratum, the scan order is the
  // stable non-ignored-first permutation under THAT stratum's ignore flags
  std::unordered_map<int32_t, ImgGT> gt_by_img;
  gt_by_img.reserve(64);
  for (int32_t g = 0; g < n_gt; ++g)
    gt_by_img[gt_img_ids[g]].base.push_back(g);
  for (auto& [img, rec] : gt_by_img) {
    rec.order.resize(n_strata);
    for (int32_t s = 0; s < n_strata; ++s) {
      auto& ord = rec.order[s];
      ord.resize(rec.base.size());
      for (size_t k = 0; k < rec.base.size(); ++k)
        ord[k] = static_cast<int32_t>(k);
      const uint8_t* ig_s = gt_ignore + static_cast<size_t>(s) * n_gt;
      std::stable_sort(ord.begin(), ord.end(), [&](int32_t a, int32_t b) {
        return ig_s[rec.base[a]] < ig_s[rec.base[b]];
      });
    }
  }

  std::vector<uint8_t> claimed(
      static_cast<size_t>(n_strata) * n_thr * n_gt, 0);
  std::vector<float> ious;  // per-det IoU against its image's base GT list

  for (int32_t d = 0; d < n_det; ++d) {
    auto it = gt_by_img.find(det_img_ids[d]);
    if (it == gt_by_img.end()) {
      for (int32_t s = 0; s < n_strata; ++s) {
        if (!det_oob[static_cast<size_t>(s) * n_det + d]) continue;
        for (int32_t t = 0; t < n_thr; ++t)
          ig_out[(static_cast<size_t>(s) * n_thr + t) * n_det + d] = 1;
      }
      continue;
    }
    const auto& base = it->second.base;
    ious.resize(base.size());
    for (size_t k = 0; k < base.size(); ++k)  // IoUs once, reused per stratum
      ious[k] = iou(det_boxes + 4 * d, gt_boxes + 4 * base[k],
                    gt_crowd[base[k]] != 0);
    for (int32_t s = 0; s < n_strata; ++s) {
      const auto& ord = it->second.order[s];
      const uint8_t* ig_s = gt_ignore + static_cast<size_t>(s) * n_gt;
      const bool oob = det_oob[static_cast<size_t>(s) * n_det + d] != 0;
      for (int32_t t = 0; t < n_thr; ++t) {
        uint8_t* cl =
            claimed.data() + (static_cast<size_t>(s) * n_thr + t) * n_gt;
        float best_iou = thresholds[t];
        int32_t best = -1;  // position in `ord`
        for (size_t k = 0; k < ord.size(); ++k) {
          const int32_t g = base[ord[k]];
          if (cl[g] && !gt_crowd[g]) continue;
          if (best > -1 && !ig_s[base[ord[best]]] && ig_s[g])
            break;  // holding a real match; only ignored GTs remain
          if (ious[ord[k]] < best_iou) continue;
          best_iou = ious[ord[k]];
          best = static_cast<int32_t>(k);
        }
        uint8_t* row =
            (best >= 0 && !ig_s[base[ord[best]]]) ? tp_out : ig_out;
        if (best >= 0) {
          cl[base[ord[best]]] = 1;
          row[(static_cast<size_t>(s) * n_thr + t) * n_det + d] = 1;
        } else if (oob) {
          ig_out[(static_cast<size_t>(s) * n_thr + t) * n_det + d] = 1;
        }
      }
    }
  }
}

// Single-range matcher (original ABI): the strata matcher with n_strata = 1.
void sbd_match_class_full(const float* det_boxes, const int32_t* det_img_ids,
                          const uint8_t* det_oob, int32_t n_det,
                          const float* gt_boxes, const int32_t* gt_img_ids,
                          const uint8_t* gt_crowd, const uint8_t* gt_ignore,
                          int32_t n_gt, const float* thresholds,
                          int32_t n_thr, uint8_t* tp_out, uint8_t* ig_out) {
  sbd_match_class_strata(det_boxes, det_img_ids, det_oob, n_det, gt_boxes,
                         gt_img_ids, gt_crowd, gt_ignore, n_gt, 1, thresholds,
                         n_thr, tp_out, ig_out);
}

}  // extern "C"
