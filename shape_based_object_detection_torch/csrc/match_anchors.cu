// Anchor <-> GT match reductions for Hopper (sm_90a): a block takes a tile
// of anchors for every image of the batch, with each image's valid GT rows
// compacted into shared memory.
//
// Replaces the TPU kernel shape_based_object_detection_tpu/ops/
// matching_pallas.py:72 (_match_kernel, launched at :215 by
// match_reductions_pallas). Same function, same bits: for each (b, a) and
// each GT g the quality
//   q = inter / max(area_a + area_g - inter, 1e-8)                  (IoU)
//   q = (1 - w) * q + w * exp(-(|dlog w| + |dlog h|) / tau)        if w > 0
//   q = -1 for a padding GT row,
// then best_q = max_g q, best_g = the first g at that max, the matched GT's
// label and its offsets against the anchor (variances vc, vs), and per GT
// gt_a = the first anchor at max_a q (0 for a padding row). The anchor's
// area comes from the corners of cxcywh_to_xyxy(anchor) and its log w/h
// from its own cxcywh extents; a GT's log w/h from x1 - x0 and y1 - y0
// (matching_pallas.py:151, :188-196), as the plain version computes them.
//
// Bound on this card (chip_smoke.py's count): bytes. At the training path's
// shapes (B, A, G) = (16, 49104, 64) the function reads the anchors and the
// GT rows and writes 28 bytes per (image, anchor) and 4 per GT, ~22.8 MB,
// 6.8 us at 3.35 TB/s; its arithmetic, 16 operations per (anchor, valid GT),
// is below that at 67 TFLOP/s. What the design does about it:
//   - the (B, A, G) quality matrix never reaches device memory, and each
//     (b, a) output is written once, coalesced;
//   - only valid GT rows are looped over: at load each image's valid rows
//     are compacted into shared memory in their original order, beside
//     their labels. That is exact for 0 <= w <= 1, where every valid
//     quality is >= 0 > -1; for another w every row is kept and padding
//     rows give q = -1;
//   - the anchor's corners, area and logs are computed once per block for
//     all B images;
//   - at w = 0 a row that misses the extent of a warp's 32 anchors costs the
//     warp no arithmetic: its IoU with each of them is +0 exactly;
//   - the per-GT argmax runs across blocks, which run in no order, as an
//     atomicMax on a 64-bit key (quality mapped to an ordered uint32, -0
//     folded into +0, in the high word, 0xFFFFFFFF - anchor in the low
//     word): the largest key is the highest quality at the lowest anchor
//     whatever the order of the atomics. Per row a warp reduces its lanes
//     with one redux and one ballot, lane 0 stores the warp's key in its own
//     shared-memory slot (no shared atomics), and the block makes one global
//     atomic per GT row from the max of its warps' slots;
//   - the caller zeroes the keys and a finish counter (one fill); the last
//     block to finish (found through the counter) unpacks gt_a, so the
//     matching itself is one launch.
// What holds it above the bound is the row loop: every (warp, row) pair
// runs a dependent chain of shared-memory load, IoU, an IEEE division where
// the boxes overlap, and the warp reduction, and the division per
// overlapping (anchor, GT) pair is the arithmetic floor of this kernel.
// Where the intersection is +-0 the IoU is that zero (the denominator is
// >= 1e-8), so the division is skipped there.
//
// Bit-equality with the plain PyTorch version (ops/matching.py) needs the
// same float operations in the same order and no FMA contraction: build
// with -fmad=false, never with --use_fast_math. exp and log are CUDA's
// expf/logf, as PyTorch's CUDA kernels use them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// A block takes a tile of kTile anchors, one per thread, for every image:
// its warps split into kGroups groups, and group j takes images j,
// j + kGroups, ... The groups give each SM enough warps to hide the latency
// of a row's dependent chain (IoU, division, warp reduction). 2 x 8 warps
// was the fastest of the shapes tried on the training path's batch.
constexpr int kAnchorWarps = 2;
constexpr int kGroups = 8;
constexpr int kTile = 32 * kAnchorWarps;
constexpr int kThreads = kTile * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-8f;
constexpr uint32_t kPadding = 0x80000000u;  // flags a padding row's index

// One GT row in shared memory (32 bytes), beside its label and one 64-bit
// key per anchor warp (each warp's best anchor for the row).
struct GtRow {
  float4 box;  // x0 y0 x1 y1
  float area, log_w, log_h;
  uint32_t g;  // original index, | kPadding for a padding row
};
constexpr int kRowBytes =
    sizeof(GtRow) + sizeof(int32_t) + kAnchorWarps * sizeof(unsigned long long);

// One anchor's terms, computed once per block for every image.
struct Anchor {
  float4 cxcywh;
  float x0, y0, x1, y1;
  float area, log_w, log_h, pad;
};

// A quality as an order-preserving uint32 (never 0), -0 folded into +0.
__device__ __forceinline__ uint32_t ordered(float q) {
  q = (q == 0.0f) ? 0.0f : q;  // -0 and +0 are one quality
  const uint32_t u = __float_as_uint(q);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long make_key(uint32_t u, int a) {
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<uint32_t>(a));
}

// The warp's key for one row: its largest quality at its lowest anchor (the
// lanes hold ascending anchors; lanes past the last anchor hold u = 0).
__device__ __forceinline__ unsigned long long warp_key(uint32_t u, int first_a) {
  const uint32_t top = __reduce_max_sync(0xffffffffu, u);
  const int lane = __ffs(__ballot_sync(0xffffffffu, u == top)) - 1;
  return top ? make_key(top, first_a + lane) : 0ull;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The quality of (anchor, row) with the plain version's operations.
__device__ __forceinline__ float quality(const Anchor& an, const GtRow& r,
                                         bool use_shape, float shape_weight,
                                         float one_minus_w, float tau) {
  const float iw = fmaxf(__fsub_rn(fminf(an.x1, r.box.z), fmaxf(an.x0, r.box.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(an.y1, r.box.w), fmaxf(an.y0, r.box.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(an.area, r.area), inter);
  float q = (inter == 0.0f) ? inter : __fdiv_rn(inter, fmaxf(uni, kEps));
  if (use_shape) {
    const float d = __fadd_rn(fabsf(__fsub_rn(an.log_w, r.log_w)),
                              fabsf(__fsub_rn(an.log_h, r.log_h)));
    q = __fadd_rn(__fmul_rn(one_minus_w, q),
                  __fmul_rn(shape_weight, expf(__fdiv_rn(-d, tau))));
  }
  return (r.g & kPadding) ? -1.0f : q;
}

__global__ void __launch_bounds__(kThreads)
match_anchors_kernel(const float4* __restrict__ anchors,  // (A) cxcywh
                     const float4* __restrict__ gt_boxes,  // (B, G) xyxy
                     const int32_t* __restrict__ gt_labels,  // (B, G)
                     const uint8_t* __restrict__ gt_valid,  // (B, G) bool
                     int b_n, int a_n, int g_n, int chunk, float shape_weight,
                     float one_minus_w, float tau, float vc, float vs,
                     unsigned long long* __restrict__ keys,  // (B, G), zero
                     unsigned int* __restrict__ done,  // 1, zero
                     float* __restrict__ best_q_out,  // (B, A)
                     int32_t* __restrict__ best_g_out,  // (B, A)
                     int32_t* __restrict__ gt_a_out,  // (B, G)
                     int32_t* __restrict__ label_out,  // (B, A)
                     float4* __restrict__ reg_out) {  // (B, A)
  extern __shared__ float4 smem_f4[];
  GtRow* s_row = reinterpret_cast<GtRow*>(smem_f4);  // (chunk, G)
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(
      s_row + static_cast<size_t>(chunk) * g_n);  // (chunk, G, kAnchorWarps)
  int32_t* s_label = reinterpret_cast<int32_t*>(
      s_key + static_cast<size_t>(chunk) * g_n * kAnchorWarps);  // (chunk, G)
  int* s_count = s_label + static_cast<size_t>(chunk) * g_n;
  __shared__ Anchor s_anchor[kTile];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = tid % kTile;  // the thread's anchor in a tile
  const int anchor_warp = slot / 32;
  const int group = tid / kTile;  // its images: group, group + kGroups, ...
  const bool use_shape = shape_weight > 0.0f;
  const bool compact = shape_weight >= 0.0f && shape_weight <= 1.0f;
  const bool cull = shape_weight == 0.0f;  // also means no padding rows
  const int a = blockIdx.x * kTile + slot;
  const bool in_range = a < a_n;

  if (tid < kTile) {
    Anchor an;
    an.cxcywh = in_range ? anchors[a] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // cxcywh_to_xyxy: cx - w / 2 (exact as * 0.5)
    const float hw = __fmul_rn(an.cxcywh.z, 0.5f);
    const float hh = __fmul_rn(an.cxcywh.w, 0.5f);
    an.x0 = __fsub_rn(an.cxcywh.x, hw);
    an.y0 = __fsub_rn(an.cxcywh.y, hh);
    an.x1 = __fadd_rn(an.cxcywh.x, hw);
    an.y1 = __fadd_rn(an.cxcywh.y, hh);
    an.area = __fmul_rn(fmaxf(__fsub_rn(an.x1, an.x0), 0.0f),
                        fmaxf(__fsub_rn(an.y1, an.y0), 0.0f));
    an.log_w = use_shape ? logf(fmaxf(an.cxcywh.z, kEps)) : 0.0f;
    an.log_h = use_shape ? logf(fmaxf(an.cxcywh.w, kEps)) : 0.0f;
    an.pad = 0.0f;
    s_anchor[slot] = an;
  }
  __syncthreads();
  const Anchor an = s_anchor[slot];
  // The extent of the warp's anchors. At shape_weight 0 a row that misses it
  // has IoU +0 with each of them (every min - max is <= 0, so every
  // intersection side is fmaxf(<= 0, 0) = +0), and the row costs the warp
  // no arithmetic.
  const float inf = __int_as_float(0x7f800000);
  const float ext_x0 = warp_min(in_range ? an.x0 : inf);
  const float ext_y0 = warp_min(in_range ? an.y0 : inf);
  const float ext_x1 = warp_max(in_range ? an.x1 : -inf);
  const float ext_y1 = warp_max(in_range ? an.y1 : -inf);
  const int first_a = a - lane;  // the warp's first anchor
  const unsigned long long zero_key =
      first_a < a_n ? make_key(ordered(0.0f), first_a) : 0ull;

  for (int b0 = 0; b0 < b_n; b0 += chunk) {
    const int n_img = min(chunk, b_n - b0);
    // Load: one warp per image compacts its kept rows in their order.
    for (int ib = warp; ib < n_img; ib += kWarps) {
      const size_t src = static_cast<size_t>(b0 + ib) * g_n;
      GtRow* rows = s_row + static_cast<size_t>(ib) * g_n;
      int32_t* labels = s_label + static_cast<size_t>(ib) * g_n;
      int count = 0;
      for (int g0 = 0; g0 < g_n; g0 += 32) {
        const int g = g0 + lane;
        const bool is_valid = g < g_n && gt_valid[src + g];
        const bool take = g < g_n && (is_valid || !compact);
        const unsigned ballot = __ballot_sync(0xffffffffu, take);
        if (take) {
          const int at = count + __popc(ballot & ((1u << lane) - 1u));
          const float4 bx = gt_boxes[src + g];
          const float w = __fsub_rn(bx.z, bx.x);
          const float h = __fsub_rn(bx.w, bx.y);
          GtRow r;
          r.box = bx;
          r.area = __fmul_rn(fmaxf(w, 0.0f), fmaxf(h, 0.0f));
          r.log_w = use_shape ? logf(fmaxf(w, kEps)) : 0.0f;
          r.log_h = use_shape ? logf(fmaxf(h, kEps)) : 0.0f;
          r.g = static_cast<uint32_t>(g) | (is_valid ? 0u : kPadding);
          rows[at] = r;
          labels[at] = gt_labels[src + g];
        }
        count += __popc(ballot);
      }
      if (lane == 0) s_count[ib] = count;
    }
    __syncthreads();

    for (int ib = group; ib < n_img; ib += kGroups) {
      const int b = b0 + ib;
      const GtRow* rows = s_row + static_cast<size_t>(ib) * g_n;
      // the warp's key slot for each of this image's rows
      unsigned long long* sk = s_key + static_cast<size_t>(ib) * g_n * kAnchorWarps;
      const int count = s_count[ib];
      float best = -__int_as_float(0x7f800000);  // -inf: the first row wins
      int best_s = 0;  // its slot among the kept rows
      for (int s = 0; s < count; ++s) {
        const GtRow r = rows[s];
        float q;
        unsigned long long key;
        if (cull && (r.box.z <= ext_x0 || r.box.x >= ext_x1 ||
                     r.box.w <= ext_y0 || r.box.y >= ext_y1)) {
          q = 0.0f;  // the same for the whole warp
          key = zero_key;
        } else {
          q = quality(an, r, use_shape, shape_weight, one_minus_w, tau);
          key = warp_key(in_range ? ordered(q) : 0u, first_a);
        }
        if (q > best) {  // strict: the first row at the max wins
          best = q;
          best_s = s;
        }
        if (lane == 0) sk[s * kAnchorWarps + anchor_warp] = key;
      }
      if (!in_range) continue;
      int best_g, label;
      float4 m;
      if (count > 0) {
        best_g = static_cast<int>(rows[best_s].g & ~kPadding);
        label = s_label[static_cast<size_t>(ib) * g_n + best_s];
        m = rows[best_s].box;
      } else {  // no valid GT: best GT 0 at quality -1
        const size_t gt0 = static_cast<size_t>(b) * g_n;
        best = -1.0f;
        best_g = 0;
        label = gt_labels[gt0];
        m = gt_boxes[gt0];
      }
      const size_t o = static_cast<size_t>(b) * a_n + a;
      best_q_out[o] = best;
      best_g_out[o] = best_g;
      label_out[o] = label;
      // encode_boxes(xyxy_to_cxcywh(matched GT), anchor, (vc, vs)):
      // (x0 + x1) / 2 (exact as * 0.5), x1 - x0
      const float cx = __fmul_rn(__fadd_rn(m.x, m.z), 0.5f);
      const float cy = __fmul_rn(__fadd_rn(m.y, m.w), 0.5f);
      const float w = __fsub_rn(m.z, m.x);
      const float h = __fsub_rn(m.w, m.y);
      const float4 c = an.cxcywh;
      const float aw = fmaxf(c.z, kEps), ah = fmaxf(c.w, kEps);
      float4 t;
      t.x = __fdiv_rn(__fsub_rn(cx, c.x), __fmul_rn(aw, vc));
      t.y = __fdiv_rn(__fsub_rn(cy, c.y), __fmul_rn(ah, vc));
      t.z = __fdiv_rn(logf(__fdiv_rn(fmaxf(w, kEps), aw)), vs);
      t.w = __fdiv_rn(logf(__fdiv_rn(fmaxf(h, kEps), ah)), vs);
      reg_out[o] = t;
    }
    __syncthreads();
    // One global atomic per kept row of the chunk.
    for (int i = tid; i < n_img * g_n; i += kThreads) {
      const int ib = i / g_n, s = i - ib * g_n;
      if (s >= s_count[ib]) continue;
      const uint32_t g = s_row[i].g & ~kPadding;
      unsigned long long* dst = &keys[static_cast<size_t>(b0 + ib) * g_n + g];
      unsigned long long key = 0ull;
#pragma unroll
      for (int w = 0; w < kAnchorWarps; ++w) {
        const unsigned long long k = s_key[static_cast<size_t>(i) * kAnchorWarps + w];
        key = k > key ? k : key;
      }
      if (key > __ldcg(dst)) atomicMax(dst, key);  // a stale read costs an atomic
    }
    __syncthreads();  // the next chunk overwrites the rows
  }

  // The last block to finish unpacks gt_a.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < b_n * g_n; i += kThreads) {
    const unsigned long long key = __ldcg(&keys[i]);
    gt_a_out[i] = gt_valid[i] ? static_cast<int32_t>(
        0xFFFFFFFFu - static_cast<uint32_t>(key & 0xFFFFFFFFull)) : 0;
  }
}

int g_max_smem = 0;  // the device's opt-in shared memory per block

}  // namespace

// Once per process and device: lets the kernel use the device's opt-in
// shared memory. Returns the most GT rows per image it takes (one image's
// rows must fit), or 0 on an error.
extern "C" int match_anchors_init() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, match_anchors_kernel) != cudaSuccess) return 0;
  const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
  if (cudaFuncSetAttribute(match_anchors_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dynamic) != cudaSuccess)
    return 0;
  g_max_smem = dynamic;
  return (dynamic - static_cast<int>(sizeof(int))) / kRowBytes;
}

// keys (B, G) uint64 and done (1) uint32 must be zero before the call.
extern "C" int match_anchors_launch(
    const void* anchors, const void* gt_boxes, const void* gt_labels,
    const void* gt_valid, int b, int a_n, int g_n, float shape_weight,
    float one_minus_w, float tau, float vc, float vs, void* keys, void* done,
    void* best_q, void* best_g, void* gt_a, void* label, void* reg,
    void* stream) {
  const int per_image = g_n * kRowBytes + static_cast<int>(sizeof(int));  // + count
  if (b < 1 || a_n < 1 || g_n < 1 || g_max_smem < per_image) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = std::min(b, g_max_smem / per_image);  // images per pass
  const size_t smem = static_cast<size_t>(chunk) * per_image;
  const int grid = (a_n + kTile - 1) / kTile;  // a block per tile
  match_anchors_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(anchors), static_cast<const float4*>(gt_boxes),
      static_cast<const int32_t*>(gt_labels),
      static_cast<const uint8_t*>(gt_valid), b, a_n, g_n, chunk, shape_weight,
      one_minus_w, tau, vc, vs, static_cast<unsigned long long*>(keys),
      static_cast<unsigned int*>(done), static_cast<float*>(best_q),
      static_cast<int32_t*>(best_g), static_cast<int32_t*>(gt_a),
      static_cast<int32_t*>(label), static_cast<float4*>(reg));
  return static_cast<int>(cudaGetLastError());
}
