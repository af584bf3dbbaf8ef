// Anchor <-> GT match reductions for Hopper (sm_90a): one thread per
// (image, anchor), the image's GT rows in shared memory.
//
// Replaces the TPU kernel shape_based_object_detection_tpu/ops/
// matching_pallas.py:72 (_match_kernel, launched by match_reductions_pallas).
// Same function, same bits: for each (b, a) and each GT g the quality
//   q = inter / max(area_a + area_g - inter, 1e-8)                  (IoU)
//   q = (1 - w) * q + w * exp(-(|dlog w| + |dlog h|) / tau)        if w > 0
//   q = -1 for a padding GT row,
// then best_q = max_g q, best_g = the first g at that max, the matched GT's
// label and its offsets against the anchor (variances vc, vs), and per GT
// gt_a = the first anchor at max_a q. The anchor's area comes from the
// corners of cxcywh_to_xyxy(anchor) and its log w/h from its own cxcywh
// extents; a GT's log w/h from x1 - x0 and y1 - y0 (matching_pallas.py:151,
// :188-196), as the plain version computes them.
//
// What bounds it on this card: operations. At the training path's shapes
// (B, A, G) = (16, 49104, 64) it does ~20 float operations for each of 50 M
// (b, a, g) triples, ~1.0 G operations, ~15 us at 67 TFLOP/s non-tensor
// fp32; its device-memory traffic is ~25 MB (the (B, A) outputs at 28 bytes
// per anchor and image, the anchors, the GT rows), ~7.5 us at 3.35 TB/s.
// The design keeps the (B, A, G) quality matrix out of device memory: each
// block loads its image's G rows once into shared memory, and each thread
// keeps its anchor's running max and first argmax in registers and writes
// the winner's label and offsets directly (the Pallas kernel's one-hot sums
// exist only because the TPU lacks gathers). The per-GT argmax runs across
// blocks, which run in no order, so it is an atomicMax on a 64-bit key
// (quality mapped to an ordered uint32 in the high word, 0xFFFFFFFF - anchor
// in the low word): the largest key is the highest quality at the lowest
// anchor index whatever the order of the atomics. Each block first reduces
// its own anchors into shared memory keys and then makes one global atomic
// per GT; a second small launch unpacks the anchor index.
//
// Bit-equality with the plain PyTorch version (ops/matching.py) needs the
// same float operations in the same order and no FMA contraction: build
// with -fmad=false, never with --use_fast_math. exp and log are CUDA's
// expf/logf, as PyTorch's CUDA kernels use them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;
// floats per GT row in shared memory: x0 y0 x1 y1 area log_w log_h valid
// cx cy w h, then the label as an int
constexpr int kGtFloats = 12;
constexpr int kGtBytes = 8 + kGtFloats * 4 + 4;  // + the u64 key

__device__ __forceinline__ unsigned long long order_key(float q, int a) {
  q = (q == 0.0f) ? 0.0f : q;  // -0 and +0 are one quality
  uint32_t u = __float_as_uint(q);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<uint32_t>(a));
}

__global__ void __launch_bounds__(kThreads)
match_anchors_kernel(const float4* __restrict__ anchors,  // (A) cxcywh
                     const float4* __restrict__ gt_boxes,  // (B, G) xyxy
                     const int32_t* __restrict__ gt_labels,  // (B, G)
                     const uint8_t* __restrict__ gt_valid,  // (B, G) bool
                     int a_n, int g_n, float shape_weight, float one_minus_w,
                     float tau, float vc, float vs,
                     unsigned long long* __restrict__ keys,  // (B, G)
                     float* __restrict__ best_q_out,  // (B, A)
                     int32_t* __restrict__ best_g_out,  // (B, A)
                     int32_t* __restrict__ label_out,  // (B, A)
                     float4* __restrict__ reg_out) {  // (B, A)
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* s_key = smem_u64;
  float* s = reinterpret_cast<float*>(smem_u64 + g_n);
  float* sx0 = s;
  float* sy0 = sx0 + g_n;
  float* sx1 = sy0 + g_n;
  float* sy1 = sx1 + g_n;
  float* sarea = sy1 + g_n;
  float* slw = sarea + g_n;
  float* slh = slw + g_n;
  float* svalid = slh + g_n;
  float* scx = svalid + g_n;
  float* scy = scx + g_n;
  float* sw = scy + g_n;
  float* sh = sw + g_n;
  int32_t* slabel = reinterpret_cast<int32_t*>(sh + g_n);

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  gt_boxes += static_cast<size_t>(b) * g_n;
  gt_labels += static_cast<size_t>(b) * g_n;
  gt_valid += static_cast<size_t>(b) * g_n;

  for (int g = tid; g < g_n; g += kThreads) {
    const float4 bx = gt_boxes[g];
    const float w = __fsub_rn(bx.z, bx.x);
    const float h = __fsub_rn(bx.w, bx.y);
    sx0[g] = bx.x;
    sy0[g] = bx.y;
    sx1[g] = bx.z;
    sy1[g] = bx.w;
    sarea[g] = __fmul_rn(fmaxf(w, 0.0f), fmaxf(h, 0.0f));
    slw[g] = logf(fmaxf(w, kEps));
    slh[g] = logf(fmaxf(h, kEps));
    svalid[g] = gt_valid[g] ? 1.0f : 0.0f;
    // xyxy_to_cxcywh: (x0 + x1) / 2 (exact as * 0.5), x1 - x0
    scx[g] = __fmul_rn(__fadd_rn(bx.x, bx.z), 0.5f);
    scy[g] = __fmul_rn(__fadd_rn(bx.y, bx.w), 0.5f);
    sw[g] = w;
    sh[g] = h;
    slabel[g] = gt_labels[g];
    s_key[g] = 0ull;
  }
  __syncthreads();

  const int a = blockIdx.x * kThreads + tid;
  if (a < a_n) {
    const float4 an = anchors[a];
    // cxcywh_to_xyxy: cx - w / 2 (exact as * 0.5)
    const float hw = __fmul_rn(an.z, 0.5f);
    const float hh = __fmul_rn(an.w, 0.5f);
    const float ax0 = __fsub_rn(an.x, hw), ay0 = __fsub_rn(an.y, hh);
    const float ax1 = __fadd_rn(an.x, hw), ay1 = __fadd_rn(an.y, hh);
    const float a_area = __fmul_rn(fmaxf(__fsub_rn(ax1, ax0), 0.0f),
                                   fmaxf(__fsub_rn(ay1, ay0), 0.0f));
    const bool use_shape = shape_weight > 0.0f;
    const float a_lw = use_shape ? logf(fmaxf(an.z, kEps)) : 0.0f;
    const float a_lh = use_shape ? logf(fmaxf(an.w, kEps)) : 0.0f;

    float best = -__int_as_float(0x7f800000);  // -inf: g = 0 always wins
    int best_g = 0;
    for (int g = 0; g < g_n; ++g) {
      const float iw = fmaxf(__fsub_rn(fminf(ax1, sx1[g]), fmaxf(ax0, sx0[g])), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(ay1, sy1[g]), fmaxf(ay0, sy0[g])), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(a_area, sarea[g]), inter);
      float q = __fdiv_rn(inter, fmaxf(uni, kEps));
      if (use_shape) {
        const float d = __fadd_rn(fabsf(__fsub_rn(a_lw, slw[g])),
                                  fabsf(__fsub_rn(a_lh, slh[g])));
        q = __fadd_rn(__fmul_rn(one_minus_w, q),
                      __fmul_rn(shape_weight, expf(__fdiv_rn(-d, tau))));
      }
      if (svalid[g] == 0.0f) q = -1.0f;
      if (q > best) {  // strict: the first g at the max wins
        best = q;
        best_g = g;
      }
      const unsigned long long key = order_key(q, a);
      // a stale read only costs an extra atomic
      if (key > s_key[g]) atomicMax(&s_key[g], key);
    }

    const size_t o = static_cast<size_t>(b) * a_n + a;
    best_q_out[o] = best;
    best_g_out[o] = best_g;
    label_out[o] = slabel[best_g];
    // encode_boxes(matched cxcywh, anchor cxcywh, (vc, vs))
    const float aw = fmaxf(an.z, kEps), ah = fmaxf(an.w, kEps);
    float4 r;
    r.x = __fdiv_rn(__fsub_rn(scx[best_g], an.x), __fmul_rn(aw, vc));
    r.y = __fdiv_rn(__fsub_rn(scy[best_g], an.y), __fmul_rn(ah, vc));
    r.z = __fdiv_rn(logf(__fdiv_rn(fmaxf(sw[best_g], kEps), aw)), vs);
    r.w = __fdiv_rn(logf(__fdiv_rn(fmaxf(sh[best_g], kEps), ah)), vs);
    reg_out[o] = r;
  }
  __syncthreads();
  for (int g = tid; g < g_n; g += kThreads) {
    atomicMax(&keys[static_cast<size_t>(b) * g_n + g], s_key[g]);
  }
}

__global__ void unpack_gt_anchor(const unsigned long long* __restrict__ keys,
                                 int32_t* __restrict__ gt_a, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    gt_a[i] = static_cast<int32_t>(
        0xFFFFFFFFu - static_cast<uint32_t>(keys[i] & 0xFFFFFFFFull));
  }
}

size_t smem_bytes(int g_n) { return static_cast<size_t>(g_n) * kGtBytes; }

}  // namespace

extern "C" int match_anchors_launch(
    const void* anchors, const void* gt_boxes, const void* gt_labels,
    const void* gt_valid, int b, int a_n, int g_n, float shape_weight,
    float one_minus_w, float tau, float vc, float vs, void* keys,
    void* best_q, void* best_g, void* gt_a, void* label, void* reg,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_keys = static_cast<size_t>(b) * g_n;
  cudaError_t err = cudaMemsetAsync(keys, 0, n_keys * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(g_n);
  err = cudaFuncSetAttribute(match_anchors_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a_n + kThreads - 1) / kThreads, b);
  match_anchors_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float4*>(anchors), static_cast<const float4*>(gt_boxes),
      static_cast<const int32_t*>(gt_labels),
      static_cast<const uint8_t*>(gt_valid), a_n, g_n, shape_weight,
      one_minus_w, tau, vc, vs, static_cast<unsigned long long*>(keys),
      static_cast<float*>(best_q), static_cast<int32_t*>(best_g),
      static_cast<int32_t*>(label), static_cast<float4*>(reg));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = static_cast<int>(n_keys);
  unpack_gt_anchor<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const unsigned long long*>(keys), static_cast<int32_t*>(gt_a), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int match_anchors_max_gt() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin / kGtBytes;
}
