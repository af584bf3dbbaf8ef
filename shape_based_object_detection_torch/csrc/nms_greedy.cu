// Batched greedy NMS for Hopper (sm_90a), one thread block per image.
//
// Replaces the TPU kernel shape_based_object_detection_tpu/ops/nms_pallas.py
// (_nms_kernel, launched by greedy_nms_pallas). Same function, same bits:
// for each of M steps take the row-max live score (lowest index on ties),
// compute one IoU row against the pick with denominator max(union, 1e-8),
// suppress where iou >= t (gated on best > -5e9) and write slot i. Slots
// after the last pick hold idx 0, score 0, valid 0.
//
// What bounds it on this card: a serial chain of M block-wide argmax
// reductions, so it is latency-bound. Its device-memory traffic at B=16,
// N=1000, M=100 is ~0.35 MB (boxes, scores, valid in; idx, score, valid
// out), ~0.1 us at 3.35 TB/s, far below the chain's length. Only B of the
// 132 SMs are busy. The design keeps each image's candidates in shared
// memory (read from device memory once) and fuses the suppression of step
// i with the per-thread argmax of step i+1, so each step costs one
// __syncthreads and one warp-shuffle reduction. Making it fast (several
// blocks per image, a bitmask formulation) is later work.
//
// Bit-equality with the plain PyTorch version (ops/nms.py) needs the same
// float operations in the same order (nms_pallas.py:60-64) and no FMA
// contraction: build with -fmad=false, never with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e10f;
constexpr float kFoundAbove = -5e9f;

// (score, index) pair order of the argmax: higher score first, then the
// lower index, as jnp.argmax and the Pallas kernel's min-index tie-break.
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__global__ void __launch_bounds__(kThreads)
nms_greedy_kernel(const float4* __restrict__ boxes,  // (B, N) xyxy
                  const float* __restrict__ scores,  // (B, N)
                  const uint8_t* __restrict__ valid,  // (B, N) bool
                  int n, int m, float iou_threshold,
                  int32_t* __restrict__ idx_out,  // (B, M)
                  float* __restrict__ score_out,  // (B, M)
                  uint8_t* __restrict__ valid_out) {  // (B, M) bool
  extern __shared__ float smem[];
  float* sx0 = smem;
  float* sy0 = sx0 + n;
  float* sx1 = sy0 + n;
  float* sy1 = sx1 + n;
  float* sarea = sy1 + n;
  float* slive = sarea + n;
  __shared__ float warp_best[2][kWarps];
  __shared__ int warp_idx[2][kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  boxes += static_cast<size_t>(b) * n;
  scores += static_cast<size_t>(b) * n;
  valid += static_cast<size_t>(b) * n;
  idx_out += static_cast<size_t>(b) * m;
  score_out += static_cast<size_t>(b) * m;
  valid_out += static_cast<size_t>(b) * m;

  // Load, and the first step's per-thread argmax.
  float my_best = kNeg;
  int my_idx = n;
  for (int j = tid; j < n; j += kThreads) {
    const float4 bx = boxes[j];
    sx0[j] = bx.x;
    sy0[j] = bx.y;
    sx1[j] = bx.z;
    sy1[j] = bx.w;
    sarea[j] = __fmul_rn(fmaxf(bx.z - bx.x, 0.0f), fmaxf(bx.w - bx.y, 0.0f));
    const float live = valid[j] ? scores[j] : kNeg;
    slive[j] = live;
    if (better(live, j, my_best, my_idx)) {
      my_best = live;
      my_idx = j;
    }
  }

  for (int i = 0; i < m; ++i) {
    // Block argmax: shuffle within the warp, then every thread reduces the
    // per-warp results itself (no second barrier). The buffers alternate
    // between steps so step i+1's writes cannot race step i's reads.
    float best = my_best;
    int bi = my_idx;
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(os, oi, best, bi)) {
        best = os;
        bi = oi;
      }
    }
    const int buf = i & 1;
    if (lane == 0) {
      warp_best[buf][warp] = best;
      warp_idx[buf][warp] = bi;
    }
    __syncthreads();  // also orders step i-1's suppression before the reads
    best = warp_best[buf][0];
    bi = warp_idx[buf][0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(warp_best[buf][w], warp_idx[buf][w], best, bi)) {
        best = warp_best[buf][w];
        bi = warp_idx[buf][w];
      }
    }

    if (!(best > kFoundAbove)) {
      // Nothing live is left: no later step can find anything either,
      // since suppression is gated on a find. Zero the remaining slots.
      for (int s = i + tid; s < m; s += kThreads) {
        idx_out[s] = 0;
        score_out[s] = 0.0f;
        valid_out[s] = 0;
      }
      return;
    }
    if (tid == 0) {
      idx_out[i] = bi;
      score_out[i] = best;
      valid_out[i] = 1;
    }

    const float bx0 = sx0[bi], by0 = sy0[bi];
    const float bx1 = sx1[bi], by1 = sy1[bi];
    const float barea = sarea[bi];
    my_best = kNeg;
    my_idx = n;
    for (int j = tid; j < n; j += kThreads) {
      float live = slive[j];
      const float iw = fmaxf(__fsub_rn(fminf(sx1[j], bx1), fmaxf(sx0[j], bx0)), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(sy1[j], by1), fmaxf(sy0[j], by0)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(sarea[j], barea), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-8f));
      if (iou >= iou_threshold) {
        live = kNeg;
        slive[j] = live;
      }
      if (better(live, j, my_best, my_idx)) {
        my_best = live;
        my_idx = j;
      }
    }
  }
}

}  // namespace

extern "C" int nms_greedy_launch(const void* boxes, const void* scores,
                                 const void* valid, int b, int n, int m,
                                 float iou_threshold, void* idx_out,
                                 void* score_out, void* valid_out,
                                 void* stream) {
  const size_t smem = static_cast<size_t>(6) * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_greedy_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), n, m, iou_threshold,
      static_cast<int32_t*>(idx_out), static_cast<float*>(score_out),
      static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nms_greedy_max_candidates() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  // the static warp buffers take 2 * 2 * kWarps * 4 bytes
  return (optin - 2 * 2 * kWarps * 4) / (6 * static_cast<int>(sizeof(float)));
}
