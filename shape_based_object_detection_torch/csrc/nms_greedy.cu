// Batched greedy NMS for Hopper (sm_90a) as sort -> IoU bitmask -> sweep.
//
// Replaces the TPU kernel shape_based_object_detection_tpu/ops/nms_pallas.py:33
// (_nms_kernel, launched at :106 by greedy_nms_pallas). Same function, same
// bits as the plain version (ops/nms.py): each of M steps takes the live
// candidate of highest score (lowest index on ties), suppresses every
// candidate whose IoU with it (denominator max(union, 1e-8)) is >= t, and
// writes slot i; slots after the last pick hold idx 0, score 0, valid 0.
// That equals: order the live candidates (valid, score > -5e9) by (score
// descending, index ascending), then walk them in that order and keep each
// one that no kept candidate suppresses, until M are kept.
//
//   1. nms_sort_kernel, one block per image: a bitonic sort in shared memory
//      of 64-bit keys (the score mapped to an order-preserving uint32 with -0
//      folded into +0 in the high word, 0xFFFFFFFF - index in the low word),
//      skipped when one pass finds them in order already. Writes the sorted
//      original indices, the boxes in that order and the live count.
//   2. nms_mask_kernel, one block per (image, 64-row tile, 64-column word):
//      bit k of mask[b][i][w] is IoU(sorted i, sorted 64 w + k) >= t, for
//      the columns from i on (the diagonal included). Every SM has work.
//   3. nms_sweep_kernel, one warp per image: walks the sorted candidates a
//      64-bit word at a time. A word's removed bits are the OR of the kept
//      rows' mask words for it (gathered only for the words the walk
//      reaches); the kept bits inside the word are resolved serially from
//      the word's 64 diagonal rows in shared memory.
//
// The one trap: the reference never removes a pick explicitly. A pick
// leaves the live set only because it suppresses itself, IoU(p, p) >= t. A
// box of area below ~t * 1e-8 (a zero-area box, or any box when t > 1)
// fails that test, stays the argmax and fills every remaining slot with its
// own index. The sweep reads IoU(p, p) >= t from the diagonal bit, computed
// by the mask kernel with the same operations as every other IoU.
//
// Bound on this card (chip_smoke.py's count): the reference's work is 15
// float operations per candidate per step it runs; at (B, N, M) = (16, 1000,
// 100) that is ~24 M operations, 0.36 us at 67 TFLOP/s (fp32, non-tensor),
// above its device-memory traffic (~0.35 MB, 0.1 us at 3.35 TB/s). The old
// design (one block per image, M block-wide argmax steps) was a serial chain
// of M barriers on B of 132 SMs. This design computes up to N^2 / 2 IoUs per
// image, more arithmetic than the bound counts, but all in parallel; what
// stays serial is the sweep over the candidates it reaches (a few shared-
// memory reads and bit operations each) and three launches.
//
// Bits: the IoU uses the plain version's operations in its order
// (nms_pallas.py:60-64): __fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn and
// fmaxf(union, 1e-8f). fminf, fmaxf and __fadd_rn commute bit for bit, so
// IoU(i, j) and IoU(j, i) have the same bits. Where the intersection is
// +-0 the quotient is that zero (the denominator is >= 1e-8), so the
// division is skipped there. Build with -fmad=false, never with
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The sort holds one 64-bit key per candidate, padded to a power of two, in
// 32 KB of static shared memory; the sweep keeps up to N kept positions.
// ops/nms_cuda.py states the same limit (MAX_CANDIDATES).
constexpr int kMaxN = 4096;
constexpr int kSortThreads = 1024;
constexpr int kWord = 64;
constexpr float kFoundAbove = -5e9f;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ uint32_t ordered_score(float s) {
  s = (s == 0.0f) ? 0.0f : s;  // -0 and +0 are one score
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// IoU(c, p) >= t with the plain version's operations (c the candidate, p
// the pick).
__device__ __forceinline__ bool suppresses(float4 c, float c_area, float4 p,
                                           float p_area, float t) {
  const float iw = fmaxf(__fsub_rn(fminf(c.z, p.z), fmaxf(c.x, p.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(c.w, p.w), fmaxf(c.y, p.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(c_area, p_area), inter);
  const float iou = (inter == 0.0f) ? inter : __fdiv_rn(inter, fmaxf(uni, kEps));
  return iou >= t;
}

__global__ void __launch_bounds__(kSortThreads)
nms_sort_kernel(const float4* __restrict__ boxes,  // (B, N) xyxy
                const float* __restrict__ scores,  // (B, N)
                const uint8_t* __restrict__ valid,  // (B, N) bool
                int n,
                int32_t* __restrict__ order,  // (B, N) original index by rank
                float4* __restrict__ sorted_boxes,  // (B, N)
                int32_t* __restrict__ n_live) {  // (B)
  __shared__ unsigned long long keys[kMaxN];
  __shared__ int s_live;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  boxes += static_cast<size_t>(b) * n;
  scores += static_cast<size_t>(b) * n;
  valid += static_cast<size_t>(b) * n;
  order += static_cast<size_t>(b) * n;
  sorted_boxes += static_cast<size_t>(b) * n;

  int p = 1;
  while (p < n) p <<= 1;
  if (tid == 0) s_live = 0;
  __syncthreads();
  int live = 0;
  for (int j = tid; j < p; j += kSortThreads) {
    unsigned long long key = 0ull;  // dead and padding keys sort last
    if (j < n) {
      const float s = scores[j];
      if (valid[j] && s > kFoundAbove) {
        key = (static_cast<unsigned long long>(ordered_score(s)) << 32) |
              (0xFFFFFFFFu - static_cast<uint32_t>(j));
        ++live;
      }
    }
    keys[j] = key;
  }
  if (live) atomicAdd(&s_live, live);
  __syncthreads();

  // Candidates that arrive in order (select_candidates sorts them) need no
  // sort; the check costs one pass.
  bool in_order = true;
  for (int j = tid; j + 1 < p; j += kSortThreads) {
    in_order = in_order && keys[j] >= keys[j + 1];
  }
  const bool sorted = __syncthreads_and(in_order);

  // Bitonic sort, descending. Live keys are distinct (the index is in them).
  for (int size = 2; !sorted && size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = tid; t < p / 2; t += kSortThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long ki = keys[i], kj = keys[j];
        if ((ki < kj) == ((i & size) == 0)) {
          keys[i] = kj;
          keys[j] = ki;
        }
      }
    }
  }
  __syncthreads();
  const int count = s_live;
  for (int i = tid; i < count; i += kSortThreads) {
    const int j = static_cast<int>(
        0xFFFFFFFFu - static_cast<uint32_t>(keys[i] & 0xFFFFFFFFull));
    order[i] = j;
    sorted_boxes[i] = boxes[j];
  }
  if (tid == 0) n_live[b] = count;
}

__global__ void __launch_bounds__(kWord)
nms_mask_kernel(const float4* __restrict__ sorted_boxes,  // (B, N)
                const int32_t* __restrict__ n_live,  // (B)
                int n, int nw, float iou_threshold,
                unsigned long long* __restrict__ mask) {  // (B, N, nw)
  const int cw = blockIdx.x;  // column word
  const int rt = blockIdx.y;  // row tile
  const int b = blockIdx.z;
  const int live = n_live[b];
  const int row0 = rt * kWord, col0 = cw * kWord;
  // Only columns from the row on are read: the tiles on and above the
  // diagonal, inside the live prefix.
  if (cw < rt || row0 >= live || col0 >= live) return;
  __shared__ float4 cbox[kWord];
  __shared__ float carea[kWord];
  const int tid = threadIdx.x;
  sorted_boxes += static_cast<size_t>(b) * n;
  if (col0 + tid < live) {
    const float4 c = sorted_boxes[col0 + tid];
    cbox[tid] = c;
    carea[tid] = box_area(c);
  }
  __syncthreads();
  const int i = row0 + tid;
  if (i >= live) return;
  const float4 pb = sorted_boxes[i];
  const float pa = box_area(pb);
  const int cols = min(kWord, live - col0);
  unsigned long long bits = 0ull;
#pragma unroll 4
  for (int k = (cw == rt) ? tid : 0; k < cols; ++k) {
    if (suppresses(cbox[k], carea[k], pb, pa, iou_threshold)) bits |= 1ull << k;
  }
  mask[(static_cast<size_t>(b) * n + i) * nw + cw] = bits;
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__global__ void __launch_bounds__(32)
nms_sweep_kernel(const unsigned long long* __restrict__ mask,  // (B, N, nw)
                 const int32_t* __restrict__ order,  // (B, N)
                 const int32_t* __restrict__ n_live,  // (B)
                 const float* __restrict__ scores,  // (B, N)
                 int n, int nw, int m,
                 int32_t* __restrict__ idx_out,  // (B, M)
                 float* __restrict__ score_out,  // (B, M)
                 uint8_t* __restrict__ valid_out) {  // (B, M) bool
  __shared__ int kept[kMaxN];  // sorted positions of the picks
  __shared__ unsigned long long diag[kWord];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int live = n_live[b];
  mask += static_cast<size_t>(b) * n * nw;
  order += static_cast<size_t>(b) * n;
  scores += static_cast<size_t>(b) * n;
  idx_out += static_cast<size_t>(b) * m;
  score_out += static_cast<size_t>(b) * m;
  valid_out += static_cast<size_t>(b) * m;

  int nk = 0;     // picks so far
  int fill = -1;  // a pick that does not suppress itself fills the rest
  for (int w = 0; w * kWord < live && nk < m && fill < 0; ++w) {
    const int r0 = w * kWord;
    // this word's bits removed by the picks of earlier words
    unsigned long long removed = 0ull;
    for (int s = lane; s < nk; s += 32) {
      removed |= mask[static_cast<size_t>(kept[s]) * nw + w];
    }
    removed = warp_or(removed);
    for (int r = lane; r < kWord; r += 32) {
      diag[r] = (r0 + r < live) ? mask[static_cast<size_t>(r0 + r) * nw + w] : 0ull;
    }
    __syncwarp();
    const int cnt = min(kWord, live - r0);
    const unsigned long long in_range = (cnt == kWord) ? ~0ull : ((1ull << cnt) - 1ull);
    unsigned long long cand = in_range & ~removed;
    // Every lane walks the same bits. A pick's diagonal row holds its own
    // bit when it suppresses itself, so `removed` covers every decided bit
    // and the lowest candidate bit is always the next one in order.
    while (cand != 0ull && nk < m) {
      const int k = __ffsll(static_cast<long long>(cand)) - 1;
      const unsigned long long row = diag[k];
      if (!((row >> k) & 1ull)) {
        fill = r0 + k;
        break;
      }
      if (lane == 0) kept[nk] = r0 + k;
      ++nk;
      removed |= row;
      cand = in_range & ~removed;
    }
    __syncwarp();
  }

  for (int s = lane; s < m; s += 32) {
    const int pos = (s < nk) ? kept[s] : fill;
    if (pos >= 0) {
      const int j = order[pos];
      idx_out[s] = j;
      score_out[s] = scores[j];  // the input's bits
      valid_out[s] = 1;
    } else {
      idx_out[s] = 0;
      score_out[s] = 0.0f;
      valid_out[s] = 0;
    }
  }
}

}  // namespace

// Scratch (from the caller): order (B, N) int32, sorted_boxes (B, N) float4
// (16-byte aligned), n_live (B) int32, mask (B, N, ceil(N / 64)) uint64.
extern "C" int nms_greedy_launch(const void* boxes, const void* scores,
                                 const void* valid, int b, int n, int m,
                                 float iou_threshold, void* order,
                                 void* sorted_boxes, void* n_live, void* mask,
                                 void* idx_out, void* score_out,
                                 void* valid_out, void* stream) {
  if (n < 1 || n > kMaxN || m < 1 || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nw = (n + kWord - 1) / kWord;
  nms_sort_kernel<<<b, kSortThreads, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), n, static_cast<int32_t*>(order),
      static_cast<float4*>(sorted_boxes), static_cast<int32_t*>(n_live));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_mask_kernel<<<dim3(nw, nw, b), kWord, 0, st>>>(
      static_cast<const float4*>(sorted_boxes),
      static_cast<const int32_t*>(n_live), n, nw, iou_threshold,
      static_cast<unsigned long long*>(mask));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<b, 32, 0, st>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(n_live),
      static_cast<const float*>(scores), n, nw, m,
      static_cast<int32_t*>(idx_out), static_cast<float*>(score_out),
      static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
