// Batched greedy NMS for Hopper (sm_90a): sort, then a bitmask sweep (N <=
// 4096 candidates per image) or a walk against the kept picks (N > 4096).
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
// The bitmask route, N <= kMaxN (three launches):
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
// The walk route, N > kMaxN (two launches, scratch linear in N): the bitmask
// would be N * ceil(N / 64) * 8 bytes per image (50 MB at N = 20000), and
// the sort's keys outgrow static shared memory.
//   1. nms_sort_large_kernel: the same sort, its keys in dynamic shared
//      memory up to kSharedKeys (128 KB) and in global scratch above.
//   2. nms_walk_kernel, one block of 256 threads per image: walks the sorted
//      candidates a word at a time. A word's candidates are tested against
//      the picks kept so far (at most min(M, N), in global scratch, each
//      read by many threads at once through L1): 4 slices of the kept list,
//      one thread per candidate and slice. Its own 64 x 64
//      diagonal tile is computed in shared memory for the rows still in
//      play, and the picks inside it are resolved serially as the sweep
//      does. That is at most about N * M + 33 N IoUs per image (the
//      reference's own N * M, and the diagonal tiles), and no bitmask.
//
// The one trap: the reference never removes a pick explicitly. A pick
// leaves the live set only because it suppresses itself, IoU(p, p) >= t. A
// box of area below ~t * 1e-8 (a zero-area box, or any box when t > 1)
// fails that test, stays the argmax and fills every remaining slot with its
// own index. Both routes read IoU(p, p) >= t from the diagonal bit, computed
// with the same operations as every other IoU.
//
// Bound on this card (chip_smoke.py's count): the reference's work is 15
// float operations per candidate per step it runs; at (B, N, M) = (16, 1000,
// 100) that is ~24 M operations, 0.36 us at 67 TFLOP/s (fp32, non-tensor),
// above its device-memory traffic (~0.35 MB, 0.1 us at 3.35 TB/s). The old
// design (one block per image, M block-wide argmax steps) was a serial chain
// of M barriers on B of 132 SMs. The bitmask route computes up to N^2 / 2
// IoUs per image, more arithmetic than the bound counts, but all in
// parallel; what stays serial is the sweep over the candidates it reaches (a
// few shared-memory reads and bit operations each) and three launches. The
// walk route uses B blocks only, and its sort is B blocks of barriers over
// log2(N) (log2(N) + 1) / 2 passes: a simple right route, not a fast one.
//
// Bits: the IoU uses the plain version's operations in its order
// (nms_pallas.py:60-64): __fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn and
// fmaxf(union, 1e-8f). fminf, fmaxf and __fadd_rn commute bit for bit, so
// IoU(i, j) and IoU(j, i) have the same bits. Where the intersection is
// +-0 the quotient is that zero (the denominator is >= 1e-8), so the
// division is skipped there. Build with -fmad=false, never with
// --use_fast_math.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

// The bitmask route's sort holds one 64-bit key per candidate, padded to a
// power of two, in 32 KB of static shared memory; its sweep keeps up to N
// kept positions. nms_greedy_route tells ops/nms_cuda.py the route.
constexpr int kMaxN = 4096;
constexpr int kSortThreads = 1024;
constexpr int kWord = 64;
constexpr float kFoundAbove = -5e9f;
constexpr float kEps = 1e-8f;
// The walk route: 4 slices of the kept list, one thread per candidate of a
// word in each; the sort's keys in dynamic shared memory up to kSharedKeys
// (128 KB), in global scratch above; the kept picks in global scratch, 24
// bytes each; candidates are indexed with int.
constexpr int kWalkThreads = 256;
constexpr int kSlices = kWalkThreads / kWord;
constexpr int kSharedKeys = 16384;
constexpr int kPickBytes = 16 + 4 + 4;  // box, area, sorted position
constexpr int kLargestN = 1 << 30;

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

// The sort of one image (blockIdx.x) by a block of kSortThreads: keys[0, p)
// (p: N padded to a power of two) in shared memory or global scratch.
__device__ __forceinline__ void sort_candidates(
    const float4* __restrict__ boxes, const float* __restrict__ scores,
    const uint8_t* __restrict__ valid, int n, unsigned long long* keys,
    int* s_live, int32_t* __restrict__ order, float4* __restrict__ sorted_boxes,
    int32_t* __restrict__ n_live) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  boxes += static_cast<size_t>(b) * n;
  scores += static_cast<size_t>(b) * n;
  valid += static_cast<size_t>(b) * n;
  order += static_cast<size_t>(b) * n;
  sorted_boxes += static_cast<size_t>(b) * n;

  int p = 1;
  while (p < n) p <<= 1;
  if (tid == 0) *s_live = 0;
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
  if (live) atomicAdd(s_live, live);
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
  const int count = *s_live;
  for (int i = tid; i < count; i += kSortThreads) {
    const int j = static_cast<int>(
        0xFFFFFFFFu - static_cast<uint32_t>(keys[i] & 0xFFFFFFFFull));
    order[i] = j;
    sorted_boxes[i] = boxes[j];
  }
  if (tid == 0) n_live[b] = count;
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
  sort_candidates(boxes, scores, valid, n, keys, &s_live, order, sorted_boxes,
                  n_live);
}

// The walk route's sort: keys in dynamic shared memory (global_keys null) or
// in global scratch, p per image.
__global__ void __launch_bounds__(kSortThreads)
nms_sort_large_kernel(const float4* __restrict__ boxes,
                      const float* __restrict__ scores,
                      const uint8_t* __restrict__ valid, int n,
                      unsigned long long* global_keys, int p,
                      int32_t* __restrict__ order,
                      float4* __restrict__ sorted_boxes,
                      int32_t* __restrict__ n_live) {
  extern __shared__ unsigned long long shared_keys[];
  __shared__ int s_live;
  unsigned long long* keys =
      global_keys ? global_keys + static_cast<size_t>(blockIdx.x) * p : shared_keys;
  sort_candidates(boxes, scores, valid, n, keys, &s_live, order, sorted_boxes,
                  n_live);
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

__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const float4* __restrict__ sorted_boxes,  // (B, N)
                const int32_t* __restrict__ order,  // (B, N)
                const int32_t* __restrict__ n_live,  // (B)
                const float* __restrict__ scores,  // (B, N)
                int n, int m, int cap, float iou_threshold,
                unsigned char* picks,  // (B, cap * kPickBytes)
                int32_t* __restrict__ idx_out,  // (B, M)
                float* __restrict__ score_out,  // (B, M)
                uint8_t* __restrict__ valid_out) {  // (B, M) bool
  __shared__ float4 wbox[kWord];  // the word's boxes and areas
  __shared__ float warea[kWord];
  __shared__ unsigned diag[2 * kWord];  // row r: columns 0-31, then 32-63
  __shared__ unsigned removed_part[kWalkThreads / 32];
  __shared__ int s_nk, s_fill;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int col = tid & (kWord - 1);  // the candidate this thread tests
  const int slice = tid / kWord;  // picks slice, slice + kSlices, ...
  // the kept picks: boxes, areas and sorted positions, cap of each
  float4* pick_box =
      reinterpret_cast<float4*>(picks + static_cast<size_t>(b) * cap * kPickBytes);
  float* pick_area = reinterpret_cast<float*>(pick_box + cap);
  int* pick_pos = reinterpret_cast<int*>(pick_area + cap);
  const int live = n_live[b];
  sorted_boxes += static_cast<size_t>(b) * n;
  order += static_cast<size_t>(b) * n;
  scores += static_cast<size_t>(b) * n;
  idx_out += static_cast<size_t>(b) * m;
  score_out += static_cast<size_t>(b) * m;
  valid_out += static_cast<size_t>(b) * m;

  int nk = 0;     // picks so far, the same in every thread
  int fill = -1;  // a pick that does not suppress itself fills the rest
  for (int r0 = 0; r0 < live && nk < m && fill < 0; r0 += kWord) {
    const int cnt = min(kWord, live - r0);
    if (tid < cnt) {
      const float4 c = sorted_boxes[r0 + tid];
      wbox[tid] = c;
      warea[tid] = box_area(c);
    }
    __syncthreads();
    // this word's candidates removed by the picks of earlier words
    bool hit = false;
    if (col < cnt) {
      const float4 c = wbox[col];
      const float ca = warea[col];
      for (int s = slice; s < nk && !hit; s += kSlices) {
        hit = suppresses(c, ca, pick_box[s], pick_area[s], iou_threshold);
      }
    }
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) removed_part[tid / 32] = hits;
    __syncthreads();
    unsigned long long removed = 0ull;
    for (int w = 0; w < kWalkThreads / 32; ++w) {
      removed |= static_cast<unsigned long long>(removed_part[w]) << (32 * (w & 1));
    }
    const unsigned long long in_range = (cnt == kWord) ? ~0ull : ((1ull << cnt) - 1ull);
    unsigned long long cand = in_range & ~removed;
    // The diagonal tile's rows still in play, columns from the row on: a
    // warp takes 32 columns of one row, so the branch is the same in all
    // its lanes.
    for (int e = tid; e < kWord * kWord; e += kWalkThreads) {
      const int r = e / kWord, k = e % kWord;
      if ((cand >> r) & 1ull) {
        const bool bit = k >= r && k < cnt &&
                         suppresses(wbox[k], warea[k], wbox[r], warea[r], iou_threshold);
        const unsigned bits = __ballot_sync(0xffffffffu, bit);
        if (lane == 0) diag[2 * r + k / 32] = bits;
      }
    }
    __syncthreads();
    if (tid == 0) {
      // As the sweep: the lowest candidate bit is always the next in order.
      while (cand != 0ull && nk < m) {
        const int k = __ffsll(static_cast<long long>(cand)) - 1;
        const unsigned long long row =
            diag[2 * k] | (static_cast<unsigned long long>(diag[2 * k + 1]) << 32);
        if (!((row >> k) & 1ull)) {
          fill = r0 + k;
          break;
        }
        pick_box[nk] = wbox[k];
        pick_area[nk] = warea[k];
        pick_pos[nk] = r0 + k;
        ++nk;
        removed |= row;
        cand = in_range & ~removed;
      }
      s_nk = nk;
      s_fill = fill;
    }
    __syncthreads();
    nk = s_nk;
    fill = s_fill;
  }

  for (int s = tid; s < m; s += kWalkThreads) {
    const int pos = (s < nk) ? pick_pos[s] : fill;
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

// Where each part of the scratch lies (byte offsets into one buffer, each
// 256-byte aligned), and the walk route's sort's dynamic shared memory.
struct Layout {
  bool walk;  // the walk route (N > kMaxN)
  int p;  // N padded to a power of two: the sort's keys per image
  int cap;  // the walk's kept picks per image: min(M, N), rounded up to 4
  size_t sorted_boxes, order, n_live;  // both routes
  size_t mask;  // the bitmask route: (B, N, ceil(N / 64)) uint64
  size_t picks;  // the walk route
  size_t keys;  // the walk route, when its keys are not in shared memory
  size_t shared_keys;  // the walk route's sort's dynamic shared memory
  size_t total;
};

Layout layout_for(int b, int n, int m) {
  Layout l = {};
  const size_t nb = static_cast<size_t>(b), nn = static_cast<size_t>(n);
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    const size_t off = at;
    at += (bytes + 255) & ~static_cast<size_t>(255);
    return off;
  };
  l.walk = n > kMaxN;
  l.p = 1;
  while (l.p < n) l.p <<= 1;
  l.cap = ((m < n ? m : n) + 3) & ~3;
  l.sorted_boxes = take(nb * nn * 16);
  l.order = take(nb * nn * 4);
  l.n_live = take(nb * 4);
  if (!l.walk) {
    l.mask = take(nb * nn * ((nn + kWord - 1) / kWord) * 8);
  } else {
    const size_t key_bytes = static_cast<size_t>(l.p) * 8;
    l.picks = take(nb * static_cast<size_t>(l.cap) * kPickBytes);
    if (l.p <= kSharedKeys) l.shared_keys = key_bytes;
    else l.keys = take(nb * key_bytes);
  }
  l.total = at;
  return l;
}

bool valid_shape(int b, int n, int m) {
  return b >= 1 && n >= 1 && n <= kLargestN && m >= 1;
}

// Lets the walk route's sort take kSharedKeys keys of dynamic shared memory
// on the current device: set once per device, always to that maximum, so
// that launches of any size from any thread see the same limit.
cudaError_t allow_shared_keys() {
  constexpr int kDevices = 64;
  static std::atomic<bool> done[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(nms_sort_large_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSharedKeys * static_cast<int>(sizeof(unsigned long long)));
  if (err == cudaSuccess && dev < kDevices) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// Bytes of scratch nms_greedy_launch needs for (B, N, M), 0 if it refuses
// the shape.
extern "C" size_t nms_greedy_scratch_bytes(int b, int n, int m) {
  return valid_shape(b, n, m) ? layout_for(b, n, m).total : 0;
}

// The route nms_greedy_launch takes for N candidates per image: 0 the
// bitmask route, 1 the walk route.
extern "C" int nms_greedy_route(int n) { return n > kMaxN ? 1 : 0; }

// scratch: nms_greedy_scratch_bytes(b, n, m) bytes, 256-byte aligned. The
// route is chosen by N: the bitmask route up to kMaxN, the walk route above.
extern "C" int nms_greedy_launch(const void* boxes, const void* scores,
                                 const void* valid, int b, int n, int m,
                                 float iou_threshold, void* scratch,
                                 void* idx_out, void* score_out,
                                 void* valid_out, void* stream) {
  if (!valid_shape(b, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout l = layout_for(b, n, m);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const float4* in_boxes = static_cast<const float4*>(boxes);
  const float* in_scores = static_cast<const float*>(scores);
  const uint8_t* in_valid = static_cast<const uint8_t*>(valid);
  int32_t* order = reinterpret_cast<int32_t*>(base + l.order);
  float4* sorted_boxes = reinterpret_cast<float4*>(base + l.sorted_boxes);
  int32_t* n_live = reinterpret_cast<int32_t*>(base + l.n_live);
  cudaError_t err;
  if (!l.walk) {
    const int nw = (n + kWord - 1) / kWord;
    unsigned long long* mask = reinterpret_cast<unsigned long long*>(base + l.mask);
    nms_sort_kernel<<<b, kSortThreads, 0, st>>>(in_boxes, in_scores, in_valid, n,
                                                order, sorted_boxes, n_live);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    nms_mask_kernel<<<dim3(nw, nw, b), kWord, 0, st>>>(sorted_boxes, n_live, n, nw,
                                                       iou_threshold, mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    nms_sweep_kernel<<<b, 32, 0, st>>>(
        mask, order, n_live, in_scores, n, nw, m, static_cast<int32_t*>(idx_out),
        static_cast<float*>(score_out), static_cast<uint8_t*>(valid_out));
    return static_cast<int>(cudaGetLastError());
  }
  if (l.shared_keys) {
    err = allow_shared_keys();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sort_large_kernel<<<b, kSortThreads, l.shared_keys, st>>>(
      in_boxes, in_scores, in_valid, n,
      l.shared_keys ? nullptr : reinterpret_cast<unsigned long long*>(base + l.keys),
      l.p, order, sorted_boxes, n_live);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<b, kWalkThreads, 0, st>>>(
      sorted_boxes, order, n_live, in_scores, n, m, l.cap, iou_threshold,
      base + l.picks, static_cast<int32_t*>(idx_out),
      static_cast<float*>(score_out), static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}
