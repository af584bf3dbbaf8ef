// Frozen BatchNorm with what follows it in a ResNet, in one pass over the
// activations (sm_90a): K3.
//
// Replaces no TPU kernel: the JAX package's frozen nn.BatchNorm, its ReLU
// and the bottleneck's residual add are plain jnp arithmetic, which XLA
// fuses into the convolution's consumers on the TPU. In PyTorch the same
// arithmetic is a chain of elementwise kernels, each of which reads and
// writes the whole activation: this kernel is that chain as one.
//
// Function (ops/frozen_bn.py holds the plain composition it reproduces):
//   bn(x) = ((x - mean) * (rsqrt(var + eps) * weight)) + bias
// in float32 in flax's order, each operation rounded on its own (no FMA),
// the factor rsqrt(var + eps) * weight computed here from the four float32
// vectors as torch.rsqrt and a multiply compute it on the card. Two forms:
//   act:  y = round(bn(x)), then relu(y) where asked;
//   tail: y = relu(round(round(bn(a)) + r)), where r is the block's input
//         or round(bn_d(d)), the downsample branch's BatchNorm of d.
// round() is to the activations' type: bf16 rounds to nearest even as
// PyTorch's cast on this card does (cvt.rn.bf16.f32), float32 not at all.
// relu keeps a NaN, as F.relu does, and is max(y, 0) elsewhere.
//
// Bound on this card: bytes. Per element it reads the input (and the
// residual or the downsample branch) once and writes once: 4 bytes per bf16
// element, 6 with a residual; the chain it replaces moves 28 bytes per bf16
// element in each BatchNorm (a float32 subtract, multiply, add and bf16
// round), 4 more in its ReLU and 10 in the add and ReLU after it. Its
// arithmetic, 3 float operations per element and BatchNorm, is far below
// the bytes' time at 67 TFLOP/s. What the design does about it:
//   - the vector route (channels-last, C a multiple of the 16-byte vector's
//     8 bf16 or 4 float32 elements, 16-byte aligned tensors) reads and
//     writes 16 bytes per access, coalesced along C;
//   - its grid strides over the vectors by a multiple of C / vector, so a
//     thread's channels never change: it computes their factors once, into
//     registers, and then touches nothing but activations; the parameter
//     vectors are read once per thread from L2;
//   - two vectors per loop step keep more loads in flight per thread, and
//     a small map gets fewer threads, each over several vectors.
// The scalar route takes everything else that is dense: NCHW, C not a
// multiple of the vector, a residual in the other layout, unaligned views.
// It computes each element's channel and factor as it goes.
//
// Bit-equality with the plain version needs the same float operations in
// the same order and no contraction: the arithmetic uses the _rn
// intrinsics, which nvcc never fuses, and the build passes -fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNone = 0;        // act: bn, then relu where asked
constexpr int kResidual = 1;    // tail: + the block's input, relu
constexpr int kDownsample = 2;  // tail: + bn_d(d), relu
constexpr int kMaxThreads = 1024;
constexpr int kTargetThreads = 256;
constexpr int kThreadsPerSm = 2048;
// The vector route's vectors in flight per thread and step: two, one where
// the downsample branch's factors take another 24 registers.
constexpr int kIlp = 2;
constexpr int kIlpDownsample = 1;
// Its grid gives each thread at least this many vectors: a small map's
// threads then amortise their factors over more than one vector.
constexpr int kMinVecsPerThread = 4;

// One BatchNorm's float32 vectors, each of C entries, and its epsilon.
struct Stats {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

// An element type by its bits: float, or bf16 as its 16 bits.
template <typename S>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
};

template <>
struct Elem<uint16_t> {
  static constexpr int kVec = 8;
  __device__ static float load(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static uint16_t store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));  // round to nearest even
  }
};

template <typename S>
union Pack {
  uint4 u;
  S e[Elem<S>::kVec];
};

// torch.rsqrt(var + eps) * weight, as PyTorch's CUDA kernels compute it
// (rsqrtf of the float32 sum, then the product).
__device__ __forceinline__ float factor(const Stats& s, int c) {
  return __fmul_rn(rsqrtf(__fadd_rn(s.var[c], s.eps)), s.weight[c]);
}

__device__ __forceinline__ float bn(float x, float mean, float mul, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
}

// F.relu on the rounded value: a NaN stays as it is, bit for bit.
template <typename S>
__device__ __forceinline__ S relu(S v) {
  const float f = Elem<S>::load(v);
  return isnan(f) ? v : Elem<S>::store(fmaxf(f, 0.0f));
}

// One element: x (or a) with its channel's mean, factor and bias; r the
// residual or d with the downsample BatchNorm's (dm, dk, db). tail is
// kNone (then act_relu says whether the ReLU follows), kResidual or
// kDownsample; the vector route passes it as a constant.
template <typename S>
__device__ __forceinline__ S apply(S x, float m, float k, float b, S r, float dm, float dk,
                                   float db, int tail, bool act_relu) {
  const S y = Elem<S>::store(bn(Elem<S>::load(x), m, k, b));
  if (tail == kNone) return act_relu ? relu(y) : y;
  const float res = tail == kDownsample
                        ? Elem<S>::load(Elem<S>::store(bn(Elem<S>::load(r), dm, dk, db)))
                        : Elem<S>::load(r);
  return relu(Elem<S>::store(__fadd_rn(Elem<S>::load(y), res)));
}

// The vector route: channels-last, vectors of V elements of one pixel;
// groups = C / V. The grid's stride is a multiple of groups, so a thread's
// vectors all start at the channel c0 of its first. A step takes L vectors
// a stride apart; the first step's loads are issued before the factors are
// computed, so their latencies overlap.
template <typename S, int kTail>
__global__ void __launch_bounds__(kMaxThreads)
    frozen_bn_vec(const S* __restrict__ a, Stats sa, const S* __restrict__ r, Stats sd,
                  S* __restrict__ out, int64_t nvec, int groups, bool act_relu) {
  constexpr int V = Elem<S>::kVec;
  constexpr int L = kTail == kDownsample ? kIlpDownsample : kIlp;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (first >= nvec) return;
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  Pack<S> x[L], q[L];
  int64_t v = first;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int64_t at = v + j * stride;
    x[j].u = at < nvec ? av[at] : zero;
    q[j].u = kTail != kNone && at < nvec ? rv[at] : zero;
  }
  const int c0 = static_cast<int>(first % groups) * V;
  float am[V], ak[V], ab[V], dm[V], dk[V], db[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    am[i] = sa.mean[c0 + i];
    ak[i] = factor(sa, c0 + i);
    ab[i] = sa.bias[c0 + i];
    if (kTail == kDownsample) {
      dm[i] = sd.mean[c0 + i];
      dk[i] = factor(sd, c0 + i);
      db[i] = sd.bias[c0 + i];
    } else {
      dm[i] = dk[i] = db[i] = 0.0f;
    }
  }
  for (;;) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int64_t at = v + j * stride;
      if (at < nvec) {
        Pack<S> y;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          y.e[i] = apply<S>(x[j].e[i], am[i], ak[i], ab[i], q[j].e[i], dm[i], dk[i], db[i],
                            kTail, act_relu);
        }
        ov[at] = y.u;
      }
    }
    v += L * stride;
    if (v >= nvec) break;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int64_t at = v + j * stride;
      x[j].u = at < nvec ? av[at] : zero;
      q[j].u = kTail != kNone && at < nvec ? rv[at] : zero;
    }
  }
}

// The scalar route: one element at a time, in a's memory order, over
// (N, C, HW) images. a_nhwc / r_nhwc: each tensor's layout (channels-last
// or NCHW); the output has a's.
template <typename S>
__global__ void __launch_bounds__(kTargetThreads)
    frozen_bn_scalar(const S* __restrict__ a, Stats sa, int a_nhwc, const S* __restrict__ r,
                     Stats sd, int r_nhwc, S* __restrict__ out, int64_t n, int c, int64_t hw,
                     int tail, bool act_relu) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t image, pos;
    int ch;
    if (a_nhwc) {
      ch = static_cast<int>(i % c);
      const int64_t pixel = i / c;
      image = pixel / hw;
      pos = pixel % hw;
    } else {
      pos = i % hw;
      const int64_t plane = i / hw;
      ch = static_cast<int>(plane % c);
      image = plane / c;
    }
    S q = S();
    float dm = 0.0f, dk = 0.0f, db = 0.0f;
    if (tail != kNone) {
      const int64_t j = r_nhwc == a_nhwc ? i
                        : r_nhwc          ? (image * hw + pos) * c + ch
                                          : (image * c + ch) * hw + pos;
      q = r[j];
      if (tail == kDownsample) {
        dm = sd.mean[ch];
        dk = factor(sd, ch);
        db = sd.bias[ch];
      }
    }
    out[i] = apply<S>(a[i], sa.mean[ch], factor(sa, ch), sa.bias[ch], q, dm, dk, db, tail,
                      act_relu);
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 0: the vector route, 1: the scalar route.
int route(int bf16, int tail, int a_nhwc, int r_nhwc, int c, const void* a, const void* r,
          const void* out) {
  const int vec = bf16 ? Elem<uint16_t>::kVec : Elem<float>::kVec;
  const bool ok = a_nhwc && (tail == kNone || r_nhwc) && c % vec == 0 &&
                  c / vec <= kMaxThreads && aligned(a) && aligned(out) &&
                  (tail == kNone || aligned(r));
  return ok ? 0 : 1;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return sms;
}

template <typename S, int kTail>
void launch_vec(const S* a, Stats sa, const S* r, Stats sd, S* out, int64_t n, int c,
                bool act_relu, int sms, cudaStream_t stream) {
  constexpr int V = Elem<S>::kVec;
  const int groups = c / V;
  // a multiple of groups near kTargetThreads (groups <= kMaxThreads)
  const int block = groups <= kTargetThreads ? groups * (kTargetThreads / groups) : groups;
  const int64_t nvec = n / V;
  const int64_t per_block = static_cast<int64_t>(block) * kMinVecsPerThread;
  const int64_t want = (nvec + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sms) * (kThreadsPerSm / block);
  const int grid = static_cast<int>(want < cap ? want : cap);
  frozen_bn_vec<S, kTail><<<grid, block, 0, stream>>>(a, sa, r, sd, out, nvec, groups, act_relu);
}

template <typename S>
int launch(int tail, int act_relu, const void* a, Stats sa, int a_nhwc, const void* r,
           Stats sd, int r_nhwc, void* out, int64_t n, int c, int64_t hw,
           cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const S* ap = static_cast<const S*>(a);
  const S* rp = static_cast<const S*>(r);
  S* op = static_cast<S*>(out);
  if (route(sizeof(S) == 2, tail, a_nhwc, r_nhwc, c, a, r, out) == 0) {
    if (tail == kNone) {
      launch_vec<S, kNone>(ap, sa, rp, sd, op, n, c, act_relu != 0, sms, stream);
    } else if (tail == kResidual) {
      launch_vec<S, kResidual>(ap, sa, rp, sd, op, n, c, true, sms, stream);
    } else {
      launch_vec<S, kDownsample>(ap, sa, rp, sd, op, n, c, true, sms, stream);
    }
  } else {
    const int64_t want = (n + kTargetThreads - 1) / kTargetThreads;
    const int64_t cap = static_cast<int64_t>(sms) * (kThreadsPerSm / kTargetThreads);
    const int grid = static_cast<int>(want < cap ? want : cap);
    frozen_bn_scalar<S><<<grid, kTargetThreads, 0, stream>>>(ap, sa, a_nhwc, rp, sd, r_nhwc, op,
                                                             n, c, hw, tail, act_relu != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The route a launch with these arguments takes: 0 vector, 1 scalar.
extern "C" int frozen_bn_route(int bf16, int tail, int a_nhwc, int r_nhwc, int c,
                               const void* a, const void* r, const void* out) {
  return route(bf16, tail, a_nhwc, r_nhwc, c, a, r, out);
}

// out = act(bn(a)) (tail 0; relu where act_relu), relu(bn(a) + r) (tail 1)
// or relu(bn(a) + bn_d(r)) (tail 2), rounded as the header says. a, r and
// out are dense (N, C, HW) tensors of one type (bf16 when bf16, else
// float32), each channels-last (*_nhwc 1) or NCHW (0); out has a's layout.
// The statistics are float32 vectors of C entries; d_* are read for tail 2
// only. Launches on stream and does not synchronise; returns a CUDA error.
extern "C" int frozen_bn_launch(int bf16, int tail, int act_relu, const void* a, int a_nhwc,
                                const float* mean, const float* var, const float* weight,
                                const float* bias, float eps, const void* r, int r_nhwc,
                                const float* d_mean, const float* d_var, const float* d_weight,
                                const float* d_bias, float d_eps, void* out, long long n, int c,
                                long long hw, void* stream) {
  if (n < 1 || c < 1 || hw < 1 || n % (static_cast<long long>(c) * hw) != 0 ||
      tail < kNone || tail > kDownsample || (tail != kNone && r == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Stats sa{mean, var, weight, bias, eps};
  const Stats sd{d_mean, d_var, d_weight, d_bias, d_eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<uint16_t>(tail, act_relu, a, sa, a_nhwc, r, sd, r_nhwc, out, n, c, hw, s)
              : launch<float>(tail, act_relu, a, sa, a_nhwc, r, sd, r_nhwc, out, n, c, hw, s);
}
