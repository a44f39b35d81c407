// Inference BatchNorm, residual add and ReLU of a bottleneck ResNet block
// as one in-place pass over a channels_last float32 convolution output
// (CUDA, sm_90a).
//
// It replaces no TPU kernel.  The JAX package has no bottleneck block, and
// in its ResNets (dmcnet_tpu/models/resnet.py) XLA fuses each BatchNorm,
// add and ReLU into the convolution that feeds it, so no Pallas kernel was
// written for them.
// PyTorch runs the same glue eagerly as a pass each: cuDNN's inference BN
// reads and writes a convolution's output, ReLU reads and writes it again,
// and the block's add reads two tensors and writes a third.  This kernel
// does the work of those passes in one.
//
// What it computes, for y (N, H, W, C) and an optional r of y's shape, both
// channels_last (C innermost), per channel c:
//   k = weight / sqrt(running_var + eps),   s = bias - running_mean * k
//   y <- act(y * k1 + s1)                      kRes = 0: no residual
//   y <- act(y * k1 + s1 + r)                  kRes = 1: the identity
//   y <- act(y * k1 + s1 + (r * k2 + s2))      kRes = 2: a BN'd downsample
// with act ReLU or none.  k and s are computed from the BN's tensors at
// each launch, so nothing is cached and nothing goes stale after
// `load_state_dict`.  Every operation is rounded once, in the order the
// plain version (`ops/bn_epilogue.bn_epilogue_ref`) rounds it, with the
// `__f*_rn` intrinsics so that nvcc contracts nothing into an FMA: the
// kernel and its plain version agree bit for bit.
//
// What bounds it on an H100.  Two flops a value against 8 bytes (12 with
// r): it is bound by device-memory bandwidth, by far.  One ResNet-152
// forward of 250 clips at 224x224 makes 151 launches over 55.24 GB, 16.5
// ms at 3.35 TB/s; the passes it replaces moved 127 GB.
//
// What the design does about it:
//   * 16-byte loads and stores (float4) along C, which the wrapper checks
//     is a multiple of 4 and 16-byte aligned;
//   * a grid of as many blocks as the card keeps resident (SM count x
//     occupancy), each thread striding through the tensor, with the
//     grid's thread count a multiple of C/4: a thread then stays on the
//     same 4 channels for the whole pass and computes their k and s once,
//     in registers, with no shared memory, no index division in the loop
//     and no atomics;
//   * kUnroll independent float4 loads (of y, and of r) issued before the
//     first store, so each thread keeps several loads in flight.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes by ops/_build.py): `bn_epilogue_launch` launches on the given
// stream and returns cudaGetLastError() as an int (0 = launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct Bn {
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
};

__device__ __forceinline__ void scale_shift(const Bn& p, int c, float* k,
                                            float* s) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    k[j] = __fdiv_rn(p.weight[c + j],
                     __fsqrt_rn(__fadd_rn(p.var[c + j], p.eps)));
    s[j] = __fsub_rn(p.bias[c + j], __fmul_rn(p.mean[c + j], k[j]));
  }
}

template <int kRes, bool kRelu>
__device__ __forceinline__ float one(float y, float r, float k1, float s1,
                                     float k2, float s2) {
  float v = __fadd_rn(__fmul_rn(y, k1), s1);
  if (kRes == 1) v = __fadd_rn(v, r);
  if (kRes == 2) v = __fadd_rn(v, __fadd_rn(__fmul_rn(r, k2), s2));
  if (kRelu) v = v < 0.f ? 0.f : v;   // NaN stays NaN, as torch.relu
  return v;
}

template <int kRes, bool kRelu>
__device__ __forceinline__ float4 apply(float4 y, float4 r, const float* k1,
                                        const float* s1, const float* k2,
                                        const float* s2) {
  return make_float4(one<kRes, kRelu>(y.x, r.x, k1[0], s1[0], k2[0], s2[0]),
                     one<kRes, kRelu>(y.y, r.y, k1[1], s1[1], k2[1], s2[1]),
                     one<kRes, kRelu>(y.z, r.z, k1[2], s1[2], k2[2], s2[2]),
                     one<kRes, kRelu>(y.w, r.w, k1[3], s1[3], k2[3], s2[3]));
}

// y and r as n4 float4s; the grid's thread count is a multiple of c4 = C/4,
// so thread t serves the channels 4 * (t % c4) .. + 3 at every step.
template <int kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_epilogue_kernel(float4* __restrict__ y, const float4* __restrict__ r,
                       Bn p, Bn q, long long n4, int c4) {
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int c = static_cast<int>(i % c4) * 4;
  float k1[4], s1[4], k2[4] = {}, s2[4] = {};
  scale_shift(p, c, k1, s1);
  if (kRes == 2) scale_shift(q, c, k2, s2);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    float4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = y[i + u * stride];
      b[u] = kRes ? r[i + u * stride] : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      y[i + u * stride] = apply<kRes, kRelu>(a[u], b[u], k1, s1, k2, s2);
  }
  for (; i < n4; i += stride)
    y[i] = apply<kRes, kRelu>(y[i], kRes ? r[i] : zero, k1, s1, k2, s2);
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <int kRes, bool kRelu>
int launch(float* y, const float* r, Bn p, Bn q, long long n4, int c4,
           void* stream) {
  static int per_sm = 0;   // resident blocks an SM, per instantiation
  if (per_sm == 0) {
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bn_epilogue_kernel<kRes, kRelu>, kThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // blocks: one resident wave, no more than one float4 a thread needs, then
  // up to a multiple of `unit` so that blocks * kThreads % c4 == 0
  const long long unit = c4 / gcd(kThreads, c4);
  long long blocks = static_cast<long long>(sms) * per_sm;
  const long long need = (n4 + kThreads - 1) / kThreads;
  if (need < blocks) blocks = need;
  blocks = (blocks + unit - 1) / unit * unit;
  bn_epilogue_kernel<kRes, kRelu><<<static_cast<unsigned>(blocks), kThreads,
                                    0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(y), reinterpret_cast<const float4*>(r), p,
      q, n4, c4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y <- act(BN_p(y) [+ r | + BN_q(r)]) in place on `stream` (a cudaStream_t,
// 0 = legacy default): res_mode 0 (no r), 1 (identity r) or 2 (BN'd r),
// relu 0 or 1.  y and r hold n4 = numel / 4 float4s, channels_last with
// C = 4 * c4 channels; each BN's four tensors hold C floats.  The caller
// has checked devices, types, shapes, layouts and 16-byte alignment.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a mode it does
// not know.
int bn_epilogue_launch(void* y, const void* r, int res_mode, int relu,
                       const void* w1, const void* b1, const void* m1,
                       const void* v1, float eps1, const void* w2,
                       const void* b2, const void* m2, const void* v2,
                       float eps2, long long n4, int c4, void* stream) {
  const Bn p{static_cast<const float*>(w1), static_cast<const float*>(b1),
             static_cast<const float*>(m1), static_cast<const float*>(v1),
             eps1};
  const Bn q{static_cast<const float*>(w2), static_cast<const float*>(b2),
             static_cast<const float*>(m2), static_cast<const float*>(v2),
             eps2};
  float* yy = static_cast<float*>(y);
  const float* rr = static_cast<const float*>(r);
  if (n4 <= 0 || c4 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (res_mode * 2 + (relu ? 1 : 0)) {
    case 0: return launch<0, false>(yy, rr, p, q, n4, c4, stream);
    case 1: return launch<0, true>(yy, rr, p, q, n4, c4, stream);
    case 2: return launch<1, false>(yy, rr, p, q, n4, c4, stream);
    case 3: return launch<1, true>(yy, rr, p, q, n4, c4, stream);
    case 4: return launch<2, false>(yy, rr, p, q, n4, c4, stream);
    case 5: return launch<2, true>(yy, rr, p, q, n4, c4, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bn_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
