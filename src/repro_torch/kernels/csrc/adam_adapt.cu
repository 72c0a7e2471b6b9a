// SAMA's Adam adaptation product (paper Eq. 4, Appendix C) for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/adam_adapt.py::_adapt_kernel (the Pallas body
// of adam_adapt_product). Elementwise over flat f32 g, m, v, g_meta:
//   m1 = b1 m + (1 - b1) g,  v1 = b2 v + (1 - b2) g^2
//   mhat = m1 / bc1, vhat = v1 / bc2, bc_i = 1 - b_i^t
//   diag = lr (a / (sqrt(vhat) + eps)
//              - mhat b g / (max(sqrt(vhat), 1e-15) (sqrt(vhat) + eps)^2))
//   out  = diag g_meta,  a = (1 - b1) / bc1, b = (1 - b2) / bc2
// and each block's sum of out^2 in f32, so eps = alpha / ||v|| needs no
// second pass. t and lr are read from a (2,) f32 device tensor, as the
// TPU kernel reads its `sched` input: the step count and a scheduled rate
// never cross to the host.
//
// What bounds it on this card: the bytes. Four f32 reads and one f32
// write per element, 20 B, against about 20 operations: 23.4 M elements
// (bert-base's embedding) move 469 MB, 0.14 ms at 3.35 TB/s.
//
// What the design does: one grid-stride pass with 16-byte loads and
// stores where the arrays allow them (the scalar loop takes the rest), a
// fixed grid (so the partial sums, and their sum, come out the same on
// every run), and one f32 partial per block, reduced in a fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Coef {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float adapt(float g, float m, float v, float gm, float bc1, float bc2,
                                       float a, float bb, float lr, const Coef& c) {
  const float m1 = c.b1 * m + c.omb1 * g;
  const float v1 = c.b2 * v + c.omb2 * g * g;
  const float mhat = m1 / bc1;
  const float vhat = v1 / bc2;
  const float sq = sqrtf(vhat);
  const float denom = sq + c.eps;
  const float diag = lr * (a / denom - mhat * bb * g / (fmaxf(sq, 1e-15f) * denom * denom));
  return diag * gm;
}

__global__ void __launch_bounds__(kThreads)
adam_adapt_kernel(const float* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ v, const float* __restrict__ gm,
                  const float* __restrict__ sched, float* __restrict__ out,
                  float* __restrict__ partial, long long n, int vec, Coef c) {
  const float t = sched[0];
  const float lr = sched[1];
  const float bc1 = 1.f - powf(c.b1, t);
  const float bc2 = 1.f - powf(c.b2, t);
  const float a = c.omb1 / bc1;
  const float bb = c.omb2 / bc2;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  float ss = 0.f;
  long long done = 0;
  if (vec) {  // every pointer 16-byte aligned
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const float4 g4 = reinterpret_cast<const float4*>(g)[i];
      const float4 m4 = reinterpret_cast<const float4*>(m)[i];
      const float4 v4 = reinterpret_cast<const float4*>(v)[i];
      const float4 q4 = reinterpret_cast<const float4*>(gm)[i];
      float4 o;
      o.x = adapt(g4.x, m4.x, v4.x, q4.x, bc1, bc2, a, bb, lr, c);
      o.y = adapt(g4.y, m4.y, v4.y, q4.y, bc1, bc2, a, bb, lr, c);
      o.z = adapt(g4.z, m4.z, v4.z, q4.z, bc1, bc2, a, bb, lr, c);
      o.w = adapt(g4.w, m4.w, v4.w, q4.w, bc1, bc2, a, bb, lr, c);
      reinterpret_cast<float4*>(out)[i] = o;
      ss += o.x * o.x + o.y * o.y + o.z * o.z + o.w * o.w;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float o = adapt(g[i], m[i], v[i], gm[i], bc1, bc2, a, bb, lr, c);
    out[i] = o;
    ss += o * o;
  }

  __shared__ float warp_ss[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) warp_ss[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_ss[w];
    partial[blockIdx.x] = total;
  }
}

}  // namespace

// g, m, v, g_meta, out: n contiguous float32 on one device; sched (2,)
// float32 = (t, lr); partial: `blocks` float32, one sum of out^2 per
// block. b1/omb1 and b2/omb2 are b and 1 - b, each rounded from double
// as the JAX constants are. Returns the CUDA error of the launch.
extern "C" int adam_adapt_launch(const void* g, const void* m, const void* v, const void* g_meta,
                                 const void* sched, void* out, void* partial, long long n,
                                 int blocks, float b1, float omb1, float b2, float omb2,
                                 float eps, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t any = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(m) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g_meta) |
                        reinterpret_cast<uintptr_t>(out);
  const int vec = (any % 16) == 0;
  adam_adapt_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const float*>(g_meta), static_cast<const float*>(sched),
      static_cast<float*>(out), static_cast<float*>(partial), n, vec,
      Coef{b1, omb1, b2, omb2, eps});
  return static_cast<int>(cudaGetLastError());
}
