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
// every run), and one f32 partial per block, reduced in a fixed order
// (flat_pass.cuh, shared with lion_adapt.cu and adafactor_adapt.cu).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flat_pass.cuh"

namespace {

struct Coef {
  float b1, omb1, b2, omb2, eps;
};

struct AdamOp {
  Coef c;
  float bc1, bc2, a, bb, lr;
  // x = (g, m, v, g_meta)
  __device__ __forceinline__ float operator()(const float (&x)[4]) const {
    const float g = x[0];
    const float m1 = c.b1 * x[1] + c.omb1 * g;
    const float v1 = c.b2 * x[2] + c.omb2 * g * g;
    const float mhat = m1 / bc1;
    const float vhat = v1 / bc2;
    const float sq = sqrtf(vhat);
    const float denom = sq + c.eps;
    const float diag = lr * (a / denom - mhat * bb * g / (fmaxf(sq, 1e-15f) * denom * denom));
    return diag * x[3];
  }
};

__global__ void __launch_bounds__(flat::kThreads)
adam_adapt_kernel(flat::Ptrs<4> in, const float* __restrict__ sched, float* __restrict__ out,
                  float* __restrict__ partial, long long n, int vec, Coef c) {
  const float t = sched[0];
  AdamOp op;
  op.c = c;
  op.lr = sched[1];
  op.bc1 = 1.f - powf(c.b1, t);
  op.bc2 = 1.f - powf(c.b2, t);
  op.a = c.omb1 / op.bc1;
  op.bb = c.omb2 / op.bc2;
  flat::pass(in, out, partial, n, vec, op);
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
  const flat::Ptrs<4> in{{static_cast<const float*>(g), static_cast<const float*>(m),
                          static_cast<const float*>(v), static_cast<const float*>(g_meta)}};
  adam_adapt_kernel<<<blocks, flat::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(sched), static_cast<float*>(out),
      static_cast<float*>(partial), n, flat::all_aligned(in, out),
      Coef{b1, omb1, b2, omb2, eps});
  return static_cast<int>(cudaGetLastError());
}
