// SAMA's Lion adaptation product for Hopper (sm_90a).
//
// Replaces src/repro/kernels/lion_adapt.py::_lion_kernel (the Pallas body
// of lion_adapt_product). Lion's step is lr sign(c), c = b1 m + (1 - b1) g;
// the derivative of sign is zero almost everywhere, so the optimizer
// declares the smoothed surrogate sign_d(c) = c / (|c| + delta), whose
// elementwise derivative is the diagonal here. Over flat f32 g, m, g_meta:
//   c    = b1 m + (1 - b1) g
//   diag = lr (1 - b1) delta / (|c| + delta)^2
//   out  = diag g_meta
// and each block's sum of out^2 in f32, so eps = alpha / ||v|| needs no
// second pass. lr is read from a (1,) f32 device tensor, as the TPU
// kernel reads its `sched` input: a scheduled rate never crosses to the
// host.
//
// What bounds it on this card: the bytes. Three f32 reads and one f32
// write per element, 16 B, against about 8 operations: 23.4 M elements
// (bert-base's embedding) move 375 MB, 0.112 ms at 3.35 TB/s.
//
// What the design does: the shape of adam_adapt.cu (flat_pass.cuh): one
// grid-stride pass with 16-byte loads and stores where the arrays allow
// them, the ragged tail masked by the bound (the TPU pads it to a tile),
// a fixed grid so the partial sums repeat exactly from run to run, and
// one f32 partial per block reduced in a fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flat_pass.cuh"

namespace {

struct LionOp {
  float b1, omb1, delta, scale;  // scale = lr (1 - b1) delta
  // x = (g, m, g_meta)
  __device__ __forceinline__ float operator()(const float (&x)[3]) const {
    const float c = b1 * x[1] + omb1 * x[0];
    const float ad = fabsf(c) + delta;
    return scale / (ad * ad) * x[2];
  }
};

__global__ void __launch_bounds__(flat::kThreads)
lion_adapt_kernel(flat::Ptrs<3> in, const float* __restrict__ sched, float* __restrict__ out,
                  float* __restrict__ partial, long long n, int vec, float b1, float omb1,
                  float delta) {
  LionOp op;
  op.b1 = b1;
  op.omb1 = omb1;
  op.delta = delta;
  op.scale = sched[0] * omb1 * delta;  // (lr (1 - b1)) delta, the TPU kernel's order
  flat::pass(in, out, partial, n, vec, op);
}

}  // namespace

// g, m, g_meta, out: n contiguous float32 on one device; sched (1,)
// float32 = (lr,); partial: `blocks` float32, one sum of out^2 per block.
// b1 and omb1 are b1 and 1 - b1, each rounded from double as the JAX
// constants are. Returns the CUDA error of the launch.
extern "C" int lion_adapt_launch(const void* g, const void* m, const void* g_meta,
                                 const void* sched, void* out, void* partial, long long n,
                                 int blocks, float b1, float omb1, float delta, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const flat::Ptrs<3> in{{static_cast<const float*>(g), static_cast<const float*>(m),
                          static_cast<const float*>(g_meta)}};
  lion_adapt_kernel<<<blocks, flat::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(sched), static_cast<float*>(out),
      static_cast<float*>(partial), n, flat::all_aligned(in, out), b1, omb1, delta);
  return static_cast<int>(cudaGetLastError());
}
