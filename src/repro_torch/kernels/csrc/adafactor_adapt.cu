// SAMA's Adafactor adaptation product for Hopper (sm_90a).
//
// Replaces src/repro/kernels/adafactor_adapt.py::_adafactor_kernel (the
// Pallas body of adafactor_adapt_product). Adafactor's factored second
// moment couples every element of a row and a column, so the optimizer
// declares the frozen-statistics diagonal lr / (sqrt(vhat) + eps); the
// caller rebuilds vhat (the rank-1 product of the row and column means,
// or the full moment) in torch ahead of the kernel. Over flat f32 vhat,
// g_meta:
//   out = lr / (sqrt(vhat) + eps) g_meta
// and each block's sum of out^2 in f32, so eps = alpha / ||v|| needs no
// second pass. lr is read from a (1,) f32 device tensor, as the TPU
// kernel reads its `sched` input.
//
// What bounds it on this card: the bytes. Two f32 reads and one f32 write
// per element, 12 B, against about 4 operations: 23.4 M elements
// (bert-base's embedding) move 281 MB, 0.084 ms at 3.35 TB/s.
//
// What the design does: the shape of adam_adapt.cu (flat_pass.cuh): one
// grid-stride pass with 16-byte loads and stores where the arrays allow
// them, the ragged tail masked by the bound (the TPU pads vhat with ones
// only to keep its padded tile finite), a fixed grid so the partial sums
// repeat exactly from run to run, and one f32 partial per block reduced
// in a fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flat_pass.cuh"

namespace {

struct AdafactorOp {
  float lr, eps;
  // x = (vhat, g_meta)
  __device__ __forceinline__ float operator()(const float (&x)[2]) const {
    return lr / (sqrtf(x[0]) + eps) * x[1];
  }
};

__global__ void __launch_bounds__(flat::kThreads)
adafactor_adapt_kernel(flat::Ptrs<2> in, const float* __restrict__ sched,
                       float* __restrict__ out, float* __restrict__ partial, long long n,
                       int vec, float eps) {
  AdafactorOp op;
  op.lr = sched[0];
  op.eps = eps;
  flat::pass(in, out, partial, n, vec, op);
}

}  // namespace

// vhat, g_meta, out: n contiguous float32 on one device; sched (1,)
// float32 = (lr,); partial: `blocks` float32, one sum of out^2 per block.
// Returns the CUDA error of the launch.
extern "C" int adafactor_adapt_launch(const void* vhat, const void* g_meta, const void* sched,
                                      void* out, void* partial, long long n, int blocks,
                                      float eps, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const flat::Ptrs<2> in{{static_cast<const float*>(vhat), static_cast<const float*>(g_meta)}};
  adafactor_adapt_kernel<<<blocks, flat::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const float*>(sched), static_cast<float*>(out),
      static_cast<float*>(partial), n, flat::all_aligned(in, out), eps);
  return static_cast<int>(cudaGetLastError());
}
