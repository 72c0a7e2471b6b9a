// Shared by the SAMA adaptation-product kernels (adam_adapt.cu,
// lion_adapt.cu, adafactor_adapt.cu): one elementwise pass over flat f32
// arrays that writes out[i] = op(inputs at i) and one f32 partial sum of
// out^2 per block.
//
// The grid is fixed by the caller (a function of n only), each thread
// walks it with a grid stride, and each block reduces its threads in a
// fixed order: the partial sums, and the eps = alpha / ||v|| built from
// them, come out the same on every run. 16-byte loads and stores where
// every pointer is 16-byte aligned; the ragged tail (and unaligned views)
// take the scalar loop, masked by the bound, never padded.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flat {

constexpr int kThreads = 256;

template <int N>
struct Ptrs {
  const float* p[N];
};

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// The whole kernel body: `op(const float (&x)[N])` maps the N inputs at
// one index to the output there.
template <int N, class Op>
__device__ __forceinline__ void pass(const Ptrs<N>& in, float* __restrict__ out,
                                     float* __restrict__ partial, long long n, int vec,
                                     const Op& op) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  float ss = 0.f;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      float4 x4[N];
#pragma unroll
      for (int k = 0; k < N; ++k) x4[k] = reinterpret_cast<const float4*>(in.p[k])[i];
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x[N];
#pragma unroll
        for (int k = 0; k < N; ++k) x[k] = lane(x4[k], j);
        o[j] = op(x);
        ss += o[j] * o[j];
      }
      reinterpret_cast<float4*>(out)[i] = make_float4(o[0], o[1], o[2], o[3]);
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float x[N];
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = in.p[k][i];
    const float o = op(x);
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

// 1 when every pointer is 16-byte aligned (the float4 loop may run).
template <int N>
inline int all_aligned(const Ptrs<N>& in, const void* out) {
  uintptr_t any = reinterpret_cast<uintptr_t>(out);
  for (int k = 0; k < N; ++k) any |= reinterpret_cast<uintptr_t>(in.p[k]);
  return (any % 16) == 0;
}

}  // namespace flat
