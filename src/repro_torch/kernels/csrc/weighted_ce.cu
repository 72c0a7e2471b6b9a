// Blockwise per-row cross-entropy over a large vocabulary, forward and
// backward, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/weighted_ce.py::_ce_fwd_kernel (forward) and
// ::_ce_bwd_kernel (backward), the two Pallas bodies behind its custom
// VJP. For logits (R, V) in f32, bf16 or f16 and int32 targets (R,):
//   forward:  lse[r] = log sum_c exp(x[r, c]),  ce[r] = lse[r] - x[r, t[r]]
//             (both f32; a target outside [0, V) adds nothing, as in the
//             TPU kernel)
//   backward: dlogits[r, c] = (exp(x[r, c] - lse[r]) - [c == t[r]]) g[r]
//             computed in f32, stored in the logits' dtype.
//
// What bounds it on this card: the bytes. gemma3-1b's LM loss has R = 4,092
// rows of V = 262,144 f32 logits, 4.29 GB: the forward reads them once
// (1.28 ms at 3.35 TB/s) and the backward reads them and writes dlogits
// (8.59 GB, 2.56 ms). One exp per logit (1.07 G) is far below the
// card's rate.
//
// What the design does. The TPU carries (m, l, target logit) in scratch
// across a sequential vocabulary grid; blocks here run in parallel and in
// no order, so one block owns one row and loops over it instead. Each
// thread streams the row with 16-byte loads and keeps its own online max
// and sum of exponentials in f32; the block merges the (m, l) pairs by
// warp shuffles and then one warp's pairs in shared memory, in a fixed
// order. The target logit is read once, at x[r, t[r]], with no
// compare-and-select sweep. The backward is one elementwise pass with
// 16-byte loads and stores, one block per row. Rows are addressed by two
// strides (row r at (r / inner_n) s_outer + (r % inner_n) s_inner), so
// the model's logits[:, :-1] view (B, S - 1, V) is read in place, without
// the copy a reshape to (R, V) would make. A row whose start is not
// 16-byte aligned takes the scalar loop, and so does a ragged end.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// 16 bytes of T: 4 floats or 8 bf16 or f16 (a bf16 is the high half of its
// f32; an f16 converts by the intrinsic, round to nearest even)
template <typename T> struct Pack { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load16(const __half* p, float (&x)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[k]));
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&x)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(x[2 * k]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(x[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(__half* p, const float (&x)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = __half_as_ushort(__float2half(x[2 * k]));
    const unsigned hi = __half_as_ushort(__float2half(x[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ long long row_offset(long long r, long long inner_n, long long s_outer,
                                                long long s_inner) {
  return (r / inner_n) * s_outer + (r % inner_n) * s_inner;
}

// One more logit into a thread's running (max, sum of exp(x - max)).
__device__ __forceinline__ void online(float& m, float& l, float x) {
  if (x > m) {
    l *= expf(m - x);  // m = -inf: exp(-inf) = 0, and l is 0 then
    m = x;
  }
  l += expf(x - m);
}

// Merge another (max, sum) pair into (m, l). An empty pair has m = -inf.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
              float* __restrict__ ce, float* __restrict__ lse_out, long long v,
              long long inner_n, long long s_outer, long long s_inner) {
  constexpr int N = Pack<T>::N;
  const long long r = blockIdx.x;
  const T* row = logits + row_offset(r, inner_n, s_outer, s_inner);
  float m = -INFINITY, l = 0.f;
  long long done = 0;
  if (aligned16(row)) {
    const long long nv = v / N;
#pragma unroll 2
    for (long long i = threadIdx.x; i < nv; i += kThreads) {
      float x[N];
      load16(row + i * N, x);
      float mx = x[0];
#pragma unroll
      for (int j = 1; j < N; ++j) mx = fmaxf(mx, x[j]);
      if (mx > m) {
        l *= expf(m - mx);
        m = mx;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) l += expf(x[j] - m);
    }
    done = nv * N;
  }
  for (long long c = done + threadIdx.x; c < v; c += kThreads) online(m, l, to_f32(row[c]));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  __shared__ float warp_m[kWarps], warp_l[kWarps];
  if ((threadIdx.x & 31) == 0) {
    warp_m[threadIdx.x >> 5] = m;
    warp_l[threadIdx.x >> 5] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = warp_m[0];
    l = warp_l[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge(m, l, warp_m[w], warp_l[w]);
    const float lse = logf(l) + m;
    const int t = targets[r];
    const float tgt = (t >= 0 && t < v) ? to_f32(row[t]) : 0.f;
    lse_out[r] = lse;
    ce[r] = lse - tgt;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ dlogits, long long v, long long inner_n, long long s_outer,
              long long s_inner) {
  constexpr int N = Pack<T>::N;
  const long long r = blockIdx.x;
  const T* row = logits + row_offset(r, inner_n, s_outer, s_inner);
  T* out = dlogits + r * v;
  const float ls = lse[r];
  const float gr = g[r];
  const long long t = targets[r];
  long long done = 0;
  if (aligned16(row) && aligned16(out)) {
    const long long nv = v / N;
#pragma unroll 2
    for (long long i = threadIdx.x; i < nv; i += kThreads) {
      float x[N];
      load16(row + i * N, x);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float p = expf(x[j] - ls);
        if (i * N + j == t) p -= 1.f;
        x[j] = p * gr;
      }
      store16(out + i * N, x);
    }
    done = nv * N;
  }
  for (long long c = done + threadIdx.x; c < v; c += kThreads) {
    float p = expf(to_f32(row[c]) - ls);
    if (c == t) p -= 1.f;
    out[c] = from_f32<T>(p * gr);
  }
}

bool bad_shape(long long rows, long long v, long long inner_n) {
  return rows < 1 || rows > 0x7fffffffLL || v < 1 || inner_n < 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. logits: rows of v contiguous elements,
// row r starting (r / inner_n) * s_outer + (r % inner_n) * s_inner
// elements from `logits`; targets (rows,) int32; ce, lse (rows,) float32.
// Returns the CUDA error of the launch.
extern "C" int weighted_ce_fwd_launch(const void* logits, const void* targets, void* ce,
                                      void* lse, long long rows, long long v, long long inner_n,
                                      long long s_outer, long long s_inner, int dtype,
                                      void* stream) {
  if (bad_shape(rows, v, inner_n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(targets);
  float* c = static_cast<float*>(ce);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      ce_fwd_kernel<float><<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
          static_cast<const float*>(logits), tg, c, ls, v, inner_n, s_outer, s_inner);
      break;
    case 1:
      ce_fwd_kernel<__nv_bfloat16><<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(logits), tg, c, ls, v, inner_n, s_outer, s_inner);
      break;
    case 2:
      ce_fwd_kernel<__half><<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
          static_cast<const __half*>(logits), tg, c, ls, v, inner_n, s_outer, s_inner);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As above; lse, g (rows,) float32; dlogits (rows, v) contiguous in the
// logits' dtype.
extern "C" int weighted_ce_bwd_launch(const void* logits, const void* targets, const void* lse,
                                      const void* g, void* dlogits, long long rows, long long v,
                                      long long inner_n, long long s_outer, long long s_inner,
                                      int dtype, void* stream) {
  if (bad_shape(rows, v, inner_n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(targets);
  const float* ls = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  switch (dtype) {
    case 0:
      ce_bwd_kernel<float><<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
          static_cast<const float*>(logits), tg, ls, gg, static_cast<float*>(dlogits), v,
          inner_n, s_outer, s_inner);
      break;
    case 1:
      ce_bwd_kernel<__nv_bfloat16><<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(logits), tg, ls, gg,
          static_cast<__nv_bfloat16*>(dlogits), v, inner_n, s_outer, s_inner);
      break;
    case 2:
      ce_bwd_kernel<__half><<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
          static_cast<const __half*>(logits), tg, ls, gg, static_cast<__half*>(dlogits), v,
          inner_n, s_outer, s_inner);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
