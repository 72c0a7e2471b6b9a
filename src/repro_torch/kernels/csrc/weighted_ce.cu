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
// (8.59 GB, 2.56 ms). One exp per logit stays far below the card's rate
// as a subtraction, a multiply and one ex2.approx (the MUFU unit):
// exp(x - m) = 2^((x - m) log2 e), within ~3e-7 relative of expf, against
// a 1e-5 tolerance. The target's p - 1 cancels where p is near 1, so
// there alone the backward takes expf, as the plain version's exp does.
//
// What the design does. The TPU carries (m, l, target logit) in scratch
// across a sequential vocabulary grid; blocks here run in parallel and in
// no order, so one block owns one row and loops over it instead. Rows are
// addressed by two strides (row r at (r / inner_n) s_outer + (r % inner_n)
// s_inner), so the model's logits[:, :-1] view (B, S - 1, V) is read in
// place, without the copy a reshape to (R, V) would make; at an odd V such
// a row starts anywhere in a 16-byte line. Every row therefore takes the
// vector path whatever its alignment: a scalar head up to the first
// 16-byte boundary (at most 16 / sizeof(T) - 1 elements), an aligned body
// of 16-byte vectors, a scalar tail.
//   The forward's body is aligned on the logits row. Each thread keeps
// kUnroll 16-byte loads in flight, then folds them into its own online max
// and sum of exponentials in f32, in a fixed order; the block merges the
// (m, l) pairs by warp shuffles and then one warp's pairs in shared
// memory, in a fixed order, so a repeat is bitwise equal. The target logit
// is read once, at x[r, t[r]].
//   The backward's body is aligned on the dlogits row (contiguous, r V),
// whose phase in a 16-byte line differs from the logits row's wherever the
// logits are a view at an odd V. Its stores are aligned 16-byte streaming
// stores (st.global.cs: dlogits is not read again here); its loads stay
// aligned on the logits: each vector of dlogits takes the two aligned
// logits vectors that hold its elements and re-phases them in registers
// (a funnel shift by the two rows' phase difference, one per row). The
// second load of each pair is the first of the next thread's, so it hits
// L1: device memory reads each byte once. Where the phases agree one load
// serves. No store leaves the row; a load may read the 16-byte line that
// holds the row's last element past the row's end, never past that line.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// threads of a row's block: 512 took whisper's out-of-phase backward 3.5%
// below 256 and moved gemma3-1b's by 0.4% (perf/ce_variants.py)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// 16-byte loads each thread keeps in flight in the bodies
constexpr int kUnroll = 4;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the MUFU unit, subnormal results kept (no .ftz), as expf keeps them
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - m) for a shift m that is finite, or 0 in place of -inf (so that
// a -inf logit gives 0 and never inf - inf): x - m first, as the plain
// version takes it
__device__ __forceinline__ float exp_shifted(float x, float m) { return ex2((x - m) * kLog2e); }

__device__ __forceinline__ float finite_shift(float m) { return m == -INFINITY ? 0.f : m; }

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

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store16_stream(void* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

__device__ __forceinline__ void unpack(uint4 u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

template <typename T> __device__ __forceinline__ void unpack16(uint4 u, float (&x)[8]);

template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 u, float (&x)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <> __device__ __forceinline__ void unpack16<__half>(uint4 u, float (&x)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[k]));
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ void unpack_any(uint4 u, float (&x)[Pack<T>::N]);
template <> __device__ __forceinline__ void unpack_any<float>(uint4 u, float (&x)[4]) {
  unpack(u, x);
}
template <> __device__ __forceinline__ void unpack_any<__nv_bfloat16>(uint4 u, float (&x)[8]) {
  unpack16<__nv_bfloat16>(u, x);
}
template <> __device__ __forceinline__ void unpack_any<__half>(uint4 u, float (&x)[8]) {
  unpack16<__half>(u, x);
}

template <typename T> __device__ __forceinline__ uint4 pack_any(const float (&x)[Pack<T>::N]);

template <> __device__ __forceinline__ uint4 pack_any<float>(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                    __float_as_uint(x[3]));
}

template <> __device__ __forceinline__ uint4 pack_any<__nv_bfloat16>(const float (&x)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(x[2 * k]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(x[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <> __device__ __forceinline__ uint4 pack_any<__half>(const float (&x)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = __half_as_ushort(__float2half(x[2 * k]));
    const unsigned hi = __half_as_ushort(__float2half(x[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bytes [4 q + r, 4 q + r + 16) of the 32 bytes a:c (q in 0..3, r in {0, 2}:
// rows of 2- and 4-byte elements differ in phase by a multiple of 2 bytes).
// q and r are the same for every vector of a row, so the branch is uniform.
__device__ __forceinline__ uint4 window(uint4 a, uint4 c, int q, unsigned r_bits) {
  unsigned w0, w1, w2, w3, w4;
  if (q == 0) {
    w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = c.x;
  } else if (q == 1) {
    w0 = a.y; w1 = a.z; w2 = a.w; w3 = c.x; w4 = c.y;
  } else if (q == 2) {
    w0 = a.z; w1 = a.w; w2 = c.x; w3 = c.y; w4 = c.z;
  } else {
    w0 = a.w; w1 = c.x; w2 = c.y; w3 = c.z; w4 = c.w;
  }
  return make_uint4(__funnelshift_r(w0, w1, r_bits), __funnelshift_r(w1, w2, r_bits),
                    __funnelshift_r(w2, w3, r_bits), __funnelshift_r(w3, w4, r_bits));
}

__device__ __forceinline__ long long row_offset(long long r, long long inner_n, long long s_outer,
                                                long long s_inner) {
  return (r / inner_n) * s_outer + (r % inner_n) * s_inner;
}

// Elements of T from p up to its first 16-byte boundary, at most v.
template <typename T> __device__ __forceinline__ long long head_len(const void* p, long long v) {
  const long long h = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T);
  return h < v ? h : v;
}

// One more logit into a thread's running (max, sum of exp(x - max)); ms
// is finite_shift(m).
__device__ __forceinline__ void online(float& m, float& l, float& ms, float x) {
  if (x > m) {
    l *= exp_shifted(m, x);  // m = -inf: 0, and l is 0 then
    m = x;
    ms = finite_shift(m);
  }
  l += exp_shifted(x, ms);
}

// A vector of logits into (m, l): one rescale for its max at most.
template <int N>
__device__ __forceinline__ void online_vec(float& m, float& l, float& ms, const float (&x)[N]) {
  float mx = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) mx = fmaxf(mx, x[j]);
  if (mx > m) {
    l *= exp_shifted(m, mx);
    m = mx;
    ms = finite_shift(m);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) l += exp_shifted(x[j], ms);
}

// Merge another (max, sum) pair into (m, l). An empty pair has m = -inf.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  l = l * exp_shifted(m, mn) + l2 * exp_shifted(m2, mn);
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
  const long long head = head_len<T>(row, v);
  const long long nvec = (v - head) / N;
  const T* body = row + head;
  float m = -INFINITY, l = 0.f, ms = 0.f;
  if (threadIdx.x < head) online(m, l, ms, to_f32(row[threadIdx.x]));

  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) u[k] = load16(body + (i + k * kThreads) * N);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      float x[N];
      unpack_any<T>(u[k], x);
      online_vec<N>(m, l, ms, x);
    }
  }
  for (; i < nvec; i += kThreads) {
    float x[N];
    unpack_any<T>(load16(body + i * N), x);
    online_vec<N>(m, l, ms, x);
  }
  for (long long c = head + nvec * N + threadIdx.x; c < v; c += kThreads) {
    online(m, l, ms, to_f32(row[c]));
  }

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

// exp(x - lse) - [c == t] for one logit: the target's by expf, whose
// rounding p - 1 would otherwise magnify where p is near 1.
__device__ __forceinline__ float grad_one(float x, long long c, long long t, float ls) {
  return c == t ? expf(x - ls) - 1.f : exp_shifted(x, ls);
}

// (exp(x - lse) - [c == t]) g for the N elements of a vector starting at
// element c0 of the row.
template <int N>
__device__ __forceinline__ void grad_vec(float (&x)[N], long long c0, long long t, float ls,
                                         float gr) {
  if (t >= c0 && t < c0 + N) {  // one thread of the row
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = grad_one(x[j], c0 + j, t, ls);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = exp_shifted(x[j], ls);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] *= gr;
}

// The backward's body: nvec vectors of dlogits from out (16-byte aligned),
// element c0 = head + i N of the row for vector i; the logits of vector i
// are bytes [shift, shift + 16) of the two aligned vectors at in + 16 i
// (kShift), or the one aligned vector there (shift 0).
template <typename T, bool kShift>
__device__ __forceinline__ void bwd_body(const char* in, T* out, long long nvec, long long head,
                                         long long t, float ls, float gr, int shift) {
  constexpr int N = Pack<T>::N;
  const int q = shift >> 2;
  const unsigned r_bits = (shift & 3) * 8;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 a[kUnroll], c[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const char* p = in + (i + k * kThreads) * 16;
      a[k] = load16(p);
      if (kShift) c[k] = load16(p + 16);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + k * kThreads;
      float x[N];
      unpack_any<T>(kShift ? window(a[k], c[k], q, r_bits) : a[k], x);
      grad_vec<N>(x, head + j * N, t, ls, gr);
      store16_stream(out + j * N, pack_any<T>(x));
    }
  }
  for (; i < nvec; i += kThreads) {
    const char* p = in + i * 16;
    const uint4 a = load16(p);
    float x[N];
    unpack_any<T>(kShift ? window(a, load16(p + 16), q, r_bits) : a, x);
    grad_vec<N>(x, head + i * N, t, ls, gr);
    store16_stream(out + i * N, pack_any<T>(x));
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
  const float ls = finite_shift(lse[r]);
  const float gr = g[r];
  const long long t = targets[r];
  // head and body on dlogits' 16-byte lines
  const long long head = head_len<T>(out, v);
  const long long nvec = (v - head) / N;
  if (threadIdx.x < head) {
    const long long c = threadIdx.x;
    out[c] = from_f32<T>(grad_one(to_f32(row[c]), c, t, ls) * gr);
  }
  const uintptr_t first = reinterpret_cast<uintptr_t>(row + head);
  const int shift = static_cast<int>(first & 15);
  const char* in = reinterpret_cast<const char*>(first - shift);
  if (shift == 0) {
    bwd_body<T, false>(in, out + head, nvec, head, t, ls, gr, 0);
  } else {
    bwd_body<T, true>(in, out + head, nvec, head, t, ls, gr, shift);
  }
  for (long long c = head + nvec * N + threadIdx.x; c < v; c += kThreads) {
    out[c] = from_f32<T>(grad_one(to_f32(row[c]), c, t, ls) * gr);
  }
}

bool bad_shape(long long rows, long long v, long long inner_n) {
  return rows < 1 || rows > 0x7fffffffLL || v < 1 || inner_n < 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. logits: rows of v contiguous elements,
// row r starting (r / inner_n) * s_outer + (r % inner_n) * s_inner
// elements from `logits`, at any alignment of the element type; targets
// (rows,) int32; ce, lse (rows,) float32. Returns the CUDA error of the launch.
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
