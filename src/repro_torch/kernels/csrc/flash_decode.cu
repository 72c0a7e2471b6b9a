// Split-KV one-token GQA decode attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attn.py::_decode_kernel (the Pallas
// stage 1 of flash_decode) and, in a second small kernel, its stage 2
// merge_partials, which the JAX package computes in jnp.
//
// What it computes, for each lane b, KV head h and query head g of the
// group (G = H / KV query heads share one KV head):
//   s[t]   = softcap(q[b,g] . k[b,t,h] / sqrt(Dh))          in f32
//   valid  = t <= pos[b]  and  t < T  and  (window == 0 or pos[b] - t < window)
//   out    = sum_t softmax(s)[t] * v[b,t,h]    (zeros for a fully masked row)
// Stage 1 runs one block per (split, lane * KV head) and writes each
// split's normalised partial output and its log-sum-exp (NEG = -1e30 for a
// split with no valid row). Stage 2 merges the splits by their
// log-sum-exps and writes the output in the input dtype (f32, bf16, f16).
//
// What bounds it on this card: the bytes of the K/V read. In bf16 a full
// read is 2 * B * T * KV * Dh * 2 bytes, 4 MB at B = 4, T = 1024, KV = 1,
// Dh = 256: about 1.25 us at 3.35 TB/s, less than a kernel launch costs.
// At the serving sizes the launch overhead and the latency of the reads
// set the floor, not the arithmetic (2 * 2 * G * Dh operations per row).
//
// What the design does about it:
//  * one launch covers every lane, KV head and split, and the merge is one
//    more launch that also casts to the output dtype (the plain torch merge
//    takes about eight);
//  * a block reads only the rows its lane can see: rows past pos[b] are
//    never read, and a sliding-window layer reads at most `window` rows
//    whatever the cache length, so the bytes moved follow the data;
//  * each warp runs its own online softmax over its rows, with no barrier
//    until the block's four warps merge at the end, and keeps several rows'
//    K and V loads in flight (16-byte loads, one per lane per row at
//    Dh = 256 in bf16) so the read latency overlaps;
//  * all G query heads of a group share each K and V row read;
//  * K and V are read in place in the cache's (B, T, KV, Dh) layout, q and
//    the output in the model's (B, 1, H, Dh) layout: no transpose or pad
//    copies around the kernel, as the TPU version needed;
//  * the split count is chosen by the caller (pick_splits) to spread the
//    rows over the 132 SMs when the lanes alone cannot.
// No tensor cores: at one query token per head the products are
// matrix-vector, memory-bound by construction.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;        // head-dim elements per lane: d in [8 lane, 8 lane + 8)
constexpr int kMaxDh = 32 * kVec;
constexpr int kMergeThreads = 256;
constexpr float kNeg = -1e30f;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// kVec consecutive elements from a 16-byte aligned address, as f32.
__device__ __forceinline__ void load_vec(const float* p, float out[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float out[kVec]) {  // 2-byte types
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) out[i] = to_f32(h[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage 1. grid (n_splits, B * KV), kThreads threads. kG >= g_n query
// heads per KV head (a compile-time bound keeps the per-head state in
// registers); kRows rows of K and V in flight per warp.
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, float* __restrict__ o_part,
                    float* __restrict__ lse_part, int t_len, int kv, int g_n, int dh,
                    int n_splits, int split, int window, float softcap, float scale) {
  constexpr int kRows = kG >= 8 ? 2 : 4;
  const int si = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / kv;
  const int kvh = bh % kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = q_pos[b];
  const int d0 = lane * kVec;
  const bool lane_on = d0 < dh;  // dh is a multiple of kVec

  __shared__ float s_m[kWarps][kG];
  __shared__ float s_l[kWarps][kG];
  __shared__ float s_acc[kWarps][kG][kMaxDh];

  // the group's queries, in f32 registers
  float qr[kG][kVec];
  const T* qg = q + ((size_t)b * kv * g_n + (size_t)kvh * g_n) * dh;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < g_n && lane_on) {
      load_vec(qg + (size_t)g * dh + d0, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) qr[g][i] = 0.f;
    }
  }
  float m[kG], l[kG], acc[kG][kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  // the valid rows of this split: [lo, hi). Every row inside is valid, so
  // no per-row mask is needed; a split outside it reads nothing.
  int lo = si * split;
  const int hi = min(min(lo + split, t_len), pos + 1);
  if (window > 0) lo = max(lo, pos - window + 1);

  const size_t row = (size_t)kv * dh;
  const T* kb = k + (size_t)b * t_len * row + (size_t)kvh * dh + d0;
  const T* vb = v + (size_t)b * t_len * row + (size_t)kvh * dh + d0;

  // warp w takes rows lo + w, lo + w + 4, ...; kRows of them per batch
  for (int r0 = lo + warp; r0 < hi; r0 += kWarps * kRows) {
    float kf[kRows][kVec], vf[kRows][kVec];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + u * kWarps;
      if (r < hi && lane_on) {
        load_vec(kb + (size_t)r * row, kf[u]);
        load_vec(vb + (size_t)r * row, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (r0 + u * kWarps >= hi) break;  // warp-uniform
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g >= g_n) break;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) s += qr[g][i] * kf[u][i];
        s = warp_sum(s) * scale;  // every lane holds the score
        if (softcap != 0.f) s = softcap * tanhf(s / softcap);
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);  // 0 before the first row
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[g][i] = acc[g][i] * alpha + p * vf[u][i];
      }
    }
  }

  // merge the four warps' running states, then normalise
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
    if (lane_on) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) s_acc[warp][g][d0 + i] = acc[g][i];
    }
  }
  __syncthreads();
  const size_t part_idx = (size_t)bh * n_splits + si;
  for (int e = tid; e < g_n * dh; e += kThreads) {
    const int g = e / dh;
    const int d = e - g * dh;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float den = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][g] - mx);  // a warp with no rows: l = 0, acc = 0
      den += s_l[w][g] * c;
      o += s_acc[w][g][d] * c;
    }
    o_part[part_idx * g_n * dh + e] = o / fmaxf(den, kTiny);
    if (d == 0) lse_part[part_idx * g_n + g] = den > 0.f ? mx + logf(fmaxf(den, kTiny)) : kNeg;
  }
}

// Stage 2: the log-sum-exp merge of the splits. grid (ceil(G * Dh / 256),
// B * KV), one thread per (g, d) element. Empty splits carry lse = NEG and
// weigh exp(NEG - m) = 0; a row with no valid split gives zeros.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ o_part, const float* __restrict__ lse_part,
             T* __restrict__ out, int n_splits, int g_n, int dh) {
  const int bh = blockIdx.y;
  const int width = g_n * dh;
  const int e = blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= width) return;
  const int g = e / dh;
  const float* lse_b = lse_part + (size_t)bh * n_splits * g_n + g;
  const float* o_b = o_part + (size_t)bh * n_splits * width + e;
  float m = kNeg;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, lse_b[s * g_n]);
  float denom = 0.f;
  float o = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(lse_b[s * g_n] - m);
    denom += w;
    o += w * o_b[(size_t)s * width];
  }
  out[(size_t)bh * width + e] = from_f32<T>(o / fmaxf(denom, kTiny));
}

template <typename T, int kG>
void launch_g(const void* q, const void* k, const void* v, const int* q_pos, float* o_part,
              float* lse_part, int b, int t_len, int kv, int g_n, int dh, int n_splits,
              int split, int window, float softcap, float scale, cudaStream_t stream) {
  decode_split_kernel<T, kG><<<dim3(n_splits, b * kv), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      o_part, lse_part, t_len, kv, g_n, dh, n_splits, split, window, softcap, scale);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* q_pos, float* o_part,
            float* lse_part, void* out, int b, int t_len, int kv, int g_n, int dh,
            int n_splits, int split, int window, float softcap, float scale,
            cudaStream_t stream) {
  if (g_n <= 1) {
    launch_g<T, 1>(q, k, v, q_pos, o_part, lse_part, b, t_len, kv, g_n, dh, n_splits, split,
                   window, softcap, scale, stream);
  } else if (g_n <= 2) {
    launch_g<T, 2>(q, k, v, q_pos, o_part, lse_part, b, t_len, kv, g_n, dh, n_splits, split,
                   window, softcap, scale, stream);
  } else if (g_n <= 4) {
    launch_g<T, 4>(q, k, v, q_pos, o_part, lse_part, b, t_len, kv, g_n, dh, n_splits, split,
                   window, softcap, scale, stream);
  } else {
    launch_g<T, 8>(q, k, v, q_pos, o_part, lse_part, b, t_len, kv, g_n, dh, n_splits, split,
                   window, softcap, scale, stream);
  }
  const dim3 grid((g_n * dh + kMergeThreads - 1) / kMergeThreads, b * kv);
  merge_kernel<T><<<grid, kMergeThreads, 0, stream>>>(o_part, lse_part, static_cast<T*>(out),
                                                      n_splits, g_n, dh);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q (B, 1, KV * G, Dh),
// k and v (B, T, KV, Dh), q_pos (B,) int32, out like q; o_part
// (B * KV, n_splits, G, Dh) and lse_part (B * KV, n_splits, G) float32
// scratch. All contiguous on one device, 16-byte aligned, G <= 8,
// Dh <= 256 and a multiple of 8. Returns cudaGetLastError().
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* q_pos, void* o_part, void* lse_part, void* out,
                                   int b, int t_len, int kv, int g_n, int dh, int n_splits,
                                   int split, int window, float softcap, float scale, int dtype,
                                   void* stream) {
  if (b < 1 || kv < 1 || g_n < 1 || g_n > 8 || dh < kVec || dh > kMaxDh || dh % kVec ||
      n_splits < 1 || split < 0 || t_len < 0 || (long long)split * n_splits < t_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* pos = static_cast<const int*>(q_pos);
  float* op = static_cast<float*>(o_part);
  float* lp = static_cast<float*>(lse_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(q, k, v, pos, op, lp, out, b, t_len, kv, g_n, dh, n_splits, split, window,
                    softcap, scale, st);
      break;
    case 1:
      launch<__nv_bfloat16>(q, k, v, pos, op, lp, out, b, t_len, kv, g_n, dh, n_splits, split,
                            window, softcap, scale, st);
      break;
    case 2:
      launch<__half>(q, k, v, pos, op, lp, out, b, t_len, kv, g_n, dh, n_splits, split, window,
                     softcap, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
