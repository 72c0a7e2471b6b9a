// Shared pieces of the blockwise training attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): dtype conversions, warp
// reductions, the tile mask and the block shape.
//
// Layouts, as the model holds them (no transposes or padding copies):
//   q, out, dO (B, S, H, Dh), k, v (B, T, KV, Dh), H = KV * G
//   q_pos (B, S) int32, kv_pos (T,) int32 (-1 marks padding)
//   lse (B * KV, G, S) f32, delta (B, S, H) f32
// The CUDA-core kernels (the f32 forward, dq and dk/dv) work in
// f32 on f32 copies of their tiles in shared memory; the tensor-core
// kernels' pieces are in attn_mma.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace attn {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // keys (forward, dq) or queries (dk/dv) per tile: one per lane
constexpr float kNeg = -1e30f;
constexpr float kTiny = 1e-30f;
constexpr int kMaxDh = 256;
constexpr int kMaxGroup = 8;

// The shapes the training kernels take (flash_attn._check_attention
// checks the same before a launch).
inline bool shape_ok(int b, int s_len, int t_len, int kv, int g_n, int dh) {
  return b >= 1 && s_len >= 1 && t_len >= 1 && kv >= 1 && g_n >= 1 && g_n <= kMaxGroup &&
         dh >= 8 && dh <= kMaxDh && dh % 8 == 0 && (long long)b * kv <= 65535;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The Pallas kernel's _tile_mask: padding (position < 0) on either side,
// optional causality, and the sliding window when the caller engaged it
// (window > 0 only on local layers).
__device__ __forceinline__ bool tile_valid(int qp, int kp, bool causal, int window) {
  bool ok = kp >= 0 && qp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// Per-row work per lane: kDV = ceil(Dh / 32) head-dim elements, lane owns
// d = lane + 32 i. Rows per warp kRW = 16 / kDV keeps the per-row state in
// registers at every head dim; a block holds kRows = 4 * kRW rows.
template <int kDV>
struct Shape {
  static constexpr int kRW = 16 / kDV;
  static constexpr int kRows = kWarps * kRW;
};

// Copy a (rows, dh) slab of a strided tensor into shared memory as f32.
// Row r starts at src + row_off(r) (elements); rows with row_off < 0 are
// zero. dst rows are `stride` floats apart.
template <typename T, typename RowOff>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* __restrict__ src,
                                          int rows, int dh, RowOff row_off) {
  for (int e = threadIdx.x; e < rows * dh; e += kThreads) {
    const int r = e / dh;
    const int d = e - r * dh;
    const long long off = row_off(r);
    dst[r * stride + d] = off >= 0 ? to_f32(src[off + d]) : 0.f;
  }
}

// Raise a kernel's dynamic shared-memory limit to `bytes` (above 48 KB it
// must be asked for). Done once per kernel and size, not at every launch,
// so a launch inside a CUDA-graph capture makes no such call. The kernel is
// a template argument, so each kernel has its own record of what it got.
template <auto Kern>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace attn
