// Blockwise online-softmax GQA attention, training forward, for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/flash_attn.py::_fwd_kernel (the Pallas body
// of _fwd_impl, reached through flash_attention). What it computes, for
// each lane b, KV head h, query head g of the group and query s:
//   x[t]  = softcap(q[b,s,h,g] . k[b,t,h] / sqrt(Dh))          in f32
//   valid = the Pallas _tile_mask (positions >= 0, causal, window)
//   out   = sum_t softmax(x)[t] v[b,t,h]   (zeros for a fully masked row)
//   lse   = log sum_t exp(x[t])            (NEG = -1e30 for a masked row)
// out is written in the input dtype, lse in f32 for the backward.
//
// What bounds it on this card: at the bert-base shape (B 48, S = T 128,
// H = KV 12, Dh 64, bf16) a layer reads q, k, v and writes out and lse,
// 38 MB, for 2.4 GFLOP: 64 operations per byte, under the card's 295, so
// the 3.35 TB/s set the bound (11 us). This first kernel runs its
// products on the CUDA cores in f32, as the TPU kernel does on f32 copies
// of its tiles: exact against the plain version, but far from that bound.
// Tensor cores are later work.
//
// What the design does:
//  * one block per (query tile, lane * KV head) holds that tile's rows for
//    all G query heads of the group, so each K/V tile read serves G heads;
//  * K/V tiles of 32 keys are staged in shared memory as f32 (rows padded
//    to Dh + 1 floats, so a warp reading 32 keys' same element hits 32
//    banks); lane j scores key j against each of its warp's rows, with the
//    rows' queries read as float4 broadcasts;
//  * each row's running max, sum and output stay in registers across the
//    whole KV loop (kDV = ceil(Dh/32) elements per lane), and the
//    probabilities go through shared memory to the P.V product;
//  * q, k, v, out are read and written in place in the model's layouts,
//    with ragged S and T handled by bounds checks: no transpose or padding
//    copies around the kernel.

#include "attn_common.cuh"

namespace {

using namespace attn;

template <typename T, int kDV>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ q_pos, const int* __restrict__ kv_pos, T* __restrict__ out,
           float* __restrict__ lse, int s_len, int t_len, int kv, int g_n, int dh, int bq,
           bool causal, int window, float softcap, float scale) {
  constexpr int kRW = Shape<kDV>::kRW;
  constexpr int kRows = Shape<kDV>::kRows;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kstride = dh + 1;
  float* qs = smem;                   // kRows x dh
  float* ks = qs + kRows * dh;        // kTile x (dh + 1)
  float* vs = ks + kTile * kstride;   // kTile x (dh + 1)
  float* ps = vs + kTile * kstride;   // kRows x kTile

  const int bh = blockIdx.y;
  const int b = bh / kv;
  const int kvh = bh - b * kv;
  const int h_n = kv * g_n;
  const int s0 = blockIdx.x * bq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // block row r: query head g = r / bq of the group, query s0 + r % bq
  auto q_off = [&](int r) -> long long {
    const int g = r / bq;
    const int sq = s0 + r - g * bq;
    if (g >= g_n || sq >= s_len) return -1;
    return (((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g) * dh;
  };
  load_rows(qs, dh, q, kRows, dh, q_off);

  int qp[kRW];
  float m[kRW], l[kRW], acc[kRW][kDV];
#pragma unroll
  for (int u = 0; u < kRW; ++u) {
    const int r = warp * kRW + u;
    const int g = r / bq;
    const int sq = s0 + r - g * bq;
    qp[u] = (g < g_n && sq < s_len) ? q_pos[(long long)b * s_len + sq] : -1;
    m[u] = kNeg;
    l[u] = 0.f;
#pragma unroll
    for (int i = 0; i < kDV; ++i) acc[u][i] = 0.f;
  }

  const long long t_stride = (long long)kv * dh;
  for (int t0 = 0; t0 < t_len; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is loaded)
    auto kv_off = [&](int j) -> long long {
      const int t = t0 + j;
      return t < t_len ? ((long long)b * t_len + t) * t_stride + (long long)kvh * dh : -1;
    };
    load_rows(ks, kstride, k, kTile, dh, kv_off);
    load_rows(vs, kstride, v, kTile, dh, kv_off);
    __syncthreads();

    const int t = t0 + lane;
    const int kp = t < t_len ? kv_pos[t] : -1;
    float s[kRW];
#pragma unroll
    for (int u = 0; u < kRW; ++u) s[u] = 0.f;
    const float* kr = ks + lane * kstride;
    for (int d = 0; d < dh; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
      for (int u = 0; u < kRW; ++u) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (warp * kRW + u) * dh + d);
        s[u] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
      }
    }
#pragma unroll
    for (int u = 0; u < kRW; ++u) {
      float x = s[u] * scale;
      if (softcap != 0.f) x = softcap * tanhf(x / softcap);
      const bool ok = tile_valid(qp[u], kp, causal, window);
      x = ok ? x : kNeg;
      const float m_new = fmaxf(m[u], warp_max(x));
      const float p = ok ? expf(x - m_new) : 0.f;
      const float alpha = m[u] <= kNeg ? 0.f : expf(fminf(m[u] - m_new, 0.f));
      l[u] = l[u] * alpha + warp_sum(p);
      m[u] = m_new;
      ps[(warp * kRW + u) * kTile + lane] = p;
#pragma unroll
      for (int i = 0; i < kDV; ++i) acc[u][i] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < kTile; j += 4) {
      float vv[4][kDV];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < kDV; ++i) {
          const int d = lane + 32 * i;
          vv[jj][i] = d < dh ? vs[(j + jj) * kstride + d] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kRW; ++u) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + (warp * kRW + u) * kTile + j);
#pragma unroll
        for (int i = 0; i < kDV; ++i) {
          acc[u][i] += p4.x * vv[0][i] + p4.y * vv[1][i] + p4.z * vv[2][i] + p4.w * vv[3][i];
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kRW; ++u) {
    const int r = warp * kRW + u;
    const int g = r / bq;
    const int sq = s0 + r - g * bq;
    if (g >= g_n || sq >= s_len) continue;
    const long long o = (((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g) * dh;
    const float den = fmaxf(l[u], kTiny);
#pragma unroll
    for (int i = 0; i < kDV; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) out[o + d] = from_f32<T>(acc[u][i] / den);
    }
    if (lane == 0) {
      lse[((long long)bh * g_n + g) * s_len + sq] = l[u] > 0.f ? m[u] + logf(den) : kNeg;
    }
  }
}

template <typename T, int kDV>
int launch(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
           void* out, float* lse, int b, int s_len, int t_len, int kv, int g_n, int dh,
           int causal, int window, float softcap, float scale, cudaStream_t stream) {
  constexpr int kRows = Shape<kDV>::kRows;
  const int bq = kRows / g_n;
  const size_t smem = sizeof(float) * ((size_t)kRows * dh + 2 * (size_t)kTile * (dh + 1) +
                                       (size_t)kRows * kTile);
  auto kern = fwd_kernel<T, kDV>;
  cudaError_t err = allow_smem<fwd_kernel<T, kDV>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_len + bq - 1) / bq, b * kv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      kv_pos, static_cast<T*>(out), lse, s_len, t_len, kv, g_n, dh, bq, causal != 0, window,
      softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
              void* out, float* lse, int b, int s_len, int t_len, int kv, int g_n, int dh,
              int causal, int window, float softcap, float scale, cudaStream_t stream) {
  if (dh <= 32) {
    return launch<T, 1>(q, k, v, q_pos, kv_pos, out, lse, b, s_len, t_len, kv, g_n, dh, causal,
                        window, softcap, scale, stream);
  } else if (dh <= 64) {
    return launch<T, 2>(q, k, v, q_pos, kv_pos, out, lse, b, s_len, t_len, kv, g_n, dh, causal,
                        window, softcap, scale, stream);
  } else if (dh <= 128) {
    return launch<T, 4>(q, k, v, q_pos, kv_pos, out, lse, b, s_len, t_len, kv, g_n, dh, causal,
                        window, softcap, scale, stream);
  }
  return launch<T, 8>(q, k, v, q_pos, kv_pos, out, lse, b, s_len, t_len, kv, g_n, dh, causal,
                      window, softcap, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q (B, S, KV * G, Dh),
// k and v (B, T, KV, Dh), out like q; q_pos (B, S) and kv_pos (T,) int32;
// lse (B * KV, G, S) float32. All contiguous on one device, G <= 8,
// Dh a multiple of 8 up to 256, B * KV <= 65535. window > 0 engages the
// sliding window (the caller gates it per layer). Returns the CUDA error
// of the launch (0 on success).
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                                     const void* q_pos, const void* kv_pos, void* out, void* lse,
                                     int b, int s_len, int t_len, int kv, int g_n, int dh,
                                     int causal, int window, float softcap, float scale,
                                     int dtype, void* stream) {
  if (b < 1 || s_len < 1 || t_len < 1 || kv < 1 || g_n < 1 || g_n > attn::kMaxGroup ||
      dh < 8 || dh > attn::kMaxDh || dh % 8 || (long long)b * kv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dh<float>(q, k, v, qp, kp, out, ls, b, s_len, t_len, kv, g_n, dh, causal,
                              window, softcap, scale, st);
    case 1:
      return launch_dh<__nv_bfloat16>(q, k, v, qp, kp, out, ls, b, s_len, t_len, kv, g_n, dh,
                                      causal, window, softcap, scale, st);
    case 2:
      return launch_dh<__half>(q, k, v, qp, kp, out, ls, b, s_len, t_len, kv, g_n, dh, causal,
                               window, softcap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
