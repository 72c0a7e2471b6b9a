// Blockwise GQA attention, training backward, for Hopper (sm_90a): two
// kernels that recompute the probabilities from the forward's lse.
//
// Replaces src/repro/kernels/flash_attn.py::_dq_kernel and ::_dkv_kernel
// (the Pallas bodies of _bwd_impl, the custom VJP of flash_attention).
// Both recompute, per (query, key) pair, as the Pallas _bwd_tile does:
//   r     = q . k / sqrt(Dh)                                  in f32
//   x     = softcap tanh(r / softcap), dcap = 1 - tanh^2   (or x = r, 1)
//   p     = valid ? exp(x - lse) : 0       (lse = NEG: a masked row, p = 0)
//   ds    = p (dO . v - delta) dcap / sqrt(Dh),  delta = rowsum(dO * out)
// and accumulate dq = sum_t ds k (flash_attn_dq_launch) and
// dk = sum_{s,g} ds q, dv = sum_{s,g} p dO (flash_attn_dkv_launch). delta
// comes in from the caller (the JAX code computes it outside the kernel
// too). Neither kernel uses atomics: every output element is summed by one
// thread in a fixed order, so the gradients are the same from run to run.
//
// What bounds them on this card: at the bert-base shape (B 48, S = T 128,
// H = KV 12, Dh 64, bf16) the two together read q, k, v, dO, lse, delta
// and write dq, dk, dv, 66 MB, for 6.0 GFLOP (two products to recompute
// p and dp, three to form the gradients): 91 operations per byte, so the
// 3.35 TB/s set the bound (20 us). As in the forward, this first version
// runs the products on the CUDA cores in f32, exact against the plain
// version and far from that bound.
//
// What the design does:
//  * dq: one block per (query tile, lane * KV head) with all G heads'
//    rows of the tile, like the forward; lane j takes key j of each
//    32-key tile staged in shared memory;
//  * dk/dv: one block per (key tile, lane * KV head); it walks every
//    query tile of every head g of the group, so the sum over the group
//    happens inside the block; lane j takes query j of each 32-query tile;
//  * the per-row gradient accumulators stay in registers over the whole
//    loop, ds and p go through shared memory to the accumulating product,
//    and the tensors are read in place in the model's layouts.

#include "attn_common.cuh"

namespace {

using namespace attn;

__device__ __forceinline__ void recompute(float raw, float softcap, float& x, float& dcap) {
  if (softcap != 0.f) {
    const float tt = tanhf(raw / softcap);
    x = softcap * tt;
    dcap = 1.f - tt * tt;
  } else {
    x = raw;
    dcap = 1.f;
  }
}

// grid (query tiles, B * KV). Rows of a block as in the forward.
template <typename T, int kDV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const int* __restrict__ q_pos,
          const int* __restrict__ kv_pos, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int s_len, int t_len, int kv,
          int g_n, int dh, int bq, bool causal, int window, float softcap, float scale) {
  constexpr int kRW = Shape<kDV>::kRW;
  constexpr int kRows = Shape<kDV>::kRows;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kstride = dh + 1;
  float* qs = smem;                   // kRows x dh
  float* os = qs + kRows * dh;        // kRows x dh   (dO)
  float* ks = os + kRows * dh;        // kTile x (dh + 1)
  float* vs = ks + kTile * kstride;   // kTile x (dh + 1)
  float* dss = vs + kTile * kstride;  // kRows x kTile

  const int bh = blockIdx.y;
  const int b = bh / kv;
  const int kvh = bh - b * kv;
  const int h_n = kv * g_n;
  const int s0 = blockIdx.x * bq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  auto q_off = [&](int r) -> long long {
    const int g = r / bq;
    const int sq = s0 + r - g * bq;
    if (g >= g_n || sq >= s_len) return -1;
    return (((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g) * dh;
  };
  load_rows(qs, dh, q, kRows, dh, q_off);
  load_rows(os, dh, dout, kRows, dh, q_off);

  int qp[kRW];
  float lse_r[kRW], delta_r[kRW], acc[kRW][kDV];
#pragma unroll
  for (int u = 0; u < kRW; ++u) {
    const int r = warp * kRW + u;
    const int g = r / bq;
    const int sq = s0 + r - g * bq;
    const bool on = g < g_n && sq < s_len;
    qp[u] = on ? q_pos[(long long)b * s_len + sq] : -1;
    const float ls = on ? lse[((long long)bh * g_n + g) * s_len + sq] : 0.f;
    lse_r[u] = ls <= kNeg ? 0.f : ls;
    delta_r[u] = on ? delta[((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g] : 0.f;
#pragma unroll
    for (int i = 0; i < kDV; ++i) acc[u][i] = 0.f;
  }

  const long long t_stride = (long long)kv * dh;
  for (int t0 = 0; t0 < t_len; t0 += kTile) {
    __syncthreads();
    auto kv_off = [&](int j) -> long long {
      const int t = t0 + j;
      return t < t_len ? ((long long)b * t_len + t) * t_stride + (long long)kvh * dh : -1;
    };
    load_rows(ks, kstride, k, kTile, dh, kv_off);
    load_rows(vs, kstride, v, kTile, dh, kv_off);
    __syncthreads();

    const int t = t0 + lane;
    const int kp = t < t_len ? kv_pos[t] : -1;
    float s[kRW], dp[kRW];
#pragma unroll
    for (int u = 0; u < kRW; ++u) s[u] = dp[u] = 0.f;
    const float* kr = ks + lane * kstride;
    const float* vr = vs + lane * kstride;
    for (int d = 0; d < dh; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
      const float v0 = vr[d], v1 = vr[d + 1], v2 = vr[d + 2], v3 = vr[d + 3];
#pragma unroll
      for (int u = 0; u < kRW; ++u) {
        const int r = warp * kRW + u;
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * dh + d);
        const float4 ov = *reinterpret_cast<const float4*>(os + r * dh + d);
        s[u] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
        dp[u] += ov.x * v0 + ov.y * v1 + ov.z * v2 + ov.w * v3;
      }
    }
#pragma unroll
    for (int u = 0; u < kRW; ++u) {
      float x, dcap;
      recompute(s[u] * scale, softcap, x, dcap);
      const bool ok = tile_valid(qp[u], kp, causal, window);
      const float p = ok ? expf(x - lse_r[u]) : 0.f;
      dss[(warp * kRW + u) * kTile + lane] = p * (dp[u] - delta_r[u]) * dcap * scale;
    }
    __syncwarp();
    for (int j = 0; j < kTile; j += 4) {
      float kk[4][kDV];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < kDV; ++i) {
          const int d = lane + 32 * i;
          kk[jj][i] = d < dh ? ks[(j + jj) * kstride + d] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kRW; ++u) {
        const float4 d4 = *reinterpret_cast<const float4*>(dss + (warp * kRW + u) * kTile + j);
#pragma unroll
        for (int i = 0; i < kDV; ++i) {
          acc[u][i] += d4.x * kk[0][i] + d4.y * kk[1][i] + d4.z * kk[2][i] + d4.w * kk[3][i];
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kRW; ++u) {
    const long long o = q_off(warp * kRW + u);
    if (o < 0) continue;
#pragma unroll
    for (int i = 0; i < kDV; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) dq[o + d] = from_f32<T>(acc[u][i]);
    }
  }
}

// grid (key tiles of kRows keys, B * KV). Row r of a block is key t0 + r.
template <typename T, int kDV>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const int* __restrict__ q_pos,
           const int* __restrict__ kv_pos, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int s_len,
           int t_len, int kv, int g_n, int dh, bool causal, int window, float softcap,
           float scale) {
  constexpr int kRW = Shape<kDV>::kRW;
  constexpr int kRows = Shape<kDV>::kRows;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kstride = dh + 1;
  float* kr_s = smem;                 // kRows x dh  (this block's keys)
  float* vr_s = kr_s + kRows * dh;    // kRows x dh
  float* qt = vr_s + kRows * dh;      // kTile x (dh + 1)
  float* ot = qt + kTile * kstride;   // kTile x (dh + 1)  (dO)
  float* ps = ot + kTile * kstride;   // kRows x kTile
  float* dss = ps + kRows * kTile;    // kRows x kTile

  const int bh = blockIdx.y;
  const int b = bh / kv;
  const int kvh = bh - b * kv;
  const int h_n = kv * g_n;
  const int t0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const long long t_stride = (long long)kv * dh;
  auto k_off = [&](int r) -> long long {
    const int t = t0 + r;
    return t < t_len ? ((long long)b * t_len + t) * t_stride + (long long)kvh * dh : -1;
  };
  load_rows(kr_s, dh, k, kRows, dh, k_off);
  load_rows(vr_s, dh, v, kRows, dh, k_off);

  int kp[kRW];
  float dk_acc[kRW][kDV], dv_acc[kRW][kDV];
#pragma unroll
  for (int u = 0; u < kRW; ++u) {
    const int t = t0 + warp * kRW + u;
    kp[u] = t < t_len ? kv_pos[t] : -1;
#pragma unroll
    for (int i = 0; i < kDV; ++i) dk_acc[u][i] = dv_acc[u][i] = 0.f;
  }

  for (int g = 0; g < g_n; ++g) {
    for (int q0 = 0; q0 < s_len; q0 += kTile) {
      __syncthreads();
      auto q_off = [&](int j) -> long long {
        const int sq = q0 + j;
        return sq < s_len ? (((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g) * dh
                          : -1;
      };
      load_rows(qt, kstride, q, kTile, dh, q_off);
      load_rows(ot, kstride, dout, kTile, dh, q_off);
      __syncthreads();

      const int sq = q0 + lane;
      const bool on = sq < s_len;
      const int qp = on ? q_pos[(long long)b * s_len + sq] : -1;
      const float ls = on ? lse[((long long)bh * g_n + g) * s_len + sq] : 0.f;
      const float lse_j = ls <= kNeg ? 0.f : ls;
      const float delta_j =
          on ? delta[((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g] : 0.f;

      float s[kRW], dp[kRW];
#pragma unroll
      for (int u = 0; u < kRW; ++u) s[u] = dp[u] = 0.f;
      const float* qr = qt + lane * kstride;
      const float* orow = ot + lane * kstride;
      for (int d = 0; d < dh; d += 4) {
        const float q0v = qr[d], q1v = qr[d + 1], q2v = qr[d + 2], q3v = qr[d + 3];
        const float o0 = orow[d], o1 = orow[d + 1], o2 = orow[d + 2], o3 = orow[d + 3];
#pragma unroll
        for (int u = 0; u < kRW; ++u) {
          const int r = warp * kRW + u;
          const float4 kv4 = *reinterpret_cast<const float4*>(kr_s + r * dh + d);
          const float4 vv4 = *reinterpret_cast<const float4*>(vr_s + r * dh + d);
          s[u] += kv4.x * q0v + kv4.y * q1v + kv4.z * q2v + kv4.w * q3v;
          dp[u] += vv4.x * o0 + vv4.y * o1 + vv4.z * o2 + vv4.w * o3;
        }
      }
#pragma unroll
      for (int u = 0; u < kRW; ++u) {
        float x, dcap;
        recompute(s[u] * scale, softcap, x, dcap);
        const bool ok = tile_valid(qp, kp[u], causal, window);
        const float p = ok ? expf(x - lse_j) : 0.f;
        const int r = warp * kRW + u;
        ps[r * kTile + lane] = p;
        dss[r * kTile + lane] = p * (dp[u] - delta_j) * dcap * scale;
      }
      __syncwarp();
      for (int j = 0; j < kTile; j += 4) {
        float qq[4][kDV], oo[4][kDV];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int i = 0; i < kDV; ++i) {
            const int d = lane + 32 * i;
            qq[jj][i] = d < dh ? qt[(j + jj) * kstride + d] : 0.f;
            oo[jj][i] = d < dh ? ot[(j + jj) * kstride + d] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRW; ++u) {
          const int r = warp * kRW + u;
          const float4 p4 = *reinterpret_cast<const float4*>(ps + r * kTile + j);
          const float4 d4 = *reinterpret_cast<const float4*>(dss + r * kTile + j);
#pragma unroll
          for (int i = 0; i < kDV; ++i) {
            dv_acc[u][i] += p4.x * oo[0][i] + p4.y * oo[1][i] + p4.z * oo[2][i] + p4.w * oo[3][i];
            dk_acc[u][i] += d4.x * qq[0][i] + d4.y * qq[1][i] + d4.z * qq[2][i] + d4.w * qq[3][i];
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kRW; ++u) {
    const long long o = k_off(warp * kRW + u);
    if (o < 0) continue;
#pragma unroll
    for (int i = 0; i < kDV; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) {
        dk[o + d] = from_f32<T>(dk_acc[u][i]);
        dv[o + d] = from_f32<T>(dv_acc[u][i]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const int *q_pos, *kv_pos;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int b, s_len, t_len, kv, g_n, dh, causal, window;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int kDV>
int launch_dq(const Args& a) {
  constexpr int kRows = Shape<kDV>::kRows;
  const int bq = kRows / a.g_n;
  const size_t smem = sizeof(float) * (2 * (size_t)kRows * a.dh + 2 * (size_t)kTile * (a.dh + 1) +
                                       (size_t)kRows * kTile);
  auto kern = dq_kernel<T, kDV>;
  cudaError_t err = allow_smem<dq_kernel<T, kDV>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.s_len + bq - 1) / bq, a.b * a.kv);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.q_pos, a.kv_pos, a.lse, a.delta, static_cast<T*>(a.dq),
      a.s_len, a.t_len, a.kv, a.g_n, a.dh, bq, a.causal != 0, a.window, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDV>
int launch_dkv(const Args& a) {
  constexpr int kRows = Shape<kDV>::kRows;
  const size_t smem = sizeof(float) * (2 * (size_t)kRows * a.dh + 2 * (size_t)kTile * (a.dh + 1) +
                                       2 * (size_t)kRows * kTile);
  auto kern = dkv_kernel<T, kDV>;
  cudaError_t err = allow_smem<dkv_kernel<T, kDV>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.t_len + kRows - 1) / kRows, a.b * a.kv);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.q_pos, a.kv_pos, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.s_len, a.t_len, a.kv, a.g_n, a.dh, a.causal != 0, a.window,
      a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDq>
int launch_dh(const Args& a) {
  if (a.dh <= 32) return kDq ? launch_dq<T, 1>(a) : launch_dkv<T, 1>(a);
  if (a.dh <= 64) return kDq ? launch_dq<T, 2>(a) : launch_dkv<T, 2>(a);
  if (a.dh <= 128) return kDq ? launch_dq<T, 4>(a) : launch_dkv<T, 4>(a);
  return kDq ? launch_dq<T, 8>(a) : launch_dkv<T, 8>(a);
}

template <bool kDq>
int launch_dtype(const Args& a, int dtype) {
  if (a.b < 1 || a.s_len < 1 || a.t_len < 1 || a.kv < 1 || a.g_n < 1 || a.g_n > kMaxGroup ||
      a.dh < 8 || a.dh > kMaxDh || a.dh % 8 || (long long)a.b * a.kv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0: return launch_dh<float, kDq>(a);
    case 1: return launch_dh<__nv_bfloat16, kDq>(a);
    case 2: return launch_dh<__half, kDq>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Layouts as in flash_attn_fwd_launch; dout like q, lse (B * KV, G, S)
// float32 from the forward, delta (B, S, KV * G) float32. dq like q;
// dk and dv like k. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attn_dq_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* q_pos, const void* kv_pos,
                                    const void* lse, const void* delta, void* dq, int b,
                                    int s_len, int t_len, int kv, int g_n, int dh, int causal,
                                    int window, float softcap, float scale, int dtype,
                                    void* stream) {
  const Args a{q, k, v, dout, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
               static_cast<const float*>(lse), static_cast<const float*>(delta), dq, nullptr,
               nullptr, b, s_len, t_len, kv, g_n, dh, causal, window, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_dtype<true>(a, dtype);
}

extern "C" int flash_attn_dkv_launch(const void* q, const void* k, const void* v,
                                     const void* dout, const void* q_pos, const void* kv_pos,
                                     const void* lse, const void* delta, void* dk, void* dv,
                                     int b, int s_len, int t_len, int kv, int g_n, int dh,
                                     int causal, int window, float softcap, float scale,
                                     int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
               static_cast<const float*>(lse), static_cast<const float*>(delta), nullptr, dk,
               dv, b, s_len, t_len, kv, g_n, dh, causal, window, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_dtype<false>(a, dtype);
}
