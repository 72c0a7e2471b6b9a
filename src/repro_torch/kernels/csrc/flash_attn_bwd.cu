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
// What bounds them on this card:
//  * bert-base (B 48, S = T 128, H = KV 12, Dh 64, bf16): dq reads q, k,
//    v, dO, lse, delta and writes dq, 47 MB, for 3.6 GFLOP (three
//    products): the 3.35 TB/s set its bound (14 us); dk/dv, 57 MB for 4.8
//    GFLOP, likewise (17 us);
//  * gemma3-1b (B 4, S = T 1024, H 4 over KV 1, Dh 256, causal, window 512
//    on 5 of 6 layers): dq does 12.9 GFLOP of valid pairs on a global
//    layer for 7 MB, so the 989 TFLOP/s of bf16 set its bound (13 us);
//    dk/dv 17.2 GFLOP (four products), likewise (17 us).
//
// Routes, chosen by dtype (each dtype has exactly one):
//  * dq in bf16 and f16: dq_tc_kernel, on the tensor cores. A block owns
//    one (lane, KV head) and 64 (query, head) rows as in the forward
//    (flash_attn_fwd.cu); Q and dO stay in shared memory for the whole
//    block, lse and delta of each thread's two rows in registers, and K
//    and V tiles (16 keys at Dh 256, 32 at Dh 128, 64 below) stream in by
//    double-buffered 16-byte cp.async. Per tile, S = Q.K^T and dP = dO.V^T
//    run on the tensor cores (exact products, f32 sums); p = exp(x - lse)
//    and dS = p (dP - delta) dcap scale are formed in f32 on the
//    accumulator registers, which are then the A operand of dQ += dS.K
//    (K through ldmatrix.trans) as two 2-byte terms (hi and the rounded
//    remainder, 16 bits of dS: the gradients' tolerance is 5e-5 + 1e-4
//    relative). dQ stays in registers and is rounded once. The key tiles
//    the causal mask, the window or padding leave empty are skipped, and
//    full ones skip the elementwise mask (attn_mma.cuh);
//  * dk/dv in bf16 and f16: dkv_tc_kernel, the same products from the key
//    side. A block owns one key tile of a (lane, KV head): 64 keys up to
//    Dh 64, 32 above (128 blocks at gemma3-1b, one per SM), earliest first
//    since causal query tiles reach them most; K and V stay in shared
//    memory, and the live query tiles (64 (query, head) rows each, all G
//    heads of a query, so the sum over the group stays in the block) stream
//    in with their lse and delta by double-buffered cp.async. Per tile,
//    S^T = K.Q^T and dP^T = V.dO^T on the tensor cores, P^T and dS^T in f32
//    on the accumulators, then dV += P^T.dO and dK += dS^T.Q with P^T and
//    dS^T as two 2-byte terms each. dK and dV take 2 x 16 keys x Dh f32,
//    which at Dh 256 no warp can hold: there eight warps split the
//    columns (64 each, 64 registers per thread for both), compute S^T and
//    dP^T once, split by query rows, and swap P^T and dS^T through shared
//    memory (read back by ldmatrix); up to Dh 64 each warp owns 16 keys
//    by all of Dh and feeds the products from its registers. Full tiles run
//    a body compiled without the mask; no tile's query range is split, so
//    at the global layer the block of the first keys walks all 64 query
//    tiles while the mean block walks 33;
//  * dq and dk/dv in f32: the first design, on the CUDA cores in f32
//    (exact against the plain version): one block per (tile, lane * KV
//    head) with all G heads of a group, lane j taking key (dq) or query
//    (dk/dv) j of each 32-row tile staged in shared memory as f32; dk/dv
//    walks every query tile of every head g of the group, so the sum over
//    the group happens inside the block. The per-row gradient accumulators
//    stay in registers, ds and p go through shared memory to the
//    accumulating product, and the tensors are read in place in the
//    model's layouts.

#include "attn_mma.cuh"

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


// ---------------------------------------------------------------------------
// dq in bf16 / f16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kSplitDq = 2;  // 2-byte terms of dS in dS.K

template <typename T, int kD, int kBK>
struct DqTc {
  static constexpr int kLd = kD + tc::kPad;
  static constexpr size_t kSmem = sizeof(T) * (size_t)(2 * tc::kM + 4 * kBK) * kLd;
};

// grid: B * KV * (query tiles) blocks (tc::block_rows).
template <typename T, int kD, int kBK>
__global__ void __launch_bounds__(kThreads)
dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const int* __restrict__ q_pos,
             const int* __restrict__ kv_pos, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, int s_len, int t_len, int kv,
             int g_n, int dh, int bq, int n_bh, int n_qt, bool causal, int window,
             float softcap, float scale) {
  using namespace tc;
  using M = Mma<T>;
  constexpr int kLd = DqTc<T, kD, kBK>::kLd;
  constexpr int kN = kBK / 8;  // n8 tiles of scores per warp
  constexpr int kO = kD / 8;   // n8 tiles of dq per warp
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);  // kM x kLd
  T* os = qs + kM * kLd;                // kM x kLd (dO)
  T* ks = os + kM * kLd;                // 2 x kBK x kLd
  T* vs = ks + 2 * kBK * kLd;           // 2 x kBK x kLd

  const BlockRows blk = block_rows(n_bh, n_qt, bq);
  const int bh = blk.bh, s0 = blk.s0;
  const int b = bh / kv;
  const int kvh = bh - b * kv;
  const int h_n = kv * g_n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  load_rows_async<kD>(qs, q, b, kvh, s0, bq, s_len, h_n, g_n, dh);
  load_rows_async<kD>(os, dout, b, kvh, s0, bq, s_len, h_n, g_n, dh);

  // this thread's two rows: warp * 16 + lane / 4 and 8 below it
  int qp[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = warp * 16 + (lane >> 2) + 8 * u;
    const int qi = r / g_n;
    const int g = r - qi * g_n;
    const int sq = s0 + qi;
    const bool on = qi < bq && sq < s_len;
    qp[u] = on ? q_pos[(long long)b * s_len + sq] : -1;
    const float ls = on ? lse[((long long)bh * g_n + g) * s_len + sq] : 0.f;
    lse_r[u] = ls <= kNeg ? 0.f : ls;
    delta_r[u] =
        on ? delta[((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g] : 0.f;
  }
  float acc[kO][4];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  KeyTiles tiles(query_span(q_pos, b, s0, bq, s_len, lane));
  const int n_kt = (t_len + kBK - 1) / kBK;
  bool full = false, full_next = false;
  int j = tiles.next<kBK>(0, full, kv_pos, t_len, n_kt, causal, window, lane);
  if (j < n_kt) {
    load_keys_async<kD, kBK>(ks, k, b, kvh, j * kBK, t_len, kv, dh);
    load_keys_async<kD, kBK>(vs, v, b, kvh, j * kBK, t_len, kv, dh);
  }
  cp_commit();

  // this lane's ldmatrix addresses (bytes, shared space); buffer 1 of K
  // and V lies kBuf bytes above buffer 0
  constexpr uint32_t kE = sizeof(T), kBuf = kBK * kLd * sizeof(T);
  const uint32_t q_addr = smem_u32(qs) + (warp * 16 * kLd + a_off(lane, kLd)) * kE;
  const uint32_t o_addr = smem_u32(os) + (warp * 16 * kLd + a_off(lane, kLd)) * kE;
  const uint32_t k_addr = smem_u32(ks) + bn_off(lane, kLd) * kE;
  const uint32_t kt_addr = smem_u32(ks) + bt_off(lane, kLd) * kE;
  const uint32_t v_addr = smem_u32(vs) + bn_off(lane, kLd) * kE;
  int buf = 0;
  while (j < n_kt) {
    const int jn = tiles.next<kBK>(j + 1, full_next, kv_pos, t_len, n_kt, causal, window, lane);
    if (jn < n_kt) {
      load_keys_async<kD, kBK>(ks + (buf ^ 1) * kBK * kLd, k, b, kvh, jn * kBK, t_len, kv, dh);
      load_keys_async<kD, kBK>(vs + (buf ^ 1) * kBK * kLd, v, b, kvh, jn * kBK, t_len, kv, dh);
    }
    cp_commit();
    cp_wait<1>();  // every group but the newest: tile j (and Q, dO) have landed
    __syncthreads();
    const uint32_t kb = k_addr + buf * kBuf, vb = v_addr + buf * kBuf;
    const uint32_t ktb = kt_addr + buf * kBuf;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and kBK keys
    float sc[kN][4], dp[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm4(aq, q_addr + kk * 16 * kE);
      ldsm4(ao, o_addr + kk * 16 * kE);
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm4(bk, kb + (np * 16 * kLd + kk * 16) * kE);
        ldsm4(bv, vb + (np * 16 * kLd + kk * 16) * kE);
        M::mma(sc[2 * np], aq, bk[0], bk[1]);
        M::mma(sc[2 * np + 1], aq, bk[2], bk[3]);
        M::mma(dp[2 * np], ao, bv[0], bv[1]);
        M::mma(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }

    // dS in place of S
    const int t0 = j * kBK;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        bool ok[2] = {true, true};
        if (!full) {
          const int t = t0 + n * 8 + 2 * (lane & 3) + c;
          const int kp = t < t_len ? kv_pos[t] : -1;
          ok[0] = tile_valid(qp[0], kp, causal, window);
          ok[1] = tile_valid(qp[1], kp, causal, window);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * u + c;
          float x, dcap;
          recompute(sc[n][e] * scale, softcap, x, dcap);
          const float p = ok[u] ? expf(x - lse_r[u]) : 0.f;
          sc[n][e] = p * (dp[n][e] - delta_r[u]) * dcap * scale;
        }
      }
    }

    // dQ += dS K, dS from the score registers in two 2-byte terms
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kSplitDq][4];
      c_to_a<T, kSplitDq>(sc[2 * kk], sc[2 * kk + 1], a);
#pragma unroll
      for (int np = 0; np < kO / 2; ++np) {
        uint32_t bb[4];
        ldsm4_t(bb, ktb + (kk * 16 * kLd + np * 16) * kE);
#pragma unroll
        for (int s = 0; s < kSplitDq; ++s) {
          M::mma(acc[2 * np], a[s], bb[0], bb[1]);
          M::mma(acc[2 * np + 1], a[s], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
    j = jn;
    full = full_next;
    buf ^= 1;
  }
  cp_wait<0>();

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = warp * 16 + (lane >> 2) + 8 * u;
    const int qi = r / g_n, g = r - qi * g_n, sq = s0 + qi;
    if (qi >= bq || sq >= s_len) continue;
    T* dst = dq + (((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g) * dh +
             2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < kO; ++i) {
      if (i * 8 < dh) {
        float x0 = acc[i][2 * u], x1 = acc[i][2 * u + 1];
        *reinterpret_cast<uint32_t*>(dst + i * 8) = M::take(x0, x1);
      }
    }
  }
}

// key tiles: 64 keys up to Dh 64, 32 at Dh 128, 16 at Dh 256 (dq then
// holds 128 registers per thread, and two blocks fit on an SM)
constexpr int dq_key_tile(int d) { return d <= 64 ? 64 : d <= 128 ? 32 : 16; }

template <typename T, int kD>
int launch_dq_tc(const Args& a) {
  constexpr int kBK = dq_key_tile(kD);
  constexpr size_t smem = DqTc<T, kD, kBK>::kSmem;
  const int bq = tc::kM / a.g_n;
  const int n_qt = (a.s_len + bq - 1) / bq;
  const int n_bh = a.b * a.kv;
  if ((long long)n_qt * n_bh > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<dq_tc_kernel<T, kD, kBK>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<T, kD, kBK><<<n_qt * n_bh, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.q_pos, a.kv_pos, a.lse, a.delta, static_cast<T*>(a.dq),
      a.s_len, a.t_len, a.kv, a.g_n, a.dh, bq, n_bh, n_qt, a.causal != 0, a.window, a.softcap,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq_tc_dh(const Args& a) {
  switch (tc::tile_dh(a.dh)) {
    case 32: return launch_dq_tc<T, 32>(a);
    case 64: return launch_dq_tc<T, 64>(a);
    case 128: return launch_dq_tc<T, 128>(a);
    default: return launch_dq_tc<T, 256>(a);
  }
}

// ---------------------------------------------------------------------------
// dk/dv in bf16 / f16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kSplitDkv = 2;  // 2-byte terms of P^T in P^T dO and of dS^T in dS^T Q

// The block of head dim kD: kWK groups of 16 keys by kWD groups of
// columns. Warp (wk, wd) owns keys wk * 16 .. + 15 and dh columns wd * kCols
// .. of dK and dV (kCols f32 accumulators per thread: 64 from Dh 64 up) and
// computes S^T and dP^T for those keys and query rows wd * kQ .. of each
// tile; with kWD > 1 the warps of a key group swap P^T and dS^T through
// shared memory.
template <int kD>
struct DkvShape {
  static constexpr int kWD = kD <= 64 ? 1 : kD / 64;  // Dh 32, 64: 1; 128: 2; 256: 4
  static constexpr int kWK = kD <= 64 ? 4 : 2;
  static constexpr int kNT = 32 * kWK * kWD;          // threads: 128, or 256 at Dh 256
  static constexpr int kBK = 16 * kWK;                // keys per block: 64, or 32 from Dh 128
  static constexpr int kCols = kD / kWD;
  static constexpr int kQ = tc::kM / kWD;
};

template <typename T, int kD>
struct DkvTc {
  using S = DkvShape<kD>;
  static constexpr int kLd = kD + tc::kPad;
  static constexpr int kXLd = tc::kM + tc::kPad;  // a swap row: 64 query rows
  static constexpr int kX = S::kWD > 1 ? 2 * kSplitDkv * S::kBK * kXLd : 0;
  // lse and delta of two tiles, K and V, two tiles of Q and dO, the swap
  static constexpr size_t kSmem =
      sizeof(float) * 4 * tc::kM + sizeof(T) * ((size_t)(2 * S::kBK + 4 * tc::kM) * kLd + kX);
};

// Stage query tile s0 (rows as tc::load_rows_async) of Q and dO, and the
// rows' lse and delta, zero past S and past the used rows.
template <int kD, int kNT, typename T>
__device__ __forceinline__ void load_query_tile(T* qs, T* os, float* ls, float* dl,
                                                const T* __restrict__ q,
                                                const T* __restrict__ dout,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta, int b, int kvh,
                                                int bh, int s0, int bq, int s_len, int h_n,
                                                int g_n, int dh) {
  tc::load_rows_async<kD, kNT>(qs, q, b, kvh, s0, bq, s_len, h_n, g_n, dh);
  tc::load_rows_async<kD, kNT>(os, dout, b, kvh, s0, bq, s_len, h_n, g_n, dh);
  const int r = threadIdx.x;
  if (r < tc::kM) {
    const int qi = r / g_n, g = r - qi * g_n, sq = s0 + qi;
    const bool ok = qi < bq && sq < s_len;
    tc::cp4(ls + r, ok ? lse + ((long long)bh * g_n + g) * s_len + sq : lse, ok);
    tc::cp4(dl + r, ok ? delta + ((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g
                       : delta, ok);
  }
}

// One query tile of a dkv_tc_kernel block: S^T = K Q^T and dP^T = V dO^T
// for this warp's 16 keys and kQ rows; P^T = exp(x - lse) and dS^T = P^T
// (dP^T - delta) dcap scale in f32 on the accumulators (kFull: every pair
// valid, no mask); then dV += P^T dO and dK += dS^T Q over the 64 rows,
// P^T and dS^T as kSplitDkv 2-byte terms, from registers (kWD 1) or from
// the swap (written here for the key group's other warps). Addresses are
// this lane's ldmatrix bases in the tile's buffers.
template <typename T, int kD, bool kFull>
__device__ __forceinline__ void dkv_tile(float (&acc_v)[DkvShape<kD>::kCols / 8][4],
                                         float (&acc_k)[DkvShape<kD>::kCols / 8][4],
                                         uint32_t k_addr, uint32_t v_addr, uint32_t q_addr,
                                         uint32_t o_addr, uint32_t qt_addr, uint32_t ot_addr,
                                         T* xs, uint32_t x_addr, const float* ls,
                                         const float* dl, const int (&kp)[2],
                                         const int* __restrict__ q_pos, int s0, int bq,
                                         int s_len, int g_n, bool causal, int window,
                                         float softcap, float scale) {
  using namespace tc;
  using M = Mma<T>;
  using S = DkvShape<kD>;
  constexpr int kLd = DkvTc<T, kD>::kLd, kXLd = DkvTc<T, kD>::kXLd;
  constexpr int kN = S::kQ / 8;     // n8 tiles of S^T per warp
  constexpr int kO = S::kCols / 8;  // n8 tiles of dK and dV per warp
  constexpr uint32_t kE = sizeof(T), kXTerm = S::kBK * kXLd * sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wk = warp / S::kWD, wd = warp - wk * S::kWD;

  float st[kN][4], dpt[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t ak[4], av[4];
    ldsm4(ak, k_addr + kk * 16 * kE);
    ldsm4(av, v_addr + kk * 16 * kE);
#pragma unroll
    for (int np = 0; np < kN / 2; ++np) {
      uint32_t bq4[4], bo4[4];
      ldsm4(bq4, q_addr + (np * 16 * kLd + kk * 16) * kE);
      ldsm4(bo4, o_addr + (np * 16 * kLd + kk * 16) * kE);
      M::mma(st[2 * np], ak, bq4[0], bq4[1]);
      M::mma(st[2 * np + 1], ak, bq4[2], bq4[3]);
      M::mma(dpt[2 * np], av, bo4[0], bo4[1]);
      M::mma(dpt[2 * np + 1], av, bo4[2], bo4[3]);
    }
  }

  // P^T in place of S^T, dS^T in place of dP^T: element e of tile n is key
  // (lane / 4) + 8 (e / 2) of the warp's, row r0 + e % 2 of the tile
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int r0 = wd * S::kQ + n * 8 + 2 * (lane & 3);
    const float2 l2 = *reinterpret_cast<const float2*>(ls + r0);
    const float2 d2 = *reinterpret_cast<const float2*>(dl + r0);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float lr = c ? l2.y : l2.x;
      const float lse_r = lr <= kNeg ? 0.f : lr;
      const float delta_r = c ? d2.y : d2.x;
      int qp = 0;
      if constexpr (!kFull) {
        const int qi = (r0 + c) / g_n, sq = s0 + qi;
        qp = (qi < bq && sq < s_len) ? q_pos[sq] : -1;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * u + c;
        float x, dcap;
        recompute(st[n][e] * scale, softcap, x, dcap);
        float p = expf(x - lse_r);
        if constexpr (!kFull) {
          if (!tile_valid(qp, kp[u], causal, window)) p = 0.f;
        }
        dpt[n][e] = p * (dpt[n][e] - delta_r) * dcap * scale;
        st[n][e] = p;
      }
    }
  }

  if constexpr (S::kWD > 1) {
    // the swap: P^T terms, then dS^T terms, each kBK keys x 64 rows
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        T* at = xs + (wk * 16 + (lane >> 2) + 8 * u) * kXLd + wd * S::kQ + n * 8 +
                2 * (lane & 3);
#pragma unroll
        for (int s = 0; s < kSplitDkv; ++s) {
          *reinterpret_cast<uint32_t*>(at + s * S::kBK * kXLd) =
              M::take(st[n][2 * u], st[n][2 * u + 1]);
          *reinterpret_cast<uint32_t*>(at + (kSplitDkv + s) * S::kBK * kXLd) =
              M::take(dpt[n][2 * u], dpt[n][2 * u + 1]);
        }
      }
    }
    // the key group's warps alone (named barrier 1 + wk)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wk), "r"(32 * S::kWD) : "memory");
  }

  // dV += P^T dO and dK += dS^T Q over the tile's 64 rows
#pragma unroll
  for (int kk = 0; kk < kM / 16; ++kk) {
    uint32_t ap[kSplitDkv][4], ad[kSplitDkv][4];
    if constexpr (S::kWD == 1) {
      c_to_a<T, kSplitDkv>(st[2 * kk], st[2 * kk + 1], ap);
      c_to_a<T, kSplitDkv>(dpt[2 * kk], dpt[2 * kk + 1], ad);
    } else {
#pragma unroll
      for (int s = 0; s < kSplitDkv; ++s) {
        ldsm4(ap[s], x_addr + s * kXTerm + kk * 16 * kE);
        ldsm4(ad[s], x_addr + (kSplitDkv + s) * kXTerm + kk * 16 * kE);
      }
    }
#pragma unroll
    for (int np = 0; np < kO / 2; ++np) {
      uint32_t bo4[4], bq4[4];
      ldsm4_t(bo4, ot_addr + (kk * 16 * kLd + np * 16) * kE);
      ldsm4_t(bq4, qt_addr + (kk * 16 * kLd + np * 16) * kE);
#pragma unroll
      for (int s = 0; s < kSplitDkv; ++s) {
        M::mma(acc_v[2 * np], ap[s], bo4[0], bo4[1]);
        M::mma(acc_v[2 * np + 1], ap[s], bo4[2], bo4[3]);
        M::mma(acc_k[2 * np], ad[s], bq4[0], bq4[1]);
        M::mma(acc_k[2 * np + 1], ad[s], bq4[2], bq4[3]);
      }
    }
  }
}

// grid: B * KV * (key tiles) blocks (tc::block_keys), DkvShape<kD>::kNT
// threads. K and V of the block's keys stay in shared memory; the live
// query tiles (tc::QueryTiles) stream through two buffers.
template <typename T, int kD>
__global__ void __launch_bounds__(DkvShape<kD>::kNT)
dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const int* __restrict__ q_pos,
              const int* __restrict__ kv_pos, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
              int s_len, int t_len, int kv, int g_n, int dh, int bq, int n_bh, bool causal,
              int window, float softcap, float scale) {
  using namespace tc;
  using M = Mma<T>;
  using S = DkvShape<kD>;
  constexpr int kLd = DkvTc<T, kD>::kLd, kXLd = DkvTc<T, kD>::kXLd;
  constexpr int kBK = S::kBK, kO = S::kCols / 8;
  extern __shared__ float4 smem4[];
  float* ls = reinterpret_cast<float*>(smem4);  // 2 x kM: lse of the tile's rows
  float* dl = ls + 2 * kM;                      // 2 x kM: delta
  T* ks = reinterpret_cast<T*>(dl + 2 * kM);    // kBK x kLd
  T* vs = ks + kBK * kLd;                       // kBK x kLd
  T* qs = vs + kBK * kLd;                       // 2 x kM x kLd
  T* os = qs + 2 * kM * kLd;                    // 2 x kM x kLd (dO)
  T* xs = os + 2 * kM * kLd;                    // the swap (kWD > 1)

  const BlockKeys blk = block_keys(n_bh, kBK);
  const int bh = blk.bh, t0 = blk.t0;
  const int b = bh / kv;
  const int kvh = bh - b * kv;
  const int h_n = kv * g_n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wk = warp / S::kWD, wd = warp - wk * S::kWD;
  const int* qp_b = q_pos + (long long)b * s_len;

  load_keys_async<kD, kBK, S::kNT>(ks, k, b, kvh, t0, t_len, kv, dh);
  load_keys_async<kD, kBK, S::kNT>(vs, v, b, kvh, t0, t_len, kv, dh);

  // the positions of this thread's two keys, wk * 16 + lane / 4 and 8 below
  int kp[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = t0 + wk * 16 + (lane >> 2) + 8 * u;
    kp[u] = t < t_len ? kv_pos[t] : -1;
  }
  float acc_v[kO][4], acc_k[kO][4];
#pragma unroll
  for (int i = 0; i < kO; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[i][e] = acc_k[i][e] = 0.f;
  }

  QueryTiles tiles(warp_span(kv_pos, t0, kBK, t_len, lane));
  const int n_qt = (s_len + bq - 1) / bq;
  bool full = false, full_next = false;
  int i = tiles.next(0, full, qp_b, s_len, bq, n_qt, causal, window, lane);
  if (i < n_qt) {
    load_query_tile<kD, S::kNT>(qs, os, ls, dl, q, dout, lse, delta, b, kvh, bh, i * bq, bq,
                                s_len, h_n, g_n, dh);
  }
  cp_commit();

  // this lane's ldmatrix addresses (bytes, shared space); buffer 1 of Q,
  // dO lies kBuf bytes above buffer 0
  constexpr uint32_t kE = sizeof(T), kBuf = kM * kLd * sizeof(T);
  const uint32_t k_addr = smem_u32(ks) + (wk * 16 * kLd + a_off(lane, kLd)) * kE;
  const uint32_t v_addr = smem_u32(vs) + (wk * 16 * kLd + a_off(lane, kLd)) * kE;
  const uint32_t q_addr = smem_u32(qs) + (wd * S::kQ * kLd + bn_off(lane, kLd)) * kE;
  const uint32_t o_addr = smem_u32(os) + (wd * S::kQ * kLd + bn_off(lane, kLd)) * kE;
  const uint32_t qt_addr = smem_u32(qs) + (wd * S::kCols + bt_off(lane, kLd)) * kE;
  const uint32_t ot_addr = smem_u32(os) + (wd * S::kCols + bt_off(lane, kLd)) * kE;
  const uint32_t x_addr = smem_u32(xs) + (wk * 16 * kXLd + a_off(lane, kXLd)) * kE;
  int buf = 0;
  while (i < n_qt) {
    const int in = tiles.next(i + 1, full_next, qp_b, s_len, bq, n_qt, causal, window, lane);
    if (in < n_qt) {
      load_query_tile<kD, S::kNT>(qs + (buf ^ 1) * kM * kLd, os + (buf ^ 1) * kM * kLd,
                                  ls + (buf ^ 1) * kM, dl + (buf ^ 1) * kM, q, dout, lse, delta,
                                  b, kvh, bh, in * bq, bq, s_len, h_n, g_n, dh);
    }
    cp_commit();
    cp_wait<1>();  // every group but the newest: tile i (and K, V) have landed
    __syncthreads();
    const uint32_t off = buf * kBuf;
    const float* lsb = ls + buf * kM;
    const float* dlb = dl + buf * kM;
    if (full) {
      dkv_tile<T, kD, true>(acc_v, acc_k, k_addr, v_addr, q_addr + off, o_addr + off,
                            qt_addr + off, ot_addr + off, xs, x_addr, lsb, dlb, kp, qp_b, i * bq,
                            bq, s_len, g_n, causal, window, softcap, scale);
    } else {
      dkv_tile<T, kD, false>(acc_v, acc_k, k_addr, v_addr, q_addr + off, o_addr + off,
                             qt_addr + off, ot_addr + off, xs, x_addr, lsb, dlb, kp, qp_b, i * bq,
                             bq, s_len, g_n, causal, window, softcap, scale);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
    i = in;
    full = full_next;
    buf ^= 1;
  }
  cp_wait<0>();

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = t0 + wk * 16 + (lane >> 2) + 8 * u;
    if (t >= t_len) continue;
    const long long o =
        (((long long)b * t_len + t) * kv + kvh) * dh + wd * S::kCols + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < kO; ++c) {
      if (wd * S::kCols + c * 8 < dh) {
        *reinterpret_cast<uint32_t*>(dk + o + c * 8) =
            M::take(acc_k[c][2 * u], acc_k[c][2 * u + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + c * 8) =
            M::take(acc_v[c][2 * u], acc_v[c][2 * u + 1]);
      }
    }
  }
}

template <typename T, int kD>
int launch_dkv_tc(const Args& a) {
  using S = DkvShape<kD>;
  constexpr size_t smem = DkvTc<T, kD>::kSmem;
  const int bq = tc::kM / a.g_n;
  const int n_kt = (a.t_len + S::kBK - 1) / S::kBK;
  const int n_bh = a.b * a.kv;
  if ((long long)n_kt * n_bh > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<dkv_tc_kernel<T, kD>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_tc_kernel<T, kD><<<n_kt * n_bh, S::kNT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.q_pos, a.kv_pos, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.s_len, a.t_len, a.kv, a.g_n, a.dh, bq, n_bh, a.causal != 0,
      a.window, a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv_tc_dh(const Args& a) {
  switch (tc::tile_dh(a.dh)) {
    case 32: return launch_dkv_tc<T, 32>(a);
    case 64: return launch_dkv_tc<T, 64>(a);
    case 128: return launch_dkv_tc<T, 128>(a);
    default: return launch_dkv_tc<T, 256>(a);
  }
}

// the CUDA-core kernels: dq and dk/dv in f32
template <typename T>
int launch_dq_dh(const Args& a) {
  if (a.dh <= 32) return launch_dq<T, 1>(a);
  if (a.dh <= 64) return launch_dq<T, 2>(a);
  if (a.dh <= 128) return launch_dq<T, 4>(a);
  return launch_dq<T, 8>(a);
}

template <typename T>
int launch_dkv_dh(const Args& a) {
  if (a.dh <= 32) return launch_dkv<T, 1>(a);
  if (a.dh <= 64) return launch_dkv<T, 2>(a);
  if (a.dh <= 128) return launch_dkv<T, 4>(a);
  return launch_dkv<T, 8>(a);
}

// the route by dtype: bf16 and f16 on the tensor cores, f32 on the CUDA cores
template <bool kDq>
int launch_dtype(const Args& a, int dtype) {
  if (!shape_ok(a.b, a.s_len, a.t_len, a.kv, a.g_n, a.dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (kDq) {
    switch (dtype) {
      case 0: return launch_dq_dh<float>(a);
      case 1: return launch_dq_tc_dh<__nv_bfloat16>(a);
      case 2: return launch_dq_tc_dh<__half>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (dtype) {
      case 0: return launch_dkv_dh<float>(a);
      case 1: return launch_dkv_tc_dh<__nv_bfloat16>(a);
      case 2: return launch_dkv_tc_dh<__half>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

// The walk of dkv_tc_kernel's grid alone: block i walks the query tiles of
// its key tile (tc::block_keys) as the kernel does and adds how many it
// visits to *visits (flash_attn.tc_visits).
__global__ void __launch_bounds__(32)
visit_dkv_kernel(const int* __restrict__ q_pos, const int* __restrict__ kv_pos, int s_len,
                 int t_len, int kv, int bq, int bk, int n_bh, bool causal, int window,
                 unsigned long long* visits) {
  const tc::BlockKeys blk = tc::block_keys(n_bh, bk);
  const int lane = threadIdx.x;
  tc::QueryTiles tiles(tc::warp_span(kv_pos, blk.t0, bk, t_len, lane));
  const int* qp = q_pos + (long long)(blk.bh / kv) * s_len;
  const int n_qt = (s_len + bq - 1) / bq;
  bool full = false;
  unsigned long long n = 0;
  for (int i = tiles.next(0, full, qp, s_len, bq, n_qt, causal, window, lane); i < n_qt;
       i = tiles.next(i + 1, full, qp, s_len, bq, n_qt, causal, window, lane)) {
    ++n;
  }
  if (lane == 0) atomicAdd(visits, n);
}

}  // namespace

// Layouts as in flash_attn_fwd_launch; dout like q (16-byte aligned, as
// q, k and v), lse (B * KV, G, S) float32 from the forward, delta (B, S,
// KV * G) float32. dq like q; dk and dv like k. dtype 0 = float32, 1 =
// bfloat16, 2 = float16 (both kernels on the tensor cores in the last two). Returns
// the CUDA error of the launch (0 on success).
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

// The tile of the bf16/f16 dq kernel at group size g_n and head dim dh:
// *bq queries (with all g_n heads of each) by *bk keys. Returns 0, or
// cudaErrorInvalidValue for a shape flash_attn_dq_launch refuses.
extern "C" int flash_attn_dq_tiles(int g_n, int dh, int* bq, int* bk) {
  if (!attn::shape_ok(1, 1, 1, 1, g_n, dh)) return static_cast<int>(cudaErrorInvalidValue);
  *bq = attn::tc::kM / g_n;
  *bk = dq_key_tile(attn::tc::tile_dh(dh));
  return 0;
}

// The key tiles the bf16/f16 dq kernel's blocks visit at these positions,
// added to *visits (one uint64 on the device): its walk alone
// (tc::visit_kernel). Arguments as in flash_attn_dq_launch.
extern "C" int flash_attn_dq_visits(const void* q_pos, const void* kv_pos, int b, int s_len,
                                    int t_len, int kv, int g_n, int dh, int causal, int window,
                                    void* visits, void* stream) {
  int bq = 0, bk = 0;
  if (!attn::shape_ok(b, s_len, t_len, kv, g_n, dh) || flash_attn_dq_tiles(g_n, dh, &bq, &bk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return attn::tc::launch_visits(bq, bk, q_pos, kv_pos, b, s_len, t_len, kv, causal, window,
                                 visits, stream);
}

// The tile of the bf16/f16 dk/dv kernel: a block owns *bk keys and walks
// query tiles of *bq queries (with all g_n heads of each). Returns 0, or
// cudaErrorInvalidValue for a shape flash_attn_dkv_launch refuses.
extern "C" int flash_attn_dkv_tiles(int g_n, int dh, int* bq, int* bk) {
  if (!attn::shape_ok(1, 1, 1, 1, g_n, dh)) return static_cast<int>(cudaErrorInvalidValue);
  *bq = attn::tc::kM / g_n;
  switch (attn::tc::tile_dh(dh)) {
    case 32: *bk = DkvShape<32>::kBK; break;
    case 64: *bk = DkvShape<64>::kBK; break;
    case 128: *bk = DkvShape<128>::kBK; break;
    default: *bk = DkvShape<256>::kBK;
  }
  return 0;
}

// The (query tile, key tile) pairs the bf16/f16 dk/dv kernel's blocks
// visit at these positions, added to *visits (one uint64 on the device):
// its walk alone (visit_dkv_kernel). Arguments as in flash_attn_dq_visits.
extern "C" int flash_attn_dkv_visits(const void* q_pos, const void* kv_pos, int b, int s_len,
                                     int t_len, int kv, int g_n, int dh, int causal, int window,
                                     void* visits, void* stream) {
  int bq = 0, bk = 0;
  if (!attn::shape_ok(b, s_len, t_len, kv, g_n, dh) || flash_attn_dkv_tiles(g_n, dh, &bq, &bk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_kt = (t_len + bk - 1) / bk, n_bh = b * kv;
  if ((long long)n_kt * n_bh > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  visit_dkv_kernel<<<n_kt * n_bh, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos), s_len, t_len, kv, bq, bk,
      n_bh, causal != 0, window, static_cast<unsigned long long*>(visits));
  return static_cast<int>(cudaGetLastError());
}
