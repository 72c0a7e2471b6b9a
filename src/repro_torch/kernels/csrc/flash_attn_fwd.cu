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
// Two routes, chosen by dtype in flash_attn_fwd_launch (not a fallback:
// each dtype has exactly one):
//  * bf16 and f16 (the training path): fwd_tc_kernel, on the tensor cores;
//  * f32 (the held f32 step pairs and kernel checks): fwd_kernel, the
//    products on the CUDA cores in f32, exact against the plain version.
//
// What bounds it on this card, at the two shapes the main paths run:
//  * bert-base (B 48, S = T 128, H = KV 12, Dh 64, bf16, non-causal): a
//    layer reads q, k, v and writes out and lse, 38 MB, for 2.4 GFLOP: 64
//    operations per byte, under the card's 295, so the 3.35 TB/s set the
//    bound (11 us);
//  * gemma3-1b (B 4, S = T 1024, H 4 over KV 1, Dh 256, causal, window 512
//    on 5 of 6 layers): 5 MB for 8.6 GFLOP of valid (query, key) pairs on a
//    global layer and 6.4 on a local one, so the 989 TFLOP/s of bf16 set
//    the bound (8.7 and 6.5 us).
//
// What the tensor-core design does:
//  * a block owns one (lane b, KV head) and 64 (query, head) rows, r =
//    query * G + g, so all heads of a query share one mask row and every
//    K/V tile read serves the G heads (16 queries at G 4, 64 at G 1); the
//    grid runs the latest, heaviest causal query tiles first;
//  * each of the four warps owns 16 rows: S = Q.K^T by mma.sync m16n8k16
//    (bf16 x bf16 is exact in the f32 accumulators), Q and K fed by
//    ldmatrix from shared memory, where Q stays for the whole block;
//  * K and V tiles (32 keys at Dh 256, 64 below) are staged in the input
//    dtype by 16-byte cp.async, zero past T and Dh, double-buffered, rows
//    padded by 16 bytes against ldmatrix bank conflicts;
//  * softcap, mask, running max and sum act on the S accumulators in
//    registers (row reductions are two quad shuffles), and those registers
//    are the A operand of P.V (V through ldmatrix.trans); the output stays
//    in registers (Dh / 2 floats per thread) and is rounded once at the end;
//  * P is f32 in the Pallas kernel: it enters the tensor cores as three
//    bf16 terms (hi, the remainder, its remainder: all 24 bits; f16: two
//    terms, 22 bits), since the forward's f32 tolerance is 1e-5 absolute
//    and 16 bits of P err by up to 2^-16 |v| in a row of a few keys;
//  * key tiles with no valid pair (causal, window, padding: see
//    attn_mma.cuh) are never loaded or computed, tiles whose pairs are all
//    valid skip the elementwise mask, the rest keep tile_valid per element.
//  The first design ran the products on the CUDA cores in f32 at 2 to 8
//  rows per block at Dh 256 and read every key tile; its f32 instantiation
//  is the f32 route above.

#include <type_traits>

#include "attn_mma.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16 / f16: the tensor-core kernel
// ---------------------------------------------------------------------------

template <typename T, int kD, int kBK>
struct FwdTc {
  static constexpr int kLd = kD + tc::kPad;
  static constexpr int kSplit = std::is_same<T, __nv_bfloat16>::value ? 3 : 2;
  static constexpr size_t kSmem = sizeof(T) * (size_t)(tc::kM + 4 * kBK) * kLd;
};

// grid: B * KV * (query tiles) blocks (tc::block_rows). Rows of a block as
// in tc::load_rows_async.
template <typename T, int kD, int kBK>
__global__ void __launch_bounds__(kThreads)
fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos, T* __restrict__ out,
              float* __restrict__ lse, int s_len, int t_len, int kv, int g_n, int dh, int bq,
              int n_bh, int n_qt, bool causal, int window, float softcap, float scale) {
  using namespace tc;
  using M = Mma<T>;
  constexpr int kLd = FwdTc<T, kD, kBK>::kLd;
  constexpr int kSplit = FwdTc<T, kD, kBK>::kSplit;
  constexpr int kN = kBK / 8;  // n8 tiles of scores per warp
  constexpr int kO = kD / 8;   // n8 tiles of the output per warp
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);  // kM x kLd
  T* ks = qs + kM * kLd;                // 2 x kBK x kLd
  T* vs = ks + 2 * kBK * kLd;           // 2 x kBK x kLd

  const BlockRows blk = block_rows(n_bh, n_qt, bq);
  const int bh = blk.bh, s0 = blk.s0;
  const int b = bh / kv;
  const int kvh = bh - b * kv;
  const int h_n = kv * g_n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  load_rows_async<kD>(qs, q, b, kvh, s0, bq, s_len, h_n, g_n, dh);

  // running max and sum of this thread's two rows, warp * 16 + lane / 4
  // and 8 below it
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[kO][4];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

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
  const uint32_t k_addr = smem_u32(ks) + bn_off(lane, kLd) * kE;
  const uint32_t v_addr = smem_u32(vs) + bt_off(lane, kLd) * kE;
  int buf = 0;
  while (j < n_kt) {
    const int jn = tiles.next<kBK>(j + 1, full_next, kv_pos, t_len, n_kt, causal, window, lane);
    if (jn < n_kt) {
      load_keys_async<kD, kBK>(ks + (buf ^ 1) * kBK * kLd, k, b, kvh, jn * kBK, t_len, kv, dh);
      load_keys_async<kD, kBK>(vs + (buf ^ 1) * kBK * kLd, v, b, kvh, jn * kBK, t_len, kv, dh);
    }
    cp_commit();
    cp_wait<1>();  // every group but the newest: tile j (and Q) have landed
    __syncthreads();
    const uint32_t kb = k_addr + buf * kBuf, vb = v_addr + buf * kBuf;

    // S = Q K^T for this warp's 16 rows and the tile's kBK keys
    float sc[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4];
      ldsm4(a, q_addr + kk * 16 * kE);
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bb[4];
        ldsm4(bb, kb + (np * 16 * kLd + kk * 16) * kE);
        M::mma(sc[2 * np], a, bb[0], bb[1]);
        M::mma(sc[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // softcap and mask in place; valid bit n * 4 + e of element sc[n][e]
    const int t0 = j * kBK;
    uint32_t valid = 0xffffffffu;
    float mx[2] = {kNeg, kNeg};
    int qp[2] = {0, 0};  // the rows' positions, read for a partial tile only
    if (!full) {
      qp[0] = row_pos(q_pos, b, s0, bq, s_len, g_n, 0);
      qp[1] = row_pos(q_pos, b, s0, bq, s_len, g_n, 1);
    }
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
          float x = sc[n][2 * u + c] * scale;
          if (softcap != 0.f) x = softcap * tanhf(x / softcap);
          if (!ok[u]) {
            x = kNeg;
            valid &= ~(1u << (n * 4 + 2 * u + c));
          }
          sc[n][2 * u + c] = x;
          mx[u] = fmaxf(mx[u], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      const float m_new = fmaxf(m[u], mx[u]);
      alpha[u] = m[u] <= kNeg ? 0.f : expf(fminf(m[u] - m_new, 0.f));
      m[u] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1;
        const float p = (valid >> (n * 4 + e)) & 1u ? expf(sc[n][e] - m[u]) : 0.f;
        sc[n][e] = p;
        sum[u] += p;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 1);
      sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 2);
      l[u] = l[u] * alpha[u] + sum[u];
    }
#pragma unroll
    for (int i = 0; i < kO; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, P from the score registers in kSplit 2-byte terms
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kSplit][4];
      c_to_a<T, kSplit>(sc[2 * kk], sc[2 * kk + 1], a);
#pragma unroll
      for (int np = 0; np < kO / 2; ++np) {
        uint32_t bb[4];
        ldsm4_t(bb, vb + (kk * 16 * kLd + np * 16) * kE);
#pragma unroll
        for (int s = 0; s < kSplit; ++s) {
          M::mma(o[2 * np], a[s], bb[0], bb[1]);
          M::mma(o[2 * np + 1], a[s], bb[2], bb[3]);
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
    const long long row = ((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g;
    const float den = fmaxf(l[u], kTiny);
    T* dst = out + row * dh + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < kO; ++i) {
      if (i * 8 < dh) {
        float x0 = o[i][2 * u] / den, x1 = o[i][2 * u + 1] / den;
        *reinterpret_cast<uint32_t*>(dst + i * 8) = M::take(x0, x1);
      }
    }
    if ((lane & 3) == 0) {
      lse[((long long)bh * g_n + g) * s_len + sq] = l[u] > 0.f ? m[u] + logf(den) : kNeg;
    }
  }
}

// key tiles: 64 keys up to Dh 128, 32 at Dh 256 (the output then holds 128
// registers per thread and ptxas spills a few bytes; a 16-key tile spills
// nothing but pays its barriers and softmax reductions twice as often)
constexpr int key_tile(int d) { return d <= 128 ? 64 : 32; }

template <typename T, int kD>
int launch_tc(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
              void* out, float* lse, int b, int s_len, int t_len, int kv, int g_n, int dh,
              int causal, int window, float softcap, float scale, cudaStream_t stream) {
  constexpr int kBK = key_tile(kD);
  constexpr size_t smem = FwdTc<T, kD, kBK>::kSmem;
  const int bq = tc::kM / g_n;
  const int n_qt = (s_len + bq - 1) / bq;
  const int n_bh = b * kv;
  if ((long long)n_qt * n_bh > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<fwd_tc_kernel<T, kD, kBK>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_tc_kernel<T, kD, kBK><<<n_qt * n_bh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      kv_pos, static_cast<T*>(out), lse, s_len, t_len, kv, g_n, dh, bq, n_bh, n_qt, causal != 0,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc_dh(const void* q, const void* k, const void* v, const int* q_pos,
                 const int* kv_pos, void* out, float* lse, int b, int s_len, int t_len, int kv,
                 int g_n, int dh, int causal, int window, float softcap, float scale,
                 cudaStream_t stream) {
  switch (tc::tile_dh(dh)) {
    case 32:
      return launch_tc<T, 32>(q, k, v, q_pos, kv_pos, out, lse, b, s_len, t_len, kv, g_n, dh,
                              causal, window, softcap, scale, stream);
    case 64:
      return launch_tc<T, 64>(q, k, v, q_pos, kv_pos, out, lse, b, s_len, t_len, kv, g_n, dh,
                              causal, window, softcap, scale, stream);
    case 128:
      return launch_tc<T, 128>(q, k, v, q_pos, kv_pos, out, lse, b, s_len, t_len, kv, g_n, dh,
                               causal, window, softcap, scale, stream);
    default:
      return launch_tc<T, 256>(q, k, v, q_pos, kv_pos, out, lse, b, s_len, t_len, kv, g_n, dh,
                               causal, window, softcap, scale, stream);
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16, 2 = float16
// (tensor-core route). q (B, S, KV * G, Dh), k and v (B, T, KV, Dh), out
// like q; q_pos (B, S) and kv_pos (T,) int32; lse (B * KV, G, S) float32.
// All contiguous on one device, q, k, v and out 16-byte aligned, G <= 8,
// Dh a multiple of 8 up to 256, B * KV <= 65535. window > 0 engages the
// sliding window (the caller gates it per layer). Returns the CUDA error
// of the launch (0 on success).
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                                     const void* q_pos, const void* kv_pos, void* out, void* lse,
                                     int b, int s_len, int t_len, int kv, int g_n, int dh,
                                     int causal, int window, float softcap, float scale,
                                     int dtype, void* stream) {
  if (!attn::shape_ok(b, s_len, t_len, kv, g_n, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dh<float>(q, k, v, qp, kp, out, ls, b, s_len, t_len, kv, g_n, dh, causal,
                              window, softcap, scale, st);
    case 1:
      return launch_tc_dh<__nv_bfloat16>(q, k, v, qp, kp, out, ls, b, s_len, t_len, kv, g_n, dh,
                                         causal, window, softcap, scale, st);
    case 2:
      return launch_tc_dh<__half>(q, k, v, qp, kp, out, ls, b, s_len, t_len, kv, g_n, dh, causal,
                                  window, softcap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tile of the bf16/f16 forward at group size g_n and head dim dh: *bq
// queries (with all g_n heads of each) by *bk keys. Returns 0, or
// cudaErrorInvalidValue for a shape flash_attn_fwd_launch refuses.
extern "C" int flash_attn_fwd_tiles(int g_n, int dh, int* bq, int* bk) {
  if (!attn::shape_ok(1, 1, 1, 1, g_n, dh)) return static_cast<int>(cudaErrorInvalidValue);
  *bq = attn::tc::kM / g_n;
  *bk = key_tile(attn::tc::tile_dh(dh));
  return 0;
}

// The key tiles the bf16/f16 forward's blocks visit at these positions,
// added to *visits (one uint64 on the device): its walk alone
// (tc::visit_kernel). Arguments as in flash_attn_fwd_launch.
extern "C" int flash_attn_fwd_visits(const void* q_pos, const void* kv_pos, int b, int s_len,
                                     int t_len, int kv, int g_n, int dh, int causal, int window,
                                     void* visits, void* stream) {
  int bq = 0, bk = 0;
  if (!attn::shape_ok(b, s_len, t_len, kv, g_n, dh) || flash_attn_fwd_tiles(g_n, dh, &bq, &bk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return attn::tc::launch_visits(bq, bk, q_pos, kv_pos, b, s_len, t_len, kv, causal, window,
                                 visits, stream);
}
