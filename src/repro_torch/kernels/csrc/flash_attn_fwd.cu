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
// What the tensor-core design does (Hopper's shape: TMA into a ring of
// shared-memory stages, mbarriers, a producer warp, wgmma in consumer
// warpgroups):
//  * a block owns one (lane b, KV head) and 128 (query, head) rows, r =
//    query * G + g, so all heads of a query share one mask row and every
//    K/V tile read serves the G heads; the grid runs the latest, heaviest
//    causal query tiles first;
//  * one producer warp loads Q once and K and V tiles of 64 keys (16 at Dh
//    256) into a ring of 4 stages by TMA: 4-D tensor maps over (B, S or T,
//    heads, Dh), so a box past T or Dh reads zeros, never the next lane's
//    keys; 128-byte swizzled rows, Dh in 64-wide pieces. It walks the
//    same key tiles as before (tc::KeyTiles), never loading one with no
//    valid pair, and writes each tile's index and fullness beside it;
//  * two consumer warpgroups of 64 rows (setmaxnreg gives them the
//    producer's registers) compute S = Q K^T by wgmma from shared memory,
//    then softcap, running max and sum on the accumulators in registers
//    (exponentials as one exp2 each, the scores in log2 units), and O +=
//    P V by wgmma with P from registers and V read MN-major; the output
//    stays in registers (Dh / 2 floats per thread). A full tile runs a
//    copy of the tile's code with no mask at all: with the mask's
//    branches inside the one loop, the compiler kept their work on every
//    tile;
//  * P is f32 in the Pallas kernel: it enters the tensor cores as three
//    bf16 terms (hi, the remainder, its remainder: all 24 bits; f16: two
//    terms, 22 bits), each one wgmma over the same V, since the forward's
//    f32 tolerance is 1e-5 absolute and 16 bits of P err by up to 2^-16
//    |v| in a row of a few keys;
//  * the output is normalised and rounded once, staged in the Q tile and
//    written by one TMA store, which writes nothing past S or Dh.

#include <type_traits>

#include "attn_mma.cuh"
#include "hopper.cuh"

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
// bf16 / f16: the tensor-core kernel (wgmma, TMA, a warp-specialised ring)
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU instruction (2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int kD>
struct FwdTc {
  static constexpr int kRows = 128;  // (query, head) rows: two consumer warpgroups of 64
  // keys per tile: 64, and 16 at Dh 256, where the output holds 128
  // registers a thread: beside it, the scores and P's three terms of a
  // 32-key tile already made ptxas spill and serialize the wgmmas
  static constexpr int kBK = kD == 256 ? 16 : 64;
  static constexpr int kSplit = std::is_same<T, __nv_bfloat16>::value ? 3 : 2;
  static constexpr int kStages = 4;                    // K/V tiles in flight
  static constexpr int kConsumers = 256;               // threads of the two consumer warpgroups
  static constexpr int kThreadsTc = kConsumers + 128;  // and the producer warpgroup
  static constexpr int kPieces = kD / 64;              // 64-column pieces, 128-byte rows
  static constexpr int kQBytes = kPieces * kRows * 128;
  static constexpr int kTileBytes = kPieces * kBK * 128;  // one K (or V) tile
  // Q, then the K ring, the V ring, their full and empty barriers, Q's
  // barrier and the tiles' indices; 1 KB of slack to align Q to 1,024
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * (size_t)kStages * kTileBytes + 8 * (2 * kStages + 1) + 4 * kStages;
};

// What one consumer thread carries from tile to tile: its two rows'
// positions, running max (log2 units) and sum, and the output.
template <int kD>
struct FwdRows {
  int qp[2];
  float m[2], l[2];
  float o[kD / 8][4];
};

// One key tile j (K at shared address kb, V at vb) for this warpgroup's 64
// rows (Q at q_addr): S = Q K^T, softcap, the mask where kMasked (a
// partial tile; a full one runs without it), the online softmax, O += P V.
template <typename T, int kD, bool kMasked>
__device__ __forceinline__ void fwd_tile(FwdRows<kD>& r, int j, uint32_t q_addr, uint32_t kb,
                                         uint32_t vb, const int* __restrict__ kv_pos, int t_len,
                                         bool causal, int window, float softcap, float scale) {
  using namespace tc;
  using F = FwdTc<T, kD>;
  using W = hopper::Wgmma<T>;
  constexpr int kBK = F::kBK;
  constexpr int kSplit = F::kSplit;
  constexpr int kN = kBK / 8;  // n8 blocks of scores per row pair
  constexpr int kO = kD / 8;   // n8 blocks of the output
  const int lane = threadIdx.x & 31;
  float(&o_flat)[kO * 4] = reinterpret_cast<float(&)[kO * 4]>(r.o);

  // S = Q K^T for the 64 rows and the tile's kBK keys, 16 columns of Dh a
  // step
  float sc[kN][4];
  float(&sc_flat)[kN * 4] = reinterpret_cast<float(&)[kN * 4]>(sc);
  // zeroed though the first step overwrites them: left undefined, ptxas
  // spilled at Dh 256 and the layer ran slower
#pragma unroll
  for (int i = 0; i < kN * 4; ++i) sc_flat[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kN * 4; ++i) hopper::fence_operand(sc_flat[i]);
  hopper::wgmma_fence();
#pragma unroll
  for (int p = 0; p < F::kPieces; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      W::ss(sc_flat, hopper::desc_b128(q_addr + p * F::kRows * 128 + kk * 32, 16, 1024),
            hopper::desc_b128(kb + p * kBK * 128 + kk * 32, 16, 1024), p + kk > 0);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kN * 4; ++i) hopper::fence_operand(sc_flat[i]);

  // softcap and mask in place, in log2 units (x log2(e)), so that each
  // exponential is one exp2; valid bit n * 4 + e of element sc[n][e]
  uint32_t valid = 0xffffffffu;
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      bool ok[2] = {true, true};
      if (kMasked) {
        const int t = j * kBK + n * 8 + 2 * (lane & 3) + c;
        const int kp = t < t_len ? kv_pos[t] : -1;
        ok[0] = tile_valid(r.qp[0], kp, causal, window);
        ok[1] = tile_valid(r.qp[1], kp, causal, window);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float x = sc[n][2 * u + c] * scale;
        x = softcap != 0.f ? softcap * tanhf(x / softcap) * kLog2e : x * kLog2e;
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
    const float m_new = fmaxf(r.m[u], mx[u]);
    alpha[u] = r.m[u] <= kNeg ? 0.f : exp2_approx(r.m[u] - m_new);
    r.m[u] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = e >> 1;
      const float p = !kMasked || (valid >> (n * 4 + e)) & 1u ? exp2_approx(sc[n][e] - r.m[u])
                                                               : 0.f;
      sc[n][e] = p;
      sum[u] += p;
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 1);
    sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], 2);
    r.l[u] = r.l[u] * alpha[u] + sum[u];
  }
#pragma unroll
  for (int i = 0; i < kO; ++i) {
    r.o[i][0] *= alpha[0];
    r.o[i][1] *= alpha[0];
    r.o[i][2] *= alpha[1];
    r.o[i][3] *= alpha[1];
  }

  // O += P V: P from the score registers in kSplit 2-byte terms, one wgmma
  // each over the same 16 keys of V (read MN-major)
  uint32_t a[kBK / 16][kSplit][4];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) c_to_a<T, kSplit>(sc[2 * kk], sc[2 * kk + 1], a[kk]);
#pragma unroll
  for (int i = 0; i < kO * 4; ++i) hopper::fence_operand(o_flat[i]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      W::rs(o_flat, a[kk][s], hopper::desc_b128(vb + kk * 16 * 128, kBK * 128, 1024), 1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kO * 4; ++i) hopper::fence_operand(o_flat[i]);
}

// One block: (lane b, KV head) bh and the 128 rows r = query * G + g of
// queries s0 .. s0 + bq - 1 (tc::block_rows). Threads 0-255 are two
// consumer warpgroups of 64 rows each; warp 8 is the producer, and warps
// 9-11 only give their registers away. The producer loads Q once and
// walks the key tiles (tc::KeyTiles), putting each live tile's K and V
// into the next stage of the ring by TMA and its index and fullness beside
// them; a tile index of -1 ends the walk. Each stage has a full barrier
// (the producer's arrival and the tile's bytes) and an empty one (one
// arrival per consumer warp once its products have read the stage).
template <typename T, int kD>
__global__ void __launch_bounds__(FwdTc<T, kD>::kThreadsTc, 1)
fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
              float* __restrict__ lse, int s_len, int t_len, int kv, int g_n, int bq, int n_bh,
              int n_qt, bool causal, int window, float softcap, float scale) {
  using namespace tc;
  using F = FwdTc<T, kD>;
  constexpr int kBK = F::kBK;
  constexpr int kStages = F::kStages;
  constexpr int kO = kD / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = qs + F::kQBytes;
  uint8_t* vs = ks + kStages * F::kTileBytes;
  uint64_t* full_bar = reinterpret_cast<uint64_t*>(vs + kStages * F::kTileBytes);
  uint64_t* empty_bar = full_bar + kStages;
  uint64_t* q_bar = empty_bar + kStages;
  int* tile_of = reinterpret_cast<int*>(q_bar + 1);

  const BlockRows blk = block_rows(n_bh, n_qt, bq);
  const int bh = blk.bh, s0 = blk.s0;
  const int b = bh / kv;
  const int kvh = bh - b * kv;
  const int n_kt = (t_len + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full_bar[s], 1);
      hopper::mbar_init(&empty_bar[s], F::kConsumers / 32);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= F::kConsumers) {
    // ---- producer ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x < F::kConsumers + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        hopper::mbar_expect_tx(q_bar, F::kPieces * 128 * g_n * bq);
        for (int p = 0; p < F::kPieces; ++p) {
          hopper::tma_load_4d(qs + p * F::kRows * 128, &tm_q, q_bar, p * 64, kvh * g_n, s0, b);
        }
      }
      KeyTiles tiles(query_span(q_pos, b, s0, bq, s_len, lane));
      bool full = false;
      int j = tiles.next<kBK>(0, full, kv_pos, t_len, n_kt, causal, window, lane);
      int stage = 0;
      uint32_t parity = 1;  // a fresh ring's stages are empty
      while (true) {
        if (lane == 0) {
          hopper::mbar_wait(&empty_bar[stage], parity);
          if (j < n_kt) {
            tile_of[stage] = 2 * j + (full ? 1 : 0);
            hopper::mbar_expect_tx(&full_bar[stage], 2 * F::kTileBytes);
            for (int p = 0; p < F::kPieces; ++p) {
              const int off = stage * F::kTileBytes + p * kBK * 128;
              hopper::tma_load_4d(ks + off, &tm_k, &full_bar[stage], p * 64, kvh, j * kBK, b);
              hopper::tma_load_4d(vs + off, &tm_v, &full_bar[stage], p * 64, kvh, j * kBK, b);
            }
          } else {
            tile_of[stage] = -1;
            hopper::mbar_arrive(&full_bar[stage]);
          }
        }
        __syncwarp();
        if (j >= n_kt) break;
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
        j = tiles.next<kBK>(j + 1, full, kv_pos, t_len, n_kt, causal, window, lane);
      }
    }
  } else {
    // ---- consumers: rows 64 wg .. 64 wg + 63 ----
    hopper::setmaxnreg_inc<232>();
    using M = Mma<T>;
    const int lane = threadIdx.x & 31;
    const int wg = threadIdx.x >> 7;
    // this thread's two rows: warp * 16 + lane / 4 and 8 below
    FwdRows<kD> r;
    r.qp[0] = row_pos(q_pos, b, s0, bq, s_len, g_n, 0);
    r.qp[1] = row_pos(q_pos, b, s0, bq, s_len, g_n, 1);
    r.m[0] = r.m[1] = kNeg;
    r.l[0] = r.l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < kO; ++i) r.o[i][0] = r.o[i][1] = r.o[i][2] = r.o[i][3] = 0.f;

    const uint32_t q_addr = hopper::smem_u32(qs) + wg * 64 * 128;
    const uint32_t k_addr = hopper::smem_u32(ks), v_addr = hopper::smem_u32(vs);
    hopper::mbar_wait(q_bar, 0);
    int stage = 0;
    uint32_t parity = 0;
    while (true) {
      hopper::mbar_wait(&full_bar[stage], parity);
      const int info = tile_of[stage];
      if (info < 0) break;
      const uint32_t kb = k_addr + stage * F::kTileBytes;
      const uint32_t vb = v_addr + stage * F::kTileBytes;
      if (info & 1) {
        fwd_tile<T, kD, false>(r, info >> 1, q_addr, kb, vb, kv_pos, t_len, causal, window,
                               softcap, scale);
      } else {
        fwd_tile<T, kD, true>(r, info >> 1, q_addr, kb, vb, kv_pos, t_len, causal, window,
                              softcap, scale);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty_bar[stage]);  // this warp is done with it
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }

    // normalise once, round once, into this warpgroup's rows of the Q tile
    // (its products are done) in the swizzled layout; then one thread
    // stores the tile by TMA, which writes nothing past S or Dh
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * u;
      const float den = fmaxf(r.l[u], kTiny);
      uint8_t* dst = qs + row * 128 + 4 * (lane & 3);
#pragma unroll
      for (int i = 0; i < kO; ++i) {
        float x0 = r.o[i][2 * u] / den, x1 = r.o[i][2 * u + 1] / den;
        *reinterpret_cast<uint32_t*>(dst + (i >> 3) * F::kRows * 128 +
                                     (((i & 7) ^ (row & 7)) << 4)) = M::take(x0, x1);
      }
      const int qi = row / g_n, g = row - qi * g_n, sq = s0 + qi;
      if (qi < bq && sq < s_len && (lane & 3) == 0) {
        lse[((long long)bh * g_n + g) * s_len + sq] =
            r.l[u] > 0.f ? r.m[u] * kLn2 + logf(den) : kNeg;
      }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1, F::kConsumers);
    if (threadIdx.x == 0) {
      for (int p = 0; p < F::kPieces; ++p) {
        hopper::tma_store_4d(&tm_o, qs + p * F::kRows * 128, p * 64, kvh * g_n, s0, b);
      }
      hopper::tma_store_commit();
      hopper::tma_store_wait_read();
    }
  }
}

// the head dim an instantiation is built for: Dh rounded up to 64, 128 or
// 256 (TMA fills the columns past Dh with zeros and stores none of them)
constexpr int fwd_dh(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }

template <typename T, int kD>
int launch_tc(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
              void* out, float* lse, int b, int s_len, int t_len, int kv, int g_n, int dh,
              int causal, int window, float softcap, float scale, cudaStream_t stream) {
  using F = FwdTc<T, kD>;
  const int bq = F::kRows / g_n;
  const int n_qt = (s_len + bq - 1) / bq;
  const int n_bh = b * kv;
  const int h_n = kv * g_n;
  if ((long long)n_qt * n_bh > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // q and out (B, S, H, Dh) in boxes of bq queries x the group's G heads;
  // k and v (B, T, KV, Dh) in boxes of kBK keys of one head: a box past T
  // reads zeros, never the next lane's keys
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int err = hopper::tensor_map_4d<T>(&tm_q, q, dh, h_n, s_len, b, g_n, bq);
  if (!err) err = hopper::tensor_map_4d<T>(&tm_o, out, dh, h_n, s_len, b, g_n, bq);
  if (!err) err = hopper::tensor_map_4d<T>(&tm_k, k, dh, kv, t_len, b, 1, F::kBK);
  if (!err) err = hopper::tensor_map_4d<T>(&tm_v, v, dh, kv, t_len, b, 1, F::kBK);
  if (err) return err;
  const cudaError_t smem_err = allow_smem<fwd_tc_kernel<T, kD>>(F::kSmem);
  if (smem_err != cudaSuccess) return static_cast<int>(smem_err);
  fwd_tc_kernel<T, kD><<<n_qt * n_bh, F::kThreadsTc, F::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, q_pos, kv_pos, lse, s_len, t_len, kv, g_n, bq, n_bh, n_qt,
      causal != 0, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc_dh(const void* q, const void* k, const void* v, const int* q_pos,
                 const int* kv_pos, void* out, float* lse, int b, int s_len, int t_len, int kv,
                 int g_n, int dh, int causal, int window, float softcap, float scale,
                 cudaStream_t stream) {
  switch (fwd_dh(dh)) {
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
  *bq = FwdTc<__nv_bfloat16, 64>::kRows / g_n;
  *bk = fwd_dh(dh) == 256 ? FwdTc<__nv_bfloat16, 256>::kBK : FwdTc<__nv_bfloat16, 64>::kBK;
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
