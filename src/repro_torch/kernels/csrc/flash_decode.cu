// One-token GQA decode attention for Hopper (sm_90a): one launch, the
// split merge inside it through a thread-block cluster.
//
// Replaces src/repro/kernels/flash_attn.py::_decode_kernel (the Pallas
// stage 1 of flash_decode) and its stage 2, merge_partials, which the JAX
// package computes in jnp.
//
// What it computes, for each lane b, KV head h and query head g of the
// group (G = H / KV query heads share one KV head):
//   s[t]   = softcap(q[b,g] . k[b,t,h] / sqrt(Dh))          in f32
//   valid  = t <= pos[b]  and  t < T  and  (window == 0 or pos[b] - t < window)
//   out    = sum_t softmax(s)[t] * v[b,t,h]    (zeros for a fully masked row)
// in the input dtype (f32, bf16, f16), G <= 8, Dh <= 256 and a multiple of 8.
//
// What bounds it on this card: the bytes of the K/V rows the lanes can see,
// 2 * rows * Dh * itemsize (at gemma3-1b's B 4, Dh 256, bf16: 4 MB for a
// global layer at T 1024, 2 MB for a local one with its 512-row window),
// about 0.6 to 1.25 us at 3.35 TB/s, under what one launch costs. So the
// time goes to the launch and to chains of dependent latency, not to the
// bytes or the 4 * G * Dh operations per row.
//
// What the design does about launch and latency:
//  * one launch: the C splits of one (lane, KV head) are the C blocks of
//    one cluster (C <= 16, 16 through the non-portable attribute). Each
//    block keeps its running max and sum per head in shared memory and its
//    unnormalised G x Dh output in registers. After one cluster barrier
//    every block reads its peers' maxima and sums (map_shared_rank, one
//    remote load a thread, reduced by shuffles) and pushes its output,
//    weighted, into the shared memory of the block that owns each element
//    (remote stores, no round trip); after a second barrier each block sums
//    its slice over the peers in rank order (bitwise repeatable) and writes
//    it in the output dtype. No partials in device memory, no second
//    kernel (the two-launch design this replaces wrote f32 partials and
//    merged them in a second launch, a dependent chain of C loads per
//    thread);
//  * the splits cut the rows the lane can see, [max(0, pos - window + 1),
//    min(pos + 1, T)), computed on the device from pos, into C shares of a
//    multiple of 16 rows: every block of a local layer has rows, and a lane
//    at pos 0 reads one row (the two-launch design split [0, T) and launched
//    empty splits below the window);
//  * a block stages its share 64 rows at a time (32 in f32) with 16-byte
//    cp.async into a two-deep ring, both chunks issued at once, so a share
//    of up to 128 rows (64 at f32) is in flight in one wait; Q's copies go
//    out before the position is read, since they do not depend on it;
//  * a chunk is scored, softmaxed and accumulated as a whole: one max, one
//    rescale and one sum reduction per chunk and head, not per row. In bf16
//    and f16 both products run on the tensor cores (mma.sync m16n8k16,
//    attn_mma.cuh). The scores transposed, S^T = K Q^T: a warp's 16 keys
//    fill the 16 rows and the G <= 8 heads the 8 columns. P.V as O = P V,
//    P's G rows padded to 16; P enters as three bf16 or two f16 terms, all
//    of P's 24 bits or 22, as in the training forward. (O^T = V^T P^T, with
//    half the padding, measured slower per layer: by the phase clock its
//    scatter of the output to the owners cost more than its products
//    saved.) In f32 each thread forms whole dot products from shared
//    memory (one (key, head) pair each, four partial sums, no reductions)
//    and owns output columns for P.V, on the CUDA cores;
//  * K and V are read in place in the cache's (B, T, KV, Dh) layout, q and
//    the output in the model's (B, 1, H, Dh): no copies around the kernel.

#include <cooperative_groups.h>

#include <type_traits>

#include "attn_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace attn;

constexpr int kMaxCluster = 16;  // H100: 8 portable, 16 with the non-portable attribute
constexpr int kShareRows = 16;   // a block's share of rows is a multiple of this

// Shared-memory layout of one block: the K and V rings, Q, P as 2-byte
// terms (bf16, f16), the chunk's scores (f32; in f32 also its P), the
// slices of output the peers push for the merge, and per head the block's
// max, sum, rescale and merge weight.
template <typename T, int kD>
struct Dec {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kR = kF32 ? 32 : 64;                // rows per chunk
  static constexpr int kLd = kD + (kF32 ? 4 : tc::kPad);   // elements per staged row
  static constexpr int kSplit = std::is_same<T, __nv_bfloat16>::value ? 3 : 2;
  static constexpr int kLdP = kR + tc::kPad;               // elements per row of P
  static constexpr size_t kRing = 2 * (size_t)kR * kLd * sizeof(T);
  static constexpr size_t kQ = (size_t)kMaxGroup * kLd * sizeof(T);
  static constexpr size_t kP = kF32 ? 0 : (size_t)kSplit * 16 * kLdP * sizeof(T);
  static constexpr size_t kS = (size_t)kMaxGroup * kR * sizeof(float);
  // the merge's receive buffer: n_rank slots of ceil(G Dh / n_rank) floats
  static constexpr size_t kRecv = ((size_t)kMaxGroup * kD + kMaxCluster) * sizeof(float);
  static constexpr size_t kSmem = 2 * kRing + kQ + kP + kS + kRecv + 4 * kMaxGroup * sizeof(float);
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// [beg, end) of block rank of a cluster of n_rank over the rows a lane at
// pos sees in a cache of t_len rows, [max(0, pos - window + 1), min(pos +
// 1, t_len)) (window > 0 engaged): an equal share rounded up to kShareRows
// rows, in rank order; the last blocks' shares may be empty. The kernel
// runs it on the device, flash_decode_shares on the host.
__host__ __device__ inline void block_share(int pos, int t_len, int window, int rank, int n_rank,
                                            int* beg, int* end) {
  const int hi = imax(0, imin(pos + 1, t_len));
  const int lo = window > 0 ? imin(hi, imax(0, pos - window + 1)) : 0;
  const int per = ((hi - lo + n_rank - 1) / n_rank + kShareRows - 1) / kShareRows * kShareRows;
  *beg = imin(hi, lo + rank * per);
  *end = imin(hi, *beg + per);
}

// Rows r0 .. r0 + n - 1 of one (lane, KV head) of src (B, T, KV, Dh) into
// dst, rows kLd elements apart; zero at rows >= end and past Dh.
template <int kD, int kLd, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, long long base,
                                           long long stride, int r0, int n, int end, int dh) {
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kC = kD / kE;
  for (int c = threadIdx.x; c < n * kC; c += kThreads) {
    const int r = c / kC, ch = c - (c / kC) * kC, t = r0 + r;
    const bool ok = t < end && ch * kE < dh;
    tc::cp16(dst + r * kLd + ch * kE, ok ? src + base + t * stride + ch * kE : src, ok);
  }
}

// ldmatrix.x4 row address into a [n][k] tile of 8 rows (Q): matrix j is
// columns 8 j .. 8 j + 7, so registers 0-1 are the B operand (k16 x n8) of
// one 16-deep step and registers 2-3 of the next.
__device__ __forceinline__ int b8_off(int lane, int ld) { return (lane & 7) * ld + (lane >> 3) * 8; }

__device__ __forceinline__ float finish_score(float x, bool ok, float softcap, float scale) {
  x *= scale;
  if (softcap != 0.f) x = softcap * tanhf(x / softcap);
  return ok ? x : kNeg;
}

// grid (C, B * KV), clusters of C blocks along x; kThreads threads.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ q_pos, T* __restrict__ out, int t_len, int kv, int g_n,
              int dh, int window, float softcap, float scale) {
  using P = Dec<T, kD>;
  constexpr int kR = P::kR, kLd = P::kLd;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_rank = static_cast<int>(cluster.num_blocks());
  const int bh = blockIdx.y;
  const int b = bh / kv;
  const int kvh = bh - b * kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float4 smem4[];
  char* sp = reinterpret_cast<char*>(smem4);
  T* ks = reinterpret_cast<T*>(sp);
  T* vs = reinterpret_cast<T*>(sp + P::kRing);
  T* qs = reinterpret_cast<T*>(sp + 2 * P::kRing);
  T* ps = reinterpret_cast<T*>(sp + 2 * P::kRing + P::kQ);
  float* ss = reinterpret_cast<float*>(sp + 2 * P::kRing + P::kQ + P::kP);
  float* recv = ss + kMaxGroup * kR;  // [peer][slot], this block's slice of the output
  float* ms = recv + kMaxGroup * kD + kMaxCluster;
  float* ls = ms + kMaxGroup;
  float* as = ls + kMaxGroup;
  float* sw = as + kMaxGroup;  // this block's merge weight per head

  // Q's G rows (zero up to 8 rows and past Dh), before the position they
  // do not depend on
  stage_rows<kD, kLd>(qs, q, (long long)bh * g_n * dh, dh, 0, kMaxGroup, g_n, dh);

  // this block's share of the rows the lane can see
  int beg, end;
  block_share(q_pos[b], t_len, window, rank, n_rank, &beg, &end);
  const int n_chunks = (end - beg + kR - 1) / kR;

  const long long stride = (long long)kv * dh;
  const long long base = (long long)b * t_len * stride + (long long)kvh * dh;

  // chunks 0 (in Q's group) and 1
  if (n_chunks > 0) {
    stage_rows<kD, kLd>(ks, k, base, stride, beg, kR, end, dh);
    stage_rows<kD, kLd>(vs, v, base, stride, beg, kR, end, dh);
  }
  tc::cp_commit();
  if (n_chunks > 1) {
    stage_rows<kD, kLd>(ks + kR * kLd, k, base, stride, beg + kR, kR, end, dh);
    stage_rows<kD, kLd>(vs + kR * kLd, v, base, stride, beg + kR, kR, end, dh);
  }
  tc::cp_commit();
  if (tid < kMaxGroup) {
    ms[tid] = kNeg;
    ls[tid] = 0.f;
  }
  if constexpr (!P::kF32) {  // P's rows g >= G and its padding stay zero
    for (int e = tid; e < static_cast<int>(P::kP / 16); e += kThreads) {
      reinterpret_cast<uint4*>(ps)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // output accumulators: f32, columns tid + kThreads i of every head; tc,
  // column pairs np = warp + 4 i (16 columns each) of P's 16 rows
  constexpr int kDV = (kD + kThreads - 1) / kThreads;
  constexpr int kNP = kD / 16;
  constexpr int kNPW = (kNP + kWarps - 1) / kWarps;
  float acc[kMaxGroup][kDV];
  float o[kNPW][2][4];
  if constexpr (P::kF32) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
      for (int i = 0; i < kDV; ++i) acc[g][i] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < kNPW; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) o[i][n][0] = o[i][n][1] = o[i][n][2] = o[i][n][3] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int n_valid = min(kR, end - (beg + c * kR));
    const T* kc = ks + buf * kR * kLd;
    const T* vc = vs + buf * kR * kLd;
    tc::cp_wait<1>();  // every group but the newest: chunk c (and Q) have landed
    __syncthreads();

    // 1. the chunk's scores, ss[g][j]: scaled, softcapped, kNeg past n_valid
    if constexpr (P::kF32) {
      const float* kr = kc + lane * kLd;  // key j = lane (kR = 32)
      for (int g = warp; g < g_n; g += kWarps) {
        const float* qr = qs + g * kLd;
        float s[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, not one of kD
#pragma unroll 8
        for (int d = 0; d < kD; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + d);
          const float4 x = *reinterpret_cast<const float4*>(kr + d);
          s[0] += a.x * x.x;
          s[1] += a.y * x.y;
          s[2] += a.z * x.z;
          s[3] += a.w * x.w;
        }
        ss[g * kR + lane] =
            finish_score((s[0] + s[1]) + (s[2] + s[3]), lane < n_valid, softcap, scale);
      }
    } else {
      // warp w: keys 16 w .. 16 w + 15 of the chunk as the 16 rows of
      // S^T = K Q^T (A = K from its tile, B = Q's 8 head rows), over Dh
      constexpr uint32_t kE = sizeof(T);
      const uint32_t ka = tc::smem_u32(kc) + (warp * 16 * kLd + tc::a_off(lane, kLd)) * kE;
      const uint32_t qb = tc::smem_u32(qs) + b8_off(lane, kLd) * kE;
      float sc[2][4] = {};  // two chains: even and odd 16-column steps
#pragma unroll
      for (int kp = 0; kp < kD / 32; ++kp) {
        uint32_t bq[4], a0[4], a1[4];
        tc::ldsm4(bq, qb + kp * 32 * kE);
        tc::ldsm4(a0, ka + kp * 32 * kE);
        tc::ldsm4(a1, ka + (kp * 32 + 16) * kE);
        tc::Mma<T>::mma(sc[0], a0, bq[0], bq[1]);
        tc::Mma<T>::mma(sc[1], a1, bq[2], bq[3]);
      }
      // C: element e is key lane / 4 (+ 8 for e >= 2), head 2 (lane % 4) + e % 2
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = 2 * (lane & 3) + (e & 1);
        const int j = warp * 16 + (lane >> 2) + 8 * (e >> 1);
        if (g < g_n) {
          ss[g * kR + j] = finish_score(sc[0][e] + sc[1][e], j < n_valid, softcap, scale);
        }
      }
    }
    __syncthreads();

    // 2. per head: the chunk's max, the rescale of what came before, P and
    // its sum; one warp per head
    for (int g = warp; g < g_n; g += kWarps) {
      constexpr int kPer = kR / 32;
      float* sr = ss + g * kR;
      float x[kPer];
      float mx = kNeg;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        x[i] = sr[lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
      mx = warp_max(mx);
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = m_old <= kNeg ? 0.f : expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = lane + 32 * i;
        const float p = j < n_valid ? expf(x[i] - m_new) : 0.f;
        sum += p;
        if constexpr (P::kF32) {
          sr[j] = p;
        } else {
          float rest = p;
#pragma unroll
          for (int s = 0; s < P::kSplit; ++s) {
            const T h = from_f32<T>(rest);
            ps[(s * 16 + g) * P::kLdP + j] = h;
            rest -= to_f32(h);
          }
        }
      }
      sum = warp_sum(sum);
      __syncwarp();  // every lane has read ms[g] before it changes
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = ls[g] * alpha + sum;
        as[g] = alpha;
      }
    }
    __syncthreads();

    // 3. O = alpha O + P V
    if constexpr (P::kF32) {
#pragma unroll
      for (int i = 0; i < kDV; ++i) {
        const int d = tid + kThreads * i;
        if (d >= kD) break;
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < g_n) acc[g][i] *= as[g];
#pragma unroll 2
        for (int j = 0; j < kR; j += 4) {  // P is 0 and V zero past n_valid
          float x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] = vc[(j + u) * kLd + d];
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < g_n) {
              const float4 pr = *reinterpret_cast<const float4*>(ss + g * kR + j);
              acc[g][i] += pr.x * x[0] + pr.y * x[1] + pr.z * x[2] + pr.w * x[3];
            }
          }
        }
      }
    } else {
      // O += P V: A = P's 16 rows (heads, then zeros), one kSplit term at a
      // time, B = V (ldmatrix.trans); warp w owns column pairs w + 4 i
      constexpr uint32_t kE = sizeof(T);
      const int g = lane >> 2;
      const float alpha = g < g_n ? as[g] : 0.f;
      const uint32_t pa = tc::smem_u32(ps) + tc::a_off(lane, P::kLdP) * kE;
      const uint32_t vb = tc::smem_u32(vc) + tc::bt_off(lane, kLd) * kE;
#pragma unroll
      for (int i = 0; i < kNPW; ++i) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          o[i][n][0] *= alpha;
          o[i][n][1] *= alpha;
        }
      }
      // the terms outermost: 2 kNPW independent products lie between two
      // that accumulate into one tile (mma.sync's order is kept as written)
#pragma unroll
      for (int kk = 0; kk < kR / 16; ++kk) {
        uint32_t a[P::kSplit][4], bb[kNPW][4];
#pragma unroll
        for (int s = 0; s < P::kSplit; ++s) tc::ldsm4(a[s], pa + (s * 16 * P::kLdP + kk * 16) * kE);
#pragma unroll
        for (int i = 0; i < kNPW; ++i) {
          if (warp + kWarps * i < kNP) {  // warp-uniform
            tc::ldsm4_t(bb[i], vb + (kk * 16 * kLd + (warp + kWarps * i) * 16) * kE);
          }
        }
#pragma unroll
        for (int s = 0; s < P::kSplit; ++s) {
#pragma unroll
          for (int i = 0; i < kNPW; ++i) {
            if (warp + kWarps * i < kNP) {
              tc::Mma<T>::mma(o[i][0], a[s], bb[i][0], bb[i][1]);
              tc::Mma<T>::mma(o[i][1], a[s], bb[i][2], bb[i][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // chunk c's buffers, scores and P are consumed
    if (c + 2 < n_chunks) {
      const int r0 = beg + (c + 2) * kR;
      stage_rows<kD, kLd>(ks + buf * kR * kLd, k, base, stride, r0, kR, end, dh);
      stage_rows<kD, kLd>(vs + buf * kR * kLd, v, base, stride, r0, kR, end, dh);
    }
    tc::cp_commit();
  }
  tc::cp_wait<0>();

  // The merge. Per head g, over the cluster's blocks r: the max M = max_r
  // m_r, the sum L = sum_r l_r exp(m_r - M), and block r's weight
  // w_r = exp(m_r - M) / L (an empty block has m kNeg, l 0 and O 0).
  cluster.sync();  // every block's ms and ls are final
  {
    // thread g * 16 + r reads peer r's m and l of head g; the 16 lanes of
    // a head reduce by shuffles
    const int g = tid >> 4, r = tid & 15;
    float m_r = kNeg, l_r = 0.f;
    if (g < g_n && r < n_rank) {
      m_r = cluster.map_shared_rank(ms, r)[g];
      l_r = cluster.map_shared_rank(ls, r)[g];
    }
    float mx = m_r;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float w = expf(m_r - mx);
    float den = l_r * w;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    if (g < g_n && r == rank) sw[g] = w / fmaxf(den, kTiny);
  }
  __syncthreads();

  // Each block pushes its weighted output to the owners: element e = g Dh +
  // d belongs to block e / per_e, which keeps it in slot [rank][e mod
  // per_e] of its recv buffer (remote stores: no round trip)
  const int width = g_n * dh;
  const int per_e = (width + n_rank - 1) / n_rank;
  auto push = [&](int e, float x) {
    const int owner = e / per_e;
    cluster.map_shared_rank(recv, owner)[rank * per_e + e - owner * per_e] = x;
  };
  if constexpr (P::kF32) {
#pragma unroll
    for (int i = 0; i < kDV; ++i) {
      const int d = tid + kThreads * i;
      if (d >= dh) break;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < g_n) push(g * dh + d, acc[g][i] * sw[g]);
    }
  } else {
    // C rows lane / 4 are the heads (rows 8-15 are padding: G <= 8)
    const int g = lane >> 2;
    if (g < g_n) {
      const float wg = sw[g];
#pragma unroll
      for (int i = 0; i < kNPW; ++i) {
        const int np = warp + kWarps * i;
        if (np >= kNP) break;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = np * 16 + n * 8 + 2 * (lane & 3);
          if (col < dh) {  // dh is a multiple of 8: col + 1 < dh as well
            push(g * dh + col, o[i][n][0] * wg);
            push(g * dh + col + 1, o[i][n][1] * wg);
          }
        }
      }
    }
  }
  // every push has landed; after this no block touches another's shared
  // memory, so none has to wait for its peers before it leaves
  cluster.sync();

  // block r sums its slice over the peers, in rank order, and writes it
  const int e0 = rank * per_e;
  const int e1 = min(width, e0 + per_e);
  for (int e = e0 + tid; e < e1; e += kThreads) {
    float acc_e = 0.f;
    for (int r = 0; r < n_rank; ++r) acc_e += recv[r * per_e + e - e0];
    out[(long long)bh * width + e] = from_f32<T>(acc_e);
  }
}

// The attributes a launch needs, set once per kernel (outside any graph
// capture: the first call sets them): its shared memory, and clusters
// above the portable 8.
template <typename T, int kD>
cudaError_t prepare() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto kern = decode_kernel<T, kD>;
  cudaError_t err = allow_smem<decode_kernel<T, kD>>(Dec<T, kD>::kSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  done = err == cudaSuccess;
  return err;
}

template <typename T, int kD>
cudaLaunchConfig_t config(int cluster, int bh, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, bh, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Dec<T, kD>::kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, const int* q_pos, void* out, int b,
           int t_len, int kv, int g_n, int dh, int cluster, int window, float softcap,
           float scale, cudaStream_t stream) {
  cudaError_t err = prepare<T, kD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, kD>(cluster, b * kv, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, decode_kernel<T, kD>, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
                           static_cast<T*>(out), t_len, kv, g_n, dh, window, softcap, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The largest cluster, up to kMaxCluster, that the card can schedule for
// this kernel (cudaOccupancyMaxActiveClusters > 0); 0 if none.
template <typename T, int kD>
int max_cluster() {
  if (prepare<T, kD>() != cudaSuccess) return 0;
  for (int c = kMaxCluster; c >= 1; --c) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config<T, kD>(c, 1, nullptr, &attr);
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, decode_kernel<T, kD>, &cfg);
    if (err == cudaSuccess && n > 0) return c;
    cudaGetLastError();  // clear what a refused query recorded, before a launch reads it
  }
  return 0;
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const int* q_pos, void* out, int b,
              int t_len, int kv, int g_n, int dh, int cluster, int window, float softcap,
              float scale, cudaStream_t st) {
  switch (tc::tile_dh(dh)) {
    case 32:
      return launch<T, 32>(q, k, v, q_pos, out, b, t_len, kv, g_n, dh, cluster, window, softcap,
                           scale, st);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, out, b, t_len, kv, g_n, dh, cluster, window, softcap,
                           scale, st);
    case 128:
      return launch<T, 128>(q, k, v, q_pos, out, b, t_len, kv, g_n, dh, cluster, window,
                            softcap, scale, st);
    default:
      return launch<T, 256>(q, k, v, q_pos, out, b, t_len, kv, g_n, dh, cluster, window,
                            softcap, scale, st);
  }
}

template <typename T>
int max_cluster_dh(int dh) {
  switch (tc::tile_dh(dh)) {
    case 32: return max_cluster<T, 32>();
    case 64: return max_cluster<T, 64>();
    case 128: return max_cluster<T, 128>();
    default: return max_cluster<T, 256>();
  }
}

bool dims_ok(int dh, int dtype) {
  return dh >= 8 && dh <= kMaxDh && dh % 8 == 0 && dtype >= 0 && dtype <= 2;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q (B, 1, KV * G, Dh),
// k and v (B, T, KV, Dh), q_pos (B,) int32, out like q; all contiguous on
// one device, 16-byte aligned, G <= 8, Dh <= 256 and a multiple of 8, and
// 1 <= cluster <= flash_decode_max_cluster(dh, dtype). window > 0 is an
// engaged window. Returns the launch's CUDA error (0 on success).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* q_pos, void* out, int b, int t_len, int kv,
                                   int g_n, int dh, int cluster, int window, float softcap,
                                   float scale, int dtype, void* stream) {
  if (b < 1 || b * (long long)kv > 65535 || kv < 1 || g_n < 1 || g_n > kMaxGroup ||
      t_len < 0 || cluster < 1 || cluster > kMaxCluster || !dims_ok(dh, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* pos = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dh<float>(q, k, v, pos, out, b, t_len, kv, g_n, dh, cluster, window,
                              softcap, scale, st);
    case 1:
      return launch_dh<__nv_bfloat16>(q, k, v, pos, out, b, t_len, kv, g_n, dh, cluster, window,
                                      softcap, scale, st);
    default:
      return launch_dh<__half>(q, k, v, pos, out, b, t_len, kv, g_n, dh, cluster, window,
                               softcap, scale, st);
  }
}

// The largest cluster size flash_decode_launch takes at this head dim and
// dtype on this card (1 to 16), or -1 for a head dim or dtype it refuses,
// 0 if the card schedules no cluster of the kernel.
extern "C" int flash_decode_max_cluster(int dh, int dtype) {
  if (!dims_ok(dh, dtype)) return -1;
  switch (dtype) {
    case 0: return max_cluster_dh<float>(dh);
    case 1: return max_cluster_dh<__nv_bfloat16>(dh);
    default: return max_cluster_dh<__half>(dh);
  }
}

// [beg, end) of each block of a cluster of `cluster` over the rows a lane
// at pos sees, by the kernel's own arithmetic (block_share), into
// beg_end[2 r] and beg_end[2 r + 1]; -1 for a cluster size the kernel does
// not take, else 0.
extern "C" int flash_decode_shares(int pos, int t_len, int window, int cluster, int* beg_end) {
  if (cluster < 1 || cluster > kMaxCluster || t_len < 0) return -1;
  for (int r = 0; r < cluster; ++r) block_share(pos, t_len, window, r, cluster, beg_end + 2 * r,
                                                beg_end + 2 * r + 1);
  return 0;
}
