// Tensor-core building blocks of the 2-byte (bf16, f16) training attention
// kernels. For dq and dk/dv (flash_attn_bwd.cu): mma.sync m16n8k16 with f32
// accumulators, ldmatrix fragment loads, 16-byte cp.async staging with zero
// fill. For them and the forward (flash_attn_fwd.cu, on wgmma): the split
// of an f32 operand into 2-byte terms, the test that decides which (query
// tile, key tile) pairs a block visits, the two walks over them (KeyTiles
// from a block of query rows, QueryTiles from a block of keys), and the
// first walk alone (visit_kernel), which counts the tiles
// (flash_attn_bwd.cu has the second's).
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16 x 16 row-major, 4 registers of 2 elements: (g, 2t..2t+1),
//     (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..);
//   B 16 x 8, 2 registers: (rows 2t..2t+1, column g), (rows 2t + 8.., g);
//   C 16 x 8 f32, 4 floats: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// Two C tiles of neighbouring columns are, element for element, the A
// fragment of a 16-deep product over those columns: the scores' registers
// feed the P.V (and dS.K) product without a trip through shared memory.
//
// Shared-memory tiles hold rows of kD + kPad elements: the 16 bytes of
// padding put the 8 rows an ldmatrix reads in 8 different bank groups.

#pragma once

#include <limits.h>

#include "attn_common.cuh"

namespace attn {
namespace tc {

constexpr int kM = 64;    // (query, head) rows of a dq or dk/dv query tile, 16 per warp
constexpr int kPad = 8;   // elements of padding per shared-memory row

// The head dim a tensor-core instantiation is built for: Dh rounded up to
// 32, 64, 128 or 256 (the tail is zero-filled).
constexpr int tile_dh(int dh) { return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }

// The block's rows: block i of the n_bh * n_qt grid takes (lane, KV head)
// pair bh = i % n_bh and query tile n_qt - 1 - i / n_bh, so the latest,
// heaviest causal query tiles start first.
struct BlockRows {
  int bh, s0;
};
__device__ __forceinline__ BlockRows block_rows(int n_bh, int n_qt, int bq) {
  return BlockRows{static_cast<int>(blockIdx.x % n_bh),
                   (n_qt - 1 - static_cast<int>(blockIdx.x / n_bh)) * bq};
}

// The mirror for a block of bk keys (dkv_tc_kernel): block i takes pair bh
// = i % n_bh and keys t0 = (i / n_bh) * bk on, so the earliest key tiles,
// which the most causal query tiles reach, start first.
struct BlockKeys {
  int bh, t0;
};
__device__ __forceinline__ BlockKeys block_keys(int n_bh, int bk) {
  return BlockKeys{static_cast<int>(blockIdx.x % n_bh), static_cast<int>(blockIdx.x / n_bh) * bk};
}

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  // the pair rounded to bf16 in one register, low half first; the
  // remainders (exact in f32) are left in a and b
  static __device__ __forceinline__ uint32_t take(float& a, float& b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(v);
    a -= f.x;
    b -= f.y;
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ uint32_t take(float& a, float& b) {
    const __half2 v = __floats2half2_rn(a, b);
    const float2 f = __half22float2(v);
    a -= f.x;
    b -= f.y;
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// The A fragment of a 16-deep product whose operand is f32 in the C
// fragments c0 (columns 0-7) and c1 (columns 8-15), as kSplit 2-byte terms:
// a[0] the operand rounded, a[1] the remainder rounded, and so on. Two
// bf16 terms carry 16 bits of the operand, three 24 (all of f32's).
template <typename T, int kSplit>
__device__ __forceinline__ void c_to_a(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&a)[kSplit][4]) {
  float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int s = 0; s < kSplit; ++s) {
    a[s][0] = Mma<T>::take(x[0], x[1]);
    a[s][1] = Mma<T>::take(x[2], x[3]);
    a[s][2] = Mma<T>::take(x[4], x[5]);
    a[s][3] = Mma<T>::take(x[6], x[7]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix.x4 (and .trans) from a shared-memory byte address: callers keep
// one 32-bit base per operand and add compile-time offsets, which the
// instruction takes as immediates
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// This lane's row address for ldmatrix.x4, as an element offset into a
// tile of rows `ld` elements apart:
//  a_off:  the A operand, 16 rows x 16 columns (matrices: rows 0-7 and
//          8-15 of columns 0-7, then of columns 8-15);
//  bn_off: the B operands of two n8 tiles from a [n][k] tile (K for Q.K^T,
//          V for dO.V^T): registers 0-1 are n 0-7, registers 2-3 n 8-15;
//  bt_off: the same from a [k][n] tile through .trans (V for P.V, K for
//          dS.K): registers 0-1 are columns 0-7, registers 2-3 columns 8-15.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int bn_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_off(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8;
}

// 16 bytes global -> shared, asynchronously; zeros where !ok (nothing is
// read then, and src is only a valid placeholder).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously (through L1); zeros where !ok
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A block's rows: row r is query head r % g_n of query s0 + r / g_n, for
// r < bq * g_n (bq = kM / g_n queries; the last kM % g_n rows are unused).
// Stage the kM rows of src (B, S, H, Dh), zero past S, past the used rows
// and past Dh. kNT threads share the copies.
template <int kD, int kNT = kThreads, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* __restrict__ src, int b,
                                                int kvh, int s0, int bq, int s_len, int h_n,
                                                int g_n, int dh) {
  constexpr int kC = kD / 8;
  for (int c = threadIdx.x; c < kM * kC; c += kNT) {
    const int r = c / kC, ch = c % kC;
    const int qi = r / g_n, g = r - qi * g_n, sq = s0 + qi;
    const bool ok = qi < bq && sq < s_len && ch * 8 < dh;
    const T* p =
        ok ? src + (((long long)b * s_len + sq) * h_n + (long long)kvh * g_n + g) * dh + ch * 8
           : src;
    cp16(dst + r * (kD + kPad) + ch * 8, p, ok);
  }
}

// The position of this thread's row warp * 16 + lane / 4 + 8 u of the
// block (-1 for a row past S or past the used rows).
__device__ __forceinline__ int row_pos(const int* __restrict__ q_pos, int b, int s0, int bq,
                                       int s_len, int g_n, int u) {
  const int qi = ((threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * u) / g_n;
  return (qi < bq && s0 + qi < s_len) ? q_pos[(long long)b * s_len + s0 + qi] : -1;
}

// Stage keys t0 .. t0 + kBK - 1 of head kvh of src (B, T, KV, Dh), zero
// past T and past Dh.
template <int kD, int kBK, int kNT = kThreads, typename T>
__device__ __forceinline__ void load_keys_async(T* dst, const T* __restrict__ src, int b,
                                                int kvh, int t0, int t_len, int kv, int dh) {
  constexpr int kC = kD / 8;
  for (int c = threadIdx.x; c < kBK * kC; c += kNT) {
    const int r = c / kC, ch = c % kC, t = t0 + r;
    const bool ok = t < t_len && ch * 8 < dh;
    const T* p = ok ? src + (((long long)b * t_len + t) * kv + kvh) * dh + ch * 8 : src;
    cp16(dst + r * (kD + kPad) + ch * 8, p, ok);
  }
}

// ---------------------------------------------------------------------------
// Which tiles a block visits (flash_attn.live_tiles is the same rule in
// Python). Over the valid (>= 0) positions of a query tile and of a key
// tile, a tile is skipped when it has no valid query or no valid key, or
// causal and kmin > qmax, or window > 0 and qmin - kmax >= window: then no
// pair of the tile passes tile_valid. A tile is full when every pair of
// its rows within S passes: no padding on either side, no key past T, and
// (causal) kmax <= qmin, and (window) qmax - kmin < window; a full tile
// needs no elementwise mask (rows past S are computed but never stored).
// ---------------------------------------------------------------------------

struct Span {
  int lo, hi;   // min and max of the valid positions
  bool any;     // some position is valid
  bool all;     // every position is valid and in range
};

// pos[i0 .. i0 + n - 1] (indices >= len count as padding), reduced over the warp
__device__ __forceinline__ Span warp_span(const int* __restrict__ pos, int i0, int n, int len,
                                          int lane) {
  int lo = INT_MAX, hi = -1;
  bool bad = false;
  for (int i = lane; i < n; i += 32) {
    const int p = i0 + i < len ? pos[i0 + i] : -1;
    if (p >= 0) {
      lo = min(lo, p);
      hi = max(hi, p);
    } else {
      bad = true;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  return Span{lo, hi, hi >= 0, !__any_sync(0xffffffffu, bad)};
}

// the span of queries s0 .. s0 + bq - 1 of lane b, over the warp
__device__ __forceinline__ Span query_span(const int* __restrict__ q_pos, int b, int s0, int bq,
                                           int s_len, int lane) {
  return warp_span(q_pos + (long long)b * s_len, s0, min(bq, s_len - s0), s_len, lane);
}

// the same span, by one thread alone
template <int kN>
__device__ __forceinline__ Span serial_span(const int* __restrict__ pos, int i0, int len) {
  int lo = INT_MAX, hi = -1;
  bool bad = false;
#pragma unroll 8
  for (int i = 0; i < kN; ++i) {
    const int p = i0 + i < len ? pos[i0 + i] : -1;
    if (p >= 0) {
      lo = min(lo, p);
      hi = max(hi, p);
    } else {
      bad = true;
    }
  }
  return Span{lo, hi, hi >= 0, !bad};
}

// pos[i0 .. i0 + n - 1], by one thread (n at run time: a query tile's rows
// within S)
__device__ __forceinline__ Span row_span(const int* __restrict__ pos, int i0, int n) {
  int lo = INT_MAX, hi = -1;
  bool bad = false;
  for (int i = 0; i < n; ++i) {
    const int p = pos[i0 + i];
    if (p >= 0) {
      lo = min(lo, p);
      hi = max(hi, p);
    } else {
      bad = true;
    }
  }
  return Span{lo, hi, hi >= 0, !bad};
}

enum TileState { kDead = 0, kPartial = 1, kFull = 2 };

__device__ __forceinline__ int tile_state(const Span& q, const Span& k, bool causal, int window) {
  if (!q.any || !k.any) return kDead;
  if (causal && k.lo > q.hi) return kDead;
  if (window > 0 && q.lo - k.hi >= window) return kDead;
  const bool full = q.all && k.all && (!causal || k.hi <= q.lo) &&
                    (window <= 0 || q.hi - k.lo < window);
  return full ? kFull : kPartial;
}

// Walks a block's key tiles in order, 32 at a time: lane i classifies tile
// base + i and a ballot keeps which are live and which full. Every warp of
// the block walks the same tiles to the same answers, with no barrier. The
// kernel's own arguments are passed to next(), not kept here, so that the
// walk holds few registers beside the output accumulators.
struct KeyTiles {
  Span q;  // the block's query span
  int base;
  unsigned live, full;

  __device__ __forceinline__ explicit KeyTiles(Span qs) : q(qs), base(-32), live(0u), full(0u) {}

  // the first live tile at or after j (n, the number of key tiles, if
  // none); is_full says whether it needs no mask
  template <int kBK>
  __device__ __forceinline__ int next(int j, bool& is_full, const int* __restrict__ kv_pos,
                                      int t_len, int n, bool causal, int window, int lane) {
    while (j < n) {
      if (j >= base + 32) {
        base = j;
        const int jt = j + lane;
        const int st =
            jt < n ? tile_state(q, serial_span<kBK>(kv_pos, jt * kBK, t_len), causal, window)
                   : kDead;
        live = __ballot_sync(0xffffffffu, st != kDead);
        full = __ballot_sync(0xffffffffu, st == kFull);
      }
      const unsigned rest = live >> (j - base);
      if (rest) {
        j += __ffs(static_cast<int>(rest)) - 1;
        is_full = (full >> (j - base)) & 1u;
        return j;
      }
      j = base + 32;
    }
    return n;
  }
};

// The same walk from the key side, for a block that owns a key tile
// (dkv_tc_kernel): lane i classifies query tile base + i (its positions
// within S, serially) against the block's key span, so the two walks keep
// the same (query tile, key tile) pairs.
struct QueryTiles {
  Span k;  // the block's key span
  int base;
  unsigned live, full;

  __device__ __forceinline__ explicit QueryTiles(Span ks) : k(ks), base(-32), live(0u), full(0u) {}

  // the first live query tile at or after i (n if none); q_pos is the
  // block's batch lane's row of positions, bq queries per tile
  __device__ __forceinline__ int next(int i, bool& is_full, const int* __restrict__ q_pos,
                                      int s_len, int bq, int n, bool causal, int window,
                                      int lane) {
    while (i < n) {
      if (i >= base + 32) {
        base = i;
        const int it = i + lane;
        const int s0 = it * bq;
        const int st =
            it < n ? tile_state(row_span(q_pos, s0, min(bq, s_len - s0)), k, causal, window)
                   : kDead;
        live = __ballot_sync(0xffffffffu, st != kDead);
        full = __ballot_sync(0xffffffffu, st == kFull);
      }
      const unsigned rest = live >> (i - base);
      if (rest) {
        i += __ffs(static_cast<int>(rest)) - 1;
        is_full = (full >> (i - base)) & 1u;
        return i;
      }
      i = base + 32;
    }
    return n;
  }
};

// The walk alone: each block of fwd_tc_kernel's or dq_tc_kernel's grid
// (one warp here) walks its key tiles as the kernel does and adds how many
// it visits to *visits. Nothing is loaded and no product runs; the count
// (flash_attn.tc_visits) is what the kernel's tile skip leaves to do.
template <int kBK>
__global__ void __launch_bounds__(32)
visit_kernel(const int* __restrict__ q_pos, const int* __restrict__ kv_pos, int s_len,
             int t_len, int kv, int bq, int n_bh, int n_qt, bool causal, int window,
             unsigned long long* visits) {
  const BlockRows blk = block_rows(n_bh, n_qt, bq);
  const int lane = threadIdx.x;
  KeyTiles tiles(query_span(q_pos, blk.bh / kv, blk.s0, bq, s_len, lane));
  const int n_kt = (t_len + kBK - 1) / kBK;
  bool full = false;
  unsigned long long n = 0;
  for (int j = tiles.next<kBK>(0, full, kv_pos, t_len, n_kt, causal, window, lane); j < n_kt;
       j = tiles.next<kBK>(j + 1, full, kv_pos, t_len, n_kt, causal, window, lane)) {
    ++n;
  }
  if (lane == 0) atomicAdd(visits, n);
}

// visit_kernel on the grid of a kernel whose tiles are bq queries by bk keys
inline int launch_visits(int bq, int bk, const void* q_pos, const void* kv_pos, int b,
                         int s_len, int t_len, int kv, int causal, int window, void* visits,
                         void* stream) {
  const int n_qt = (s_len + bq - 1) / bq, n_bh = b * kv;
  if ((long long)n_qt * n_bh > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  auto* out = static_cast<unsigned long long*>(visits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bk) {
    case 16:
      visit_kernel<16><<<n_qt * n_bh, 32, 0, st>>>(qp, kp, s_len, t_len, kv, bq, n_bh, n_qt,
                                                    causal != 0, window, out);
      break;
    case 32:
      visit_kernel<32><<<n_qt * n_bh, 32, 0, st>>>(qp, kp, s_len, t_len, kv, bq, n_bh, n_qt,
                                                    causal != 0, window, out);
      break;
    case 64:
      visit_kernel<64><<<n_qt * n_bh, 32, 0, st>>>(qp, kp, s_len, t_len, kv, bq, n_bh, n_qt,
                                                    causal != 0, window, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace attn
