// Hopper (sm_90a) building blocks for hand-written kernels: the Tensor
// Memory Accelerator (TMA) with its tensor maps, mbarriers, warpgroup
// matrix multiply (wgmma) with its shared-memory descriptors and fences,
// setmaxnreg and named barriers. flash_attn_fwd.cu's training forward is
// built from them; the backward kernels can be.
//
// Layouts these helpers assume (the ones TMA writes under a 128-byte
// swizzle and wgmma reads with a 128-byte-swizzle descriptor):
//  * a tile is a stack of 128-byte rows (64 2-byte elements); within each
//    1024-byte group of 8 rows, the 16-byte chunk c of row r sits at chunk
//    c ^ (r % 8). Tiles start on 1024-byte boundaries, so the swizzle is
//    a function of the shared-memory address alone;
//  * K-major operand (A, or B of S = Q K^T): rows are M (or N), K
//    contiguous; a 16-deep step k of a 64-wide piece starts 32 k bytes into
//    the rows, 8-row groups are 1024 bytes apart (SBO);
//  * MN-major B (V of O = P V): rows are K, N contiguous in 64-wide pieces
//    LBO bytes apart, 8-row groups 1024 bytes apart (SBO).
// wgmma's accumulator fragment (m64nN, f32): warp w of the warpgroup holds
// rows 16 w + lane / 4 and 8 below; n8 block i of the row pair is
// d[4 i .. 4 i + 3] = (row, 8 i + 2 t), (row, 8 i + 2 t + 1), (row + 8, 8 i
// + 2 t), (row + 8, 8 i + 2 t + 1), t = lane % 4: the mma.sync m16n8k16 C
// fragment, so two neighbouring n8 blocks are the A fragment of a 16-deep
// register-A product (attn_mma.cuh c_to_a).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers (shared-memory barriers that count arrivals and TMA bytes)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the inits visible to the async proxy (TMA) before any use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// the longest a barrier wait may last before the kernel traps: a pipeline
// whose arrivals or bytes do not add up faults the launch instead of
// spinning on the card for ever
constexpr uint64_t kWaitLimitNs = 4000000000ull;

// waits until the phase of parity `parity` has completed (parity 1 on a
// fresh barrier passes at once: the phase before the first)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > kWaitLimitNs) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA: whole tiles between device and shared memory, issued by one thread
// ---------------------------------------------------------------------------

// the box at coordinates (c0 innermost .. c3) of `map` into dst; its bytes
// complete a transaction on bar. Out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// src into the box at (c0 .. c3) of `map`; elements out of bounds are not
// written. Reads of src are tracked by the bulk group (tma_store_commit,
// tma_store_wait_read).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until every committed store has read its shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's ordinary shared-memory writes before later reads by
// the async proxy (TMA stores, wgmma operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// warp specialisation
// ---------------------------------------------------------------------------

// barrier `id` (1-15; 0 is __syncthreads) among `n` threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the calling warpgroup's registers per thread, raised or lowered (all
// four warps execute it; the kernel's roles must not reconverge after)
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// the descriptor of a 128-byte-swizzled operand at shared address addr;
// lbo and sbo in bytes (see the layouts above)
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// before the first wgmma of a group whose registers other instructions wrote
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins an accumulator register in program order around wgmma's
// asynchronous reads and writes: the compiler moves no access across it
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D (64 x 16, f32) = A (64 x 16) B^T + D (D ignored where scale_d is 0), A
// (desc da) and B (16 x 16, desc db) both K-major in shared memory
#define HOPPER_WGMMA_SS_16(TY)                                                        \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "                     \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "                                            \
      "%8, %9, p, 1, 1, 0, 0;\n}\n"                                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                               \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                \
      : "l"(da), "l"(db), "r"(scale_d))

// D (64 x 64, f32) = A (64 x 16) B^T + D (D ignored where scale_d is 0), A
// (desc da) and B (64 x 16, desc db) both K-major in shared memory
#define HOPPER_WGMMA_SS_64(TY)                                                        \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                     \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                              \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                        \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                                      \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                                    \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                               \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                               \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                             \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                           \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                           \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                            \
      : "l"(da), "l"(db), "r"(scale_d))

// D (64 x 64, f32) = A (64 x 16) B + D (D ignored where scale_d is 0), A
// in registers (the m16n8k16 A fragment per warp), B (16 x 64, desc db)
// MN-major in shared memory
#define HOPPER_WGMMA_RS_64(TY)                                                        \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                     \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                              \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                        \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                                      \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                                    \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                               \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                               \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                             \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                           \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                           \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// D (64 x 128, f32) = A (64 x 16) B + D (D ignored where scale_d is 0), A
// in registers (the m16n8k16 A fragment per warp), B (16 x 128, desc db)
// MN-major in shared memory
#define HOPPER_WGMMA_RS_128(TY)                                                       \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                              \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                        \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                                      \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                                      \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                                      \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                                      \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                                      \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                                    \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                               \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                               \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                             \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                           \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                           \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                           \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                           \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                           \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                           \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                           \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                           \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                           \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                           \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// D (64 x 256, f32) = A (64 x 16) B + D (D ignored where scale_d is 0), A
// in registers (the m16n8k16 A fragment per warp), B (16 x 256, desc db)
// MN-major in shared memory
#define HOPPER_WGMMA_RS_256(TY)                                                       \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                   \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7,"                                              \
      " %8, %9, %10, %11, %12, %13, %14, %15,"                                        \
      " %16, %17, %18, %19, %20, %21, %22, %23,"                                      \
      " %24, %25, %26, %27, %28, %29, %30, %31,"                                      \
      " %32, %33, %34, %35, %36, %37, %38, %39,"                                      \
      " %40, %41, %42, %43, %44, %45, %46, %47,"                                      \
      " %48, %49, %50, %51, %52, %53, %54, %55,"                                      \
      " %56, %57, %58, %59, %60, %61, %62, %63,"                                      \
      " %64, %65, %66, %67, %68, %69, %70, %71,"                                      \
      " %72, %73, %74, %75, %76, %77, %78, %79,"                                      \
      " %80, %81, %82, %83, %84, %85, %86, %87,"                                      \
      " %88, %89, %90, %91, %92, %93, %94, %95,"                                      \
      " %96, %97, %98, %99, %100, %101, %102, %103,"                                  \
      " %104, %105, %106, %107, %108, %109, %110, %111,"                              \
      " %112, %113, %114, %115, %116, %117, %118, %119,"                              \
      " %120, %121, %122, %123, %124, %125, %126, %127}, "                            \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                               \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                               \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                             \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                           \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                           \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                           \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                           \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                           \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                           \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                           \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                           \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                           \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                           \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),                           \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),                           \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),                           \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),                           \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),                           \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),                           \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),                           \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),                           \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),                           \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),                           \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),                       \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),                       \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),                       \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),                       \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),                       \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),                       \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))


template <typename T> struct Wgmma;

template <> struct Wgmma<__nv_bfloat16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da, uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_SS_16("bf16");
  }
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_SS_64("bf16");
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_RS_64("bf16");
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_RS_128("bf16");
  }
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_RS_256("bf16");
  }
};

template <> struct Wgmma<__half> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da, uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_SS_16("f16");
  }
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_SS_64("f16");
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_RS_64("f16");
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_RS_128("f16");
  }
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    HOPPER_WGMMA_RS_256("f16");
  }
};

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

template <typename T> struct TmaType;
template <> struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct TmaType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (no link
// against libcuda); null if the driver has none
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous (n3, n2, n1, n0) tensor of 2-byte T, n0
// innermost, read and written in boxes of (1, box2, box1, 64) under the
// 128-byte swizzle: each box row is one 128-byte row of a tile. Returns 0,
// or cudaErrorInvalidValue if the driver refuses the map.
template <typename T>
int tensor_map_4d(CUtensorMap* map, const void* base, int n0, int n1, int n2, int n3, int box1,
                  int box2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  constexpr cuuint64_t kE = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2, (cuuint64_t)n3};
  const cuuint64_t strides[3] = {dims[0] * kE, dims[0] * dims[1] * kE,
                                 dims[0] * dims[1] * dims[2] * kE};
  const cuuint32_t box[4] = {64, (cuuint32_t)box1, (cuuint32_t)box2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, TmaType<T>::value, 4, const_cast<void*>(base), dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
