// Hopper warpgroup helpers shared by the 16-bit attention kernels of
// flash_attention.cu (forward, dq, dk/dv; bf16 and f16) and
// decode_attention.cu (the prefill form, bf16): wgmma products with operands
// in 128-byte-swizzled shared memory (through hand-written descriptors) or A
// in registers, the fences around them, and the cp.async copy of a 64-row
// tile into the swizzled layout. The element type T (bf16 or f16) picks the
// wgmma's `.bf16` or `.f16` form: the same m64nNk16 shapes, fragment layouts
// and descriptors, f32 accumulators either way.
//
// A block is one warpgroup (4 warps, 128 threads) owning a 64-row tile.
// Q, K and V tiles sit in shared memory in the 128-byte swizzled layout
// wgmma's descriptors describe: each 64-column panel of a 64-row tile is 64
// rows of 128 bytes, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), tiles 1024-byte aligned. S = Q.K^T reads both from shared
// memory (K-major); P.V takes P from registers as the A operand (the score
// accumulators packed to the element type by `pack_a`) and V from shared
// memory (MN-major, V's rows are the k dimension).
#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;  // one warpgroup
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;  // query rows of a tile (16 per warp)
constexpr int kCols = 64;  // key columns of a tile

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until the warpgroup's committed products have completed.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Writes of the generic proxy (cp.async) visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A wgmma reads and writes its register operands after the instruction
// is sent, until its group is waited for; the compiler cannot see that.
// Fencing the registers before the wgmma and after the wait keeps every
// other read or write of them outside that window, and keeps the registers
// themselves from being reused for other values inside it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading byte offset (the stride between 64-element panels of an MN-major
// operand; unused K-major), stride byte offset 1024 (between 8-row groups).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory
// (descriptors), both K-major; scale_d = 0 ignores D's old values. TY is
// the element type's PTX name ("bf16" or "f16").
#define WGMMA_M64N64K16_SS(TY)                                               \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),          \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),          \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),          \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),          \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),          \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),          \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),          \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])           \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  if constexpr (std::is_same<T, f16>::value)
    WGMMA_M64N64K16_SS("f16");
  else
    WGMMA_M64N64K16_SS("bf16");
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (each warp's
// m16n8k16 A fragments of its 16 rows), B in shared memory, MN-major.
#define WGMMA_M64N64K16_RS(TY)                                               \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),          \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),          \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),          \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),          \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),          \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),          \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),          \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  if constexpr (std::is_same<T, f16>::value)
    WGMMA_M64N64K16_RS("f16");
  else
    WGMMA_M64N64K16_RS("bf16");
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (each warp's
// m16n8k16 A fragments of its 16 rows), B in shared memory, MN-major.
#define WGMMA_M64N128K16_RS(TY)                                              \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63"                               \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),          \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),          \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),          \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),          \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),          \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),          \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),          \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),          \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),          \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),          \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),      \
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),      \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),      \
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),      \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),      \
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[16][4],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  if constexpr (std::is_same<T, f16>::value)
    WGMMA_M64N128K16_RS("f16");
  else
    WGMMA_M64N128K16_RS("bf16");
}

// One thread's share of the 16-byte copies of a 64-row 16-bit tile into a
// swizzled tile (see above), from rows H * D elements apart: one head of a
// [B, S, H, D] tensor, or (H = 1) a contiguous [T, D] slab. Copy i of a
// thread is chunk c = tid % CPR of row r = tid / CPR + i * STEP, STEP a
// multiple of 8, so r % 8 and with it the swizzle stay those of copy 0.
template <int D>
struct SwizzledCopy {
  static constexpr int CPR = D / 8;            // 16-byte chunks per row
  static constexpr int STEP = kThreads / CPR;  // rows between copies
  static constexpr int N = kRows / STEP;
  static_assert(STEP % 8 == 0, "the swizzle repeats every 8 rows");
  int row, src, dst;  // copy 0's tile row, source element, byte offset
  int src_step;       // source elements between copies
  __device__ __forceinline__ explicit SwizzledCopy(int H)
      : row(threadIdx.x / CPR),
        src(row * H * D + (threadIdx.x % CPR) * 8),
        dst(((threadIdx.x % CPR) >> 3) * (kRows * 128) + row * 128 +
            ((((threadIdx.x % CPR) & 7) ^ (row & 7)) << 4)),
        src_step(STEP * H * D) {}
  // Rows [row0, row0 + 64) of the head whose element (0, 0) is at `head`
  // into `tile`; rows at or past S are zero-filled and not read.
  template <typename T>
  __device__ __forceinline__ void load(unsigned char* tile,
                                       const T* __restrict__ head,
                                       int row0, int S, int H) const {
    static_assert(sizeof(T) == 2, "a 16-bit element type");
    const T* first = head + (size_t)row0 * H * D + src;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool live = row0 + row + i * STEP < S;
      cp_async16(tile + dst + i * STEP * 128,
                 live ? first + (size_t)i * src_step : head, live);
    }
  }
};

// D[64 x 64] = A . B^T over D for two swizzled 64-row tiles (A rows x D,
// B columns x D), both K-major: D / 16 wgmma, the first with scale_d = 0.
template <int D, typename T = bf16>
__device__ __forceinline__ void wgmma_abt(float (&d)[kCols / 8][4],
                                          const unsigned char* a,
                                          const unsigned char* b) {
  constexpr int PANEL = kRows * 128;  // bytes of a 64-column panel
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int off = (ks >> 2) * PANEL + (ks & 3) * 32;
    wgmma_m64n64k16_ss<T>(d, sw128_desc(a + off, 16),
                          sw128_desc(b + off, 16), ks > 0);
  }
}

// O += P . V for one tile: P in registers (k-block kk in pa[kk]), V the
// swizzled tile at v_t.
template <int D, typename T = bf16>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 8][4],
                                         const uint32_t (&pa)[kCols / 16][4],
                                         const unsigned char* v_t) {
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk) {
    const uint64_t dv = sw128_desc(v_t + kk * 16 * 128, kRows * 128);
    if constexpr (D == 64)
      wgmma_m64n64k16_rs<T>(o, pa[kk], dv);
    else
      wgmma_m64n128k16_rs<T>(o, pa[kk], dv);
  }
}

#undef WGMMA_M64N64K16_SS
#undef WGMMA_M64N64K16_RS
#undef WGMMA_M64N128K16_RS

}  // namespace
