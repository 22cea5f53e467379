// Helpers shared by the port's attention kernels (flash_attention.cu,
// paged_attention.cu, decode_attention.cu): warp-level bf16 and f16 tensor-core
// products (mma.sync m16n8k16 with ldmatrix operands, or with the A operand
// already in registers) and their f32 CUDA-core twin, fragment stores and the
// packing of f32 score fragments into bf16 or f16 A fragments, quad reductions
// over an m16n8 row, the base-2 online softmax of a score tile, 16-byte
// cp.async copies, the dynamic shared memory opt-in, and the split-KV combine
// pass.
//
// The combine pass replaces the TPU package's XLA stage-2 reduction
// `_combine_partials` (paddle_tpu/ops/pallas/decode_attention.py:153): it
// rescales and sums the per-split f32 partials (o, m, l) and writes 0 for a
// row with l = 0, in a second launch (`split_kv_combine_kernel`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ f16 from_float<f16>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores, m16n8k16 with f32 accumulation; T (bf16
// or f16) picks the `.bf16` or `.f16` form, same fragment layouts.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, f16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without passing through registers. With
// `live` false nothing is read and the 16 bytes are zero-filled (source
// size 0), so `src` need only be some valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every group this thread committed has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of the groups this thread committed are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats rounded to the 16-bit type T (bf16 or f16, round to nearest
// even) and packed into one 32-bit word, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value) {
    const __half2 p = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  } else {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
}

// f32 score fragments (m16n8 accumulators, columns 8j..8j+7 in s[j]) as the
// 16-bit A fragments (element type T: bf16 or f16) of the next m16n8k16 or
// wgmma product: the accumulator layout of columns 16kk..16kk+15 is the A
// layout of k-block kk, so P never leaves the registers. Each value is
// rounded to T (round to nearest even; f16 keeps subnormals).
template <int NC, typename T = bf16>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NC / 2][4],
                                       const float (&s)[NC][4]) {
#pragma unroll
  for (int kk = 0; kk < NC / 2; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* f = &s[2 * kk + (i >> 1)][(i & 1) * 2];
      a[kk][i] = pack2<T>(f[0], f[1]);
    }
  }
}

// One warp's 16-bit products (element type T: bf16 or f16) with the A
// operand (16 x K) in registers, as `pack_a` or `load_a` leave it: a[ks] is
// k-block ks.
template <int NB, int K, typename T = bf16>
struct WarpMmaA {
  static_assert(NB % 2 == 0 && K % 16 == 0, "tile shape");
  // A rows 0..15 of a row-major 16-bit tile (stride lda) into registers.
  static __device__ __forceinline__ void load_a(uint32_t (&a)[K / 16][4],
                                                const T* A, int lda) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks)
      ldsm_x4(a[ks], A + (lane & 15) * lda + ks * 16 + (lane >> 4) * 8);
  }
  // B n-major: element (k, n) at B[n * ldb + k].
  static __device__ __forceinline__ void nk(float (&acc)[NB][4],
                                            const uint32_t (&a)[K / 16][4],
                                            const T* B, int ldb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, B + (j * 8 + (lane & 7) + (lane >> 4) * 8) * ldb +
                       ks * 16 + ((lane >> 3) & 1) * 8);
        mma16<T>(acc[j], a[ks], b[0], b[1]);
        mma16<T>(acc[j + 1], a[ks], b[2], b[3]);
      }
    }
  }
  // B k-major: element (k, n) at B[k * ldb + n].
  static __device__ __forceinline__ void kn(float (&acc)[NB][4],
                                            const uint32_t (&a)[K / 16][4],
                                            const T* B, int ldb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, B + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb +
                         j * 8 + (lane >> 4) * 8);
        mma16<T>(acc[j], a[ks], b[0], b[1]);
        mma16<T>(acc[j + 1], a[ks], b[2], b[3]);
      }
    }
  }
};

// Scores are kept in base-2 units: s * scale * log2(e), so that each
// probability is one exp2 (ex2.approx) and the maxima m are base-2 too.
// Natural-log quantities (lse, the split-KV partials' m) are m * ln 2.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One warp's product into m16n8 accumulator fragments: acc[j] holds rows
// 0..15 and columns 8j..8j+7 of C += A . B, lane l owning rows l/4 and
// l/4 + 8, columns 2(l%4) and 2(l%4) + 1. A (16 x K) is row-major with
// stride lda. B is given either n-major (`nk`: element (k, n) at
// B[n * ldb + k]) or k-major (`kn`: at B[k * ldb + n]). All in shared memory.
// The primary template is the 16-bit one (T bf16 or f16, tensor cores).
template <typename T, int NB, int K>
struct WarpMma {
  static_assert(NB % 2 == 0 && K % 16 == 0, "tile shape");
  static __device__ __forceinline__ void nk(float (&acc)[NB][4],
                                            const T* A, int lda,
                                            const T* B, int ldb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, A + (lane & 15) * lda + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, B + (j * 8 + (lane & 7) + (lane >> 4) * 8) * ldb +
                       ks * 16 + ((lane >> 3) & 1) * 8);
        mma16<T>(acc[j], a, b[0], b[1]);
        mma16<T>(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
  static __device__ __forceinline__ void kn(float (&acc)[NB][4],
                                            const T* A, int lda,
                                            const T* B, int ldb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, A + (lane & 15) * lda + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, B + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb +
                         j * 8 + (lane >> 4) * 8);
        mma16<T>(acc[j], a, b[0], b[1]);
        mma16<T>(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
};

// f32: the same fragments, each lane summing its own four outputs in f32.
template <int NB, int K>
struct WarpMma<float, NB, K> {
  static __device__ __forceinline__ void nk(float (&acc)[NB][4],
                                            const float* A, int lda,
                                            const float* B, int ldb) {
    const int lane = threadIdx.x & 31;
    const float* a0 = A + (lane >> 2) * lda;
    const float* a1 = a0 + 8 * lda;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float* b0 = B + (j * 8 + (lane & 3) * 2) * ldb;
      const float* b1 = b0 + ldb;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        acc[j][0] = fmaf(a0[k], b0[k], acc[j][0]);
        acc[j][1] = fmaf(a0[k], b1[k], acc[j][1]);
        acc[j][2] = fmaf(a1[k], b0[k], acc[j][2]);
        acc[j][3] = fmaf(a1[k], b1[k], acc[j][3]);
      }
    }
  }
  static __device__ __forceinline__ void kn(float (&acc)[NB][4],
                                            const float* A, int lda,
                                            const float* B, int ldb) {
    const int lane = threadIdx.x & 31;
    const float* a0 = A + (lane >> 2) * lda;
    const float* a1 = a0 + 8 * lda;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float* b = B + j * 8 + (lane & 3) * 2;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float b0 = b[k * ldb];
        const float b1 = b[k * ldb + 1];
        acc[j][0] = fmaf(a0[k], b0, acc[j][0]);
        acc[j][1] = fmaf(a0[k], b1, acc[j][1]);
        acc[j][2] = fmaf(a1[k], b0, acc[j][2]);
        acc[j][3] = fmaf(a1[k], b1, acc[j][3]);
      }
    }
  }
};

// Store a warp's 16 x (8 * NB) fragments into shared memory rows (stride
// ld), rounded to T.
template <typename T, int NB>
__device__ __forceinline__ void store_frag(T* dst, int ld,
                                           const float (&f)[NB][4]) {
  const int lane = threadIdx.x & 31;
  T* r0 = dst + (lane >> 2) * ld + (lane & 3) * 2;
  T* r1 = r0 + 8 * ld;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    r0[j * 8] = from_float<T>(f[j][0]);
    r0[j * 8 + 1] = from_float<T>(f[j][1]);
    r1[j * 8] = from_float<T>(f[j][2]);
    r1[j * 8 + 1] = from_float<T>(f[j][3]);
  }
}

// Max and sum over the four lanes that hold one row of an m16n8 fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The online softmax of one tile of a warp's m16n8 score fragments s,
// already in base-2 units (s * scale * log2 e, any sign of scale) and -inf
// where a column is masked: raises the row maxima m, leaves the
// unnormalised probabilities exp2(s - m) in s (one ex2 each), and rescales
// this lane's share of the row sums l and the output accumulators o by
// alpha = exp2(m_old - m) before adding the new probabilities to l. While
// every column so far is masked, m stays -inf and the probabilities are
// taken against 0, so exp2(-inf) = 0 needs no test per element; a tile
// with every column masked leaves m, l and o exactly as they were.
template <int NC, int ND>
__device__ __forceinline__ void online_softmax(float (&s)[NC][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&o)[ND][4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  float ref[2], alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = quad_max(mx[i]);
    ref[i] = m_new == -INFINITY ? 0.f : m_new;
    alpha[i] = exp2f(m[i] - ref[i]);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - ref[e >> 1]);
      l[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
}

// Grid folding. A launch over B * H (or B * Hkv) heads puts them on grid.y,
// whose limit is 65535: grid.y = min(BH, 65535), and the heads past it fold
// into another axis, `fold` = ceil(BH / grid.y) times over. A block's head
// is fold * gridDim.y + blockIdx.y; the blocks of the last fold past BH
// exit before any load or barrier.
constexpr int kMaxGridY = 65535;
inline unsigned grid_y(int BH) { return BH < kMaxGridY ? BH : kMaxGridY; }
inline unsigned grid_fold(int BH) {
  return (BH + grid_y(BH) - 1) / grid_y(BH);
}
__device__ __forceinline__ int folded_bh(unsigned fold) {
  return (int)(fold * gridDim.y + blockIdx.y);
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ------------------------------------------------------ split-KV combine
constexpr int kCombineThreads = 128;

// Row r of (b, h) = b * Hkv + h is query step r / G of query head
// h * G + r % G: its row of out [B, S, Hq, D].
template <typename T, int D>
__device__ __forceinline__ T* out_row(T* out, int bh, int r, int S, int Hq,
                                      int Hkv, int G) {
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  return out + ((size_t)(b * S + r / G) * Hq + h * G + r % G) * D;
}

// Partials o [splits, BH, SG, D] (unnormalised, f32) and m, l
// [splits, BH, SG]; row r of (b, h) = b * Hkv + h is query step r / G of
// query head h * G + r % G. One warp per (bh, row) rescales and sums the
// splits: out = sum_j o_j e^(m_j - m*) / sum_j l_j e^(m_j - m*), 0 where the
// sum of l is 0. out is [B, S, Hq, D]. A split whose m is -inf saw no
// column of the row: its o is neither read nor needs to be written.
template <typename T, int D>
__global__ void __launch_bounds__(kCombineThreads)
split_kv_combine_kernel(const float* __restrict__ o_part,
                        const float* __restrict__ m_part,
                        const float* __restrict__ l_part, T* __restrict__ out,
                        int splits, int BH, int SG, int S, int Hq, int Hkv,
                        int G) {
  constexpr int DPL = D / 32;
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (gw >= BH * SG) return;
  const int bh = gw / SG;
  const int r = gw % SG;
  float m_star = -INFINITY;
  for (int j = 0; j < splits; ++j)
    m_star = fmaxf(m_star, m_part[((size_t)j * BH + bh) * SG + r]);
  float acc[DPL];
#pragma unroll
  for (int k = 0; k < DPL; ++k) acc[k] = 0.f;
  float l_star = 0.f;
  if (m_star != -INFINITY) {
    for (int j = 0; j < splits; ++j) {
      const size_t base = ((size_t)j * BH + bh) * SG + r;
      if (m_part[base] == -INFINITY) continue;  // o of such a split unread
      const float w = expf(m_part[base] - m_star);
      l_star += l_part[base] * w;
#pragma unroll
      for (int k = 0; k < DPL; ++k)
        acc[k] += o_part[base * D + lane + 32 * k] * w;
    }
  }
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int s = r / G;
  const int g = r % G;
  T* dst = out + ((size_t)(b * S + s) * Hq + h * G + g) * D;
#pragma unroll
  for (int k = 0; k < DPL; ++k)
    dst[lane + 32 * k] = from_float<T>(l_star > 0.f ? acc[k] / l_star : 0.f);
}

template <typename T, int D>
cudaError_t launch_split_kv_combine(const void* o_part, const void* m_part,
                                    const void* l_part, void* out, int splits,
                                    int BH, int SG, int S, int Hq, int Hkv,
                                    int G, cudaStream_t stream) {
  const long long threads = (long long)BH * SG * 32;
  const int blocks = (int)((threads + kCombineThreads - 1) / kCombineThreads);
  split_kv_combine_kernel<T, D><<<blocks, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<T*>(out), splits, BH, SG,
      S, Hq, Hkv, G);
  return cudaGetLastError();
}

}  // namespace
