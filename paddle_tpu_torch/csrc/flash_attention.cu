// Flash attention forward and backward for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (paddle_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   * flash_fwd_kernel  <- `_fwd_kernel` (:89), launched by `_mha_fwd` (:146);
//   * flash_dq_kernel   <- `_dq_kernel` (:166, launched at :394) and
//                          `_dq_kernel_chunked` (:230, launched at :327);
//   * flash_dkv_kernel  <- `_dkv_kernel` (:196, launched at :420) and
//                          `_dkv_kernel_chunked` (:272, launched at :343).
// The TPU backward has two forms: full-sequence blocks for S <= 4096 and
// 512x512 chunks accumulated in f32 for longer sequences, because VMEM
// cannot hold [block, S] score tiles there. These kernels stream the
// partner axis through shared memory in 64-wide tiles at every S, which is
// the chunked form's contract (f32 accumulation, tiles above the causal
// diagonal skipped, memory independent of S), so one kernel serves both.
//
// Layout: q, k, v, out, dout, dq, dk, dv are contiguous [B, S, H, D] (the
// paddle layout; GQA is repeated by the wrapper before the call), element
// (b, s, h, d) at ((b * S + s) * H + h) * D + d. lse and delta are f32
// [B * H, S]. The wrapper computes delta = rowsum(dout * out) in f32 with one
// torch reduction, as the TPU path does outside its kernels (:375).
//
// Rounding, as the TPU kernels round: products take the storage dtype and
// accumulate in f32; P is rounded to V's dtype before P.V (:112); in the
// backward p is rounded to dO's dtype before dV (:219) and ds to K's / Q's
// dtype before dq (:191) / dk (:224); dq, dk, dv accumulate in f32 and are
// rounded once. A row with no allowed column gives out = 0 and lse = 0
// (:121-125).
//
// Bound: at the training shape (B*H = 128, S = 1024, D = 64, causal, bf16)
// the forward does 2 * 2 * B*H * S^2 * D / 2 ~ 17 GFLOP on ~67 MB (q, k, v
// read, out written), ~256 flop/byte, just under the ~295 flop/byte ridge of
// the card: bytes and operations bound it about equally. The dq kernel does
// three such products on ~85 MB and the dk/dv kernel four on ~101 MB, so
// they are bound by tensor-core operations. The design therefore puts every
// product on the tensor cores (bf16 mma.sync m16n8k16, f32 accumulation;
// operands from shared memory by ldmatrix) and keeps the [S, S] scores out
// of device memory:
//   * The TPU forward holds all of K/V for a q block in VMEM (256 KB at
//     S = 1024, over the 227 KB a block may use here). Here a block owns 64
//     query rows (16 per warp) and loops over 64-column K/V tiles, stopping
//     at the diagonal when causal, with an online softmax (m, l) in f32
//     registers.
//   * The dq kernel walks K/V tiles the same way and accumulates
//     dq += ds.K in f32 registers; the dk/dv kernel owns 64 key columns and
//     walks the query tiles from the diagonal down, accumulating
//     dv += p^T.dO and dk += ds^T.Q. No atomics: results are deterministic.
//   * P and ds go through shared memory in the storage dtype, which is
//     where the TPU kernels round them; rows are padded by 16 bytes so that
//     ldmatrix reads are free of bank conflicts.
//   * Heavy causal tiles are scheduled first.
// f32 inputs take the same tiles with the products done by CUDA-core FMAs
// in full f32 (tensor cores would round them to TF32). No wgmma, TMA or
// software pipelining yet: this is the simple, correct first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;  // query rows of a tile (16 per warp)
constexpr int kCols = 64;  // key columns of a tile

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of head (b, h) of a [B, S, H, D] tensor into a
// shared tile with row stride LD; rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int b, int h, int row0, int S,
                                          int H) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  constexpr int LD = D + VEC;
  for (int idx = threadIdx.x; idx < kRows * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(
          src + ((size_t)b * S + s) * H * D + (size_t)h * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's product into m16n8 accumulator fragments: acc[j] holds rows
// 0..15 and columns 8j..8j+7 of C += A . B, lane l owning rows l/4 and
// l/4 + 8, columns 2(l%4) and 2(l%4) + 1. A (16 x K) is row-major with
// stride lda. B is given either n-major (`nk`: element (k, n) at
// B[n * ldb + k]) or k-major (`kn`: at B[k * ldb + n]). All in shared memory.
template <typename T, int NB, int K>
struct WarpMma;

template <int NB, int K>
struct WarpMma<bf16, NB, K> {
  static_assert(NB % 2 == 0 && K % 16 == 0, "tile shape");
  static __device__ __forceinline__ void nk(float (&acc)[NB][4],
                                            const bf16* A, int lda,
                                            const bf16* B, int ldb) {
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
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
  static __device__ __forceinline__ void kn(float (&acc)[NB][4],
                                            const bf16* A, int lda,
                                            const bf16* B, int ldb) {
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
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
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

// Write a warp's 16 x D accumulators as rows of a [B, S, H, D] tensor;
// rows at or past S are not written.
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* __restrict__ dst,
                                           const float (&f)[D / 8][4], int b,
                                           int h, int row_lo, int S, int H,
                                           float mul_lo, float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row_lo + 8 * half;
    if (s >= S) continue;
    const float mul = half ? mul_hi : mul_lo;
    T* row = dst + ((size_t)b * S + s) * H * D + (size_t)h * D + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      row[j * 8] = from_float<T>(f[j][2 * half] * mul);
      row[j * 8 + 1] = from_float<T>(f[j][2 * half + 1] * mul);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  return (size_t)(3 * kRows * (D + 16 / sizeof(T)) +
                  kRows * (kCols + 16 / sizeof(T))) * sizeof(T);
}

// grid (ceil(S / 64), B * H), block 128. The heaviest causal tiles (the
// last query rows) are scheduled first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, float scale,
                 int causal) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = D + VEC;
  constexpr int LDP = kCols + VEC;
  constexpr int NC = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kRows * LD;
  T* v_s = k_s + kCols * LD;
  T* p_s = v_s + kCols * LD;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_lo = row0 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  T* p_w = p_s + warp * 16 * LDP;

  load_tile<T, D>(q_s, q, b, h, row0, S, H);
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int col_end = causal ? min(S, row0 + kRows) : S;
  const int tiles = (col_end + kCols - 1) / kCols;

  for (int t = 0; t < tiles; ++t) {
    const int c0 = t * kCols;
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<T, D>(k_s, k, b, h, c0, S, H);
    load_tile<T, D>(v_s, v, b, h, c0, S, H);
    __syncthreads();
    float s[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    WarpMma<T, NC, D>::nk(s, q_s + warp * 16 * LD, LD, k_s, LD);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + 8 * (e >> 1);
        const int col = c0 + j * 8 + cq + (e & 1);
        const bool allowed = col < S && (!causal || col <= row);
        s[j][e] = allowed ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = mx[i] == -INFINITY ? 1.f : expf(m[i] - mx[i]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    store_frag<T, NC>(p_w, LDP, s);  // P rounded to V's dtype
    __syncwarp();
    WarpMma<T, D / 8, kCols>::kn(o, p_w, LDP, v_s, LD);
    __syncwarp();
  }

  // o / l, and lse = m + log(l); 0 and 0 for a row with no allowed column
  const float inv_lo = l[0] > 0.f ? 1.f / l[0] : 0.f;
  const float inv_hi = l[1] > 0.f ? 1.f / l[1] : 0.f;
  write_rows<T, D>(out, o, b, h, row_lo, S, H, inv_lo, inv_hi);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row < S)
        lse[(size_t)bh * S + row] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
    }
  }
}

template <typename T, int D>
constexpr size_t dq_smem() {
  return (size_t)(4 * kRows * (D + 16 / sizeof(T)) +
                  kRows * (kCols + 16 / sizeof(T))) * sizeof(T);
}

// grid (ceil(S / 64), B * H), block 128: one block per 64 query rows, the
// K/V tiles walked up to the diagonal. Heaviest tiles first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int H, float scale, int causal) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = D + VEC;
  constexpr int LDP = kCols + VEC;
  constexpr int NC = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kRows * LD;
  T* k_s = do_s + kRows * LD;
  T* v_s = k_s + kCols * LD;
  T* ds_s = v_s + kCols * LD;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_lo = row0 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  T* ds_w = ds_s + warp * 16 * LDP;

  load_tile<T, D>(q_s, q, b, h, row0, S, H);
  load_tile<T, D>(do_s, dout, b, h, row0, S, H);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    lse_r[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    delta_r[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int col_end = causal ? min(S, row0 + kRows) : S;
  const int tiles = (col_end + kCols - 1) / kCols;

  for (int t = 0; t < tiles; ++t) {
    const int c0 = t * kCols;
    __syncthreads();
    load_tile<T, D>(k_s, k, b, h, c0, S, H);
    load_tile<T, D>(v_s, v, b, h, c0, S, H);
    __syncthreads();
    float s[NC][4], dp[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    WarpMma<T, NC, D>::nk(s, q_s + warp * 16 * LD, LD, k_s, LD);
    WarpMma<T, NC, D>::nk(dp, do_s + warp * 16 * LD, LD, v_s, LD);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row_lo + 8 * i;
        const int col = c0 + j * 8 + cq + (e & 1);
        const bool allowed = col < S && (!causal || col <= row);
        const float p = allowed ? expf(s[j][e] * scale - lse_r[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[i]) * scale;  // ds
      }
    }
    store_frag<T, NC>(ds_w, LDP, s);  // ds rounded to K's dtype
    __syncwarp();
    WarpMma<T, D / 8, kCols>::kn(acc, ds_w, LDP, k_s, LD);
    __syncwarp();
  }
  write_rows<T, D>(dq, acc, b, h, row_lo, S, H, 1.f, 1.f);
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  return (size_t)(4 * kRows * (D + 16 / sizeof(T)) +
                  2 * kCols * (kRows + 16 / sizeof(T))) * sizeof(T) +
         2 * kRows * sizeof(float);
}

// grid (ceil(S / 64), B * H), block 128: one block per 64 key columns, the
// query tiles walked from the diagonal down (the heaviest blocks, the first
// columns, are scheduled first by grid order).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int H, float scale, int causal) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = D + VEC;
  constexpr int LDP = kRows + VEC;
  constexpr int NR = kRows / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kCols * LD;
  T* q_s = v_s + kCols * LD;
  T* do_s = q_s + kRows * LD;
  T* p_s = do_s + kRows * LD;  // p^T [key][query]
  T* ds_s = p_s + kCols * LDP;  // ds^T [key][query]
  float* lse_s = reinterpret_cast<float*>(ds_s + kCols * LDP);
  float* delta_s = lse_s + kRows;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int col0 = blockIdx.x * kCols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key_lo = col0 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  T* p_w = p_s + warp * 16 * LDP;
  T* ds_w = ds_s + warp * 16 * LDP;

  load_tile<T, D>(k_s, k, b, h, col0, S, H);
  load_tile<T, D>(v_s, v, b, h, col0, S, H);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  const int first = causal ? col0 / kRows : 0;
  const int q_tiles = (S + kRows - 1) / kRows;

  for (int t = first; t < q_tiles; ++t) {
    const int q0 = t * kRows;
    __syncthreads();
    load_tile<T, D>(q_s, q, b, h, q0, S, H);
    load_tile<T, D>(do_s, dout, b, h, q0, S, H);
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? lse[(size_t)bh * S + q0 + r] : 0.f;
      delta_s[r] = in ? delta[(size_t)bh * S + q0 + r] : 0.f;
    }
    __syncthreads();
    float st[NR][4], dpt[NR][4];  // s^T, dp^T: rows keys, columns queries
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
    WarpMma<T, NR, D>::nk(st, k_s + warp * 16 * LD, LD, q_s, LD);
    WarpMma<T, NR, D>::nk(dpt, v_s + warp * 16 * LD, LD, do_s, LD);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_lo + 8 * (e >> 1);
        const int qi = j * 8 + cq + (e & 1);
        const int row = q0 + qi;
        const bool allowed = row < S && key < S && (!causal || key <= row);
        const float p = allowed ? expf(st[j][e] * scale - lse_s[qi]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - delta_s[qi]) * scale;  // ds^T
      }
    }
    store_frag<T, NR>(p_w, LDP, st);    // p rounded to dO's dtype
    store_frag<T, NR>(ds_w, LDP, dpt);  // ds rounded to Q's dtype
    __syncwarp();
    WarpMma<T, D / 8, kRows>::kn(dv_acc, p_w, LDP, do_s, LD);
    WarpMma<T, D / 8, kRows>::kn(dk_acc, ds_w, LDP, q_s, LD);
    __syncwarp();
  }
  write_rows<T, D>(dk, dk_acc, b, h, key_lo, S, H, 1.f, 1.f);
  write_rows<T, D>(dv, dv_acc, b, h, key_lo, S, H, 1.f, 1.f);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int S, int H, float scale,
                       int causal, cudaStream_t st) {
  const size_t smem = fwd_smem<T, D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, H, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, float scale, int causal,
                      cudaStream_t st) {
  const size_t smem = dq_smem<T, D>();
  cudaError_t err = allow_smem(flash_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, H, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, float scale,
                       int causal, cudaStream_t st) {
  const size_t smem = dkv_smem<T, D>();
  cudaError_t err = allow_smem(flash_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kCols - 1) / kCols, B * H);
  flash_dkv_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H) {
  return B <= 0 || S <= 0 || H <= 0 || B * H > 65535;
}

}  // namespace

// Each entry returns a cudaError_t (0 on success). dtype: 0 = float32,
// 1 = bfloat16; D: 64 or 128. Pointers are device pointers of contiguous
// tensors, 16-byte aligned; `stream` is a cudaStream_t (PyTorch's current
// stream). Nothing is allocated here.
#define FLASH_DISPATCH(CALL)                                        \
  do {                                                              \
    if (dtype == 0 && D == 64) return (int)CALL(float, 64);         \
    if (dtype == 0 && D == 128) return (int)CALL(float, 128);       \
    if (dtype == 1 && D == 64) return (int)CALL(bf16, 64);          \
    if (dtype == 1 && D == 128) return (int)CALL(bf16, 128);        \
    return (int)cudaErrorInvalidValue;                              \
  } while (0)

extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int S, int H, int D, int dtype,
                                       float scale, int causal,
                                       void* stream) {
  if (bad_shape(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, DD) launch_fwd<T, DD>(q, k, v, out, lse, B, S, H, scale, causal, st)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" int flash_attention_backward_dq(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dq, int B, int S, int H,
                                           int D, int dtype, float scale,
                                           int causal, void* stream) {
  if (bad_shape(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, DD) \
  launch_dq<T, DD>(q, k, v, dout, lse, delta, dq, B, S, H, scale, causal, st)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" int flash_attention_backward_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int D, int dtype, float scale, int causal, void* stream) {
  if (bad_shape(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, DD)                                                    \
  launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, \
                    causal, st)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
