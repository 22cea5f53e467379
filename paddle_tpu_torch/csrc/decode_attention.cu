// Dense split-KV attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (paddle_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernel `_splitkv_kernel`
// (paddle_tpu/ops/pallas/decode_attention.py:135, with `_partials_body`
// :101 and `_write_dead` :128; launched by `decode_attention` at :220) and
// its XLA stage-2 reduction `_combine_partials` (:153). Dense `generate()`
// attends through it at prefill (S = prompt length) and at every decode
// step (S = 1).
//
// What it computes, per request b and kv head h: the S*G query rows (row
// r = s*G + g, query head h*G + g, absolute position length[b] + s) attend
// over the contiguous cache rows c of the head-leading cache [B, Hkv, T, D]
// with c <= length[b] + s (and c < T). Output [B, S, Hq, D] in the cache's
// dtype.
//
// Two forms, chosen by the wrapper (ops/decode_attention.py
// `kernel_launch_config`) from the rows S*G of one (b, h) and the dtype:
//
// Decode form (`dense_decode_kernel`; S*G <= 16, and every f32 call). A
// block owns 16 query rows of one (b, h), one m16 fragment, and a piece of
// the cache. Bound: ~4*D operations per live (row, column) pair on each
// live K/V row read once, a few flops per byte, so device-memory bytes
// bound it: the live K/V bytes over 3.35 TB/s. The design keeps bytes in
// flight and every warp busy:
//   * A (b, h) slab [T, D] is contiguous, so a 64-row K or V tile is one
//     contiguous run; tiles go through a ring of 3-4 stages of 16-byte
//     cp.async copies (rows padded by 16 bytes for conflict-free ldmatrix),
//     tiles i + 1 .. i + stages - 1 in flight while tile i is computed, one
//     barrier per tile.
//   * All four warps do products: warp w takes columns [16w, 16w + 16) of
//     every tile with its own online softmax (m, l, o), and the four are
//     merged through shared memory at the end (m* = max m_w, each weighted
//     by exp2(m_w - m*)). bf16, f16: Q's fragments loaded once, Q.K^T and P.V
//     on mma.sync m16n8k16 with P packed from the score accumulators
//     (`pack_a`). f32 (the speculative self-drafter, generate(dtype=None)):
//     the same tiles through CUDA-core FMAs in full f32 (no TF32), P through
//     shared memory; its 64-row prefills take this form too, in 16-row
//     blocks, the longest rows first.
//   * The sequential KV axis of the TPU grid is cut into `splits` pieces of
//     several tiles each (grid.x), so each block streams several tiles and
//     short batches still fill the 132 SMs.
//
// Prefill form (`dense_prefill_kernel`; S*G > 16, bf16 or f16). A block is
// one warpgroup owning 64 query rows of one (b, h). Bound: 4*D operations per
// allowed pair, ~S/2 flops per K/V byte; at S = 512 in bf16 near the card's
// ~295 flop/byte ridge, so tensor-core operations and bytes bound it about
// equally. Built from the bf16 flash forward's pieces (wgmma_common.cuh):
// Q rows gathered per row into a 128-byte-swizzled tile, K/V tiles through
// a two-stage cp.async ring of swizzled tiles from the slab, S = Q.K^T on
// wgmma from shared memory, P.V on wgmma with P in registers. Each row's
// horizon is length + r/G + 1; the mask is tested per element only on
// tiles it cuts, and the heaviest row tiles are scheduled first.
//
// Both forms:
//   * Columns at or past the block's horizon min(length + s_last + 1, T)
//     are zero-filled by cp.async and never read (the slab's tail belongs to
//     the next (b, h); zeros keep 0 * inf out of P.V); a split past it reads
//     no K/V and leaves empty partials, as `_write_dead` does.
//   * With one split the block writes out = o / l straight into
//     [B, S, Hq, D]: no partials, no combine. That is bit for bit what the
//     combine computes for one split (its weight exp(m - m*) is 1). With
//     more, the block writes f32 partials and a second launch combines
//     them in split order (`split_kv_combine_kernel`, attention_common.cuh),
//     so results are deterministic; no value is updated atomically.
//   * Probabilities are rounded to the cache dtype before P.V, where
//     `_partials_body` rounds them (`e.astype(v.dtype)`, :121); l sums the
//     unrounded f32 values, as there. Scores are scaled (any sign) before
//     the mask and the max and kept in base 2 (`online_softmax`); the
//     partials' m is written back in natural units.

#include "wgmma_common.cuh"

namespace {

constexpr int kDecRows = 16;  // query rows of a decode block
constexpr int kWarpCols = kCols / kWarps;  // columns of a tile per warp

// ---------------------------------------------------------- decode form
// Shared memory: q [16][LD], the f32 probabilities [kWarps][16][LDP], then
// the K/V ring [kStages][K, V][64][LD]; after the loop the ring holds the
// warps' (o, m, l) for the merge.
template <typename T, int D>
struct DecodeSmem {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr int LD = D + VEC;
  static constexpr int LDP = kWarpCols + VEC;
  static constexpr int kStages = sizeof(T) * D <= 128 ? 4 : 3;
  static constexpr size_t q = (size_t)kDecRows * LD * sizeof(T);
  static constexpr size_t probs =
      sizeof(T) == 4 ? (size_t)kWarps * kDecRows * LDP * sizeof(T) : 0;
  static constexpr size_t ring = (size_t)kStages * 2 * kCols * LD * sizeof(T);
  static constexpr size_t merge =
      (size_t)kWarps * kDecRows * (D + 2) * sizeof(float);
  static constexpr size_t bytes = q + probs + (ring > merge ? ring : merge);
};

// One thread's share of the 16-byte copies of a 64-row tile of a
// contiguous [T, D] slab into a padded tile (row stride LD): copy i is
// chunk tid % CPR of row tid / CPR + i * STEP, offsets computed once.
template <typename T, int D>
struct SlabCopy {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LD = D + VEC;
  static constexpr int CPR = D / VEC;          // 16-byte chunks per row
  static constexpr int STEP = kThreads / CPR;  // rows between copies
  static constexpr int N = kCols / STEP;
  int row, src, dst;
  __device__ __forceinline__ SlabCopy()
      : row(threadIdx.x / CPR),
        src(row * D + (threadIdx.x % CPR) * VEC),
        dst(row * LD + (threadIdx.x % CPR) * VEC) {}
  // Rows [c0, c0 + 64) of `slab` into `tile`; rows at or past col_end are
  // zero-filled and not read.
  __device__ __forceinline__ void load(T* tile, const T* __restrict__ slab,
                                       int c0, int col_end) const {
    const T* first = slab + (size_t)c0 * D + src;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool live = c0 + row + i * STEP < col_end;
      cp_async16(tile + dst + i * STEP * LD,
                 live ? first + (size_t)i * STEP * D : slab, live);
    }
  }
};

// Query rows [r0, r0 + 16) of (b, h) into q_s (row stride LD) by cp.async:
// row r = s * G + g is query head h * G + g at step s; rows at or past SG
// are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_q16(T* dst, const T* __restrict__ q,
                                         int b, int h, int r0, int SG, int S,
                                         int Hq, int G) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int idx = threadIdx.x; idx < kDecRows * CPR; idx += kThreads) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * VEC;
    const int row = r0 + r;
    const bool live = row < SG;
    const T* src = q;
    if (live)
      src = q + ((size_t)(b * S + row / G) * Hq + h * G + row % G) * D + c;
    cp_async16(dst + r * (D + VEC) + c, src, live);
  }
}

// grid (splits * fold, B * Hkv folded, ceil(S * G / 16)), block 128: grid.x
// holds the split and the head fold (`grid_fold`). With one split the
// output goes straight to out; otherwise partials o [splits, B * Hkv,
// S * G, D] (unnormalised) and m, l [splits, B * Hkv, S * G], all f32.
// `scale2` is scale * log2(e).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    int uniform_length, T* __restrict__ out,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, int S, int Hq, int Hkv,
                    int T_len, int G, float scale2,
                    int tiles_per_split, int splits, int BH) {
  using L = DecodeSmem<T, D>;
  constexpr int LD = L::LD;
  constexpr int NS = L::kStages;
  constexpr int NC = kWarpCols / 8;
  constexpr bool kTensorCores = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* p_s = reinterpret_cast<T*>(smem + L::q);  // f32 only
  T* ring = reinterpret_cast<T*>(smem + L::q + L::probs);
  float* o_s = reinterpret_cast<float*>(ring);  // merge: [kWarps][16][D]
  float* m_s = o_s + kWarps * kDecRows * D;     // [kWarps][16]
  float* l_s = m_s + kWarps * kDecRows;         // [kWarps][16]

  const int split = blockIdx.x % splits;
  const int bh = folded_bh(blockIdx.x / splits);
  if (bh >= BH) return;  // past B * Hkv in the last fold
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int SG = S * G;
  const int zb = gridDim.z - 1 - blockIdx.z;  // the longest rows first
  const int r0 = zb * kDecRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cq = (lane & 3) * 2;
  const int length = lengths ? lengths[b] : uniform_length;
  const int rows_here = min(kDecRows, SG - r0);
  // the block's last row sees columns [0, length + s_last]
  const int s_last = (r0 + rows_here - 1) / G;
  const int col_end = min(length + s_last + 1, T_len);  // exclusive
  const int live_tiles = (col_end + kCols - 1) / kCols;
  const int tile0 = split * tiles_per_split;
  const int n = max(min(tile0 + tiles_per_split, live_tiles) - tile0, 0);
  int horizon[2];  // exclusive column limit of this lane's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + (lane >> 2) + 8 * i;
    horizon[i] = row < SG ? min(length + row / G + 1, T_len) : 0;
  }
  const int wc = warp * kWarpCols;  // this warp's columns of every tile
  const T* k_slab = k + (size_t)bh * T_len * D;
  const T* v_slab = v + (size_t)bh * T_len * D;
  const SlabCopy<T, D> copy;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share; summed over the quad last

  if (n > 0) load_q16<T, D>(q_s, q, b, h, r0, SG, S, Hq, G);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // tiles 0 .. NS - 2 (Q in the first)
    if (i < n) {
      T* k_t = ring + 2 * i * kCols * LD;
      copy.load(k_t, k_slab, (tile0 + i) * kCols, col_end);
      copy.load(k_t + kCols * LD, v_slab, (tile0 + i) * kCols, col_end);
    }
    cp_async_commit();
  }
  uint32_t qf[D / 16][4];  // bf16, f16: Q's A fragments, loaded once
  for (int i = 0; i < n; ++i) {  // block-uniform
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile i landed for all; tile i - 1 consumed by all
    if (i + NS - 1 < n) {
      T* k_t = ring + 2 * ((i + NS - 1) % NS) * kCols * LD;
      const int c0 = (tile0 + i + NS - 1) * kCols;
      copy.load(k_t, k_slab, c0, col_end);
      copy.load(k_t + kCols * LD, v_slab, c0, col_end);
    }
    cp_async_commit();
    const T* k_t = ring + (2 * (i % NS) * kCols + wc) * LD;
    const T* v_t = k_t + kCols * LD;
    const int c0 = (tile0 + i) * kCols + wc;
    float s[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kTensorCores) {
      if (i == 0) WarpMmaA<NC, D, T>::load_a(qf, q_s, LD);
      WarpMmaA<NC, D, T>::nk(s, qf, k_t, LD);
    } else {
      WarpMma<T, NC, D>::nk(s, q_s, LD, k_t, LD);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + j * 8 + cq + (e & 1);
        s[j][e] = col < horizon[e >> 1] ? s[j][e] * scale2 : -INFINITY;
      }
    }
    online_softmax<NC, D / 8>(s, m, l, o);
    if constexpr (kTensorCores) {
      uint32_t pa[NC / 2][4];
      pack_a<NC, T>(pa, s);  // P rounded to the cache dtype
      WarpMmaA<D / 8, kWarpCols, T>::kn(o, pa, v_t, LD);
    } else {
      T* p_w = p_s + warp * kDecRows * L::LDP;
      store_frag<T, NC>(p_w, L::LDP, s);
      __syncwarp();
      WarpMma<T, D / 8, kWarpCols>::kn(o, p_w, L::LDP, v_t, LD);
      __syncwarp();
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: it holds the merge from here on

  // each warp's (o, m, l) over its columns
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_row = quad_sum(l[i]);
    const int r = (lane >> 2) + 8 * i;
    float* dst = o_s + (warp * kDecRows + r) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(o[j][2 * i], o[j][2 * i + 1]);
    if ((lane & 3) == 0) {
      m_s[warp * kDecRows + r] = m[i];
      l_s[warp * kDecRows + r] = l_row;
    }
  }
  __syncthreads();

  // the merge: 8 threads per row, 4 columns at a time
  const int r = threadIdx.x >> 3;
  const int row = r0 + r;
  if (row < SG) {
    float m_star = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m_star = fmaxf(m_star, m_s[w * kDecRows + r]);
    const float ref = m_star == -INFINITY ? 0.f : m_star;
    float wt[kWarps];
    float l_star = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wt[w] = exp2f(m_s[w * kDecRows + r] - ref);
      l_star += l_s[w * kDecRows + r] * wt[w];
    }
    const size_t prow = ((size_t)split * BH + bh) * SG + row;
    T* dst = out_row<T, D>(out, bh, row, S, Hq, Hkv, G);
    for (int c = (threadIdx.x & 7) * 4; c < D; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(
            o_s + (w * kDecRows + r) * D + c);
        acc.x += x.x * wt[w];
        acc.y += x.y * wt[w];
        acc.z += x.z * wt[w];
        acc.w += x.w * wt[w];
      }
      if (splits == 1) {
        const bool any = l_star > 0.f;
        dst[c] = from_float<T>(any ? acc.x / l_star : 0.f);
        dst[c + 1] = from_float<T>(any ? acc.y / l_star : 0.f);
        dst[c + 2] = from_float<T>(any ? acc.z / l_star : 0.f);
        dst[c + 3] = from_float<T>(any ? acc.w / l_star : 0.f);
      } else {
        *reinterpret_cast<float4*>(o_part + prow * D + c) = acc;
      }
    }
    if (splits > 1 && (threadIdx.x & 7) == 0) {
      m_part[prow] = m_star * kLn2;  // natural units, as the combine reads m
      l_part[prow] = l_star;
    }
  }
}

// --------------------------------------------------------- prefill form
// Query rows [r0, r0 + 64) of (b, h) into the swizzled tile `dst` by
// cp.async: row r = s * G + g is query head h * G + g at step s, gathered
// row by row; rows at or past SG are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void gather_q_swizzled(unsigned char* dst,
                                                  const T* __restrict__ q,
                                                  int b, int h, int r0,
                                                  int SG, int S, int Hq,
                                                  int G) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kRows * CPR; idx += kThreads) {
    const int r = idx / CPR;
    const int c = idx % CPR;
    const int row = r0 + r;
    const bool live = row < SG;
    const T* src = q;
    if (live)
      src = q + ((size_t)(b * S + row / G) * Hq + h * G + row % G) * D + c * 8;
    cp_async16(dst + (c >> 3) * (kRows * 128) + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               src, live);
  }
}

// Q, then K and V two stages each, 1024-byte aligned (16-bit elements).
template <int D>
constexpr size_t prefill_smem() {
  return 1024 + 5 * (size_t)kRows * D * 2;
}

// grid (splits * fold, B * Hkv folded, ceil(S * G / 64)), block 128 (one
// warpgroup); T is bf16 or f16 (the wgmma's `.bf16` or `.f16` form).
// With one split the output goes straight to out; otherwise partials as
// `dense_decode_kernel`'s, combined by a second launch.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dense_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ lengths, int uniform_length,
                     T* __restrict__ out, float* __restrict__ o_part,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     int S, int Hq, int Hkv, int T_len, int G, float scale2,
                     int tiles_per_split, int splits, int BH) {
  static_assert(sizeof(T) == 2, "a 16-bit element type");
  constexpr int NC = kCols / 8;
  constexpr int TILE = kRows * D * sizeof(T);  // bytes of a 64-row tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + TILE;      // [2]
  unsigned char* v_s = k_s + 2 * TILE;  // [2]

  const int split = blockIdx.x % splits;
  const int bh = folded_bh(blockIdx.x / splits);
  if (bh >= BH) return;  // past B * Hkv in the last fold
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int SG = S * G;
  const int zb = gridDim.z - 1 - blockIdx.z;  // the heaviest rows first
  const int r0 = zb * kRows;
  const int row_lo = r0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const int cq = (threadIdx.x & 3) * 2;
  const int length = lengths ? lengths[b] : uniform_length;
  const int rows_here = min(kRows, SG - r0);
  const int s_last = (r0 + rows_here - 1) / G;
  const int col_end = min(length + s_last + 1, T_len);  // exclusive
  // every row of the block sees at least the columns [0, full_end)
  const int full_end = min(length + r0 / G + 1, T_len);
  const int live_tiles = (col_end + kCols - 1) / kCols;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, live_tiles);
  int horizon[2];  // exclusive column limit of this lane's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    horizon[i] = row < SG ? min(length + row / G + 1, T_len) : 0;
  }
  const T* k_slab = k + (size_t)bh * T_len * D;
  const T* v_slab = v + (size_t)bh * T_len * D;
  const SwizzledCopy<D> copy(1);  // slab rows are D elements apart

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

  if (tile0 < tile1) {
    gather_q_swizzled<T, D>(q_s, q, b, h, r0, SG, S, Hq, G);
    copy.load(k_s, k_slab, tile0 * kCols, col_end, 1);
    copy.load(v_s, v_slab, tile0 * kCols, col_end, 1);
  }
  cp_async_commit();
  for (int t = tile0; t < tile1; ++t) {  // block-uniform
    const int stage = (t - tile0) & 1;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t landed for all; the other stage consumed
    if (t + 1 < tile1) {
      copy.load(k_s + (stage ^ 1) * TILE, k_slab, (t + 1) * kCols, col_end,
                1);
      copy.load(v_s + (stage ^ 1) * TILE, v_slab, (t + 1) * kCols, col_end,
                1);
    }
    cp_async_commit();

    // S = Q . K^T, both K-major in shared memory
    wgmma_fence();
    fence_regs<NC>(s);
    wgmma_abt<D, T>(s, q_s, k_s + stage * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NC>(s);

    const int c0 = t * kCols;
    if (c0 + kCols <= full_end) {  // block-uniform: no row's horizon cuts it
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    } else {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + j * 8 + cq + (e & 1);
          s[j][e] = col < horizon[e >> 1] ? s[j][e] * scale2 : -INFINITY;
        }
      }
    }
    online_softmax<NC, D / 8>(s, m, l, o);
    uint32_t pa[NC / 2][4];
    pack_a<NC, T>(pa, s);  // P rounded to the cache dtype

    // O += P . V, P from registers
    wgmma_fence();
    fence_regs<D / 8>(o);
    fence_regs<NC / 2>(pa);
    wgmma_pv<D, T>(o, pa, v_s + stage * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 8>(o);
    fence_regs<NC / 2>(pa);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_row = quad_sum(l[i]);
    const int row = row_lo + 8 * i;
    if (row >= SG) continue;
    if (splits == 1) {  // out = o / l, as the combine of one split
      T* dst = out_row<T, D>(out, bh, row, S, Hq, Hkv, G) + cq;
      const bool any = l_row > 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack2<T>(any ? o[j][2 * i] / l_row : 0.f,
                     any ? o[j][2 * i + 1] / l_row : 0.f);
      continue;
    }
    const size_t base = ((size_t)split * BH + bh) * SG + row;
    float* dst = o_part + base * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(o[j][2 * i], o[j][2 * i + 1]);
    if ((threadIdx.x & 3) == 0) {
      m_part[base] = m[i] * kLn2;  // natural units, as the combine reads m
      l_part[base] = l_row;
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename T, int D>
cudaError_t launch(int form, const void* q, const void* k, const void* v,
                   const void* lengths, int uniform_length, void* o_part,
                   void* m_part, void* l_part, void* out,
                   int B, int S, int Hq, int Hkv, int T_len, float scale,
                   int tiles_per_split, int splits, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int SG = S * G;
  const float scale2 = scale * kLog2e;
  size_t smem = DecodeSmem<T, D>::bytes;
  int rows = kDecRows;
  if constexpr (sizeof(T) == 2) {
    if (form == 1) {
      smem = prefill_smem<D>();
      rows = kRows;
    }
  }
  const int BH = B * Hkv;
  const dim3 grid(splits * grid_fold(BH), grid_y(BH),
                  (SG + rows - 1) / rows);
  cudaError_t err;
  if (form == 0) {
    err = allow_smem(dense_decode_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dense_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(lengths),
        uniform_length, static_cast<T*>(out), static_cast<float*>(o_part),
        static_cast<float*>(m_part), static_cast<float*>(l_part), S, Hq, Hkv,
        T_len, G, scale2, tiles_per_split, splits, BH);
  } else if constexpr (sizeof(T) == 2) {
    err = allow_smem(dense_prefill_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dense_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(lengths),
        uniform_length, static_cast<T*>(out), static_cast<float*>(o_part),
        static_cast<float*>(m_part), static_cast<float*>(l_part), S, Hq, Hkv,
        T_len, G, scale2, tiles_per_split, splits, BH);
  } else {
    return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_split_kv_combine<T, D>(o_part, m_part, l_part, out, splits,
                                       B * Hkv, SG, S, Hq, Hkv, G, stream);
}

}  // namespace

// Returns a cudaError_t (0 on success). dtype: 0 = float32, 1 = bfloat16, 2 =
// float16; D: 64 or 128; form: 0 = decode (16-row blocks), 1 = prefill (64-row
// wgmma blocks, bf16 and f16 only). q [B, S, Hq, D] in the cache dtype, caches
// [B, Hkv, T, D], lengths int32 [B] or null (then every request is at
// `uniform_length`), out [B, S, Hq, D]. With splits > 1: the f32 partials as
// the wrapper allocates them (null with one split), combined by a second
// launch. All device pointers of contiguous, 16-byte aligned tensors. `stream`
// is a cudaStream_t (PyTorch's current stream). Nothing is allocated here.
extern "C" int decode_attention_forward(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, int uniform_length, void* o_part, void* m_part,
    void* l_part, void* out, int B, int S, int Hq, int Hkv, int T, int D,
    int dtype, float scale, int form, int tiles_per_split, int splits,
    void* stream) {
  const int rows = form == 1 ? kRows : kDecRows;
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      uniform_length < 0 || splits <= 0 || tiles_per_split <= 0 ||
      (S * (Hq / Hkv) + rows - 1) / rows > 65535 ||
      (form != 0 && !(form == 1 && (dtype == 1 || dtype == 2))) ||
      (splits > 1 && (o_part == nullptr || m_part == nullptr ||
                      l_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(TT, DD)                                                       \
  launch<TT, DD>(form, q, k_cache, v_cache, lengths, uniform_length,      \
                 o_part, m_part, l_part, out, B, S, Hq, Hkv, T, scale,   \
                 tiles_per_split, splits, st)
  if (dtype == 0 && D == 64) return (int)CALL(float, 64);
  if (dtype == 0 && D == 128) return (int)CALL(float, 128);
  if (dtype == 1 && D == 64) return (int)CALL(bf16, 64);
  if (dtype == 1 && D == 128) return (int)CALL(bf16, 128);
  if (dtype == 2 && D == 64) return (int)CALL(f16, 64);
  if (dtype == 2 && D == 128) return (int)CALL(f16, 128);
#undef CALL
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
