// Paged split-KV attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (paddle_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernel `_paged_kernel`
// (paddle_tpu/ops/pallas/decode_attention.py:245, launched at :369) and its
// XLA stage-2 reduction `_combine_partials` (:153). Every prefill chunk
// (S = chunk width), every decode step (S = 1) and every speculative
// verify (S = K + 1) of the GPT serving path attends through it.
//
// What it computes, per request b and kv head h: the S*G query rows
// (row r = s*G + g, query head h*G + g, absolute position length[b] + s)
// attend over the paged cache columns c with c <= length[b] + s, where
// column c lives in page block_tables[b][c / BS] at slot c % BS of the
// head-leading pool [Hkv, P, BS, D]. Output [B, S, Hq, D] in the pool's
// dtype.
//
// Bound: each live K/V row is read once and takes 4*D operations per query
// row that sees it, so device-memory bytes bound the kernel at both widths
// the serving path uses (decode, 1..8 rows per kv head; prefill, 64 rows,
// still ~32 flop per byte against the card's ~295). Reaching that bound
// means reading the live K/V once, keeping loads in flight, and leaving
// the products too cheap to matter; a prefill chunk of 64 rows makes the
// products visible, so they run on the tensor cores:
//   * A block owns 64 query rows of one (b, h), 16 per warp, so a 64-row
//     prefill chunk at G = 1 is one row block that gathers the live K/V
//     once. Decode's S*G rows use the same body with only the warps that
//     hold live rows doing products (the others help load).
//   * The sequential KV axis of the TPU grid is a loop over 64-column tiles
//     with an online softmax (m, l, o) in f32 registers; the tiles are cut
//     into `splits` contiguous pieces (grid.x) so that short batches still
//     fill the 132 SMs, and `split_kv_combine_kernel`
//     (attention_common.cuh) combines the f32 partials, writing 0 for a row
//     with l = 0.
//   * bf16 and f16 pools: Q.K^T and P.V on the tensor cores (mma.sync
//     m16n8k16 in the `.bf16` or `.f16` form, f32 accumulation). Q's fragments
//     are loaded once into registers; P goes from the score accumulators
//     straight into the A fragments of P.V (`pack_a`), never through shared
//     memory. f32 pools (the speculative phase's verify) take the same tiles
//     through CUDA-core FMAs in full f32. K/V tiles stay in the pool dtype in
//     shared memory, rows padded by 16 bytes so ldmatrix reads are
//     conflict-free.
//   * The paged gather is in flight while the products run: K/V tiles go
//     through a two-stage ring filled by 16-byte cp.async copies, tile
//     t + 1's gather started before tile t's products, one barrier per
//     tile. A tile spans 64 / BS pages (half a page at BS 128); each thread
//     computes its own source from the page id. The block reads its table
//     entries for its tile range once into shared memory, and only those
//     below its horizon min(length + s_last + 1, NB * BS): columns past it
//     are zero-filled by cp.async with source size 0, never read, so the
//     masked -inf columns meet zeros. A split past the horizon writes empty
//     partials without reading the tables or K/V.
//   * Probabilities are rounded to the pool dtype before P.V, as the TPU
//     kernel's `e.astype(v.dtype)` (decode_attention.py:121); l sums the
//     unrounded f32 values, as there. Scores are kept in base 2 (one ex2
//     per probability, `online_softmax` of attention_common.cuh, shared
//     with the flash and dense kernels); the partials' m is written back in
//     natural units.
// No TMA (one descriptor cannot follow a block table) and no wgmma (the
// bytes bound the kernel; mma.sync keeps the products well below them).

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;  // query rows of a block (16 per warp)
constexpr int kCols = 64;  // cache columns of a tile
constexpr int kStages = 2;  // K/V tiles in flight

// Shared memory: q [64][LD], k [kStages][64][LD], v [kStages][64][LD],
// for f32 the probabilities [64][LDP], then the block's page ids.
template <typename T, int D>
struct Smem {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr int LD = D + VEC;
  static constexpr int LDP = kCols + VEC;
  static constexpr size_t tile = (size_t)kRows * LD * sizeof(T);
  static constexpr size_t probs =
      sizeof(T) == 4 ? kRows * LDP * sizeof(T) : 0;
  static size_t bytes(int pages) {
    return tile * (1 + 2 * kStages) + probs + (size_t)pages * sizeof(int);
  }
};

// Query rows [r0, r0 + 64) of (b, h) into q_s by cp.async: row r = s*G + g
// is query head h*G + g at step s; rows at or past SG are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_q(T* dst, const T* __restrict__ q,
                                       int b, int h, int r0, int SG, int S,
                                       int Hq, int G) {
  constexpr int VEC = Smem<T, D>::VEC;
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kRows * CPR; idx += kThreads) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * VEC;
    const int row = r0 + r;
    const bool live = row < SG;
    const T* src = q;
    if (live)
      src = q + ((size_t)(b * S + row / G) * Hq + h * G + row % G) * D + c;
    cp_async16(dst + r * Smem<T, D>::LD + c, src, live);
  }
}

// Columns [c0, c0 + 64) of (b, h)'s K and V into one ring stage through
// the block's page ids (page_s[i] holds table entry pg0 + i); columns at or
// past col_end are zero-filled, and neither they nor their page ids are
// read.
template <typename T, int D>
__device__ __forceinline__ void gather_kv(T* k_dst, T* v_dst,
                                          const T* __restrict__ k_head,
                                          const T* __restrict__ v_head,
                                          const int* page_s, int pg0, int c0,
                                          int col_end, int BS) {
  constexpr int VEC = Smem<T, D>::VEC;
  constexpr int CPR = D / VEC;
  for (int idx = threadIdx.x; idx < kCols * CPR; idx += kThreads) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * VEC;
    const int col = c0 + r;
    const bool live = col < col_end;
    size_t off = 0;
    if (live) off = ((size_t)page_s[col / BS - pg0] * BS + col % BS) * D + c;
    const int dst = r * Smem<T, D>::LD + c;
    cp_async16(k_dst + dst, k_head + off, live);
    cp_async16(v_dst + dst, v_head + off, live);
  }
}

// grid (splits * fold, B*Hkv folded, ceil(S*G / 64)), block 128: grid.x
// holds the split and the head fold (`grid_fold`). Partials are
// o [splits, B*Hkv, S*G, D] (unnormalised) and m, l [splits, B*Hkv, S*G],
// all f32. `scale2` is scale * log2(e).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_partials_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ lengths,
                      float* __restrict__ o_part, float* __restrict__ m_part,
                      float* __restrict__ l_part, int S, int Hq, int Hkv,
                      int P, int BS, int NB, int G, float scale2,
                      int tiles_per_split, int splits, int BH) {
  using L = Smem<T, D>;
  constexpr int LD = L::LD;
  constexpr int NC = kCols / 8;
  constexpr bool kTensorCores = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kRows * LD;             // [kStages][kCols][LD]
  T* v_s = k_s + kStages * kCols * LD;   // [kStages][kCols][LD]
  T* p_s = v_s + kStages * kCols * LD;   // f32 only: [kRows][LDP]
  int* page_s = reinterpret_cast<int*>(smem + L::tile * (1 + 2 * kStages) +
                                       L::probs);

  const int split = blockIdx.x % splits;
  const int bh = folded_bh(blockIdx.x / splits);
  if (bh >= BH) return;  // past B * Hkv in the last fold
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int SG = S * G;
  const int r0 = blockIdx.z * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_lo = r0 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const int length = lengths[b];
  const int rows_here = min(kRows, SG - r0);
  // the block's last row sees columns [0, length + s_last]
  const int s_last = (r0 + rows_here - 1) / G;
  const int col_end = min(length + s_last + 1, NB * BS);  // exclusive
  const int live_tiles = (col_end + kCols - 1) / kCols;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, live_tiles);
  const bool warp_live = warp * 16 < rows_here;  // warp-uniform
  int horizon[2];  // exclusive column limit of this lane's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    horizon[i] = row < SG ? min(length + row / G + 1, NB * BS) : 0;
  }
  const size_t head = (size_t)h * P * BS * D;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share; summed over the quad last

  if (tile0 < tile1) {  // block-uniform
    // the page ids of the live columns [tile0 * 64, min(tile1 * 64, col_end))
    const int pg0 = tile0 * kCols / BS;
    const int pg1 = (min(tile1 * kCols, col_end) - 1) / BS + 1;
    for (int i = threadIdx.x; i < pg1 - pg0; i += kThreads)
      page_s[i] = block_tables[(size_t)b * NB + pg0 + i];
    load_q<T, D>(q_s, q, b, h, r0, SG, S, Hq, G);
    __syncthreads();  // page ids visible to every thread's gather
    gather_kv<T, D>(k_s, v_s, k_pages + head, v_pages + head, page_s, pg0,
                    tile0 * kCols, col_end, BS);
    cp_async_commit();
    uint32_t qf[D / 16][4];  // bf16, f16: Q's A fragments, loaded once

    for (int t = tile0; t < tile1; ++t) {
      const int stage = (t - tile0) & 1;
      cp_async_wait_all();
      __syncthreads();  // tile t landed for all; tile t - 1 consumed by all
      if (t + 1 < tile1)
        gather_kv<T, D>(k_s + (stage ^ 1) * kCols * LD,
                        v_s + (stage ^ 1) * kCols * LD, k_pages + head,
                        v_pages + head, page_s, pg0, (t + 1) * kCols, col_end,
                        BS);
      cp_async_commit();
      if (!warp_live) continue;  // loads only; no barrier below
      const T* k_t = k_s + stage * kCols * LD;
      const T* v_t = v_s + stage * kCols * LD;
      const int c0 = t * kCols;
      float s[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (kTensorCores) {
        if (t == tile0)
          WarpMmaA<NC, D, T>::load_a(qf, q_s + warp * 16 * LD, LD);
        WarpMmaA<NC, D, T>::nk(s, qf, k_t, LD);
      } else {
        WarpMma<T, NC, D>::nk(s, q_s + warp * 16 * LD, LD, k_t, LD);
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
        pack_a<NC, T>(pa, s);  // P rounded to the pool dtype
        WarpMmaA<D / 8, kCols, T>::kn(o, pa, v_t, LD);
      } else {
        T* p_w = p_s + warp * 16 * L::LDP;
        store_frag<T, NC>(p_w, L::LDP, s);
        __syncwarp();
        WarpMma<T, D / 8, kCols>::kn(o, p_w, L::LDP, v_t, LD);
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_row = quad_sum(l[i]);
    const int row = row_lo + 8 * i;
    if (row >= SG) continue;
    const size_t base = ((size_t)split * BH + bh) * SG + row;
    float* dst = o_part + base * D + cq;
    if (m[i] != -INFINITY) {  // the combine reads no o where m is -inf
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) =
            make_float2(o[j][2 * i], o[j][2 * i + 1]);
    }
    if ((lane & 3) == 0) {
      m_part[base] = m[i] * kLn2;  // natural units, as the combine reads m
      l_part[base] = l_row;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* lengths,
                   void* o_part, void* m_part, void* l_part, void* out, int B,
                   int S, int Hq, int Hkv, int P, int BS, int NB, float scale,
                   int tiles_per_split, int splits, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int SG = S * G;
  // pages a split's columns can touch: its tiles plus one partial page
  const int pages = (tiles_per_split * kCols + BS - 1) / BS + 1;
  const size_t smem = Smem<T, D>::bytes(pages);
  cudaError_t err = allow_smem(paged_partials_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const int BH = B * Hkv;
  const dim3 grid(splits * grid_fold(BH), grid_y(BH),
                  (SG + kRows - 1) / kRows);
  paged_partials_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<float*>(o_part),
      static_cast<float*>(m_part), static_cast<float*>(l_part), S, Hq, Hkv,
      P, BS, NB, G, scale * kLog2e, tiles_per_split, splits, BH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_split_kv_combine<T, D>(o_part, m_part, l_part, out, splits,
                                       B * Hkv, SG, S, Hq, Hkv, G, stream);
}

}  // namespace

// Returns a cudaError_t (0 on success). dtype: 0 = float32, 1 = bfloat16,
// 2 = float16;
// D: 64 or 128. All pointers are device pointers of contiguous, 16-byte
// aligned tensors; `stream` is a cudaStream_t (PyTorch's current stream).
// Nothing is allocated here.
extern "C" int paged_attention_forward(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* o_part,
    void* m_part, void* l_part, void* out, int B, int S, int Hq, int Hkv,
    int P, int BS, int NB, int D, int dtype, float scale,
    int tiles_per_split, int splits, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || BS <= 0 || NB <= 0 ||
      splits <= 0 || tiles_per_split <= 0 ||
      (S * (Hq / Hkv) + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(TT, DD)                                                         \
  launch<TT, DD>(q, k_pages, v_pages, block_tables, lengths, o_part, m_part, \
                 l_part, out, B, S, Hq, Hkv, P, BS, NB, scale,               \
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

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
