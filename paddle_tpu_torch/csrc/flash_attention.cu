// Flash attention forward and backward for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (paddle_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   * flash_fwd_wgmma_kernel (bf16, f16), flash_fwd_f32_kernel (f32)
//                       <- `_fwd_kernel` (:89), launched by `_mha_fwd` (:146);
//   * flash_dq_wgmma_kernel (bf16, f16), flash_dq_f32_kernel (f32)
//                       <- `_dq_kernel` (:166, launched at :394) and
//                          `_dq_kernel_chunked` (:230, launched at :327);
//   * flash_dkv_wgmma_kernel (bf16, f16), flash_dkv_f32_kernel (f32)
//                       <- `_dkv_kernel` (:196, launched at :420) and
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
// three such products (S, dP, dq) over the allowed pairs on ~85 MB and the
// dk/dv kernel four (S^T, dP^T, dv, dk) on ~101 MB, 384 and 512 flop/byte,
// so tensor-core operations bound them. Every kernel keeps the [S, S]
// scores out of device memory: a block owns 64 query rows (the dk/dv kernel
// 64 keys) and walks 64-wide tiles of the partner axis, the forward with an
// online softmax (m, l) in f32 registers, stopping at the diagonal when
// causal (the TPU forward holds all of K/V for a q block in VMEM, 256 KB at
// S = 1024, over the 227 KB a block may use here). Heavy causal tiles are
// scheduled first.
//
// The bf16 forward (`flash_fwd_wgmma_kernel`) runs both products on
// Hopper's warpgroup instructions: the block's 4 warps are one warpgroup,
// S = Q.K^T is wgmma with Q and K read from shared memory through
// descriptors (128-byte swizzle), and P.V is wgmma with P taken from
// registers (the score accumulators are already the A fragments, packed to
// bf16, where the TPU kernel rounds P) and V from shared memory. K/V tiles
// go through a two-stage ring of cp.async copies, tile t + 1's loads started
// before tile t's products, one barrier per tile; each thread's copy
// offsets are computed once. The softmax works in base 2 (scores scaled by
// scale * log2 e before the mask and the max, so any sign of the scale is
// exact; one ex2 per probability; lse is converted back to natural log),
// shared with the paged and dense kernels (`online_softmax`), and tests
// the mask per element only on tiles the causal diagonal or S cuts. What
// bounds it now is the chain inside a warpgroup (wait for S, softmax, wait
// for P.V); overlapping a tile's softmax with the previous tile's P.V, and
// two warpgroups sharing K/V tiles, measured no faster (PERF.md section 6).
// The f32 forward (`flash_fwd_f32_kernel`) takes the same ring and
// softmax with CUDA-core FMAs in full f32 (tensor cores would round to
// TF32) and P through shared memory.
// The bf16 backward is built from the forward's pieces, one warpgroup per
// block. `flash_dq_wgmma_kernel` loads Q and dO once and walks K/V tiles
// through the same two-stage cp.async ring; per tile S = Q.K^T and
// dP = dO.V^T are wgmma with both operands from shared memory, issued
// together, and while they run the next tile is chosen (under a mask, its
// bands read) and its loads started; p = exp2(s * scale * log2 e -
// lse * log2 e) is one FFMA and one ex2 (no running max, so any sign of the
// scale is exact); ds = p (dP - delta) scale stays in registers and, packed
// to bf16 where the TPU kernel rounds it, is the A operand of dq += ds.K,
// the same K tile read MN-major. `flash_dkv_wgmma_kernel` owns 64 key
// columns, loads K and V once and walks the query tiles from the diagonal
// down, Q, dO and their lse and delta through the ring: S^T = K.Q^T and
// dP^T = V.dO^T, whose accumulators (rows keys, columns queries) are
// already the A fragments of dv += p^T.dO and dk += ds^T.Q (p^T rounded to
// dO's dtype, ds^T to Q's). Neither p nor ds touches shared memory; the
// mask is tested per element only on tiles the diagonal, S or a band cuts.
// No atomics: results are deterministic. Registers (ptxas, sm_90a; bf16,
// unmasked / masked): dq 144 / 157 at D = 64 (compiled for three blocks an
// SM), 188 / 203 at D = 128; dk/dv 168 / 168 at D = 64 (three blocks),
// 245 / 255 at D = 128; no spills. What bounds them now is latency inside
// the warpgroup (wait for S and dP, the elementwise pass, wait for the
// gradient products), hidden only by the other blocks of the SM: overlapping
// p with dP, deferring the last wait into the next tile (ptxas then
// serialises the wgmma) and register A operands for S measured no faster;
// ex2.approx.ftz measured faster but flushes p below 2^-126, which the plain
// version keeps (PERF.md section 6).
// The f32 backward (`flash_dq_f32_kernel`, `flash_dkv_f32_kernel`) takes the
// same walks and rings with CUDA-core FMAs in full f32 and p / ds through
// shared memory (one buffer, in turn, in the dk/dv kernel).
// The warp-level products and helpers live in attention_common.cuh, the
// warpgroup ones (wgmma, descriptors, the swizzled copy) in
// wgmma_common.cuh.
// f16. The wgmma kernels are templated on the 16-bit element type: the f16
// forms (AMP in float16) are the bf16 ones with `.f16` products, and P, p
// and ds rounded to f16 where the bf16 forms round to bf16 (the TPU kernels
// round to the storage dtype). f16 keeps 11 significant bits against
// bf16's 8 but a narrower range; P, p <= 1 and ds are small, and a
// subnormal keeps its absolute spacing of 2^-24, which the plain version
// rounds alike.
//
// FlashMask. Each kernel has a masked form (template flag Mask) that
// replaces the has_sri=True form of the same TPU kernel: `_fwd_kernel`
// (:89), `_dq_kernel` (:166) and `_dkv_kernel` (:196) with the mask of
// `_allowed_mask` (:51-79), behind the custom VJP `_flash_masked`
// (:458-476). The mask is startend_row_indices, int32 [B, H', S, n] with
// H' = 1 or H and n <= 4: per key column, the query rows it hides (causal
// n = 1: rows >= start; causal n >= 2: [start, end); non-causal:
// [LTS, LTE) and [UTS, UTE), LTE = S and UTS = UTE = 0 where fewer columns
// are given). A block reads the entries of the 64 key columns of its
// current tile (the dk/dv kernel those of its own 64 keys, as the TPU cuts
// sri per k block, :414-418), turns each into two half-open row bands in
// shared memory, and tests every element against them beside the causal
// test. H' = 1 is broadcast by the index, never materialised.
// Tile skip: a 64 x 64 tile whose every column has all its causally
// allowed rows inside one band contributes exactly 0, so it is skipped
// before its loads and products (each kernel reads the next tile's bands,
// and skips it, before it starts that tile's loads): computed, it would
// leave m, l and O as they were (its probabilities are exp2(-inf) = 0 and
// alpha = 1 once m is finite) and add p = 0 to the gradients, so the skip
// is bit-exact. A live tile that no band cuts (`column_clear` for every
// column) skips the per-element test in the bf16 backward. On packed
// documents (a causal mask with start = the column's document end) this
// removes every tile across documents, most of the causal work at 8192
// tokens. The test is
// conservative (one band must hold the rows; two that only cover them
// together do not skip). Bound: the same products over the allowed pairs
// only, so operations bound the masked kernels as they bound the unmasked
// ones; the mask adds S * n * 4 bytes per head read.

#include "wgmma_common.cuh"

namespace {

// The query rows a FlashMask hides in key column c of head (b, h), as two
// half-open bands [x, y) and [z, w) (see the note at the head of the file).
__device__ __forceinline__ int4 column_bands(const int* __restrict__ sri,
                                             int b, int h, int Hp, int n,
                                             int S, int c, int causal) {
  const int* e = sri + (((size_t)b * Hp + (Hp == 1 ? 0 : h)) * S + c) * n;
  if (causal) return make_int4(e[0], n > 1 ? e[1] : S, 0, 0);
  return make_int4(e[0], n > 1 ? e[1] : S, n > 3 ? e[2] : 0,
                   n > 3 ? e[3] : 0);
}

__device__ __forceinline__ bool in_bands(const int4& m, int row) {
  return (row >= m.x && row < m.y) || (row >= m.z && row < m.w);
}

// True when column c (bands m) leaves no query row of [r0, r1) allowed:
// past S, above the causal diagonal, or one band holding every row that
// causality leaves.
__device__ __forceinline__ bool column_covered(const int4& m, int c, int r0,
                                               int r1, int S, int causal) {
  if (c >= S) return true;
  const int lo = causal ? max(r0, c) : r0;
  return lo >= r1 || (m.x <= lo && m.y >= r1) || (m.z <= lo && m.w >= r1);
}

// True when column c (bands m) allows every query row of [r0, r1): inside
// S, at or left of the diagonal of row r0 when causal, and neither band
// meeting the rows.
__device__ __forceinline__ bool column_clear(const int4& m, int c, int r0,
                                             int r1, int S, int causal) {
  return c < S && (!causal || c <= r0) && max(m.x, r0) >= min(m.y, r1) &&
         max(m.z, r0) >= min(m.w, r1);
}

// The bands of key columns [c0, c0 + 64) into `bands`; returns, to every
// thread, whether they cover the tile of query rows [r0, r1), and leaves in
// `clear` whether this thread's column allows all of them (true for the
// threads that hold no column). Contains a barrier: every thread of the
// block calls it.
__device__ __forceinline__ bool load_bands(int4* bands,
                                           const int* __restrict__ sri,
                                           int b, int h, int Hp, int n,
                                           int S, int c0, int r0, int r1,
                                           int causal, bool& clear) {
  bool covered = true;
  clear = true;
  if (threadIdx.x < kCols) {
    const int c = c0 + threadIdx.x;
    const int4 m = c < S ? column_bands(sri, b, h, Hp, n, S, c, causal)
                         : make_int4(0, 0, 0, 0);
    bands[threadIdx.x] = m;
    covered = column_covered(m, c, r0, r1, S, causal);
    clear = column_clear(m, c, r0, r1, S, causal);
  }
  return __syncthreads_and(covered);
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

// The masked forms keep one int4 of bands per key column of a tile after
// the tiles of the unmasked form.
template <bool Mask>
constexpr size_t bands_smem() {
  return Mask ? kCols * sizeof(int4) : 0;
}

// ------------------------------------------------------------- forward
// The first tile at or after t that the block computes: under a FlashMask
// the first whose bands do not cover the rows [row0, row1), its bands left
// in `bands`, so a covered tile is never fetched. With `clear` given, it is
// set, to every thread, to whether that tile's bands allow every pair of
// it. Contains barriers under Mask: every thread of the block calls it.
template <bool Mask>
__device__ __forceinline__ int next_tile(int t, int tiles, int4* bands,
                                         const int* __restrict__ sri, int b,
                                         int h, int Hp, int n, int S,
                                         int row0, int row1, int causal,
                                         bool* clear = nullptr) {
  if constexpr (Mask) {
    bool mine = true;
    while (t < tiles && load_bands(bands, sri, b, h, Hp, n, S, t * kCols,
                                   row0, row1, causal, mine))
      ++t;
    if (clear != nullptr && t < tiles) *clear = __syncthreads_and(mine);
  }
  return t;
}

// A warp's raw Q.K^T fragments of one 64-column tile as base-2 scores
// s * scale2, -inf where a column is not allowed: at or past S, above the
// row when causal, inside one of the row's bands under Mask. `full` says
// every column of the tile is allowed for every row, which skips the
// per-element test (the arithmetic of an allowed element is the same
// either way). Scaling before the mask and the max keeps any sign of the
// scale exact, and masked scores -inf for the softmax.
template <bool Mask>
__device__ __forceinline__ void scale_mask(float (&s)[kCols / 8][4],
                                           const int4* bands, int c0,
                                           int row_lo, int S, int causal,
                                           float scale2, bool full) {
  const int cq = (threadIdx.x & 3) * 2;
  if (full) {  // warp-uniform
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    return;
  }
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_lo + 8 * (e >> 1);
      const int col = c0 + j * 8 + cq + (e & 1);
      const bool allowed = col < S && (!causal || col <= row) &&
                           (!Mask || !in_bands(bands[col - c0], row));
      s[j][e] = allowed ? s[j][e] * scale2 : -INFINITY;
    }
  }
}

// o / l and lse = (m + log2 l) ln 2 for the warp's 16 rows; 0 and 0 for a
// row with no allowed column. l holds each lane's share of its rows' sums.
template <typename T, int D>
__device__ __forceinline__ void write_fwd(T* __restrict__ out,
                                          float* __restrict__ lse,
                                          const float (&o)[D / 8][4],
                                          const float (&m)[2],
                                          const float (&l)[2], int b, int h,
                                          int bh, int row_lo, int S, int H) {
  float l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) l_row[i] = quad_sum(l[i]);
  write_rows<T, D>(out, o, b, h, row_lo, S, H,
                   l_row[0] > 0.f ? 1.f / l_row[0] : 0.f,
                   l_row[1] > 0.f ? 1.f / l_row[1] : 0.f);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row < S)
        lse[(size_t)bh * S + row] =
            l_row[i] > 0.f ? (m[i] + log2f(l_row[i])) * kLn2 : 0.f;
    }
  }
}

// Whether every element of the tile at column c0 is allowed for the rows
// [row0, row0 + 64) without a FlashMask: inside S, and below the diagonal
// when causal.
__device__ __forceinline__ bool full_tile(int c0, int row0, int S,
                                          int causal) {
  return c0 + kCols <= S && (!causal || c0 + kCols - 1 <= row0);
}

// One thread's share of the 16-byte copies of a 64-row tile of one head of
// a [B, S, H, D] tensor into shared memory with row stride D + 16 bytes:
// copy i of a thread is chunk tid % CPR of row tid / CPR + i * STEP, so a
// tile's copies are an add and a compare each from offsets computed once.
template <typename T, int D>
struct RowCopy {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CPR = D / VEC;        // 16-byte chunks per row
  static constexpr int STEP = kThreads / CPR;  // rows between copies
  static constexpr int N = kRows / STEP;
  int row, src, dst;  // copy 0's tile row, source and destination element
  int src_step;       // source elements between copies
  __device__ __forceinline__ explicit RowCopy(int H)
      : row(threadIdx.x / CPR),
        src(row * H * D + (threadIdx.x % CPR) * VEC),
        dst(row * (D + VEC) + (threadIdx.x % CPR) * VEC),
        src_step(STEP * H * D) {}
  // Rows [row0, row0 + 64) of the head whose element (0, 0) is at `head`
  // (row stride H * D) into `tile`; rows at or past S are zero-filled and
  // not read.
  __device__ __forceinline__ void load(T* tile, const T* __restrict__ head,
                                       int row0, int S, int H) const {
    const T* first = head + (size_t)row0 * H * D + src;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool live = row0 + row + i * STEP < S;
      cp_async16(tile + dst + i * STEP * (D + VEC),
                 live ? first + (size_t)i * src_step : head, live);
    }
  }
};

// q [64][LD], k and v [2][64][LD], the probabilities [64][LDP]; under Mask
// the bands of two tiles: the one computed and the one fetched.
template <int D, bool Mask>
constexpr size_t fwd_f32_smem() {
  return (size_t)(5 * kRows * (D + 4) + kRows * (kCols + 4)) * sizeof(float) +
         2 * bands_smem<Mask>();
}

// The f32 forward. grid (ceil(S / 64), B * H folded), block 128; `scale2` is
// scale * log2(e). The heaviest causal tiles (the last query rows) are
// scheduled first. Products by CUDA-core FMAs in full f32, P through shared
// memory; K/V through a two-stage cp.async ring, one barrier per tile.
template <int D, bool Mask>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ sri,
                     int S, int H, float scale2, int causal, int n, int Hp,
                     int BH) {
  constexpr int LD = D + 4;
  constexpr int LDP = kCols + 4;
  constexpr int NC = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kRows * LD;        // [2][kCols][LD]
  float* v_s = k_s + 2 * kCols * LD;    // [2][kCols][LD]
  float* p_s = v_s + 2 * kCols * LD;    // [kRows][LDP]
  int4* bands = reinterpret_cast<int4*>(p_s + kRows * LDP);  // [2][kCols]

  const int bh = folded_bh(blockIdx.z);
  if (bh >= BH) return;  // past B * H in the last fold
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int row1 = min(row0 + kRows, S);
  const int warp = threadIdx.x >> 5;
  const int row_lo = row0 + warp * 16 + ((threadIdx.x & 31) >> 2);
  float* p_w = p_s + warp * 16 * LDP;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int col_end = causal ? row1 : S;
  const int tiles = (col_end + kCols - 1) / kCols;
  const RowCopy<float, D> copy(H);
  const size_t head = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)

  int t = next_tile<Mask>(0, tiles, bands, sri, b, h, Hp, n, S, row0, row1,
                          causal);
  if (t < tiles) {
    copy.load(q_s, q + head, row0, S, H);
    copy.load(k_s, k + head, t * kCols, S, H);
    copy.load(v_s, v + head, t * kCols, S, H);
  }
  cp_async_commit();
  for (int i = 0; t < tiles; ++i) {  // block-uniform
    const int stage = i & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed for all; the other stage consumed
    const int nt = next_tile<Mask>(t + 1, tiles, bands + (stage ^ 1) * kCols,
                                   sri, b, h, Hp, n, S, row0, row1, causal);
    if (nt < tiles) {
      copy.load(k_s + (stage ^ 1) * kCols * LD, k + head, nt * kCols, S, H);
      copy.load(v_s + (stage ^ 1) * kCols * LD, v + head, nt * kCols, S, H);
    }
    cp_async_commit();
    float s[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    WarpMma<float, NC, D>::nk(s, q_s + warp * 16 * LD, LD,
                              k_s + stage * kCols * LD, LD);
    scale_mask<Mask>(s, bands + stage * kCols, t * kCols, row_lo, S, causal,
                     scale2, !Mask && full_tile(t * kCols, row0, S, causal));
    online_softmax<NC, D / 8>(s, m, l, o);
    store_frag<float, NC>(p_w, LDP, s);
    __syncwarp();
    WarpMma<float, D / 8, kCols>::kn(o, p_w, LDP, v_s + stage * kCols * LD,
                                     LD);
    __syncwarp();
    t = nt;
  }
  write_fwd<float, D>(out, lse, o, m, l, b, h, bh, row_lo, S, H);
}

// ------------------------------------------------------ forward, wgmma
// The 16-bit forward on Hopper's warpgroup products (wgmma_common.cuh):
// one warpgroup owns 64 query rows; S = Q.K^T reads Q and K from
// swizzled shared memory, P.V takes P from registers.

// Q, then K and V two stages each (2-byte elements); under Mask the bands
// of two tiles.
template <int D, bool Mask>
constexpr size_t fwd_wgmma_smem() {
  return 1024 + 5 * (size_t)kRows * D * 2 + 2 * bands_smem<Mask>();
}

// The bf16 / f16 forward. grid (ceil(S / 64), B * H folded), block 128 (one
// warpgroup); `scale2` is scale * log2(e). The heaviest causal tiles first.
template <typename T, int D, bool Mask>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, const int* __restrict__ sri,
                       int S, int H, float scale2, int causal, int n, int Hp,
                       int BH) {
  constexpr int NC = kCols / 8;
  constexpr int TILE = kRows * D * sizeof(T);  // bytes of a 64-row tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + TILE;      // [2]
  unsigned char* v_s = k_s + 2 * TILE;  // [2]
  int4* bands = reinterpret_cast<int4*>(v_s + 2 * TILE);  // [2][kCols]

  const int bh = folded_bh(blockIdx.z);
  if (bh >= BH) return;  // past B * H in the last fold
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int row1 = min(row0 + kRows, S);
  const int row_lo = row0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const int col_end = causal ? row1 : S;
  const int tiles = (col_end + kCols - 1) / kCols;
  const SwizzledCopy<D> copy(H);
  const size_t head = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)

  int t = next_tile<Mask>(0, tiles, bands, sri, b, h, Hp, n, S, row0, row1,
                          causal);
  if (t < tiles) {
    copy.load(q_s, q + head, row0, S, H);
    copy.load(k_s, k + head, t * kCols, S, H);
    copy.load(v_s, v + head, t * kCols, S, H);
  }
  cp_async_commit();
  for (int i = 0; t < tiles; ++i) {  // block-uniform
    const int stage = i & 1;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t landed for all; the other stage consumed
    const int nt = next_tile<Mask>(t + 1, tiles, bands + (stage ^ 1) * kCols,
                                   sri, b, h, Hp, n, S, row0, row1, causal);
    if (nt < tiles) {
      copy.load(k_s + (stage ^ 1) * TILE, k + head, nt * kCols, S, H);
      copy.load(v_s + (stage ^ 1) * TILE, v + head, nt * kCols, S, H);
    }
    cp_async_commit();

    // S = Q . K^T, both K-major in shared memory
    wgmma_fence();
    fence_regs<NC>(s);
    wgmma_abt<D, T>(s, q_s, k_s + stage * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NC>(s);

    scale_mask<Mask>(s, bands + stage * kCols, t * kCols, row_lo, S, causal,
                     scale2, !Mask && full_tile(t * kCols, row0, S, causal));
    online_softmax<NC, D / 8>(s, m, l, o);
    uint32_t pa[NC / 2][4];
    pack_a<NC, T>(pa, s);  // P rounded to V's dtype

    // O += P . V, P from registers
    wgmma_fence();
    fence_regs<D / 8>(o);
    fence_regs<NC / 2>(pa);
    wgmma_pv<D, T>(o, pa, v_s + stage * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 8>(o);
    fence_regs<NC / 2>(pa);
    t = nt;
  }
  write_fwd<T, D>(out, lse, o, m, l, b, h, bh, row_lo, S, H);
}

// ----------------------------------------------------- backward, wgmma
// The bf16 backward on the forward's pieces: one warpgroup per block, the
// partner tiles through a two-stage cp.async ring of swizzled tiles, every
// product a wgmma, p and ds kept in registers. Scores are taken in base 2:
// p = exp2(s * scale * log2 e - lse * log2 e), one FFMA and one ex2 each,
// exact for any sign of the scale (the backward has no running max).

// 4 bytes global -> shared; with `live` false nothing is read and the 4
// bytes are zero-filled, so `src` need only be some valid address.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// Blocks an SM the backward kernels are compiled for: three at D = 64 (at
// most 168 registers, no spill), where dk/dv would otherwise take 176-193
// registers and fit two, and dq 128 and fit four, which unbalances the
// S = 8192 grid (PERF.md section 6); one at D = 128, where shared memory
// leaves room for two.
template <int D>
constexpr int bwd_min_blocks() {
  return D == 64 ? 3 : 1;
}

// ds = p (dP - delta) scale in place of a warp's S fragments (rows query
// rows row_lo, row_lo + 8 with -lse log2 e in nl2 and delta in dl; columns
// the keys of the tile at c0), p = 0 where a pair is not allowed. With
// Check false every pair of the tile is allowed and nothing is tested; the
// arithmetic of an allowed pair is the same either way.
template <bool Mask, bool Check>
__device__ __forceinline__ void dq_grads(float (&s)[kCols / 8][4],
                                         const float (&dp)[kCols / 8][4],
                                         const float (&nl2)[2],
                                         const float (&dl)[2],
                                         const int4* bands, int c0,
                                         int row_lo, int S, int causal,
                                         float scale2, float scale) {
  const int cq = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = exp2f(fmaf(s[j][e], scale2, nl2[i]));
      if constexpr (Check) {
        const int row = row_lo + 8 * i;
        const int col = c0 + j * 8 + cq + (e & 1);
        const bool allowed = col < S && (!causal || col <= row) &&
                             (!Mask || !in_bands(bands[col - c0], row));
        p = allowed ? p : 0.f;
      }
      s[j][e] = p * (dp[j][e] - dl[i]) * scale;
    }
  }
}

// Q and dO once, K and V two stages each (swizzled); under Mask the bands
// of two tiles.
template <int D, bool Mask>
constexpr size_t dq_wgmma_smem() {
  return 1024 + 6 * (size_t)kRows * D * 2 + 2 * bands_smem<Mask>();
}

// The bf16 / f16 dq. grid (ceil(S / 64), B * H folded), block 128 (one
// warpgroup) owning 64 query rows; the K/V tiles walked up to the
// diagonal, heaviest blocks first. Per tile: S = Q.K^T and dP = dO.V^T
// (wgmma, both operands from shared memory, K-major), issued together;
// while they run the next tile is chosen and its loads started; ds in
// registers, packed to T as the A operand of dq += ds.K (the same K tile
// read MN-major).
template <typename T, int D, bool Mask>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<D>())
flash_dq_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq,
                      const int* __restrict__ sri, int S, int H, float scale,
                      int causal, int n, int Hp,
                      int BH) {
  constexpr int NC = kCols / 8;
  constexpr int TILE = kRows * D * sizeof(T);  // bytes of a 64-row tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* do_s = q_s + TILE;
  unsigned char* k_s = do_s + TILE;     // [2]
  unsigned char* v_s = k_s + 2 * TILE;  // [2]
  int4* bands = reinterpret_cast<int4*>(v_s + 2 * TILE);  // [2][kCols]

  const int bh = folded_bh(blockIdx.z);
  if (bh >= BH) return;  // past B * H in the last fold
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int row1 = min(row0 + kRows, S);
  const int row_lo = row0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const float scale2 = scale * kLog2e;
  float nl2[2], dl[2];  // -lse log2 e and delta of rows row_lo, row_lo + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    nl2[i] = row < S ? -lse[(size_t)bh * S + row] * kLog2e : 0.f;
    dl[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float acc[D / 8][4], s[NC][4], dp[NC][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
  }
  const int col_end = causal ? row1 : S;
  const int tiles = (col_end + kCols - 1) / kCols;
  const SwizzledCopy<D> copy(H);
  const size_t head = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)

  bool clear = false, next_clear = false;  // under Mask: no band cuts
  int t = next_tile<Mask>(0, tiles, bands, sri, b, h, Hp, n, S, row0, row1,
                          causal, &clear);
  if (t < tiles) {
    copy.load(q_s, q + head, row0, S, H);
    copy.load(do_s, dout + head, row0, S, H);
    copy.load(k_s, k + head, t * kCols, S, H);
    copy.load(v_s, v + head, t * kCols, S, H);
  }
  cp_async_commit();
  for (int i = 0; t < tiles; ++i) {  // block-uniform
    const int stage = i & 1;
    const unsigned char* k_t = k_s + stage * TILE;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t landed for all; the other stage consumed

    // S = Q . K^T and dP = dO . V^T
    wgmma_fence();
    fence_regs<NC>(s);
    fence_regs<NC>(dp);
    wgmma_abt<D, T>(s, q_s, k_t);
    wgmma_abt<D, T>(dp, do_s, v_s + stage * TILE);
    wgmma_commit();
    // the next tile's bands and loads while the products run
    const int nt = next_tile<Mask>(t + 1, tiles, bands + (stage ^ 1) * kCols,
                                   sri, b, h, Hp, n, S, row0, row1, causal,
                                   &next_clear);
    if (nt < tiles) {
      copy.load(k_s + (stage ^ 1) * TILE, k + head, nt * kCols, S, H);
      copy.load(v_s + (stage ^ 1) * TILE, v + head, nt * kCols, S, H);
    }
    cp_async_commit();
    wgmma_wait_all();
    fence_regs<NC>(s);
    fence_regs<NC>(dp);

    const int c0 = t * kCols;
    if (Mask ? clear : full_tile(c0, row0, S, causal))  // block-uniform
      dq_grads<Mask, false>(s, dp, nl2, dl, bands, c0, row_lo, S, causal,
                            scale2, scale);
    else
      dq_grads<Mask, true>(s, dp, nl2, dl, bands + stage * kCols, c0, row_lo,
                           S, causal, scale2, scale);
    uint32_t dsa[NC / 2][4];
    pack_a<NC, T>(dsa, s);  // ds rounded to K's dtype

    // dq += ds . K, ds from registers
    wgmma_fence();
    fence_regs<D / 8>(acc);
    fence_regs<NC / 2>(dsa);
    wgmma_pv<D, T>(acc, dsa, k_t);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 8>(acc);
    fence_regs<NC / 2>(dsa);
    t = nt;
    clear = next_clear;
  }
  write_rows<T, D>(dq, acc, b, h, row_lo, S, H, 1.f, 1.f);
}

// The first query tile at or after t that the dk/dv block of key columns
// [col0, col0 + 64) computes: under a FlashMask the first whose rows the
// bands `mine` of the block's own columns (thread c < 64 holds column
// col0 + c) do not cover. With `clear` given, it is set, to every thread,
// to whether they allow every pair of that tile. Contains barriers under
// Mask: every thread of the block calls it.
template <bool Mask>
__device__ __forceinline__ int next_query_tile(int t, int tiles,
                                               const int4& mine, int col0,
                                               int S, int causal,
                                               bool* clear = nullptr) {
  if constexpr (Mask) {
    const bool own = threadIdx.x < kCols;
    const int c = col0 + threadIdx.x;
    for (; t < tiles; ++t) {
      const int q0 = t * kRows;
      const int q1 = min(q0 + kRows, S);
      if (__syncthreads_and(!own ||
                            column_covered(mine, c, q0, q1, S, causal)))
        continue;
      if (clear != nullptr)
        *clear = __syncthreads_and(!own ||
                                   column_clear(mine, c, q0, q1, S, causal));
      break;
    }
  }
  return t;
}

// p^T and ds^T = p^T (dP^T - delta) scale in place of a warp's S^T and
// dP^T fragments (rows the keys key_lo, key_lo + 8; columns the query rows
// of the tile at q0, their lse and delta in ls / dls), p = 0 where a pair is
// not allowed. With Check false every pair is allowed and nothing is tested.
template <bool Mask, bool Check>
__device__ __forceinline__ void dkv_grads(float (&st)[kRows / 8][4],
                                          float (&dpt)[kRows / 8][4],
                                          const float* ls, const float* dls,
                                          const int4* bands, int col0,
                                          int key_lo, int q0, int S,
                                          int causal, float scale2,
                                          float scale) {
  const int cq = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + j * 8 + cq);
    const float2 d2 = *reinterpret_cast<const float2*>(dls + j * 8 + cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float nl2 = -((e & 1) ? l2.y : l2.x) * kLog2e;
      const float dl = (e & 1) ? d2.y : d2.x;
      float p = exp2f(fmaf(st[j][e], scale2, nl2));
      if constexpr (Check) {
        const int key = key_lo + 8 * (e >> 1);
        const int row = q0 + j * 8 + cq + (e & 1);
        const bool allowed = row < S && key < S && (!causal || key <= row) &&
                             (!Mask || !in_bands(bands[key - col0], row));
        p = allowed ? p : 0.f;
      }
      st[j][e] = p;
      dpt[j][e] = p * (dpt[j][e] - dl) * scale;
    }
  }
}

// K and V once, Q and dO two stages each (swizzled), the lse and delta of
// two query tiles; under Mask the bands of the block's keys.
template <int D, bool Mask>
constexpr size_t dkv_wgmma_smem() {
  return 1024 + 6 * (size_t)kRows * D * 2 +
         2 * 2 * kRows * sizeof(float) + bands_smem<Mask>();
}

// The bf16 / f16 dk/dv. grid (ceil(S / 64), B * H folded), block 128 (one
// warpgroup) owning 64 key columns; the query tiles walked from the
// diagonal down (the heaviest blocks, the first columns, first in grid
// order). Per tile: S^T = K.Q^T and dP^T = V.dO^T (wgmma, K-major operands
// from shared memory), issued together; while they run the next live query
// tile is chosen and its loads started; p^T and ds^T in registers, whose
// accumulator layout (rows keys, columns queries) is the A layout of
// dv += p^T.dO and dk += ds^T.Q (the Q and dO tiles read MN-major).
template <typename T, int D, bool Mask>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks<D>())
flash_dkv_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, const int* __restrict__ sri, int S,
                       int H, float scale, int causal, int n, int Hp,
                       int BH) {
  constexpr int NR = kRows / 8;
  constexpr int TILE = kRows * D * sizeof(T);  // bytes of a 64-row tile
  static_assert(kThreads == 2 * kRows, "one stat copy per thread");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* v_s = k_s + TILE;
  unsigned char* q_s = v_s + TILE;       // [2]
  unsigned char* do_s = q_s + 2 * TILE;  // [2]
  // [2][lse, delta][kRows]
  float* stats = reinterpret_cast<float*>(do_s + 2 * TILE);
  int4* bands = reinterpret_cast<int4*>(stats + 2 * 2 * kRows);  // [kCols]

  const int bh = folded_bh(blockIdx.z);
  if (bh >= BH) return;  // past B * H in the last fold
  const int b = bh / H;
  const int h = bh % H;
  const int col0 = blockIdx.x * kCols;
  const int key_lo = col0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const float scale2 = scale * kLog2e;
  float dk_acc[D / 8][4], dv_acc[D / 8][4], st[NR][4], dpt[NR][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
    dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
  }
  const SwizzledCopy<D> copy(H);
  const size_t head = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)
  // thread r < 64 copies the lse of query row q0 + r, thread 64 + r its
  // delta (zero past S)
  const float* stat_row = (threadIdx.x < kRows ? lse : delta) + (size_t)bh * S;
  const int stat_r = threadIdx.x & (kRows - 1);
  auto load_query_tile = [&](int tq, int stage) {
    const int q0 = tq * kRows;
    copy.load(q_s + stage * TILE, q + head, q0, S, H);
    copy.load(do_s + stage * TILE, dout + head, q0, S, H);
    const bool live = q0 + stat_r < S;
    cp_async4(stats + stage * 2 * kRows + threadIdx.x,
              live ? stat_row + q0 + stat_r : stat_row, live);
  };
  // the block's own 64 key columns: their bands hold for every query tile
  int4 mine = make_int4(0, 0, 0, 0);
  if constexpr (Mask) {
    if (threadIdx.x < kCols) {
      if (col0 + (int)threadIdx.x < S)
        mine = column_bands(sri, b, h, Hp, n, S, col0 + threadIdx.x, causal);
      bands[threadIdx.x] = mine;
    }
  }
  const int q_tiles = (S + kRows - 1) / kRows;

  bool clear = false, next_clear = false;  // under Mask: no band cuts
  int t = next_query_tile<Mask>(causal ? col0 / kRows : 0, q_tiles, mine,
                                col0, S, causal, &clear);
  if (t < q_tiles) {
    copy.load(k_s, k + head, col0, S, H);
    copy.load(v_s, v + head, col0, S, H);
    load_query_tile(t, 0);
  }
  cp_async_commit();
  for (int i = 0; t < q_tiles; ++i) {  // block-uniform
    const int stage = i & 1;
    const unsigned char* q_t = q_s + stage * TILE;
    const unsigned char* do_t = do_s + stage * TILE;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t landed for all; the other stage consumed

    // S^T = K . Q^T and dP^T = V . dO^T
    wgmma_fence();
    fence_regs<NR>(st);
    fence_regs<NR>(dpt);
    wgmma_abt<D, T>(st, k_s, q_t);
    wgmma_abt<D, T>(dpt, v_s, do_t);
    wgmma_commit();
    // the next live query tile's loads while the products run
    const int nt = next_query_tile<Mask>(t + 1, q_tiles, mine, col0, S,
                                         causal, &next_clear);
    if (nt < q_tiles) load_query_tile(nt, stage ^ 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_regs<NR>(st);
    fence_regs<NR>(dpt);

    const int q0 = t * kRows;
    const float* ls = stats + stage * 2 * kRows;
    if (q0 + kRows <= S &&
        (Mask ? clear : full_tile(col0, q0, S, causal)))  // block-uniform
      dkv_grads<Mask, false>(st, dpt, ls, ls + kRows, bands, col0, key_lo,
                             q0, S, causal, scale2, scale);
    else
      dkv_grads<Mask, true>(st, dpt, ls, ls + kRows, bands, col0, key_lo, q0,
                            S, causal, scale2, scale);
    uint32_t pa[NR / 2][4], dsa[NR / 2][4];
    pack_a<NR, T>(pa, st);    // p^T rounded to dO's dtype
    pack_a<NR, T>(dsa, dpt);  // ds^T rounded to Q's dtype

    // dv += p^T . dO and dk += ds^T . Q, p^T and ds^T from registers
    wgmma_fence();
    fence_regs<D / 8>(dv_acc);
    fence_regs<D / 8>(dk_acc);
    fence_regs<NR / 2>(pa);
    fence_regs<NR / 2>(dsa);
    wgmma_pv<D, T>(dv_acc, pa, do_t);
    wgmma_pv<D, T>(dk_acc, dsa, q_t);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 8>(dv_acc);
    fence_regs<D / 8>(dk_acc);
    fence_regs<NR / 2>(pa);
    fence_regs<NR / 2>(dsa);
    t = nt;
    clear = next_clear;
  }
  write_rows<T, D>(dk, dk_acc, b, h, key_lo, S, H, 1.f, 1.f);
  write_rows<T, D>(dv, dv_acc, b, h, key_lo, S, H, 1.f, 1.f);
}

// ------------------------------------------------------- backward, f32
// The f32 backward: CUDA-core FMAs in full f32 (tensor cores would round to
// TF32), the operands and p / ds through shared memory (rows padded by 16
// bytes), the partner tiles through the two-stage cp.async ring of the f32
// forward. The exponent is expf of the unscaled score, as before.

// q and dO [64][LD], k and v [2][64][LD], ds [64][LDP]; under Mask the
// bands of two tiles.
template <int D, bool Mask>
constexpr size_t dq_f32_smem() {
  return (size_t)(6 * kRows * (D + 4) + kRows * (kCols + 4)) * sizeof(float) +
         2 * bands_smem<Mask>();
}

// grid (ceil(S / 64), B * H folded), block 128: one block per 64 query rows,
// the K/V tiles walked up to the diagonal. Heaviest tiles first.
template <int D, bool Mask>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    const int* __restrict__ sri, int S, int H, float scale,
                    int causal, int n, int Hp,
                    int BH) {
  constexpr int LD = D + 4;
  constexpr int LDP = kCols + 4;
  constexpr int NC = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + kRows * LD;
  float* k_s = do_s + kRows * LD;      // [2][kCols][LD]
  float* v_s = k_s + 2 * kCols * LD;   // [2][kCols][LD]
  float* ds_s = v_s + 2 * kCols * LD;  // [kRows][LDP]
  int4* bands = reinterpret_cast<int4*>(ds_s + kRows * LDP);  // [2][kCols]

  const int bh = folded_bh(blockIdx.z);
  if (bh >= BH) return;  // past B * H in the last fold
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int row1 = min(row0 + kRows, S);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_lo = row0 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  float* ds_w = ds_s + warp * 16 * LDP;

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
  const int col_end = causal ? row1 : S;
  const int tiles = (col_end + kCols - 1) / kCols;
  const RowCopy<float, D> copy(H);
  const size_t head = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)

  int t = next_tile<Mask>(0, tiles, bands, sri, b, h, Hp, n, S, row0, row1,
                          causal);
  if (t < tiles) {
    copy.load(q_s, q + head, row0, S, H);
    copy.load(do_s, dout + head, row0, S, H);
    copy.load(k_s, k + head, t * kCols, S, H);
    copy.load(v_s, v + head, t * kCols, S, H);
  }
  cp_async_commit();
  for (int i = 0; t < tiles; ++i) {  // block-uniform
    const int stage = i & 1;
    const float* k_t = k_s + stage * kCols * LD;
    const int4* bt = bands + stage * kCols;
    cp_async_wait_all();
    __syncthreads();  // tile t landed for all; the other stage consumed
    const int nt = next_tile<Mask>(t + 1, tiles, bands + (stage ^ 1) * kCols,
                                   sri, b, h, Hp, n, S, row0, row1, causal);
    if (nt < tiles) {
      copy.load(k_s + (stage ^ 1) * kCols * LD, k + head, nt * kCols, S, H);
      copy.load(v_s + (stage ^ 1) * kCols * LD, v + head, nt * kCols, S, H);
    }
    cp_async_commit();
    const int c0 = t * kCols;
    float s[NC][4], dp[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    WarpMma<float, NC, D>::nk(s, q_s + warp * 16 * LD, LD, k_t, LD);
    WarpMma<float, NC, D>::nk(dp, do_s + warp * 16 * LD, LD,
                              v_s + stage * kCols * LD, LD);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row_lo + 8 * i;
        const int col = c0 + j * 8 + cq + (e & 1);
        const bool allowed = col < S && (!causal || col <= row) &&
                             (!Mask || !in_bands(bt[col - c0], row));
        const float p = allowed ? expf(s[j][e] * scale - lse_r[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[i]) * scale;  // ds
      }
    }
    store_frag<float, NC>(ds_w, LDP, s);
    __syncwarp();
    WarpMma<float, D / 8, kCols>::kn(acc, ds_w, LDP, k_t, LD);
    __syncwarp();
    t = nt;
  }
  write_rows<float, D>(dq, acc, b, h, row_lo, S, H, 1.f, 1.f);
}

// k and v [64][LD], q and dO [2][64][LD], p then ds [64][LDP] (one buffer,
// used in turn), the lse and delta of two query tiles; under Mask the bands
// of the block's keys.
template <int D, bool Mask>
constexpr size_t dkv_f32_smem() {
  return (size_t)(6 * kRows * (D + 4) + kCols * (kRows + 4)) * sizeof(float) +
         2 * 2 * kRows * sizeof(float) + bands_smem<Mask>();
}

// grid (ceil(S / 64), B * H folded), block 128: one block per 64 key
// columns, the query tiles walked from the diagonal down (the heaviest
// blocks, the first columns, are scheduled first by grid order).
template <int D, bool Mask>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, const int* __restrict__ sri,
                     int S, int H, float scale, int causal, int n, int Hp,
                     int BH) {
  constexpr int LD = D + 4;
  constexpr int LDP = kRows + 4;
  constexpr int NR = kRows / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kCols * LD;
  float* q_s = v_s + kCols * LD;       // [2][kRows][LD]
  float* do_s = q_s + 2 * kRows * LD;  // [2][kRows][LD]
  float* pd_s = do_s + 2 * kRows * LD;  // p^T, then ds^T [key][query]
  float* stats = pd_s + kCols * LDP;    // [2][lse, delta][kRows]
  int4* bands = reinterpret_cast<int4*>(stats + 2 * 2 * kRows);  // [kCols]

  const int bh = folded_bh(blockIdx.z);
  if (bh >= BH) return;  // past B * H in the last fold
  const int b = bh / H;
  const int h = bh % H;
  const int col0 = blockIdx.x * kCols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key_lo = col0 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  float* pd_w = pd_s + warp * 16 * LDP;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  const RowCopy<float, D> copy(H);
  const size_t head = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)
  const float* stat_row = (threadIdx.x < kRows ? lse : delta) + (size_t)bh * S;
  const int stat_r = threadIdx.x & (kRows - 1);
  auto load_query_tile = [&](int tq, int stage) {
    const int q0 = tq * kRows;
    copy.load(q_s + stage * kRows * LD, q + head, q0, S, H);
    copy.load(do_s + stage * kRows * LD, dout + head, q0, S, H);
    const bool live = q0 + stat_r < S;
    cp_async4(stats + stage * 2 * kRows + threadIdx.x,
              live ? stat_row + q0 + stat_r : stat_row, live);
  };
  // the block's own 64 key columns: their bands hold for every query tile
  int4 mine = make_int4(0, 0, 0, 0);
  if constexpr (Mask) {
    if (threadIdx.x < kCols) {
      if (col0 + (int)threadIdx.x < S)
        mine = column_bands(sri, b, h, Hp, n, S, col0 + threadIdx.x, causal);
      bands[threadIdx.x] = mine;
    }
  }
  const int q_tiles = (S + kRows - 1) / kRows;

  int t = next_query_tile<Mask>(causal ? col0 / kRows : 0, q_tiles, mine,
                                col0, S, causal);
  if (t < q_tiles) {
    copy.load(k_s, k + head, col0, S, H);
    copy.load(v_s, v + head, col0, S, H);
    load_query_tile(t, 0);
  }
  cp_async_commit();
  for (int i = 0; t < q_tiles; ++i) {  // block-uniform
    const int stage = i & 1;
    const float* q_t = q_s + stage * kRows * LD;
    const float* do_t = do_s + stage * kRows * LD;
    const float* lse_s = stats + stage * 2 * kRows;
    const float* delta_s = lse_s + kRows;
    cp_async_wait_all();
    __syncthreads();  // tile t landed for all; the other stage consumed
    const int nt = next_query_tile<Mask>(t + 1, q_tiles, mine, col0, S,
                                         causal);
    if (nt < q_tiles) load_query_tile(nt, stage ^ 1);
    cp_async_commit();
    const int q0 = t * kRows;
    float st[NR][4], dpt[NR][4];  // s^T, dp^T: rows keys, columns queries
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
    WarpMma<float, NR, D>::nk(st, k_s + warp * 16 * LD, LD, q_t, LD);
    WarpMma<float, NR, D>::nk(dpt, v_s + warp * 16 * LD, LD, do_t, LD);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_lo + 8 * (e >> 1);
        const int qi = j * 8 + cq + (e & 1);
        const int row = q0 + qi;
        const bool allowed = row < S && key < S && (!causal || key <= row) &&
                             (!Mask || !in_bands(bands[key - col0], row));
        const float p = allowed ? expf(st[j][e] * scale - lse_s[qi]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - delta_s[qi]) * scale;  // ds^T
      }
    }
    store_frag<float, NR>(pd_w, LDP, st);
    __syncwarp();
    WarpMma<float, D / 8, kRows>::kn(dv_acc, pd_w, LDP, do_t, LD);
    __syncwarp();
    store_frag<float, NR>(pd_w, LDP, dpt);
    __syncwarp();
    WarpMma<float, D / 8, kRows>::kn(dk_acc, pd_w, LDP, q_t, LD);
    __syncwarp();
    t = nt;
  }
  write_rows<float, D>(dk, dk_acc, b, h, key_lo, S, H, 1.f, 1.f);
  write_rows<float, D>(dv, dv_acc, b, h, key_lo, S, H, 1.f, 1.f);
}

// Opt in to the kernel's dynamic shared memory and launch it.
template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                          cudaStream_t st, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D, bool Mask>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, const void* sri, int B, int S, int H,
                       float scale, int causal, int n, int Hp,
                       cudaStream_t st) {
  const dim3 grid((S + kRows - 1) / kRows, grid_y(B * H),
                  grid_fold(B * H));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  T* tout = static_cast<T*>(out);
  float* tlse = static_cast<float*>(lse);
  const int* tsri = static_cast<const int*>(sri);
  if constexpr (sizeof(T) == 2)
    return launch_kernel(flash_fwd_wgmma_kernel<T, D, Mask>, grid, kThreads,
                         fwd_wgmma_smem<D, Mask>(), st, tq, tk, tv, tout, tlse,
                         tsri, S, H, scale * kLog2e, causal, n, Hp,
                         B * H);
  else
    return launch_kernel(flash_fwd_f32_kernel<D, Mask>, grid, kThreads,
                         fwd_f32_smem<D, Mask>(), st, tq, tk, tv, tout, tlse,
                         tsri, S, H, scale * kLog2e, causal, n, Hp,
                         B * H);
}

template <typename T, int D, bool Mask>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const void* sri, int B, int S, int H,
                      float scale, int causal, int n, int Hp,
                      cudaStream_t st) {
  const dim3 grid((S + kRows - 1) / kRows, grid_y(B * H),
                  grid_fold(B * H));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* tlse = static_cast<const float*>(lse);
  const float* tdelta = static_cast<const float*>(delta);
  T* tdq = static_cast<T*>(dq);
  const int* tsri = static_cast<const int*>(sri);
  if constexpr (sizeof(T) == 2)
    return launch_kernel(flash_dq_wgmma_kernel<T, D, Mask>, grid, kThreads,
                         dq_wgmma_smem<D, Mask>(), st, tq, tk, tv, tdo, tlse,
                         tdelta, tdq, tsri, S, H, scale, causal, n, Hp,
                         B * H);
  else
    return launch_kernel(flash_dq_f32_kernel<D, Mask>, grid, kThreads,
                         dq_f32_smem<D, Mask>(), st, tq, tk, tv, tdo, tlse,
                         tdelta, tdq, tsri, S, H, scale, causal, n, Hp,
                         B * H);
}

template <typename T, int D, bool Mask>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const void* sri, int B, int S,
                       int H, float scale, int causal, int n, int Hp,
                       cudaStream_t st) {
  const dim3 grid((S + kCols - 1) / kCols, grid_y(B * H),
                  grid_fold(B * H));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* tlse = static_cast<const float*>(lse);
  const float* tdelta = static_cast<const float*>(delta);
  T* tdk = static_cast<T*>(dk);
  T* tdv = static_cast<T*>(dv);
  const int* tsri = static_cast<const int*>(sri);
  if constexpr (sizeof(T) == 2)
    return launch_kernel(flash_dkv_wgmma_kernel<T, D, Mask>, grid, kThreads,
                         dkv_wgmma_smem<D, Mask>(), st, tq, tk, tv, tdo, tlse,
                         tdelta, tdk, tdv, tsri, S, H, scale, causal, n, Hp,
                         B * H);
  else
    return launch_kernel(flash_dkv_f32_kernel<D, Mask>, grid, kThreads,
                         dkv_f32_smem<D, Mask>(), st, tq, tk, tv, tdo, tlse,
                         tdelta, tdk, tdv, tsri, S, H, scale, causal, n, Hp,
                         B * H);
}

// A FlashMask (sri not null) needs 1 <= n <= 4 and H' in {1, H}.
bool bad_shape(int B, int S, int H, const void* sri, int n, int Hp) {
  if (B <= 0 || S <= 0 || H <= 0) return true;
  return sri != nullptr && (n < 1 || n > 4 || (Hp != 1 && Hp != H));
}

}  // namespace

// Each entry returns a cudaError_t (0 on success). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16; D: 64 or 128. Pointers are device pointers of contiguous
// tensors, 16-byte aligned; `stream` is a cudaStream_t (PyTorch's current
// stream). Nothing is allocated here. `sri` is null for the unmasked
// kernels, or the FlashMask: int32 [B, Hp, S, n], Hp = 1 or H, n <= 4.
#define FLASH_DISPATCH(CALL)                                          \
  do {                                                                \
    const bool m = sri != nullptr;                                    \
    if (dtype == 0 && D == 64)                                        \
      return m ? (int)CALL(float, 64, true) : (int)CALL(float, 64, false); \
    if (dtype == 0 && D == 128)                                       \
      return m ? (int)CALL(float, 128, true)                          \
               : (int)CALL(float, 128, false);                        \
    if (dtype == 1 && D == 64)                                        \
      return m ? (int)CALL(bf16, 64, true) : (int)CALL(bf16, 64, false); \
    if (dtype == 1 && D == 128)                                       \
      return m ? (int)CALL(bf16, 128, true) : (int)CALL(bf16, 128, false); \
    if (dtype == 2 && D == 64)                                        \
      return m ? (int)CALL(f16, 64, true) : (int)CALL(f16, 64, false); \
    if (dtype == 2 && D == 128)                                       \
      return m ? (int)CALL(f16, 128, true) : (int)CALL(f16, 128, false); \
    return (int)cudaErrorInvalidValue;                                \
  } while (0)

extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       const void* sri, int B, int S, int H,
                                       int D, int dtype, float scale,
                                       int causal, int n, int Hp,
                                       void* stream) {
  if (bad_shape(B, S, H, sri, n, Hp)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, DD, M)                                                   \
  launch_fwd<T, DD, M>(q, k, v, out, lse, sri, B, S, H, scale, causal, n, \
                       Hp, st)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" int flash_attention_backward_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* sri, int B,
    int S, int H, int D, int dtype, float scale, int causal, int n, int Hp,
    void* stream) {
  if (bad_shape(B, S, H, sri, n, Hp)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, DD, M)                                                    \
  launch_dq<T, DD, M>(q, k, v, dout, lse, delta, dq, sri, B, S, H, scale, \
                      causal, n, Hp, st)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" int flash_attention_backward_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* sri,
    int B, int S, int H, int D, int dtype, float scale, int causal, int n,
    int Hp, void* stream) {
  if (bad_shape(B, S, H, sri, n, Hp)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, DD, M)                                                       \
  launch_dkv<T, DD, M>(q, k, v, dout, lse, delta, dk, dv, sri, B, S, H,      \
                       scale, causal, n, Hp, st)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
