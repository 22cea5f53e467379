// Flash attention forward and backward for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (paddle_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   * flash_fwd_wgmma_kernel (bf16), flash_fwd_f32_kernel (f32)
//                       <- `_fwd_kernel` (:89), launched by `_mha_fwd` (:146);
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
// they are bound by tensor-core operations. Every kernel keeps the [S, S]
// scores out of device memory: a block owns 64 query rows (the dk/dv kernel
// 64 keys) and walks 64-wide tiles of the partner axis with an online
// softmax (m, l) in f32 registers, stopping at the diagonal when causal
// (the TPU forward holds all of K/V for a q block in VMEM, 256 KB at
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
// The backward kernels take their operands from shared memory by ldmatrix
// for bf16 mma.sync m16n8k16 with f32 accumulation (f32: CUDA-core FMAs):
// the dq kernel walks K/V tiles and accumulates dq += ds.K in f32
// registers; the dk/dv kernel owns 64 key columns and walks the query tiles
// from the diagonal down, accumulating dv += p^T.dO and dk += ds^T.Q. No
// atomics: results are deterministic. p and ds go through shared memory in
// the storage dtype, where the TPU kernels round them, rows padded by 16
// bytes so ldmatrix reads are free of bank conflicts; their tiles are
// loaded synchronously (no loads in flight, no wgmma yet).
// The warp-level products and helpers live in attention_common.cuh.
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
// before its loads and products (the forward reads the next tile's bands,
// and skips it, before it starts that tile's loads): computed, it would
// leave m, l and O as they were (its probabilities are exp2(-inf) = 0 and
// alpha = 1 once m is finite), so the skip is bit-exact. On packed
// documents (a causal mask with start = the column's document end) this
// removes every tile across documents, most of the causal work at 8192
// tokens. The test is
// conservative (one band must hold the rows; two that only cover them
// together do not skip). Bound: the same products over the allowed pairs
// only, so operations bound the masked kernels as they bound the unmasked
// ones; the mask adds S * n * 4 bytes per head read.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;  // query rows of a tile (16 per warp)
constexpr int kCols = 64;  // key columns of a tile

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

// The bands of key columns [c0, c0 + 64) into `bands`; returns, to every
// thread, whether they cover the tile of query rows [r0, r1). Contains a
// barrier: every thread of the block calls it.
__device__ __forceinline__ bool load_bands(int4* bands,
                                           const int* __restrict__ sri,
                                           int b, int h, int Hp, int n,
                                           int S, int c0, int r0, int r1,
                                           int causal) {
  bool covered = true;
  if (threadIdx.x < kCols) {
    const int c = c0 + threadIdx.x;
    const int4 m = c < S ? column_bands(sri, b, h, Hp, n, S, c, causal)
                         : make_int4(0, 0, 0, 0);
    bands[threadIdx.x] = m;
    covered = column_covered(m, c, r0, r1, S, causal);
  }
  return __syncthreads_and(covered);
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
// in `bands`, so a covered tile is never fetched. Contains barriers under
// Mask: every thread of the block calls it.
template <bool Mask>
__device__ __forceinline__ int next_tile(int t, int tiles, int4* bands,
                                         const int* __restrict__ sri, int b,
                                         int h, int Hp, int n, int S,
                                         int row0, int row1, int causal) {
  if constexpr (Mask) {
    while (t < tiles && load_bands(bands, sri, b, h, Hp, n, S, t * kCols,
                                   row0, row1, causal))
      ++t;
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

// The f32 forward. grid (ceil(S / 64), B * H), block 128; `scale2` is
// scale * log2(e). The heaviest causal tiles (the last query rows) are
// scheduled first. Products by CUDA-core FMAs in full f32, P through shared
// memory; K/V through a two-stage cp.async ring, one barrier per tile.
template <int D, bool Mask>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ sri,
                     int S, int H, float scale2, int causal, int n, int Hp) {
  constexpr int LD = D + 4;
  constexpr int LDP = kCols + 4;
  constexpr int NC = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kRows * LD;        // [2][kCols][LD]
  float* v_s = k_s + 2 * kCols * LD;    // [2][kCols][LD]
  float* p_s = v_s + 2 * kCols * LD;    // [kRows][LDP]
  int4* bands = reinterpret_cast<int4*>(p_s + kRows * LDP);  // [2][kCols]

  const int bh = blockIdx.y;
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
// The bf16 forward on Hopper's warpgroup products. The block's 4 warps are
// one warpgroup owning 64 query rows. Q, K and V tiles sit in shared memory
// in the 128-byte swizzled layout wgmma's descriptors describe: each
// 64-column panel of a 64-row tile is 64 rows of 128 bytes, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8), tiles 1024-byte aligned.
// S = Q.K^T reads both from shared memory (K-major); P.V takes P from
// registers as the A operand (the score accumulators packed to bf16) and V
// from shared memory (MN-major, V's rows are the k dimension).

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
// (descriptors), both K-major; scale_d = 0 ignores D's old values.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (each warp's
// m16n8k16 A fragments of its 16 rows), B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (each warp's
// m16n8k16 A fragments of its 16 rows), B in shared memory, MN-major.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[16][4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One thread's share of the 16-byte copies of a 64-row bf16 tile of one
// head of a [B, S, H, D] tensor into a swizzled tile (see above): copy i of
// a thread is chunk c = tid % CPR of row r = tid / CPR + i * STEP, STEP a
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
  __device__ __forceinline__ void load(unsigned char* tile,
                                       const bf16* __restrict__ head,
                                       int row0, int S, int H) const {
    const bf16* first = head + (size_t)row0 * H * D + src;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool live = row0 + row + i * STEP < S;
      cp_async16(tile + dst + i * STEP * 128,
                 live ? first + (size_t)i * src_step : head, live);
    }
  }
};

// Q, then K and V two stages each; under Mask the bands of two tiles.
template <int D, bool Mask>
constexpr size_t fwd_wgmma_smem() {
  return 1024 + 5 * (size_t)kRows * D * sizeof(bf16) + 2 * bands_smem<Mask>();
}

// O += P . V for one tile: P in registers (k-block kk in pa[kk]), V the
// swizzled tile at v_t.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 8][4],
                                         const uint32_t (&pa)[kCols / 16][4],
                                         const unsigned char* v_t) {
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk) {
    const uint64_t dv = sw128_desc(v_t + kk * 16 * 128, kRows * 128);
    if constexpr (D == 64)
      wgmma_m64n64k16_rs(o, pa[kk], dv);
    else
      wgmma_m64n128k16_rs(o, pa[kk], dv);
  }
}

// The bf16 forward. grid (ceil(S / 64), B * H), block 128 (one warpgroup);
// `scale2` is scale * log2(e). The heaviest causal tiles first.
template <int D, bool Mask>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, const int* __restrict__ sri,
                       int S, int H, float scale2, int causal, int n, int Hp) {
  constexpr int NC = kCols / 8;
  constexpr int TILE = kRows * D * sizeof(bf16);  // bytes of a 64-row tile
  constexpr int PANEL = kRows * 128;              // bytes of a 64-col panel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + TILE;      // [2]
  unsigned char* v_s = k_s + 2 * TILE;  // [2]
  int4* bands = reinterpret_cast<int4*>(v_s + 2 * TILE);  // [2][kCols]

  const int bh = blockIdx.y;
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
    const unsigned char* k_t = k_s + stage * TILE;
    wgmma_fence();
    fence_regs<NC>(s);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int off = (ks >> 2) * PANEL + (ks & 3) * 32;
      wgmma_m64n64k16_ss(s, sw128_desc(q_s + off, 16),
                         sw128_desc(k_t + off, 16), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NC>(s);

    scale_mask<Mask>(s, bands + stage * kCols, t * kCols, row_lo, S, causal,
                     scale2, !Mask && full_tile(t * kCols, row0, S, causal));
    online_softmax<NC, D / 8>(s, m, l, o);
    uint32_t pa[NC / 2][4];
    pack_a<NC>(pa, s);  // P rounded to V's dtype

    // O += P . V, P from registers
    wgmma_fence();
    fence_regs<D / 8>(o);
    fence_regs<NC / 2>(pa);
    wgmma_pv<D>(o, pa, v_s + stage * TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 8>(o);
    fence_regs<NC / 2>(pa);
    t = nt;
  }
  write_fwd<bf16, D>(out, lse, o, m, l, b, h, bh, row_lo, S, H);
}

template <typename T, int D, bool Mask>
constexpr size_t dq_smem() {
  return (size_t)(4 * kRows * (D + 16 / sizeof(T)) +
                  kRows * (kCols + 16 / sizeof(T))) * sizeof(T) +
         bands_smem<Mask>();
}

// grid (ceil(S / 64), B * H), block 128: one block per 64 query rows, the
// K/V tiles walked up to the diagonal. Heaviest tiles first.
template <typename T, int D, bool Mask>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                const int* __restrict__ sri, int S, int H, float scale,
                int causal, int n, int Hp) {
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
  int4* bands = reinterpret_cast<int4*>(ds_s + kRows * LDP);

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
    if constexpr (Mask) {
      if (load_bands(bands, sri, b, h, Hp, n, S, c0, row0,
                     min(row0 + kRows, S), causal))
        continue;
    }
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
        const bool allowed = col < S && (!causal || col <= row) &&
                             (!Mask || !in_bands(bands[col - c0], row));
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

template <typename T, int D, bool Mask>
constexpr size_t dkv_smem() {
  return (size_t)(4 * kRows * (D + 16 / sizeof(T)) +
                  2 * kCols * (kRows + 16 / sizeof(T))) * sizeof(T) +
         2 * kRows * sizeof(float) + bands_smem<Mask>();
}

// grid (ceil(S / 64), B * H), block 128: one block per 64 key columns, the
// query tiles walked from the diagonal down (the heaviest blocks, the first
// columns, are scheduled first by grid order).
template <typename T, int D, bool Mask>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, const int* __restrict__ sri, int S,
                 int H, float scale, int causal, int n, int Hp) {
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
  int4* bands = reinterpret_cast<int4*>(delta_s + kRows);

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
  // the block's own 64 key columns: their bands hold for every query tile
  int4 mine = make_int4(0, 0, 0, 0);
  if constexpr (Mask) {
    if (threadIdx.x < kCols) {
      if (col0 + (int)threadIdx.x < S)
        mine = column_bands(sri, b, h, Hp, n, S, col0 + threadIdx.x, causal);
      bands[threadIdx.x] = mine;
    }
  }

  for (int t = first; t < q_tiles; ++t) {
    const int q0 = t * kRows;
    if constexpr (Mask) {
      const bool covered =
          threadIdx.x >= kCols ||
          column_covered(mine, col0 + threadIdx.x, q0, min(q0 + kRows, S), S,
                         causal);
      if (__syncthreads_and(covered)) continue;
    }
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
        const bool allowed = row < S && key < S && (!causal || key <= row) &&
                             (!Mask || !in_bands(bands[key - col0], row));
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
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  T* tout = static_cast<T*>(out);
  float* tlse = static_cast<float*>(lse);
  const int* tsri = static_cast<const int*>(sri);
  if constexpr (sizeof(T) == 2)
    return launch_kernel(flash_fwd_wgmma_kernel<D, Mask>, grid, kThreads,
                         fwd_wgmma_smem<D, Mask>(), st, tq, tk, tv, tout, tlse,
                         tsri, S, H, scale * kLog2e, causal, n, Hp);
  else
    return launch_kernel(flash_fwd_f32_kernel<D, Mask>, grid, kThreads,
                         fwd_f32_smem<D, Mask>(), st, tq, tk, tv, tout, tlse,
                         tsri, S, H, scale * kLog2e, causal, n, Hp);
}

template <typename T, int D, bool Mask>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const void* sri, int B, int S, int H,
                      float scale, int causal, int n, int Hp,
                      cudaStream_t st) {
  const size_t smem = dq_smem<T, D, Mask>();
  cudaError_t err = allow_smem(flash_dq_kernel<T, D, Mask>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_dq_kernel<T, D, Mask><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<const int*>(sri), S, H, scale, causal,
      n, Hp);
  return cudaGetLastError();
}

template <typename T, int D, bool Mask>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const void* sri, int B, int S,
                       int H, float scale, int causal, int n, int Hp,
                       cudaStream_t st) {
  const size_t smem = dkv_smem<T, D, Mask>();
  cudaError_t err = allow_smem(flash_dkv_kernel<T, D, Mask>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kCols - 1) / kCols, B * H);
  flash_dkv_kernel<T, D, Mask><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<const int*>(sri),
      S, H, scale, causal, n, Hp);
  return cudaGetLastError();
}

// A FlashMask (sri not null) needs 1 <= n <= 4 and H' in {1, H}.
bool bad_shape(int B, int S, int H, const void* sri, int n, int Hp) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535) return true;
  return sri != nullptr && (n < 1 || n > 4 || (Hp != 1 && Hp != H));
}

}  // namespace

// Each entry returns a cudaError_t (0 on success). dtype: 0 = float32,
// 1 = bfloat16; D: 64 or 128. Pointers are device pointers of contiguous
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
