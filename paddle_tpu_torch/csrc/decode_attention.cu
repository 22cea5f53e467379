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
// Bound. Decode (S = 1, G rows per (b, h)): ~4*D operations per live
// (row, column) pair on each live K/V row read once, a few flops per byte,
// so device-memory bytes bound it: the live K/V bytes over 3.35 TB/s.
// Prefill (S = P rows, causal within them): 4*D operations per allowed
// pair, ~P/2 flops per K/V byte; at P = 512 in bf16 that is near the card's
// ~295 flop/byte ridge, so tensor-core operations and bytes bound it about
// equally. The design:
//   * A block owns 64 query rows of one (b, h) (16 per warp) and loops over
//     64-column tiles of the [T, D] slab with an online softmax (m, l, o) in
//     f32 registers. Both products run on the tensor cores (bf16 mma.sync
//     m16n8k16 with ldmatrix operands, f32 accumulation), as in
//     flash_attention.cu; f32 caches take the same tiles through CUDA-core
//     FMAs. At prefill (P*G rows) the rows tile into ceil(P*G / 64) blocks,
//     each stopping at its last row's causal horizon.
//   * At decode a (b, h) has only G rows: one row tile, where warps with no
//     live row skip the products and only help load K/V. The sequential KV
//     axis of the TPU grid is cut into `splits` contiguous pieces (grid.x)
//     so that short batches still fill the 132 SMs; a second kernel
//     combines the f32 partials (`split_kv_combine_kernel`,
//     attention_common.cuh), writing 0 for a row with l = 0.
//   * Columns at or past the block's horizon min(length + s_last + 1, T) are
//     never read (zeros in shared memory); a split past it writes empty
//     partials without reading K/V, as `_write_dead` does.
//   * Probabilities are rounded to the cache dtype before P.V, where
//     `_partials_body` rounds them (`e.astype(v.dtype)`, :121); l sums the
//     unrounded f32 values, as there. Scores are kept in base 2 (one ex2
//     per probability, `online_softmax` of attention_common.cuh, shared
//     with the paged and flash kernels); the partials' m is written back in
//     natural units.
// No wgmma, TMA or loads in flight across tiles: this is the simple,
// correct first version.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;  // query rows of a block (16 per warp)
constexpr int kCols = 64;  // cache columns of a tile

// Query rows [r0, r0 + 64) of (b, h) into q_s (row stride LD): row r =
// s * G + g is query head h * G + g at step s. Rows at or past SG are zero.
template <typename T, int D>
__device__ __forceinline__ void load_q(T* dst, const T* __restrict__ q,
                                       int b, int h, int r0, int SG, int S,
                                       int Hq, int G) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  constexpr int LD = D + VEC;
  for (int idx = threadIdx.x; idx < kRows * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < SG) {
      const int s = row / G;
      const int g = row % G;
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t)(b * S + s) * Hq + h * G + g) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Cache rows [c0, c0 + 64) of one contiguous [T, D] slab into a shared tile
// (row stride LD); rows at or past col_end are zero and are not read.
template <typename T, int D>
__device__ __forceinline__ void load_kv(T* dst, const T* __restrict__ slab,
                                        int c0, int col_end) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  constexpr int LD = D + VEC;
  for (int idx = threadIdx.x; idx < kCols * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    const int col = c0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (col < col_end)
      val = *reinterpret_cast<const uint4*>(slab + (size_t)col * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <typename T, int D>
constexpr size_t partials_smem() {
  return (size_t)(3 * kRows * (D + 16 / sizeof(T)) +
                  kRows * (kCols + 16 / sizeof(T))) * sizeof(T);
}

// grid (splits, B * Hkv, ceil(S * G / 64)), block 128. Partials are
// o [splits, B * Hkv, S * G, D] (unnormalised) and m, l [splits, B * Hkv,
// S * G], all f32. `scale2` is scale * log2(e).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dense_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ lengths, int uniform_length,
                      float* __restrict__ o_part, float* __restrict__ m_part,
                      float* __restrict__ l_part, int S, int Hq, int Hkv,
                      int T_len, int G, float scale2, int tiles_per_split) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = D + VEC;
  constexpr int LDP = kCols + VEC;
  constexpr int NC = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kRows * LD;
  T* v_s = k_s + kCols * LD;
  T* p_s = v_s + kCols * LD;

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int SG = S * G;
  const int r0 = blockIdx.z * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_lo = r0 + warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const int length = lengths ? lengths[b] : uniform_length;
  const int rows_here = min(kRows, SG - r0);
  // the block's last row sees columns [0, length + s_last]
  const int s_last = (r0 + rows_here - 1) / G;
  const int col_end = min(length + s_last + 1, T_len);  // exclusive
  const int live_tiles = (col_end + kCols - 1) / kCols;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, live_tiles);
  const bool warp_live = warp * 16 < rows_here;  // warp-uniform
  int horizon[2];  // exclusive column limit of this lane's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    horizon[i] = row < SG ? min(length + row / G + 1, T_len) : 0;
  }
  T* p_w = p_s + warp * 16 * LDP;
  const T* k_slab = k + (size_t)bh * T_len * D;
  const T* v_slab = v + (size_t)bh * T_len * D;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  if (tile0 < tile1) load_q<T, D>(q_s, q, b, h, r0, SG, S, Hq, G);
  for (int t = tile0; t < tile1; ++t) {
    const int c0 = t * kCols;
    __syncthreads();  // q_s written / the previous tile consumed
    load_kv<T, D>(k_s, k_slab, c0, col_end);
    load_kv<T, D>(v_s, v_slab, c0, col_end);
    __syncthreads();
    if (!warp_live) continue;  // only loads for this warp; no barrier below
    float s[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    WarpMma<T, NC, D>::nk(s, q_s + warp * 16 * LD, LD, k_s, LD);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + j * 8 + cq + (e & 1);
        s[j][e] = col < horizon[e >> 1] ? s[j][e] * scale2 : -INFINITY;
      }
    }
    online_softmax<NC, D / 8>(s, m, l, o);
    store_frag<T, NC>(p_w, LDP, s);  // P rounded to the cache dtype
    __syncwarp();
    WarpMma<T, D / 8, kCols>::kn(o, p_w, LDP, v_s, LD);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_row = quad_sum(l[i]);
    const int row = row_lo + 8 * i;
    if (row >= SG) continue;
    const size_t base = ((size_t)split * gridDim.y + bh) * SG + row;
    float* dst = o_part + base * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dst[j * 8] = o[j][2 * i];
      dst[j * 8 + 1] = o[j][2 * i + 1];
    }
    if ((lane & 3) == 0) {
      m_part[base] = m[i] * kLn2;  // natural units, as the combine reads m
      l_part[base] = l_row;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, int uniform_length, void* o_part,
                   void* m_part, void* l_part, void* out, int B, int S,
                   int Hq, int Hkv,
                   int T_len, float scale, int tiles_per_split, int splits,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int SG = S * G;
  const size_t smem = partials_smem<T, D>();
  cudaError_t err = allow_smem(dense_partials_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, B * Hkv, (SG + kRows - 1) / kRows);
  dense_partials_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      uniform_length, static_cast<float*>(o_part),
      static_cast<float*>(m_part), static_cast<float*>(l_part), S, Hq, Hkv,
      T_len, G, scale * kLog2e, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_split_kv_combine<T, D>(o_part, m_part, l_part, out, splits,
                                       B * Hkv, SG, S, Hq, Hkv, G, stream);
}

}  // namespace

// Returns a cudaError_t (0 on success). dtype: 0 = float32, 1 = bfloat16;
// D: 64 or 128. q [B, S, Hq, D] in the cache dtype, caches [B, Hkv, T, D],
// lengths int32 [B] or null (then every request is at `uniform_length`),
// partials and out as the wrapper allocates them; all
// device pointers of contiguous, 16-byte aligned tensors. `stream` is a
// cudaStream_t (PyTorch's current stream). Nothing is allocated here.
extern "C" int decode_attention_forward(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, int uniform_length, void* o_part, void* m_part,
    void* l_part, void* out, int B, int S, int Hq, int Hkv, int T, int D,
    int dtype, float scale, int tiles_per_split, int splits, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      uniform_length < 0 ||
      splits <= 0 || tiles_per_split <= 0 || B * Hkv > 65535 ||
      (S * (Hq / Hkv) + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(TT, DD)                                                         \
  launch<TT, DD>(q, k_cache, v_cache, lengths, uniform_length, o_part,     \
                 m_part, l_part, out, B, S, Hq, Hkv, T, scale,              \
                 tiles_per_split, splits, st)
  if (dtype == 0 && D == 64) return (int)CALL(float, 64);
  if (dtype == 0 && D == 128) return (int)CALL(float, 128);
  if (dtype == 1 && D == 64) return (int)CALL(bf16, 64);
  if (dtype == 1 && D == 128) return (int)CALL(bf16, 128);
#undef CALL
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
