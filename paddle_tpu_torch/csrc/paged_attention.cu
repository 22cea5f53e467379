// Paged split-KV attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (paddle_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernel `_paged_kernel`
// (paddle_tpu/ops/pallas/decode_attention.py:245, launched at :369) and its
// XLA stage-2 reduction `_combine_partials` (:153). Every prefill chunk
// (S = chunk width) and every decode step (S = 1) of the GPT serving path
// attends through it.
//
// What it computes, per request b and kv head h: the S*G query rows
// (row r = s*G + g, query head h*G + g, absolute position length[b] + s)
// attend over the paged cache columns c with c <= length[b] + s, where
// column c lives in page block_tables[b][c / BS] at slot c % BS of the
// head-leading pool [Hkv, P, BS, D]. Output [B, S, Hq, D] in the pool's
// dtype.
//
// Bound: the kernel does ~4*D flops per (row, column) pair and reads each
// live K/V row once, so at decode (S*G rows per kv head is 1..8) it is
// bound by device-memory bytes: the live K/V bytes over 3.35 TB/s. A
// prefill chunk of 64 rows is still far below the ~295 flop/byte ridge of
// bf16 on this card. The design therefore spends nothing on tensor cores
// and everything on reading each live K/V row once:
//   * The sequential KV grid axis of the TPU kernel becomes a loop inside
//     the block over 32-column tiles, with an online softmax (m, l, o) in
//     f32 registers; the KV range is cut into `splits` contiguous pieces
//     (grid.x) so that short batches still fill the 132 SMs.
//   * Each block reads its own block-table entries and length (the TPU
//     kernel's scalar prefetch). Columns past length + s_last of the
//     block's rows are neither fetched nor their table entries read; a
//     split whose range is entirely dead writes empty partials and exits.
//   * K/V rows are read as 16-byte vectors, neighbouring threads on
//     neighbouring addresses, into shared memory as f32 (K rows padded to
//     D + 1 floats so the per-lane column dot products are conflict-free).
//   * One warp owns RPW query rows; lane c scores column c of the tile,
//     and lane d accumulates output columns d, d+32, ...
//   * Probabilities are rounded to the value dtype before P.V, as the TPU
//     kernel's `e.astype(v.dtype)` (decode_attention.py:121); the
//     normaliser l is summed unrounded in f32, as there.
//   * Partials (o, m, l) per split are f32; a second small kernel combines
//     them with the exp(m_j - m*) rescale and writes 0 for rows with l = 0
//     (`split_kv_combine_kernel`, attention_common.cuh).
// No wgmma and no TMA: this is the simple, correct first version.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileCols = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// grid (splits, B*Hkv, ceil(S*G / (kWarps*RPW))), block kThreads.
// Partials are [splits, B*Hkv, S*G, D] (o) and [splits, B*Hkv, S*G] (m, l).
template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
paged_partials_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ lengths,
                      float* __restrict__ o_part, float* __restrict__ m_part,
                      float* __restrict__ l_part, int S, int Hq, int Hkv,
                      int P, int BS, int NB, int G, float scale,
                      int tiles_per_split) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = D / VEC;         // 16-byte loads per row
  constexpr int R = kWarps * RPW;      // query rows per block
  constexpr int DPL = D / 32;          // output columns per lane
  __shared__ float q_s[R][D];
  __shared__ float k_s[kTileCols][D + 1];
  __shared__ float v_s[kTileCols][D];

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int SG = S * G;
  const int r0 = blockIdx.z * R;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int length = lengths[b];
  const int rows_here = min(R, SG - r0);
  // the tile's last row sees columns [0, length + s_last]
  const int s_last = (r0 + rows_here - 1) / G;
  const int col_end = min(length + s_last + 1, NB * BS);  // exclusive
  const int live_tiles = (col_end + kTileCols - 1) / kTileCols;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, live_tiles);

  float m[RPW], l[RPW], o[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) o[i][k] = 0.f;
  }

  if (tile0 < tile1) {
    for (int idx = tid; idx < R * VPR; idx += kThreads) {
      const int r = idx / VPR;
      const int v = idx % VPR;
      float* dst = &q_s[r][v * VEC];
      if (r < rows_here) {
        const int row = r0 + r;
        const int s = row / G;
        const int g = row % G;
        load16(q + ((size_t)(b * S + s) * Hq + h * G + g) * D + v * VEC, dst);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = 0.f;
      }
    }
  }

  for (int tile = tile0; tile < tile1; ++tile) {
    const int c0 = tile * kTileCols;
    __syncthreads();  // q_s written / previous tile fully consumed
    for (int idx = tid; idx < kTileCols * VPR; idx += kThreads) {
      const int c = idx / VPR;
      const int v = idx % VPR;
      const int col = c0 + c;
      float kv[VEC], vv[VEC];
      if (col < col_end) {
        const int page = block_tables[b * NB + col / BS];
        const size_t off =
            (((size_t)h * P + page) * BS + col % BS) * D + v * VEC;
        load16(k_pages + off, kv);
        load16(v_pages + off, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[c][v * VEC + e] = kv[e];
        v_s[c][v * VEC + e] = vv[e];
      }
    }
    __syncthreads();
    const int col = c0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      if (r < rows_here) {  // warp-uniform
        const int s = (r0 + r) / G;
        const bool allowed = col < col_end && col <= length + s;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) acc = fmaf(q_s[r][d], k_s[lane][d], acc);
        const float sc = allowed ? acc * scale : -INFINITY;
        const float m_new = fmaxf(m[i], warp_max(sc));
        if (m_new != -INFINITY) {  // warp-uniform
          const float alpha = expf(m[i] - m_new);
          const float p = allowed ? expf(sc - m_new) : 0.f;
          l[i] = l[i] * alpha + warp_sum(p);
          const float pv = round_to<T>(p);
#pragma unroll
          for (int k = 0; k < DPL; ++k) o[i][k] *= alpha;
#pragma unroll 8
          for (int c = 0; c < kTileCols; ++c) {
            const float pc = __shfl_sync(kFull, pv, c);
#pragma unroll
            for (int k = 0; k < DPL; ++k)
              o[i][k] = fmaf(pc, v_s[c][lane + 32 * k], o[i][k]);
          }
          m[i] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    if (r < rows_here) {
      const size_t base = ((size_t)split * gridDim.y + bh) * SG + r0 + r;
#pragma unroll
      for (int k = 0; k < DPL; ++k) o_part[base * D + lane + 32 * k] = o[i][k];
      if (lane == 0) {
        m_part[base] = m[i];
        l_part[base] = l[i];
      }
    }
  }
}

template <typename T, int D, int RPW>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* lengths,
                   void* o_part, void* m_part, void* l_part, void* out, int B,
                   int S, int Hq, int Hkv, int P, int BS, int NB, float scale,
                   int tiles_per_split, int splits, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int SG = S * G;
  const int R = kWarps * RPW;
  const dim3 grid(splits, B * Hkv, (SG + R - 1) / R);
  paged_partials_kernel<T, D, RPW><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<float*>(o_part),
      static_cast<float*>(m_part), static_cast<float*>(l_part), S, Hq, Hkv,
      P, BS, NB, G, scale, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_split_kv_combine<T, D>(o_part, m_part, l_part, out, splits,
                                       B * Hkv, SG, S, Hq, Hkv, G, stream);
}

template <typename T, int D>
cudaError_t dispatch_rpw(int rpw, const void* q, const void* k,
                         const void* v, const void* t, const void* len,
                         void* op, void* mp, void* lp, void* out, int B,
                         int S, int Hq, int Hkv, int P, int BS, int NB,
                         float scale, int tps, int splits, cudaStream_t st) {
  switch (rpw) {
    case 1:
      return launch<T, D, 1>(q, k, v, t, len, op, mp, lp, out, B, S, Hq, Hkv,
                             P, BS, NB, scale, tps, splits, st);
    case 2:
      return launch<T, D, 2>(q, k, v, t, len, op, mp, lp, out, B, S, Hq, Hkv,
                             P, BS, NB, scale, tps, splits, st);
    case 4:
      return launch<T, D, 4>(q, k, v, t, len, op, mp, lp, out, B, S, Hq, Hkv,
                             P, BS, NB, scale, tps, splits, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, int rpw, const void* q, const void* k,
                       const void* v, const void* t, const void* len,
                       void* op, void* mp, void* lp, void* out, int B, int S,
                       int Hq, int Hkv, int P, int BS, int NB, float scale,
                       int tps, int splits, cudaStream_t st) {
  switch (D) {
    case 64:
      return dispatch_rpw<T, 64>(rpw, q, k, v, t, len, op, mp, lp, out, B, S,
                                 Hq, Hkv, P, BS, NB, scale, tps, splits, st);
    case 128:
      return dispatch_rpw<T, 128>(rpw, q, k, v, t, len, op, mp, lp, out, B,
                                  S, Hq, Hkv, P, BS, NB, scale, tps, splits,
                                  st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). dtype: 0 = float32, 1 = bfloat16.
// All pointers are device pointers of contiguous tensors; `stream` is a
// cudaStream_t (PyTorch's current stream). Nothing is allocated here.
extern "C" int paged_attention_forward(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* o_part,
    void* m_part, void* l_part, void* out, int B, int S, int Hq, int Hkv,
    int P, int BS, int NB, int D, int dtype, float scale, int rpw,
    int tiles_per_split, int splits, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || splits <= 0 || tiles_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, rpw, q, k_pages, v_pages, block_tables,
                            lengths, o_part, m_part, l_part, out, B, S, Hq,
                            Hkv, P, BS, NB, scale, tiles_per_split, splits,
                            st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, rpw, q, k_pages, v_pages,
                                    block_tables, lengths, o_part, m_part,
                                    l_part, out, B, S, Hq, Hkv, P, BS, NB,
                                    scale, tiles_per_split, splits, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
