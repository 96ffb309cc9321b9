// Quantized GEMMs for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of chitu_tpu/ops/pallas_quant_gemm.py:
//   wg_gemm_kernel<MODE, TN> (gemm_common.cuh), launched by chitu_quant_gemm
//                      <- _gemm_kernel (B6 `_quant_gemm_stacked` / `matmul_stacked`
//                         and B7 `_quant_gemm` / `_matmul_impl`): y = x @
//                         dequant(W), one kernel family, since a layer of a
//                         stacked weight is a view
//   int8_gemm_kernel   <- _w8a8_kernel (B10): int8 x int8 -> int32, then the
//                         per-token and per-channel scales
//
// B6+B7. What bounds it on this card: at decode (T <= 64 rows) the weight
// bytes, read once from device memory (e4m3 [4096 -> 28672]: 117 MB, 35 us
// at 3.35 TB/s), with the conversion's instruction slots close behind; at a
// 512-row prefill slab the tensor cores. The design is the shared TMA +
// wgmma mainloop of gemm_common.cuh: weight tiles by TMA into a ring of
// shared-memory stages, one conversion a tile into the swizzled bf16
// layout wgmma reads, products straight from shared memory. Decode rows
// (T <= 64) swap A and B, so the weight's 64-column strips are wgmma's M
// and the T tokens its N (16, 32 or 64); K is split over grid.x where the
// column tiles alone would not fill the card (deterministic split-K). The
// slab runs tiles of 128 or 256 rows by 128 columns (256 where that takes
// fewer waves: one conversion then feeds twice the products), the grid
// over M tiles fastest, so blocks that share a weight tile run together
// and share it in L2. Modes: e4m3 with
// blockwise [K/B, N/B] or rowwise [K/B, N] scales, int8 with per-channel
// [N] scales, int4 with scales and zeros [K/B, N] one nibble a byte or
// packed (`pack_int4_storage`: the 512-column nibble layout, a tile reads
// 64 byte columns and produces the two 64-column ranges they hold).
// Scales and zeros are read where they lie; (w - zero) * scale is taken in
// f32 and rounded to bf16 once, where QTensor.dequantize rounds. Quant
// blocks of B rows must tile with the K tile (64 slab, 128 decode): 32,
// 64 or a multiple of 128. Ragged K and N are free: TMA fills zeros past
// the edges; a weight or x whose base or row stride a tensor map cannot
// describe is copied by the producer warp through cp.async instead (the
// wrapper decides by shape and pointer, ops/quant_gemm_kernels.gemm_plan).

#include <cuda_pipeline.h>
#include <mma.h>

#include "gemm_common.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------------------
// B10: int8 x int8 -> int32, then f32(acc) * x_scale[t] * w_scale[n]
// ---------------------------------------------------------------------------

struct Int8Args {
  const int8_t* x;       // [T, K]
  const float* x_scale;  // [T]
  const int8_t* w;       // [K, N]
  const float* w_scale;  // [N]
  const __nv_bfloat16* bias;
  void* out;  // [T, N] f32, bf16, or the raw int32 sums
  int T, K, N, out_mode;
  int vec_w, vec_x;
};

__device__ __forceinline__ uint4 load_i8_chunk(const int8_t* base, int row,
                                               int rows, int col, int ld,
                                               int vec) {
  Bytes16 u;
  u.v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= ld) return u.v;
  const int8_t* p = base + (size_t)row * ld + col;
  if (vec && col + 16 <= ld) {
    u.v = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (col + i < ld) u.b[i] = (uint8_t)p[i];
  }
  return u.v;
}

// Shared-memory tiles are kept as 16-byte-wide slabs ([k-step][row][16] for
// x, [column fragment][k][16] for W), so every wmma fragment starts on a
// 256-byte boundary with a leading dimension of 16.
template <int BM, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(Int8Args a) {
  constexpr int BK = 64;
  constexpr int FM = BM / WM / 16;
  constexpr int FN = BN / WN / 16;
  constexpr int WC = BK * BN / 16;  // 16-byte weight chunks per tile
  constexpr int WP = WC / THREADS;
  constexpr int XC = BM * BK / 16;
  constexpr int XP = (XC + THREADS - 1) / THREADS;
  static_assert(WM * WN * 32 == THREADS, "warp layout");

  __shared__ __align__(128) int8_t sA[(BK / 16) * BM * 16];
  __shared__ __align__(128) int8_t sB[(BN / 16) * BK * 16];
  __shared__ __align__(128) int sC[THREADS / 32][256];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  uint4 wreg[WP], xreg[XP];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < WP; ++p) {
      int c = tid + p * THREADS;
      wreg[p] = load_i8_chunk(a.w, k0 + c / 8, a.K, n0 + (c % 8) * 16, a.N, a.vec_w);
    }
#pragma unroll
    for (int p = 0; p < XP; ++p) {
      int c = tid + p * THREADS;
      if (c < XC)
        xreg[p] = load_i8_chunk(a.x, m0 + c / 4, a.T, k0 + (c % 4) * 16, a.K, a.vec_x);
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int p = 0; p < WP; ++p) {
      int c = tid + p * THREADS;
      *reinterpret_cast<uint4*>(&sB[((c % 8) * BK + c / 8) * 16]) = wreg[p];
    }
#pragma unroll
    for (int p = 0; p < XP; ++p) {
      int c = tid + p * THREADS;
      if (c < XC)
        *reinterpret_cast<uint4*>(&sA[((c % 4) * BM + c / 4) * 16]) = xreg[p];
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < a.K; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < a.K) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            af[i], reinterpret_cast<const signed char*>(
                       &sA[(kk * BM + (wm * FM + i) * 16) * 16]), 16);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf;
        wmma::load_matrix_sync(
            bf, reinterpret_cast<const signed char*>(
                    &sB[((wn * FN + j) * BK + kk * 16) * 16]), 16);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
      }
    }
    __syncthreads();
  }

  int* cw = sC[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cw, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int idx = lane; idx < 256; idx += 32) {
        int t = m0 + (wm * FM + i) * 16 + (idx >> 4);
        int n = n0 + (wn * FN + j) * 16 + (idx & 15);
        if (t < a.T && n < a.N) {
          size_t o = (size_t)t * a.N + n;
          if (a.out_mode == 2) {
            reinterpret_cast<int*>(a.out)[o] = cw[idx];
          } else {
            float v = (float)cw[idx] * a.x_scale[t] * a.w_scale[n];
            if (a.bias) v += __bfloat162float(a.bias[n]);
            if (a.out_mode == 1)
              reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(v);
            else
              reinterpret_cast<float*>(a.out)[o] = v;
          }
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// mode: 0 e4m3 bytes, 1 int8, 2 int4 one nibble a byte, 3 int4 packed.
// scale_mode: 0 blockwise [K/B, N/B], 1 rowwise [K/B, N], 2 per-channel [N];
// scale_ld is the scale's (and zeros') row length. N is the logical width.
// The plan (ops/quant_gemm_kernels.gemm_plan): tn, the rows a tile, 16 /
// 32 / 64 runs the swapped decode tiles with `splits` K splits, 128 / 256
// the slab tiles; tma_w /
// tma_x say whether a tensor map loads the weight / x (else cp.async).
// ws / counters: the split-K workspace, ncol * splits * tn * 128 floats
// and ncol ints that are zero between launches (ncol = column tiles).
int chitu_quant_gemm(const void* x, const void* w, const void* scale,
                     const void* zeros, const void* bias, void* out, int T,
                     int K, int N, int mode, int scale_mode, int block,
                     int scale_ld, int out_bf16, int tn, int splits, int tma_w,
                     int tma_x, void* ws, void* counters, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || block <= 0) return NOT_SUPPORTED;
  if (mode == MODE_INT4P && N % 512) return NOT_SUPPORTED;
  if (mode >= MODE_INT4 && zeros == nullptr) return NOT_SUPPORTED;
  if ((tn >= 128) != (T > 64) || (tn < 128 && tn < T)) return NOT_SUPPORTED;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return NOT_SUPPORTED;
  WgParams p;
  memset(&p, 0, sizeof(p));
  p.x = (const __nv_bfloat16*)x;
  p.w = (const uint8_t*)w;
  p.scale = (const float*)scale;
  p.zeros = (const float*)zeros;
  p.bias = (const __nv_bfloat16*)bias;
  p.out = out;
  p.ws = (float*)ws;
  p.counters = (int*)counters;
  p.x_rows = T;
  p.K = K;
  p.N = N;
  p.w_ld = (mode == MODE_INT4P) ? N / 2 : N;
  p.w_rows = K;
  p.bm = T;
  p.scale_mode = scale_mode;
  p.block = block;
  p.scale_ld = scale_ld;
  p.out_bf16 = out_bf16;
  p.ncol = (mode == MODE_INT4P) ? N / BN : (N + BN - 1) / BN;
  p.splits = splits;
  p.tma_w = tma_w;
  p.tma_x = tma_x;
  const int row_tiles = (T + tn - 1) / tn;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_FP8: return wg_gemm<MODE_FP8, 0>(p, tn, 1, row_tiles, s);
    case MODE_INT8: return wg_gemm<MODE_INT8, 0>(p, tn, 1, row_tiles, s);
    case MODE_INT4: return wg_gemm<MODE_INT4, 0>(p, tn, 1, row_tiles, s);
    case MODE_INT4P: return wg_gemm<MODE_INT4P, 0>(p, tn, 1, row_tiles, s);
  }
  return NOT_SUPPORTED;
}

// out_mode: 0 f32, 1 bf16, 2 the raw int32 sums (scales unused)
int chitu_int8_gemm(const void* x, const void* x_scale, const void* w,
                    const void* w_scale, const void* bias, void* out, int T,
                    int K, int N, int out_mode, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0) return NOT_SUPPORTED;
  if (out_mode != 2 && (x_scale == nullptr || w_scale == nullptr)) return NOT_SUPPORTED;
  Int8Args a;
  a.x = (const int8_t*)x;
  a.x_scale = (const float*)x_scale;
  a.w = (const int8_t*)w;
  a.w_scale = (const float*)w_scale;
  a.bias = (const __nv_bfloat16*)bias;
  a.out = out;
  a.T = T;
  a.K = K;
  a.N = N;
  a.out_mode = out_mode;
  a.vec_w = aligned16(w) && (N % 16 == 0);
  a.vec_x = aligned16(x) && (K % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  int nb = (N + BN - 1) / BN;
  if (T <= 16) {
    dim3 grid(1, nb);
    int8_gemm_kernel<16, 1, 8><<<grid, THREADS, 0, s>>>(a);
  } else {
    dim3 grid((T + 127) / 128, nb);
    int8_gemm_kernel<128, 4, 2><<<grid, THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
