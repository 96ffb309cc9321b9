// Quantized GEMMs for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of chitu_tpu/ops/pallas_quant_gemm.py:
//   wg_gemm_kernel<MODE, TN> (gemm_common.cuh), launched by chitu_quant_gemm
//                      <- _gemm_kernel (B6 `_quant_gemm_stacked` / `matmul_stacked`
//                         and B7 `_quant_gemm` / `_matmul_impl`): y = x @
//                         dequant(W), one kernel family, since a layer of a
//                         stacked weight is a view
//   wg_gemm_kernel<MODE_S8, TN> (the same mainloop), launched by
//                      chitu_int8_gemm
//                      <- _w8a8_kernel (B10 `_w8a8_matmul` /
//                         `_w8a8_matmul_pre`): int8 x int8 -> int32, then
//                         the per-token and per-channel scales
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
//
// B10. What bounds it: at decode the int8 weight bytes (117 MB at
// [4096 -> 28672], 35 us), at a 512-row slab the int8 tensor cores (1979
// TOP/s). The design: the same mainloop in MODE_S8 -- x [T, K] int8 by TMA
// as it lies (K-major), the raw int8 weight tile by TMA, transposed once
// into K-major rows (wgmma takes 8-bit operands K-major only; the JAX
// package's [K, N] layout stays the port's), `wgmma ... .s32.s8.s8`, the
// decode's K splits summed in int32 in split order (exact, deterministic),
// then f32(sum) * x_scale[t] * w_scale[n] (+ bias) as the old kernel did.

#include "gemm_common.cuh"

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

// B10. out_mode: 0 f32, 1 bf16, 2 the raw int32 sums (scales unused).
// The plan (ops/quant_gemm_kernels.int8_plan) as for chitu_quant_gemm: tn,
// splits, tma_w, tma_x; ws / counters: ncol * splits * tn * 128 int32
// partials and ncol tickets that are zero between launches.
int chitu_int8_gemm(const void* x, const void* x_scale, const void* w,
                    const void* w_scale, const void* bias, void* out, int T,
                    int K, int N, int out_mode, int tn, int splits, int tma_w,
                    int tma_x, void* ws, void* counters, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || out_mode < 0 || out_mode > 2) return NOT_SUPPORTED;
  if (out_mode != 2 && (x_scale == nullptr || w_scale == nullptr)) return NOT_SUPPORTED;
  if ((tn >= 128) != (T > 64) || (tn < 128 && tn < T)) return NOT_SUPPORTED;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return NOT_SUPPORTED;
  WgParams p;
  memset(&p, 0, sizeof(p));
  p.x = (const __nv_bfloat16*)x;  // int8 rows: the mainloop reads bytes
  p.w = (const uint8_t*)w;
  p.scale = (const float*)w_scale;
  p.x_scale = (const float*)x_scale;
  p.bias = (const __nv_bfloat16*)bias;
  p.out = out;
  p.ws = (float*)ws;
  p.counters = (int*)counters;
  p.x_rows = T;
  p.K = K;
  p.N = N;
  p.w_ld = N;
  p.w_rows = K;
  p.bm = T;
  p.scale_mode = SCALE_CHAN;
  p.block = 128;
  p.scale_ld = N;
  p.out_bf16 = out_mode == 1;
  p.out_i32 = out_mode == 2;
  p.ncol = (N + BN - 1) / BN;
  p.splits = splits;
  p.tma_w = tma_w;
  p.tma_x = tma_x;
  return wg_gemm<MODE_S8, 0>(p, tn, 1, (T + tn - 1) / tn, (cudaStream_t)stream);
}

}  // extern "C"
