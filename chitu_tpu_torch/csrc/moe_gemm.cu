// Grouped (expert-indexed) GEMM of the MoE path for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel of chitu_tpu/ops/pallas_moe_gemm.py
// (`grouped_matmul` / `_grouped_gemm`, body `_moe_gemm_kernel`, B8):
//   out[b*bm + i] = xs[b*bm + i] @ dequant(w[layer, block_expert[b]])
// for token-sorted rows in dispatch blocks of bm rows, each block owned by
// one expert; a block whose expert id is negative (or beyond the stack) is
// dead: it reads no weight and writes zeros. Weights are bf16, or e4m3 bytes
// with f32 scales per 128-row K block, blockwise [K/128, N/128] or rowwise
// [K/128, N], read where they lie.
//
// What bounds it on this card: at decode the bytes of the live experts'
// weights, each read once from device memory (R1's top-8 of 256 at 16
// tokens reads up to 128 experts); at a prefill slab the tensor cores.
// The kernel is the shared TMA + wgmma mainloop of gemm_common.cuh
// (`wg_gemm_kernel<MODE_FP8 | MODE_BF16, TN, 1>`), the dequant GEMM's, with
// one weight tensor map over the layer stack's whole [L * E * K, N] rows:
// the block reads `block_expert[b]` on the device and loads its tiles at
// row (layer * E + e) * K + k, so no launch reads the routing on the host
// and the grid (K splits or row tiles, dispatch blocks, column tiles)
// depends on the static worst-case block count only: a launch can be
// captured in a CUDA graph. e4m3 tiles are converted once a tile to
// bf16(float(w) * scale), the arithmetic of `QTensor.dequantize`, so kernel
// and plain version round at the same places; bf16 tiles go by TMA straight
// into the swizzled layout wgmma reads. bm 16, 32 and 64 run the swapped
// decode tiles (64 weight columns a warpgroup as wgmma's M, the block's bm
// rows as N) with K split over grid.x where the live blocks alone would
// not fill the card (deterministic: the last ticket sums the splits in
// order); bm 128 and 256 run one slab tile of bm rows by 128 columns a
// dispatch block, all of one expert. Blocks of one column tile run together, so dispatch
// blocks of the same expert share its column strip in L2.
//
// K and N are multiples of 128 and every pointer is 16-byte aligned (the
// wrapper checks), so tensor maps describe every operand.

#include "gemm_common.cuh"

namespace {

constexpr int QBLK = 128;  // K rows that share one scale row

}  // namespace

extern "C" {

// x [NB*bm, K] bf16; w the whole stack [L, E, K, N] (L = 1 when unstacked),
// bf16 (fp8 = 0) or e4m3 bytes (fp8 = 1) with f32 scales [L, E, K/128,
// scale_ld], rowwise (one a column) or blockwise (one a 128-column block);
// block_expert [NB] int32 on the device; out [NB*bm, N] bf16. ws /
// counters: the split-K workspace of the decode tiles (bm <= 64), NB *
// (N/128) * splits * bm * 128 floats and NB * (N/128) ints that are zero
// between launches.
int chitu_moe_gemm(const void* x, const void* w, const void* scale,
                   const void* block_expert, void* out, int NB, int bm, int K,
                   int N, int E, int L, int layer, int fp8, int scale_ld,
                   int scale_rowwise, void* ws, void* counters, int splits,
                   void* stream) {
  if (NB <= 0 || K <= 0 || N <= 0 || E <= 0 || layer < 0 || layer >= L)
    return NOT_SUPPORTED;
  if (K % QBLK || N % BN) return NOT_SUPPORTED;
  if (fp8 && scale == nullptr) return NOT_SUPPORTED;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out)) return NOT_SUPPORTED;
  if (bm != 16 && bm != 32 && bm != 64 && bm != 128 && bm != 256) return NOT_SUPPORTED;
  const int tn = bm;  // rows a tile: one dispatch block
  if (tn >= 128) splits = 1;
  if (splits < 1) splits = 1;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return NOT_SUPPORTED;
  WgParams p;
  memset(&p, 0, sizeof(p));
  p.x = (const __nv_bfloat16*)x;
  p.w = (const uint8_t*)w;
  p.scale = (const float*)scale;
  p.block_expert = (const int*)block_expert;
  p.out = out;
  p.ws = (float*)ws;
  p.counters = (int*)counters;
  p.scale_expert = fp8 ? (long long)(K / QBLK) * scale_ld : 0;
  p.x_rows = NB * bm;
  p.K = K;
  p.N = N;
  p.w_ld = N;
  p.w_rows = L * E * K;
  p.bm = bm;
  p.E = E;
  p.layer = layer;
  p.scale_mode = scale_rowwise ? SCALE_ROW : SCALE_BLOCK;
  p.block = QBLK;
  p.scale_ld = scale_ld;
  p.out_bf16 = 1;
  p.ncol = N / BN;
  p.splits = splits;
  p.tma_w = 1;
  p.tma_x = 1;
  cudaStream_t s = (cudaStream_t)stream;
  const int row_tiles = 1;
  return fp8 ? wg_gemm<MODE_FP8, 1>(p, tn, NB, row_tiles, s)
             : wg_gemm<MODE_BF16, 1>(p, tn, NB, row_tiles, s);
}

}  // extern "C"
