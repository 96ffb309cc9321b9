// Dense stacked-layer GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel B13 of chitu_tpu/ops/pallas_quant_gemm.py
// (`dense_matmul_stacked`, body `_dense_kernel_stacked`):
//   y[T, N] = x[T, K] @ w[layer], w a bf16 stack [L, K, N], f32 sums, f32 out.
// The Python wrapper, its plan and its plain version live in
// chitu_tpu_torch/ops/dense_gemm_kernels.py. K and N are multiples of 128
// (the TPU kernel's own rule; the wrapper sends other shapes to
// torch.matmul, as the JAX function does).
//
// What bounds it on this card: at decode (T <= 64 rows) the layer's weight
// bytes, read once (Llama-3-8B's [14336 -> 4096]: 117 MB, 35 us at 3.35
// TB/s); at a 512-row prefill slab the tensor cores, then the copies of x
// through L2. The kernel is the shared TMA + wgmma mainloop of
// gemm_common.cuh (`wg_gemm_kernel<MODE_BF16, TN, 2>`): bf16 tiles go by
// TMA straight into the swizzled layout wgmma reads. One weight tensor map
// covers the whole stack's [L * K, N] rows and the block reads its layer's
// tiles at row layer * K + k (the layer is a kernel argument, as the TPU
// kernel's scalar-prefetched index), so no per-layer pointer or map is
// made on the host and a launch can be captured in a CUDA graph; the map is
// cached by the stack's pointer, as B8's. Decode rows swap A and B (the
// weight's 64-column strips as wgmma's M, the tokens as its N in tiles of
// 16, 32 or 64) and split K over grid.x from shapes alone (Llama-3-8B's N
// 4096: 4 splits, 128 blocks; the splits are summed in split order by the
// last block of a tile, so launches repeat bit for bit); more rows run
// slab tiles of 128 or 256 rows by 128 columns, the grid over row tiles
// fastest so blocks that share a weight tile run together.

#include "gemm_common.cuh"

extern "C" {

// x [T, K] bf16, w [L, K, N] bf16 (the whole stack), out [T, N] f32; K and
// N multiples of 128, x and w 16-byte aligned (tensor maps describe both).
// The plan (ops/gemm_plan.dense_plan): tn, the rows a tile (16 / 32 / 64
// the swapped decode tiles with `splits` K splits, 128 / 256 the slab
// tiles). ws / counters: the split-K workspace, (N/128) * splits * tn *
// 128 floats and N/128 ints that are zero between launches.
int chitu_dense_gemm(const void* x, const void* w, void* out, int T, int K,
                     int N, int L, int layer, int tn, int splits, void* ws,
                     void* counters, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || K % BN || N % BN || layer < 0 || layer >= L)
    return NOT_SUPPORTED;
  if ((tn >= 128) != (T > 64) || (tn < 128 && tn < T)) return NOT_SUPPORTED;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return NOT_SUPPORTED;
  WgParams p;
  memset(&p, 0, sizeof(p));
  p.x = (const __nv_bfloat16*)x;
  p.w = (const uint8_t*)w;
  p.out = out;
  p.ws = (float*)ws;
  p.counters = (int*)counters;
  p.x_rows = T;
  p.K = K;
  p.N = N;
  p.w_ld = N;
  p.w_rows = L * K;
  p.bm = T;
  p.layer = layer;
  p.scale_mode = SCALE_CHAN;  // bf16 weights: no scale rows to index
  p.ncol = N / BN;
  p.splits = splits;
  p.tma_w = 1;
  p.tma_x = 1;
  const int row_tiles = (T + tn - 1) / tn;
  return wg_gemm<MODE_BF16, 2>(p, tn, 1, row_tiles, (cudaStream_t)stream);
}

}  // extern "C"
