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
// weights, each read once from device memory; at a prefill slab the tensor
// cores. The design follows the dequant GEMM of quant_gemm.cu: a block of
// 256 threads owns a BM x 128 output tile of one dispatch block and walks
// K in tiles; the weight tile, the x tile and (e4m3) the tile's row of
// scales arrive by cp.async through a ring of three stages in shared
// memory. e4m3 tiles are dequantized to bf16 as bf16(float(w) * scale) into
// a second shared tile (the arithmetic of `QTensor.dequantize`, so the
// kernel and its plain version round at the same places); bf16 tiles are
// multiplied straight from the ring. The warps multiply with nvcuda::wmma
// (bf16 16x16x16, f32 accumulators). The grid is (row tiles or K splits,
// dispatch blocks, column tiles): its shape depends on the static worst-case
// block count only, never on the routing, so no launch reads
// `block_expert` on the host and a launch can be captured in a CUDA graph.
// Blocks of one column tile run together, so dispatch blocks of the same
// expert share its column strip in L2. Row tiles: bm = 16 runs 16 x 128
// tiles with K split over grid.x when the live blocks alone would not fill
// the card (deterministic: every split writes its partial tile to its own
// slab, takes a ticket, and the block that draws the last ticket sums the
// slabs in split order; no float atomics); bm = 32 and 64 run one tile a
// dispatch block; bm = 128 and 256 run 128-row tiles, two a block at 256,
// all of one expert. Not done yet: wgmma and TMA for the large tiles, and
// fewer instructions per weight byte at decode.
//
// K and N are multiples of 128 (the wrapper checks), so no edge is ragged
// and every copy is a 16-byte cp.async.

#include <cuda_pipeline.h>
#include <mma.h>

#include "gemm_common.cuh"

using namespace nvcuda;

namespace {

constexpr int M_STAGES = 3;
constexpr int M_TILE = 16 * BN;  // floats of one split-K partial tile
constexpr int QBLK = 128;        // K rows that share one scale row

struct MoeArgs {
  const __nv_bfloat16* x;   // [NB * bm, K]
  const uint8_t* w;         // this layer's [E, K, N] stack, bf16 or e4m3
  const float* scale;       // this layer's [E, K/128, scale_ld], e4m3 only
  const int* block_expert;  // [NB]
  __nv_bfloat16* out;       // [NB * bm, N]
  int NB, bm, K, N, E;
  int scale_ld;       // N / 128 blockwise, N rowwise
  int scale_rowwise;  // one scale a column, else one a 128-column block
  // split-K (bm == 16): partial tiles [dispatch block][column tile][split]
  // [16][128] and one ticket counter per output tile, zero between launches
  float* ws;
  int* counters;
  int splits;
};

// shared-memory layout of one block, in bytes (every part 128-byte aligned)
template <bool FP8, int BM, int BK>
struct MoeSmem {
  static constexpr int LDX = BK + 8;  // bf16 row length of x tiles
  static constexpr int LDB = BN + 8;  // bf16 row length of a bf16 W tile
  static constexpr int WS = FP8 ? BK * BN : BK * LDB * 2;  // W bytes a stage
  static constexpr int XS = BM * LDX * 2;                  // x bytes a stage
  static constexpr int OFF_X = M_STAGES * WS;
  static constexpr int OFF_S = OFF_X + M_STAGES * XS;
  static constexpr int OFF_B = OFF_S + (FP8 ? M_STAGES * BN * 4 : 0);
  static constexpr int OFF_T = OFF_B + (FP8 ? BK * LDB * 2 : 0);
  static constexpr int TOTAL = OFF_T + 128;
  static_assert(WS % 128 == 0 && XS % 128 == 0, "align");
  // the epilogue's scratch (one 16 x 16 f32 fragment a warp) lies over the
  // dequantized tile (e4m3) or the first W stage (bf16)
  static_assert((FP8 ? BK * LDB * 2 : WS) >= (THREADS / 32) * 256 * 4, "scratch");
};

// SPLITK: BM == 16 and grid.x runs over the splits of K. Otherwise grid.x
// runs over the BM-row tiles of one dispatch block.
template <bool FP8, int BM, int BK, int WM, int WN, bool SPLITK>
__global__ void __launch_bounds__(THREADS, 2)
moe_gemm_kernel(MoeArgs a) {
  using L = MoeSmem<FP8, BM, BK>;
  constexpr int FM = BM / WM / 16;
  constexpr int FN = BN / WN / 16;
  constexpr int WCH = FP8 ? BN / 16 : BN / 8;  // 16-byte chunks a W row
  constexpr int WROWS = THREADS / WCH;         // W rows one pass copies
  constexpr int XC = BM * BK / 8;              // x chunks a tile
  static_assert(WM * WN * 32 == THREADS && BK % 32 == 0 && QBLK % BK == 0, "layout");
  static_assert(!SPLITK || (BM == 16 && FM == 1 && FN == 1), "split-K tile");

  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* wst = smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_X);
  float* ss = reinterpret_cast<float*>(smem + L::OFF_S);
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_B);
  float* sC = reinterpret_cast<float*>(smem + (FP8 ? L::OFF_B : 0));  // after the K loop
  int* ticket = reinterpret_cast<int*>(smem + L::OFF_T);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int b = blockIdx.y;
  const int bx = blockIdx.z;
  const int split = SPLITK ? blockIdx.x : 0;
  const int m0 = b * a.bm + (SPLITK ? 0 : blockIdx.x * BM);
  const int n0 = bx * BN;
  const int e = a.block_expert[b];

  if (e < 0 || e >= a.E) {
    // dead block: no weight is read, the tile is zeros
    if (split == 0) {
      for (int i = tid; i < BM * (BN / 8); i += THREADS) {
        __nv_bfloat16* dst = a.out + (size_t)(m0 + i / (BN / 8)) * a.N + n0 + (i % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  const size_t wbytes = FP8 ? 1 : 2;
  const uint8_t* w = a.w + (size_t)e * a.K * a.N * wbytes;
  const float* scale = FP8 ? a.scale + (size_t)e * (a.K / QBLK) * a.scale_ld : nullptr;
  const int wc = tid % WCH;  // 16-byte chunk of a W row
  const int wr = tid / WCH;  // first W row of the tile

  // this block's tiles of K
  const int ntot = a.K / BK;
  const int nsplit = SPLITK ? a.splits : 1;
  const int base = ntot / nsplit, rem = ntot % nsplit;
  const int t_begin = split * base + min(split, rem);
  const int t_cnt = base + (split < rem ? 1 : 0);

  auto fetch = [&](int tile, int st) {
    const int k0 = tile * BK;
#pragma unroll
    for (int p = 0; p < BK / WROWS; ++p) {
      const int row = wr + p * WROWS;
      const uint8_t* src = w + ((size_t)(k0 + row) * a.N + n0) * wbytes + wc * 16;
      uint8_t* dst = wst + st * L::WS + (FP8 ? row * BN : row * L::LDB * 2) + wc * 16;
      __pipeline_memcpy_async(dst, src, 16);
    }
#pragma unroll
    for (int p = 0; p < (XC + THREADS - 1) / THREADS; ++p) {
      const int c = tid + p * THREADS;
      const int m = c / (BK / 8), kc = c % (BK / 8);
      if (c < XC)
        __pipeline_memcpy_async(xs + (st * BM + m) * L::LDX + kc * 8,
                                a.x + (size_t)(m0 + m) * a.K + k0 + kc * 8, 16);
    }
    if (FP8 && tid < BN) {
      const int n = n0 + tid;
      const size_t at = (size_t)(k0 / QBLK) * a.scale_ld + (a.scale_rowwise ? n : n / QBLK);
      __pipeline_memcpy_async(&ss[st * BN + tid], &scale[at], 4);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int i = 0; i < M_STAGES - 1; ++i) {
    if (i < t_cnt) fetch(t_begin + i, i);
    __pipeline_commit();
  }
  for (int i = 0; i < t_cnt; ++i) {
    const int st = i % M_STAGES;
    __pipeline_wait_prior(M_STAGES - 2);  // this thread's copies of tile i
    __syncthreads();                      // ... and everyone else's
    // the stage that tile i - 1 used is free now
    if (i + M_STAGES - 1 < t_cnt)
      fetch(t_begin + i + M_STAGES - 1, (i + M_STAGES - 1) % M_STAGES);
    __pipeline_commit();

    const __nv_bfloat16* bt;  // the bf16 W tile, row length LDB
    if (FP8) {
      float sc[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) sc[q] = ss[st * BN + wc * 16 + q];
#pragma unroll
      for (int p = 0; p < BK / WROWS; ++p) {
        const int row = wr + p * WROWS;
        float f[16];
        decode_e4m3x16(
            *reinterpret_cast<const uint4*>(wst + st * L::WS + row * BN + wc * 16), f);
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          Words4 u;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            u.u[q] = pack_bf16x2(f[g * 8 + 2 * q] * sc[g * 8 + 2 * q],
                                 f[g * 8 + 2 * q + 1] * sc[g * 8 + 2 * q + 1]);
          *reinterpret_cast<uint4*>(&sB[row * L::LDB + wc * 16 + g * 8]) = u.v;
        }
      }
      __syncthreads();
      bt = sB;
    } else {
      bt = reinterpret_cast<const __nv_bfloat16*>(wst + st * L::WS);
    }
    const __nv_bfloat16* xt = xs + st * BM * L::LDX;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
#pragma unroll
      for (int fi = 0; fi < FM; ++fi)
        wmma::load_matrix_sync(af[fi], &xt[((wm * FM + fi) * 16) * L::LDX + kk * 16], L::LDX);
#pragma unroll
      for (int fj = 0; fj < FN; ++fj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &bt[(kk * 16) * L::LDB + (wn * FN + fj) * 16], L::LDB);
#pragma unroll
        for (int fi = 0; fi < FM; ++fi) wmma::mma_sync(acc[fi][fj], af[fi], bf, acc[fi][fj]);
      }
    }
    __syncthreads();  // sB and this stage may be overwritten next
  }

  if (!SPLITK || a.splits == 1) {
    // one 16 x 16 fragment at a time through the warp's scratch
    float* cw = sC + warp * 256;
#pragma unroll
    for (int fi = 0; fi < FM; ++fi) {
#pragma unroll
      for (int fj = 0; fj < FN; ++fj) {
        wmma::store_matrix_sync(cw, acc[fi][fj], 16, wmma::mem_row_major);
        __syncwarp();
        for (int idx = lane; idx < 256; idx += 32) {
          const int m = m0 + (wm * FM + fi) * 16 + (idx >> 4);
          const int n = n0 + (wn * FN + fj) * 16 + (idx & 15);
          a.out[(size_t)m * a.N + n] = __float2bfloat16(cw[idx]);
        }
        __syncwarp();
      }
    }
    return;
  }

  // split-K: the block's 16 x 128 partial tile, warp w's 16 columns at
  // sC[w * 256], goes to this split's slab
  wmma::store_matrix_sync(sC + warp * 256, acc[0][0], 16, wmma::mem_row_major);
  __syncthreads();
  const int tile = b * gridDim.z + bx;
  float* slabs = a.ws + (size_t)tile * a.splits * M_TILE;
  for (int q = tid; q < M_TILE; q += THREADS) {  // q = row * 128 + local column
    const int j = q & (BN - 1);
    slabs[split * M_TILE + q] = sC[(j >> 4) * 256 + (q >> 7) * 16 + (j & 15)];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(&a.counters[tile], 1);
  __syncthreads();
  if (*ticket != a.splits - 1) return;
  // the last block to arrive sums the partial tiles in split order
  __threadfence();
  for (int q = tid; q < M_TILE; q += THREADS) {
    float v = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) v += __ldcg(&slabs[sp * M_TILE + q]);
    a.out[(size_t)(m0 + (q >> 7)) * a.N + n0 + (q & (BN - 1))] = __float2bfloat16(v);
  }
  if (tid == 0) a.counters[tile] = 0;
}

template <bool FP8, int BM, int BK, int WM, int WN, bool SPLITK>
int launch_tile(const MoeArgs& a, int grid_x, cudaStream_t stream) {
  using L = MoeSmem<FP8, BM, BK>;
  auto kernel = moe_gemm_kernel<FP8, BM, BK, WM, WN, SPLITK>;
  static bool ready = false;
  if (!ready) {
    int rc = allow_smem(kernel, L::TOTAL);
    if (rc != 0) return rc;
    ready = true;
  }
  dim3 grid(grid_x, a.NB, a.N / BN);
  kernel<<<grid, THREADS, L::TOTAL, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool FP8>
int launch_moe_gemm(MoeArgs a, cudaStream_t stream) {
  constexpr int BK16 = FP8 ? 128 : 64;  // K tile of the 16-row kernel
  switch (a.bm) {
    case 16:
      if (a.ws == nullptr || a.counters == nullptr || a.splits < 1) a.splits = 1;
      if (a.splits > a.K / BK16) a.splits = a.K / BK16;
      return launch_tile<FP8, 16, BK16, 1, 8, true>(a, a.splits, stream);
    case 32:
      return launch_tile<FP8, 32, 64, 2, 4, false>(a, 1, stream);
    case 64:
      return launch_tile<FP8, 64, 64, 4, 2, false>(a, 1, stream);
    case 128:
    case 256:
      return launch_tile<FP8, 128, 64, 4, 2, false>(a, a.bm / 128, stream);
  }
  return NOT_SUPPORTED;
}

}  // namespace

extern "C" {

// x [NB*bm, K] bf16; w the whole stack [L, E, K, N] (L = 1 when unstacked),
// bf16 (fp8 = 0) or e4m3 bytes (fp8 = 1) with f32 scales [L, E, K/128,
// scale_ld], rowwise (one a column) or blockwise (one a 128-column block);
// block_expert [NB] int32 on the device; out [NB*bm, N] bf16. ws / counters:
// the split-K workspace of the bm == 16 kernel, NB * (N/128) * splits * 2048
// floats and NB * (N/128) ints that are zero between launches.
int chitu_moe_gemm(const void* x, const void* w, const void* scale,
                   const void* block_expert, void* out, int NB, int bm, int K,
                   int N, int E, int layer, int fp8, int scale_ld,
                   int scale_rowwise, void* ws, void* counters, int splits,
                   void* stream) {
  if (NB <= 0 || K <= 0 || N <= 0 || E <= 0 || layer < 0) return NOT_SUPPORTED;
  if (K % QBLK || N % BN) return NOT_SUPPORTED;
  if (fp8 && scale == nullptr) return NOT_SUPPORTED;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out)) return NOT_SUPPORTED;
  MoeArgs a;
  a.x = (const __nv_bfloat16*)x;
  a.w = (const uint8_t*)w + (size_t)layer * E * K * N * (fp8 ? 1 : 2);
  a.scale = fp8 ? (const float*)scale + (size_t)layer * E * (K / QBLK) * scale_ld
                : nullptr;
  a.block_expert = (const int*)block_expert;
  a.out = (__nv_bfloat16*)out;
  a.NB = NB;
  a.bm = bm;
  a.K = K;
  a.N = N;
  a.E = E;
  a.scale_ld = scale_ld;
  a.scale_rowwise = scale_rowwise;
  a.ws = (float*)ws;
  a.counters = (int*)counters;
  a.splits = splits;
  cudaStream_t s = (cudaStream_t)stream;
  return fp8 ? launch_moe_gemm<true>(a, s) : launch_moe_gemm<false>(a, s);
}

}  // extern "C"
