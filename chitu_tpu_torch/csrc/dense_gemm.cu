// Dense stacked-layer GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel B13 of chitu_tpu/ops/pallas_quant_gemm.py:
//   dense_gemm_kernel <- _dense_kernel_stacked (`dense_matmul_stacked`):
//                        y = x @ w[layer], bf16 in, f32 sums, f32 out
// The Python wrapper and its plain version live in
// chitu_tpu_torch/ops/dense_gemm_kernels.py.
//
// The weight is the whole stack [L, K, N]; the kernel reads `layer` and
// offsets into the stack itself, as the TPU kernel's index map reads its
// scalar-prefetched layer, so no layer slice is ever formed on the host.
// K and N are multiples of 128 (the TPU kernel's own rule; the wrapper
// sends other shapes to torch.matmul, as the JAX function does).
//
// What bounds it on this card: at decode (T <= 16 rows) the weight bytes,
// read once; at a 512-row prefill slab the tensor cores. The design is the
// one of the dequant GEMM (quant_gemm.cu) without the dequant: a block of
// 256 threads owns a BM x 128 output tile and walks K in tiles that arrive
// by cp.async through a ring of three shared-memory stages (x and the
// weight tile straight into the layout the tensor cores read), and the
// warps multiply with nvcuda::wmma (bf16 16x16x16, f32 accumulators). Two
// tile shapes: 16 x 128 x 128 for T <= 16 and 128 x 128 x 64 above, where
// the grid runs over M tiles fastest, so blocks that share a weight tile
// run together. Not done yet: split K at decode (N 4096 is 32 column
// tiles for 132 SMs), TMA and wgmma.

#include <cuda_pipeline.h>
#include <mma.h>

#include "gemm_common.cuh"

using namespace nvcuda;

namespace {

constexpr int D_STAGES = 3;

template <int BM, int BK>
struct DenseSmem {
  static constexpr int LDX = BK + 8;  // bf16 row length of an x tile
  static constexpr int LDB = BN + 8;  // bf16 row length of a weight tile
  static constexpr int XS = BM * LDX * 2;
  static constexpr int WS = BK * LDB * 2;
  static constexpr int OFF_W = D_STAGES * XS;
  static constexpr int TOTAL = OFF_W + D_STAGES * WS;
  static_assert(XS % 128 == 0 && WS % 128 == 0, "align");
  static_assert(TOTAL >= (THREADS / 32) * 256 * 4, "epilogue scratch");
};

template <int BM, int BK, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
dense_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  float* __restrict__ out, int T, int K, int N, int layer) {
  using L = DenseSmem<BM, BK>;
  constexpr int FM = BM / WM / 16;
  constexpr int FN = BN / WN / 16;
  constexpr int WC = BK * (BN / 8);  // 16-byte weight chunks a tile
  constexpr int XC = BM * (BK / 8);  // 16-byte x chunks a tile
  static_assert(WM * WN * 32 == THREADS && WC % THREADS == 0, "layout");

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_W);
  float* sC = reinterpret_cast<float*>(smem);  // after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // the layer's [K, N] matrix of the stack, read on the device
  const __nv_bfloat16* wl = w + (size_t)layer * K * N;
  const int ntiles = K / BK;

  // rows t >= T of x stay zero: nothing is ever copied there
  for (int i = tid; i < D_STAGES * BM * L::LDX; i += THREADS)
    xs[i] = __float2bfloat16(0.f);
  __syncthreads();

  auto fetch = [&](int tile, int st) {
    const int k0 = tile * BK;
#pragma unroll
    for (int p = 0; p < WC / THREADS; ++p) {
      const int c = tid + p * THREADS;
      const int row = c / (BN / 8), cc = c % (BN / 8);
      __pipeline_memcpy_async(
          ws + (st * BK + row) * L::LDB + cc * 8,
          wl + (size_t)(k0 + row) * N + n0 + cc * 8, 16);
    }
#pragma unroll
    for (int p = 0; p < (XC + THREADS - 1) / THREADS; ++p) {
      const int c = tid + p * THREADS;
      const int m = c / (BK / 8), kc = c % (BK / 8);
      if (c < XC && m0 + m < T)
        __pipeline_memcpy_async(xs + (st * BM + m) * L::LDX + kc * 8,
                                x + (size_t)(m0 + m) * K + k0 + kc * 8, 16);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int i = 0; i < D_STAGES - 1; ++i) {
    if (i < ntiles) fetch(i, i);
    __pipeline_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % D_STAGES;
    __pipeline_wait_prior(D_STAGES - 2);  // this thread's copies of tile i
    __syncthreads();                      // ... and everyone else's
    // the stage that tile i - 1 used is free now
    if (i + D_STAGES - 1 < ntiles)
      fetch(i + D_STAGES - 1, (i + D_STAGES - 1) % D_STAGES);
    __pipeline_commit();
    const __nv_bfloat16* xt = xs + st * BM * L::LDX;
    const __nv_bfloat16* wt = ws + st * BK * L::LDB;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
#pragma unroll
      for (int fi = 0; fi < FM; ++fi)
        wmma::load_matrix_sync(af[fi], &xt[((wm * FM + fi) * 16) * L::LDX + kk * 16], L::LDX);
#pragma unroll
      for (int fj = 0; fj < FN; ++fj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &wt[(kk * 16) * L::LDB + (wn * FN + fj) * 16], L::LDB);
#pragma unroll
        for (int fi = 0; fi < FM; ++fi) wmma::mma_sync(acc[fi][fj], af[fi], bf, acc[fi][fj]);
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // every stage consumed: the scratch may reuse them

  // one 16 x 16 fragment at a time through the warp's scratch
  float* cw = sC + warp * 256;
#pragma unroll
  for (int fi = 0; fi < FM; ++fi) {
#pragma unroll
    for (int fj = 0; fj < FN; ++fj) {
      wmma::store_matrix_sync(cw, acc[fi][fj], 16, wmma::mem_row_major);
      __syncwarp();
      for (int idx = lane; idx < 256; idx += 32) {
        const int t = m0 + (wm * FM + fi) * 16 + (idx >> 4);
        const int n = n0 + (wn * FN + fj) * 16 + (idx & 15);
        if (t < T) out[(size_t)t * N + n] = cw[idx];
      }
      __syncwarp();
    }
  }
}

template <int BM, int BK, int WM, int WN>
int launch_dense(const void* x, const void* w, void* out, int T, int K, int N,
                 int layer, cudaStream_t stream) {
  using L = DenseSmem<BM, BK>;
  static bool attr_set = false;
  if (!attr_set) {
    const int rc = allow_smem(dense_gemm_kernel<BM, BK, WM, WN>, L::TOTAL);
    if (rc != 0) return rc;
    attr_set = true;
  }
  dim3 grid((T + BM - 1) / BM, N / BN);
  dense_gemm_kernel<BM, BK, WM, WN><<<grid, THREADS, L::TOTAL, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (float*)out, T, K, N,
      layer);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [T, K] bf16, w [L, K, N] bf16 (the whole stack), out [T, N] f32;
// K and N multiples of 128, all three 16-byte aligned.
int chitu_dense_gemm(const void* x, const void* w, void* out, int T, int K,
                     int N, int layer, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || K % 128 || N % 128 || layer < 0)
    return NOT_SUPPORTED;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out)) return NOT_SUPPORTED;
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= 16) return launch_dense<16, 128, 1, 8>(x, w, out, T, K, N, layer, s);
  return launch_dense<128, 64, 4, 2>(x, w, out, T, K, N, layer, s);
}

}  // extern "C"
