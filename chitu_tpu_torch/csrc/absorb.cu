// MLA absorb projections for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel of chitu_tpu/ops/pallas_absorb.py
// (`absorb_matmul`, body `_absorb_body`, B9). For the stacked wkv_b leaf
// w [L, C, H*S] (S = dn + dv: per head, dn "uk" lanes then dv "uv" lanes):
//
//   uk (q absorb):    out[t,h,c] = sum_d x[t,h,d] * w[l, c, h*S + d]
//   uv (v un-absorb): out[t,h,d] = sum_c x[t,h,c] * w[l, c, h*S + dn + d]
//
// that is one GEMM per head over strided slices of w[layer]:
//   uk: out_h[T, C]  = x_h[T, dn] . W_h[C, dn]^T
//   uv: out_h[T, dv] = x_h[T, C]  . W'_h[C, dv]
// with f32 accumulation and bf16 output. x [T, H, K] and out [T, H, N] are
// read and written through their strides: no head-major transpose and no
// pad of T, which the TPU kernel needed for its block shapes.
//
// What bounds it on this card: at T <= 128 (the model's gate) the bytes of
// the half of w[layer] that a call reads (dn or dv lanes of every head's
// C rows), each read once from device memory: a weight stream. The grid is
// (head, 128-column tile of the output), so every weight byte is read by
// exactly one block, and x (at most 128 rows) comes from L2. A block of 256
// threads walks K in 64-wide tiles; the x tile and the weight tile arrive by
// cp.async through a ring of three stages in shared memory, and the warps
// multiply with nvcuda::wmma (bf16 16x16x16, f32 accumulators): warp w owns
// columns 16w..16w+15 of the tile for all ceil(T/16) row tiles. uk reads
// each weight row's dn lanes as a column-major B operand; uv reads its dv
// lanes as a row-major one. Not done yet: split K for uv at small T (its
// grid is H x dv/128 blocks, 128 for DeepSeek-R1), TMA and wgmma.

#include <cuda_pipeline.h>
#include <mma.h>

#include "gemm_common.cuh"

using namespace nvcuda;

namespace {

constexpr int A_STAGES = 3;
constexpr int BK = 64;          // K per shared-memory tile
constexpr int LDA = BK + 8;     // padded x tile row (bf16)
constexpr int LDB_UV = BN + 8;  // padded [BK, BN] weight tile row (bf16)
constexpr int LDC = BN + 4;     // padded f32 output tile row

template <bool UK>
__host__ __device__ constexpr int b_elems() {
  return UK ? BN * LDA : BK * LDB_UV;
}

template <int MT, bool UK>
__host__ __device__ constexpr int stage_elems() {
  return MT * 16 * LDA + b_elems<UK>();
}

template <int MT, bool UK>
constexpr size_t smem_bytes() {
  const size_t ring = size_t(A_STAGES) * stage_elems<MT, UK>() * 2;
  const size_t outt = size_t(MT) * 16 * LDC * 4;
  return ring > outt ? ring : outt;
}

template <int MT, bool UK>
__global__ void __launch_bounds__(THREADS)
absorb_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w,
              __nv_bfloat16* __restrict__ out, int64_t sxt, int64_t sxh,
              int T, int H, int C, int dn, int dv, int layer) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int h = blockIdx.x, nt = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int S = dn + dv;
  const int64_t HS = int64_t(H) * S;
  const int K = UK ? dn : C;   // contraction
  const int N = UK ? C : dv;   // output columns
  const int nk = K / BK;
  const __nv_bfloat16* wl = w + int64_t(layer) * C * HS + int64_t(h) * S;

  // rows T..16*MT-1 of every stage's x tile stay zero
  for (int st = 0; st < A_STAGES; ++st) {
    __nv_bfloat16* a = ring + st * stage_elems<MT, UK>();
    for (int e = tid; e < (16 * MT - T) * BK; e += THREADS)
      a[(T + e / BK) * LDA + e % BK] = __float2bfloat16(0.f);
  }

  auto load_stage = [&](int st, int kt) {
    __nv_bfloat16* a = ring + st * stage_elems<MT, UK>();
    __nv_bfloat16* b = a + MT * 16 * LDA;
    const int k0 = kt * BK;
    for (int e = tid; e < T * (BK / 8); e += THREADS) {
      const int t = e / (BK / 8), c = e % (BK / 8);
      __pipeline_memcpy_async(a + t * LDA + c * 8,
                              x + t * sxt + h * sxh + k0 + c * 8, 16);
    }
    if (UK) {  // weight rows c = nt*BN + n, lanes k0..k0+63 of head h's dn
      for (int e = tid; e < BN * (BK / 8); e += THREADS) {
        const int n = e / (BK / 8), c = e % (BK / 8);
        __pipeline_memcpy_async(b + n * LDA + c * 8,
                                wl + int64_t(nt * BN + n) * HS + k0 + c * 8,
                                16);
      }
    } else {  // weight rows c = k0 + k, lanes dn + nt*BN .. of head h
      for (int e = tid; e < BK * (BN / 8); e += THREADS) {
        const int k = e / (BN / 8), c = e % (BN / 8);
        __pipeline_memcpy_async(
            b + k * LDB_UV + c * 8,
            wl + int64_t(k0 + k) * HS + dn + nt * BN + c * 8, 16);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int s = 0; s < A_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    __pipeline_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    __pipeline_wait_prior(A_STAGES - 2);  // this thread's copies of tile kt
    __syncthreads();  // everyone's copies landed; stage (kt-1) is consumed
    if (kt + A_STAGES - 1 < nk)
      load_stage((kt + A_STAGES - 1) % A_STAGES, kt + A_STAGES - 1);
    __pipeline_commit();
    const __nv_bfloat16* a = ring + (kt % A_STAGES) * stage_elems<MT, UK>();
    const __nv_bfloat16* b = a + MT * 16 * LDA;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (UK) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(bf, b + (warp * 16) * LDA + kk * 16, LDA);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::load_matrix_sync(af, a + (i * 16) * LDA + kk * 16, LDA);
          wmma::mma_sync(acc[i], af, bf, acc[i]);
        }
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, b + (kk * 16) * LDB_UV + warp * 16,
                               LDB_UV);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::load_matrix_sync(af, a + (i * 16) * LDA + kk * 16, LDA);
          wmma::mma_sync(acc[i], af, bf, acc[i]);
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is free: the output tile reuses it

  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
    wmma::store_matrix_sync(cs + (i * 16) * LDC + warp * 16, acc[i], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < T * (BN / 2); e += THREADS) {
    const int t = e / (BN / 2), c = 2 * (e % (BN / 2));
    *reinterpret_cast<uint32_t*>(out + (int64_t(t) * H + h) * N + nt * BN +
                                 c) =
        pack_bf16x2(cs[t * LDC + c], cs[t * LDC + c + 1]);
  }
}

template <int MT, bool UK>
int launch(const void* x, const void* w, void* out, int64_t sxt,
           int64_t sxh, int T, int H, int C, int dn, int dv, int layer,
           cudaStream_t s) {
  const int bytes = int(smem_bytes<MT, UK>());
  const int rc = allow_smem(absorb_kernel<MT, UK>, bytes);
  if (rc) return rc;
  dim3 grid(H, (UK ? C : dv) / BN);
  absorb_kernel<MT, UK><<<grid, THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      sxt, sxh, T, H, C, dn, dv, layer);
  return int(cudaGetLastError());
}

template <bool UK>
int dispatch(int mt, const void* x, const void* w, void* out, int64_t sxt,
             int64_t sxh, int T, int H, int C, int dn, int dv, int layer,
             cudaStream_t s) {
  switch (mt) {
    case 1: return launch<1, UK>(x, w, out, sxt, sxh, T, H, C, dn, dv, layer, s);
    case 2: return launch<2, UK>(x, w, out, sxt, sxh, T, H, C, dn, dv, layer, s);
    case 3: return launch<3, UK>(x, w, out, sxt, sxh, T, H, C, dn, dv, layer, s);
    case 4: return launch<4, UK>(x, w, out, sxt, sxh, T, H, C, dn, dv, layer, s);
    case 5: return launch<5, UK>(x, w, out, sxt, sxh, T, H, C, dn, dv, layer, s);
    case 6: return launch<6, UK>(x, w, out, sxt, sxh, T, H, C, dn, dv, layer, s);
    case 7: return launch<7, UK>(x, w, out, sxt, sxh, T, H, C, dn, dv, layer, s);
    case 8: return launch<8, UK>(x, w, out, sxt, sxh, T, H, C, dn, dv, layer, s);
  }
  return NOT_SUPPORTED;
}

}  // namespace

// kind 0 = uk, 1 = uv. x [T, H, dn] (uk) or [T, H, C] (uv), element (t, h,
// k) at x + t*sxt + h*sxh + k (a view of a wider row passes its strides);
// w [L, C, H*S] and out [T, H, C] (uk) or [T, H, dv] (uv) contiguous; all
// bf16.
extern "C" int chitu_absorb_matmul(const void* x, const void* w, void* out,
                                   int64_t sxt, int64_t sxh, int kind, int T,
                                   int H, int C, int dn, int dv, int layer,
                                   void* stream) {
  const int K = kind == 0 ? dn : C, N = kind == 0 ? C : dv;
  if (T < 1 || T > 128 || K % BK || N % BN || dn % 8 || dv % 8 ||
      sxt % 8 || sxh % 8 || !aligned16(x) || !aligned16(w) ||
      !aligned16(out))
    return NOT_SUPPORTED;
  const int mt = (T + 15) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kind == 0
             ? dispatch<true>(mt, x, w, out, sxt, sxh, T, H, C, dn, dv,
                              layer, s)
             : dispatch<false>(mt, x, w, out, sxt, sxh, T, H, C, dn, dv,
                               layer, s);
}
