// Quantized GEMMs for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of chitu_tpu/ops/pallas_quant_gemm.py:
//   quant_gemm_pipe_kernel
//                      <- _gemm_kernel (B6 `_quant_gemm_stacked` and
//                         B7 `_quant_gemm`): y = x @ dequant(W), one kernel
//                         family, since a layer of a stacked weight is a view
//   int8_gemm_kernel   <- _w8a8_kernel (B10): int8 x int8 -> int32, then the
//                         per-token and per-channel scales
//
// What bounds them on this card: at decode (T <= 16 rows) the weight bytes,
// read once from device memory; at a 512-row prefill slab the tensor cores.
// The design: a block of 256 threads owns a BM x 128 output tile and walks
// K in tiles. The packed weight tile, the x tile and the tile's rows of
// scales and zeros arrive by cp.async through a ring of three stages in
// shared memory (two tiles in flight per block, two blocks per SM, nothing
// waits in registers). A thread then takes 16-byte (int4 packed: 8-byte)
// chunks of the raw tile, dequantizes them to bf16 as (w - zero) * scale
// into a second shared tile, and the warps multiply with nvcuda::wmma
// (bf16 16x16x16, f32 accumulators; int8 16x16x16 with int32 accumulators
// for B10, which still loads through registers). Scales and zeros are read
// in place in their stored layout (blockwise [K/B, N/B], rowwise [K/B, N],
// per-channel [N]). Two tile shapes: 16 x 128 x 128 for T <= 16 and
// 128 x 128 x 64 above, where the grid runs over M tiles fastest, so the
// blocks that share a weight tile run together and share it in L2. At
// T <= 16, K is split over grid.x so that narrow outputs (N 4096 is 32
// column tiles for 132 SMs) still fill the card. Split-K is deterministic:
// every split writes its partial tile to its own slab of a workspace,
// takes a ticket, and the block that draws the last ticket sums the slabs
// in split order, adds the bias and writes the output. Quant blocks of B
// rows must tile with the K tile: B a multiple of it, or a divisor with at
// most four blocks a tile (32, 64, 128, 256, ... rows). Not done yet: TMA
// staging and wgmma for the large tiles, and fewer instructions per weight
// byte at decode (the 16-row kernel is bound by instruction slots and latencies,
// not by bytes: scripts/torch_quant_gemm_variants.py, PERF.md).
//
// Ragged edges: K and N need not be multiples of anything. Rows k >= K
// contribute zeros, columns n >= N are never written, and 16-byte loads
// are used only where the row stride and base address allow them.
//
// Packed int4 keeps the layout of `pack_int4_storage`: within each
// 512-column tile, byte column c holds logical column c in its low nibble
// and column c + 256 in its high nibble. A block reads 64 byte columns and
// produces the two 64-column output ranges they hold, so each byte is read
// once.

#include <cuda_pipeline.h>
#include <mma.h>

#include "gemm_common.cuh"

using namespace nvcuda;

namespace {

enum { MODE_FP8 = 0, MODE_INT8 = 1, MODE_INT4 = 2, MODE_INT4P = 3 };
enum { SCALE_BLOCK = 0, SCALE_ROW = 1, SCALE_CHAN = 2 };

struct GemmArgs {
  const __nv_bfloat16* x;  // [T, K]
  const uint8_t* w;        // [K, w_ld] bytes
  const float* scale;
  const float* zeros;
  const __nv_bfloat16* bias;  // [N] or null
  void* out;                  // [T, N] f32 or bf16
  int T, K, N;
  int scale_mode, block, scale_ld, out_bf16;
  int w_ld;   // bytes in one weight row: N, or N / 2 packed
  int vec_w;  // 16-byte (8-byte packed) weight loads are aligned
  int vec_x;  // 16-byte x loads are aligned
  // split-K (the T <= 16 kernel): partial tiles [column tile][split][16][128]
  // and one ticket counter per column tile, zero between launches
  float* ws;
  int* counters;
  int splits;
};

// logical output column of local column j of block column bx
template <int MODE>
__device__ __forceinline__ int logical_col(int bx, int j) {
  if (MODE == MODE_INT4P) {
    int c = bx * (BN / 2) + (j & (BN / 2 - 1));  // byte column
    return ((c >> 8) << 9) + (c & 255) + ((j >= BN / 2) ? 256 : 0);
  }
  return bx * BN + j;
}

// local column of element e (0..15) of the thread with column chunk cc
template <int MODE>
__device__ __forceinline__ int local_col(int cc, int e) {
  if (MODE == MODE_INT4P) return ((e >> 3) * (BN / 2)) + cc * 8 + (e & 7);
  return cc * 16 + e;
}

// where the scale of quant block row kb and column n is stored
__device__ __forceinline__ size_t scale_index(const GemmArgs& a, int kb, int n) {
  if (a.scale_mode == SCALE_CHAN) return (size_t)n;
  if (a.scale_mode == SCALE_ROW) return (size_t)kb * a.scale_ld + n;
  return (size_t)kb * a.scale_ld + n / a.block;
}

// 16 stored values -> (w - zero) * scale
template <int MODE>
__device__ __forceinline__ void apply_scales(float* f, const float* s,
                                             const float* z) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    float v = f[e];
    if (MODE >= MODE_INT4) v -= z[e];
    f[e] = v * s[e];
  }
}

// 16 floats -> bf16, as two 16-byte stores at the thread's two column groups
template <int MODE>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* row, int cc,
                                           const float* f) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    Words4 u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u.u[i] = pack_bf16x2(f[g * 8 + 2 * i], f[g * 8 + 2 * i + 1]);
    *reinterpret_cast<uint4*>(&row[local_col<MODE>(cc, g * 8)]) = u.v;
  }
}

// stored values of one chunk -> 16 floats (before zero and scale)
template <int MODE>
__device__ __forceinline__ void decode_chunk(uint4 raw, float* f) {
  if (MODE == MODE_FP8) {
    decode_e4m3x16(raw, f);
    return;
  }
  Bytes16 u;
  u.v = raw;
  if (MODE == MODE_INT4P) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = (float)(u.b[i] & 0xF);
      f[8 + i] = (float)(u.b[i] >> 4);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = (float)(int8_t)u.b[i];
  }
}

// ---------------------------------------------------------------------------
// The pipelined kernel: cp.async ring, and deterministic split-K at T <= 16
// ---------------------------------------------------------------------------

constexpr int P_STAGES = 3;
constexpr int P_TILE = 16 * BN;  // floats of one partial tile (T <= 16)
constexpr int P_GROUPS = 4;      // most quant-block rows one K tile may span

// shared-memory layout of one block, in bytes (every part 128-byte aligned)
template <int BM, int BK>
struct PipeSmem {
  static constexpr int LDX = BK + 8;               // bf16 row length of x tiles
  static constexpr int LDB = BN + 8;               // bf16 row length of the W tile
  static constexpr int RAW = BK * BN;              // raw weight bytes of a stage
  static constexpr int XS = BM * LDX * 2;          // x bytes of a stage
  static constexpr int OFF_X = P_STAGES * RAW;
  static constexpr int OFF_S = OFF_X + P_STAGES * XS;
  static constexpr int OFF_Z = OFF_S + P_STAGES * P_GROUPS * BN * 4;
  static constexpr int OFF_B = OFF_Z + P_STAGES * P_GROUPS * BN * 4;
  static constexpr int OFF_T = OFF_B + BK * LDB * 2;
  static constexpr int TOTAL = OFF_T + 128;
  static_assert(RAW % 128 == 0 && XS % 128 == 0 && (BK * LDB * 2) % 128 == 0, "align");
  static_assert(BK * LDB * 2 >= (THREADS / 32) * 256 * 4, "epilogue scratch");
};

// SPLITK: BM == 16, grid.x runs over the splits of K (the output has at
// most 16 rows). Otherwise grid.x runs over the M tiles.
template <int MODE, int BM, int BK, int WM, int WN, bool SPLITK>
__global__ void __launch_bounds__(THREADS, 2)
quant_gemm_pipe_kernel(GemmArgs a) {
  using L = PipeSmem<BM, BK>;
  constexpr int FM = BM / WM / 16;
  constexpr int FN = BN / WN / 16;
  constexpr int CB = (MODE == MODE_INT4P) ? 8 : 16;         // bytes of a chunk
  constexpr int ROWB = (MODE == MODE_INT4P) ? BN / 2 : BN;  // raw row bytes
  constexpr int XC = BM * BK / 8;                           // x chunks a tile
  static_assert(WM * WN * 32 == THREADS && BK % 32 == 0, "layout");
  static_assert(!SPLITK || (BM == 16 && FM == 1 && FN == 1), "split-K tile");

  extern __shared__ __align__(128) unsigned char smem[];
  uint8_t* raw = smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_X);
  float* ss = reinterpret_cast<float*>(smem + L::OFF_S);
  float* sz = reinterpret_cast<float*>(smem + L::OFF_Z);
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_B);
  float* sC = reinterpret_cast<float*>(smem + L::OFF_B);  // after the K loop
  int* ticket = reinterpret_cast<int*>(smem + L::OFF_T);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int bx = blockIdx.y;
  const int split = SPLITK ? blockIdx.x : 0;
  const int m0 = SPLITK ? 0 : blockIdx.x * BM;
  const int cc = tid & 7;   // column chunk of the weight tile
  const int r0 = tid >> 3;  // first weight row of the tile
  const int wcol = bx * ROWB + cc * CB;
  // quant-block rows a K tile spans: 1 when the block size is a multiple
  // of BK, else BK / block (the launcher admits nothing else)
  const int groups = a.block >= BK ? 1 : BK / a.block;

  // this block's tiles of K
  const int ntot = (a.K + BK - 1) / BK;
  const int nsplit = SPLITK ? a.splits : 1;
  const int base = ntot / nsplit, rem = ntot % nsplit;
  const int t_begin = split * base + min(split, rem);
  const int t_cnt = base + (split < rem ? 1 : 0);

  // rows t >= T of x stay zero: nothing is ever copied there
  for (int i = tid; i < P_STAGES * BM * L::LDX; i += THREADS)
    xs[i] = __float2bfloat16(0.f);
  __syncthreads();

  auto fetch = [&](int tile, int st) {
    const int k0 = tile * BK;
#pragma unroll
    for (int p = 0; p < BK / 32; ++p) {
      const int row = r0 + p * 32;
      const int k = k0 + row;
      uint8_t* dst = raw + st * L::RAW + row * ROWB + cc * CB;
      if (k < a.K && a.vec_w && wcol + CB <= a.w_ld) {
        __pipeline_memcpy_async(dst, a.w + (size_t)k * a.w_ld + wcol, CB);
      } else {
#pragma unroll
        for (int i = 0; i < CB; ++i)
          dst[i] = (k < a.K && wcol + i < a.w_ld)
                       ? a.w[(size_t)k * a.w_ld + wcol + i] : (uint8_t)0;
      }
    }
#pragma unroll
    for (int p = 0; p < (XC + THREADS - 1) / THREADS; ++p) {
      const int c = tid + p * THREADS;
      const int m = c / (BK / 8), kc = c % (BK / 8);
      const int t = m0 + m, k = k0 + kc * 8;
      if (c < XC && t < a.T) {
        __nv_bfloat16* dst = xs + (st * BM + m) * L::LDX + kc * 8;
        const __nv_bfloat16* src = a.x + (size_t)t * a.K + k;
        if (a.vec_x && k + 8 <= a.K) {
          __pipeline_memcpy_async(dst, src, 16);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dst[i] = (k + i < a.K) ? src[i] : __float2bfloat16(0.f);
        }
      }
    }
    if (tid < BN) {
      const int n = logical_col<MODE>(bx, tid);
      for (int g = 0; g < groups; ++g) {
        const int k = k0 + g * a.block;  // first row of the tile's g-th block
        const int at = (st * P_GROUPS + g) * BN + tid;
        if (n < a.N && k < a.K) {
          const int kb = k / a.block;
          __pipeline_memcpy_async(&ss[at], &a.scale[scale_index(a, kb, n)], 4);
          if (MODE >= MODE_INT4)
            __pipeline_memcpy_async(&sz[at], &a.zeros[(size_t)kb * a.scale_ld + n], 4);
        } else {
          ss[at] = 0.f;
          if (MODE >= MODE_INT4) sz[at] = 0.f;
        }
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int i = 0; i < P_STAGES - 1; ++i) {
    if (i < t_cnt) fetch(t_begin + i, i);
    __pipeline_commit();
  }
  for (int i = 0; i < t_cnt; ++i) {
    const int st = i % P_STAGES;
    __pipeline_wait_prior(P_STAGES - 2);  // this thread's copies of tile i
    __syncthreads();                      // ... and everyone else's
    // the stage that tile i - 1 used is free now
    if (i + P_STAGES - 1 < t_cnt)
      fetch(t_begin + i + P_STAGES - 1, (i + P_STAGES - 1) % P_STAGES);
    __pipeline_commit();

    float sc[16], zr[16];
#pragma unroll
    for (int p = 0; p < BK / 32; ++p) {
      const int row = r0 + p * 32;
      if (p == 0 || groups > 1) {  // this row's scales and zeros
        const int at = (st * P_GROUPS + (groups > 1 ? row / a.block : 0)) * BN;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          sc[e] = ss[at + local_col<MODE>(cc, e)];
          if (MODE >= MODE_INT4) zr[e] = sz[at + local_col<MODE>(cc, e)];
        }
      }
      const uint8_t* src = raw + st * L::RAW + row * ROWB + cc * CB;
      uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
      if (CB == 16) {
        chunk = *reinterpret_cast<const uint4*>(src);
      } else {
        uint2 t2 = *reinterpret_cast<const uint2*>(src);
        chunk.x = t2.x;
        chunk.y = t2.y;
      }
      float f[16];
      decode_chunk<MODE>(chunk, f);
      apply_scales<MODE>(f, sc, zr);
      store_bf16<MODE>(&sB[row * L::LDB], cc, f);
    }
    __syncthreads();
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
        wmma::load_matrix_sync(bf, &sB[(kk * 16) * L::LDB + (wn * FN + fj) * 16], L::LDB);
#pragma unroll
        for (int fi = 0; fi < FM; ++fi) wmma::mma_sync(acc[fi][fj], af[fi], bf, acc[fi][fj]);
      }
    }
    __syncthreads();  // sB and this x stage may be overwritten next
  }

  auto write_out = [&](int t, int j, float v) {  // j: local column
    const int n = logical_col<MODE>(bx, j);
    if (t < a.T && n < a.N) {
      if (a.bias) v += __bfloat162float(a.bias[n]);
      const size_t o = (size_t)t * a.N + n;
      if (a.out_bf16)
        reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(v);
      else
        reinterpret_cast<float*>(a.out)[o] = v;
    }
  };

  if (!SPLITK || a.splits == 1) {
    // one 16 x 16 fragment at a time through the warp's scratch
    float* cw = sC + warp * 256;
#pragma unroll
    for (int fi = 0; fi < FM; ++fi) {
#pragma unroll
      for (int fj = 0; fj < FN; ++fj) {
        wmma::store_matrix_sync(cw, acc[fi][fj], 16, wmma::mem_row_major);
        __syncwarp();
        for (int idx = lane; idx < 256; idx += 32)
          write_out(m0 + (wm * FM + fi) * 16 + (idx >> 4),
                    (wn * FN + fj) * 16 + (idx & 15), cw[idx]);
        __syncwarp();
      }
    }
    return;
  }

  // split-K: the block's 16 x 128 partial tile, warp w's 16 columns at
  // sC[w * 256], goes to this split's slab
  wmma::store_matrix_sync(sC + warp * 256, acc[0][0], 16, wmma::mem_row_major);
  __syncthreads();
  float* slabs = a.ws + (size_t)bx * a.splits * P_TILE;
  for (int e = tid; e < P_TILE; e += THREADS) {  // e = t * 128 + local column
    const int j = e & (BN - 1);
    slabs[split * P_TILE + e] = sC[(j >> 4) * 256 + (e >> 7) * 16 + (j & 15)];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(&a.counters[bx], 1);
  __syncthreads();
  if (*ticket != a.splits - 1) return;
  // the last block to arrive sums the partial tiles in split order
  __threadfence();
  for (int e = tid; e < P_TILE; e += THREADS) {
    float v = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) v += __ldcg(&slabs[sp * P_TILE + e]);
    write_out(e >> 7, e & (BN - 1), v);
  }
  if (tid == 0) a.counters[bx] = 0;
}

constexpr int WS_TILES = 512;  // partial tiles the split-K workspace holds

// quant blocks of `block` rows tile with K tiles of bk rows
inline bool blocks_tile(int block, int bk) {
  return block % bk == 0 || (bk % block == 0 && bk / block <= P_GROUPS);
}

template <int MODE>
int launch_quant_gemm(GemmArgs a, cudaStream_t stream) {
  int nb = (MODE == MODE_INT4P) ? a.N / BN : (a.N + BN - 1) / BN;
  if (!blocks_tile(a.block, a.T <= 16 ? 128 : 64)) return NOT_SUPPORTED;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int rc = allow_smem(quant_gemm_pipe_kernel<MODE, 16, 128, 1, 8, true>,
                        PipeSmem<16, 128>::TOTAL);
    if (rc == 0)
      rc = allow_smem(quant_gemm_pipe_kernel<MODE, 128, 64, 4, 2, false>,
                      PipeSmem<128, 64>::TOTAL);
    if (rc != 0) {
      sms = 0;
      return rc;
    }
  }
  if (a.T <= 16) {
    // two blocks fit an SM: split K until the grid fills them, keeping at
    // least two tiles a split
    const int ntot = (a.K + 127) / 128;
    int splits = 1;
    if (a.ws != nullptr && a.counters != nullptr && nb < 2 * sms) {
      splits = min(min((2 * sms) / nb, ntot / 2), 32);
      while (splits > 1 && splits * nb > WS_TILES) --splits;
      if (splits < 1) splits = 1;
    }
    a.splits = splits;
    dim3 grid(splits, nb);
    quant_gemm_pipe_kernel<MODE, 16, 128, 1, 8, true>
        <<<grid, THREADS, PipeSmem<16, 128>::TOTAL, stream>>>(a);
  } else {
    dim3 grid((a.T + 127) / 128, nb);
    quant_gemm_pipe_kernel<MODE, 128, 64, 4, 2, false>
        <<<grid, THREADS, PipeSmem<128, 64>::TOTAL, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

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
// ws / counters: the split-K workspace of the T <= 16 kernel, 512 * 2048
// floats and 512 ints that are zero between launches (null: no split-K).
int chitu_quant_gemm(const void* x, const void* w, const void* scale,
                     const void* zeros, const void* bias, void* out, int T,
                     int K, int N, int mode, int scale_mode, int block,
                     int scale_ld, int out_bf16, void* ws, void* counters,
                     void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || block <= 0) return NOT_SUPPORTED;
  if (mode == MODE_INT4P && N % 512) return NOT_SUPPORTED;
  if (mode >= MODE_INT4 && zeros == nullptr) return NOT_SUPPORTED;
  GemmArgs a;
  a.x = (const __nv_bfloat16*)x;
  a.w = (const uint8_t*)w;
  a.scale = (const float*)scale;
  a.zeros = (const float*)zeros;
  a.bias = (const __nv_bfloat16*)bias;
  a.out = out;
  a.T = T;
  a.K = K;
  a.N = N;
  a.scale_mode = scale_mode;
  a.block = block;
  a.scale_ld = scale_ld;
  a.out_bf16 = out_bf16;
  a.w_ld = (mode == MODE_INT4P) ? N / 2 : N;
  a.vec_w = aligned16(w) && (a.w_ld % 16 == 0);
  a.vec_x = aligned16(x) && (K % 8 == 0);
  a.ws = (float*)ws;
  a.counters = (int*)counters;
  a.splits = 1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_FP8: return launch_quant_gemm<MODE_FP8>(a, s);
    case MODE_INT8: return launch_quant_gemm<MODE_INT8>(a, s);
    case MODE_INT4: return launch_quant_gemm<MODE_INT4>(a, s);
    case MODE_INT4P: return launch_quant_gemm<MODE_INT4P>(a, s);
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
