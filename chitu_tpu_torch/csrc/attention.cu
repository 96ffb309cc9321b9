// Paged-KV attention kernels for Hopper (sm_90a), plain C interface.
//
// Five entry points, each the counterpart of one Pallas TPU kernel of
// chitu_tpu/ops/pallas_attention.py (their Python wrappers and plain
// PyTorch versions live in chitu_tpu_torch/ops/attention_kernels.py):
//
//   B1 decode_kernel (fused)  <- attend_decode_fused (_decode_fused_kernel)
//   B2 append_packed_kernel + prefill_attend_kernel (packed mode)
//                             <- attend_prefill_packed_fused
//                                (_prefill_packed_fused_kernel)
//   B3 prefill_attend_kernel (packed mode) alone
//                             <- attend_prefill_packed (_prefill_packed_kernel)
//   B4 decode_kernel (not fused) <- attend_decode (_decode_kernel)
//   B5 prefill_attend_kernel (single-sequence mode)
//                             <- attend_prefill (_prefill_grouped_kernel)
//
// and, for B1, B3, B4 and B5 on the MLA merged latent row, latent_kernel
// (below). Two pool layouts, as in the JAX package, [L, P, page, M]: split
// K/V rows [K_0..K_{KV-1} V_0..V_{KV-1} | pad], M = pad128(2*KV*D), at head
// sizes 32, 64, 128 and 192 (192: DeepSeek's dense MLA, K = [k_nope | k_pe]
// and V padded from 128 to 192 lanes in the row; the kernels read V at the
// K head size and the caller keeps the live lanes); and the merged latent
// row [c_kv (512) | k_pe (64) | pad] of DeepSeek's MLA absorb, M = 640, one
// KV "head" that every query head reads, whose first 512 lanes are also the
// value. Offsets into the pool are 64-bit: a full-size pool holds more than
// 2^31 elements.
//
// Two pool element types (infer.kv_dtype): bf16, and int8 lanes holding
// fp8-e4m3 bits. An e4m3 pool is read 8 bytes (8 values) at a time and
// converted to bf16 with the card's native e4m3 convert before it reaches
// shared memory (e4m3 values are exact in bf16), so everything after the
// load is the bf16 kernel. The appends (B1's in-kernel append, B2's append
// launch, the latent B1's) write e4m3 bytes equal to the JAX package's
// encode: round to nearest even, NaN (sign | 0x7F) for NaN, infinities and
// magnitudes above 464, never a saturated 448. The fused decode attends its
// new token at the value its e4m3 bytes hold, as the TPU kernel does.
//
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;
typedef uint8_t e4m3;  // a pool lane holding fp8-e4m3 bits

namespace {

constexpr int BK = 64;  // keys per shared-memory tile

// ---------------------------------------------------------------------------
// Pool element access, 8 values at a time: Raw is what 8 pool lanes occupy
// (16 bytes of bf16, 8 bytes of e4m3); the kernels load Raw, convert it to
// 8 bf16 (a uint4) with to_bf16, and store 8 bf16 as Raw with from_bf16.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t pair) {
  const __half2_raw hr =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)pair, __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&hr));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);  // exact
  return *reinterpret_cast<const uint32_t*>(&b);
}

// the JAX package's encode of one value: NaN codes beyond 464
__device__ __forceinline__ uint32_t e4m3_byte(float f) {
  if (!(fabsf(f) <= 464.f)) return (__float_as_uint(f) >> 31) ? 0xFFu : 0x7Fu;
  return (uint32_t)__nv_cvt_float_to_fp8(f, __NV_SATFINITE, __NV_E4M3);
}

template <typename PT>
struct PoolIO;

template <>
struct PoolIO<bf16> {
  typedef uint4 Raw;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void store(bf16* p, Raw r) {
    *reinterpret_cast<uint4*>(p) = r;
  }
  static __device__ __forceinline__ uint4 to_bf16(Raw r) { return r; }
  static __device__ __forceinline__ Raw from_bf16(uint4 v) { return v; }
  static __device__ __forceinline__ Raw zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
};

template <>
struct PoolIO<e4m3> {
  typedef uint2 Raw;
  static __device__ __forceinline__ Raw load(const e4m3* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ void store(e4m3* p, Raw r) {
    *reinterpret_cast<uint2*>(p) = r;
  }
  static __device__ __forceinline__ uint4 to_bf16(Raw r) {
    return make_uint4(e4m3x2_to_bf16x2(r.x & 0xFFFFu), e4m3x2_to_bf16x2(r.x >> 16),
                      e4m3x2_to_bf16x2(r.y & 0xFFFFu), e4m3x2_to_bf16x2(r.y >> 16));
  }
  static __device__ __forceinline__ Raw from_bf16(uint4 v) {
    const bf16* h = reinterpret_cast<const bf16*>(&v);
    uint32_t w[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      w[j] = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[j] |= e4m3_byte(__bfloat162float(h[4 * j + i])) << (8 * i);
    }
    return make_uint2(w[0], w[1]);
  }
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
};

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float capped(float s, float softcap) {
  return softcap > 0.f ? tanhf(s / softcap) * softcap : s;
}

__device__ __forceinline__ int64_t row_offset(int layer, int P, int page,
                                              int M, int pid, int off) {
  return ((int64_t(layer) * P + pid) * page + off) * int64_t(M);
}

// Online-softmax update of one row for a tile of 64 scores held two per
// lane (keys lane and lane+32; -INFINITY = masked). Returns the rescale
// factor for the accumulator and leaves the tile's probabilities in p0/p1.
__device__ __forceinline__ float online_update(float& m, float& l, float s0,
                                               float s1, float& p0,
                                               float& p1) {
  const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
  float alpha = 1.f;
  p0 = 0.f;
  p1 = 0.f;
  if (m_new != -INFINITY) {
    alpha = expf(m - m_new);  // m == -inf -> 0
    p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
    p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
  }
  l = l * alpha + warp_sum(p0 + p1);
  m = m_new;
  return alpha;
}

// ---------------------------------------------------------------------------
// Shared-memory staging of one 64-key tile: every thread issues all of its
// loads (16 bytes of bf16 or 8 of e4m3 each) before it converts and stores
// any, so a block keeps the whole tile of K and V in flight. K rows are
// padded by one bf16 pair (KS = D + 2) so that lanes reading the same
// column of consecutive rows hit distinct banks; V rows are dense (lanes
// read consecutive columns of one row). src(r, c, k, v) loads chunk c (8
// values) of tile row r's K and V.
// ---------------------------------------------------------------------------

template <int D, int NT, typename PT, typename Src>
__device__ __forceinline__ void stage_tile(bf16* ks, bf16* vs, int n, int tid,
                                           Src src) {
  using IO = PoolIO<PT>;
  constexpr int CH = D / 8, KS = D + 2, PER = BK * CH / NT;
  static_assert(BK * CH % NT == 0, "tile chunks");
  typename IO::Raw kr[PER], vr[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * NT, r = e / CH, c = e % CH;
    if (r < n) src(r, c, kr[i], vr[i]);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * NT, r = e / CH, c = e % CH;
    if (r < n) {
      const uint4 kv = IO::to_bf16(kr[i]);
      uint32_t* kd = reinterpret_cast<uint32_t*>(ks + r * KS + c * 8);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      reinterpret_cast<uint4*>(vs + r * D)[c] = IO::to_bf16(vr[i]);
    }
  }
}

// Scores of keys lane and lane+32 of a staged tile for one query row
// (f32 in shared memory), from the padded K tile.
template <int D>
__device__ __forceinline__ void tile_scores(const bf16* ks, const float* qrow,
                                            int lane, float& s0, float& s1) {
  constexpr int KS = D + 2;
  const __nv_bfloat162* k0 =
      reinterpret_cast<const __nv_bfloat162*>(ks + lane * KS);
  const __nv_bfloat162* k1 =
      reinterpret_cast<const __nv_bfloat162*>(ks + (lane + 32) * KS);
  const float2* q2 = reinterpret_cast<const float2*>(qrow);
  s0 = 0.f;
  s1 = 0.f;
#pragma unroll 8
  for (int d2 = 0; d2 < D / 2; ++d2) {
    const float2 a = __bfloat1622float2(k0[d2]);
    const float2 b = __bfloat1622float2(k1[d2]);
    const float2 qv = q2[d2];
    s0 += qv.x * a.x + qv.y * a.y;
    s1 += qv.x * b.x + qv.y * b.y;
  }
}

// ---------------------------------------------------------------------------
// B1 (fused) and B4: one-token decode attention.
// Grid (B, KV), 4 warps. Warp w serves query heads g = w, w+4, ... of the
// KV head: per 64-key tile its lanes score keys lane and lane+32, then
// accumulate P.V with each lane owning D/32 dims. Keys are positions
// [lo, tot]. Fused (B1): rows < tot from the pool, the new token (position
// tot) from k/v, and the row is appended after the reads. Not fused (B4):
// every row from the pool, the new token's included.
// ---------------------------------------------------------------------------

constexpr int DEC_WARPS = 4;
constexpr int DEC_HPW = 4;  // heads per warp -> G <= 16

template <int D>
constexpr size_t decode_smem_bytes() {
  return size_t(BK) * (D + 2) * 2                 // ks (padded rows)
         + size_t(BK) * D * 2                     // vs
         + size_t(DEC_WARPS * DEC_HPW) * D * 4    // qs (f32)
         + size_t(DEC_WARPS) * BK * 4;            // ps
}

template <int D, typename PT>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_kernel(const bf16* __restrict__ q, PT* __restrict__ pool,
              const bf16* __restrict__ knew, const bf16* __restrict__ vnew,
              const int* __restrict__ block_tables,
              const int* __restrict__ seq_lens,
              const uint8_t* __restrict__ valid, bf16* __restrict__ out,
              int fused, int layer, int P, int page, int M, int mp, int KV,
              int G, float scale, int window, float softcap) {
  using IO = PoolIO<PT>;
  using Raw = typename IO::Raw;
  constexpr int DPL = D / 32;
  constexpr int CH = D / 8;  // 8-value chunks in one head's row slice
  constexpr int NT = DEC_WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);                  // [BK][D + 2]
  bf16* vs = ks + BK * (D + 2);                              // [BK][D]
  float* qs = reinterpret_cast<float*>(vs + BK * D);         // [16][D]
  float* ps = qs + DEC_WARPS * DEC_HPW * D;                  // [4][BK]

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = KV * G, khalf = KV * D;
  const int tot = seq_lens[b];
  const int lo = window > 0 ? max(tot + 1 - window, 0) : 0;
  const int hi = tot + 1;
  const int* bt = block_tables + int64_t(b) * mp;
  const bf16* krow = knew + (int64_t(b) * KV + h) * D;
  const bf16* vrow = vnew + (int64_t(b) * KV + h) * D;

  for (int e = tid; e < G * D; e += NT)
    qs[e] = __bfloat162float(q[(int64_t(b) * H + h * G + e / D) * D + e % D]);

  float acc[DEC_HPW][DPL], m[DEC_HPW], l[DEC_HPW];
#pragma unroll
  for (int i = 0; i < DEC_HPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += BK) {
    const int n = min(BK, hi - t0);
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    stage_tile<D, NT, PT>(ks, vs, n, tid, [&](int r, int c, Raw& kr, Raw& vr) {
      const int pos = t0 + r;
      if (pos < tot || !fused) {
        const int pi = pos / page;
        const int pid = pi < mp ? max(bt[pi], 0) : 0;
        const PT* row = pool + row_offset(layer, P, page, M, pid, pos % page);
        kr = IO::load(row + h * D + c * 8);
        vr = IO::load(row + khalf + h * D + c * 8);
      } else {  // the new token, from the input (never read back), at the
                // value its pool encoding holds
        kr = IO::from_bf16(ld16(krow + c * 8));
        vr = IO::from_bf16(ld16(vrow + c * 8));
      }
    });
    __syncthreads();

#pragma unroll
    for (int i = 0; i < DEC_HPW; ++i) {
      const int g = warp + i * DEC_WARPS;
      if (g < G) {  // warp-uniform
        float sv[2];
        tile_scores<D>(ks, qs + g * D, lane, sv[0], sv[1]);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int j = lane + 32 * kk, pos = t0 + j;
          const bool ok =
              j < n && ((fused && pos == tot) || pos / page < mp);
          sv[kk] = ok ? capped(sv[kk] * scale, softcap) : -INFINITY;
        }
        float p0, p1;
        const float alpha = online_update(m[i], l[i], sv[0], sv[1], p0, p1);
        ps[warp * BK + lane] = p0;
        ps[warp * BK + lane + 32] = p1;
        __syncwarp();
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
        for (int j = 0; j < n; ++j) {
          const float p = ps[warp * BK + j];
#pragma unroll
          for (int d = 0; d < DPL; ++d)
            acc[i][d] += p * __bfloat162float(vs[j * D + lane * DPL + d]);
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < DEC_HPW; ++i) {
    const int g = warp + i * DEC_WARPS;
    if (g < G) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      bf16* op = out + (int64_t(b) * H + h * G + g) * D + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) op[d] = __float2bfloat16(acc[i][d] * inv);
    }
  }

  // append the new token's row (after this block's reads; no other block
  // reads slot `tot` of this row)
  if (fused && valid[b]) {
    const int pi = tot / page;
    const int pid = pi < mp ? bt[pi] : -1;
    if (pid >= 0 && pid < P) {
      PT* row = pool + row_offset(layer, P, page, M, pid, tot % page);
      for (int c = tid; c < CH; c += NT) {
        IO::store(row + h * D + c * 8, IO::from_bf16(ld16(krow + c * 8)));
        IO::store(row + khalf + h * D + c * 8, IO::from_bf16(ld16(vrow + c * 8)));
      }
      if (h == 0)
        for (int e = 2 * khalf + tid * 8; e < M; e += NT * 8)
          IO::store(row + e, IO::zero());
    }
  }
}

// ---------------------------------------------------------------------------
// B2 (first launch): packed prefill append. One block per packed token;
// the token's row [k | v | 0-pad] lands in its segment's page if the token
// is live (its block's segment >= 0 and its position < the segment's
// total), else nothing is written.
// ---------------------------------------------------------------------------

template <typename PT>
__global__ void append_packed_kernel(PT* __restrict__ pool,
                                     const bf16* __restrict__ k,
                                     const bf16* __restrict__ v,
                                     const int* __restrict__ bts,
                                     const int* __restrict__ block_seg,
                                     const int* __restrict__ block_qstart,
                                     const int* __restrict__ total_lens,
                                     int Tq, int layer, int P, int page,
                                     int M, int mp, int khalf) {
  using IO = PoolIO<PT>;
  const int t = blockIdx.x, b = t / Tq;
  const int seg = block_seg[b];
  if (seg < 0) return;
  const int pos = block_qstart[b] + t % Tq;
  if (pos < 0 || pos >= total_lens[seg]) return;
  const int pi = pos / page;
  if (pi >= mp) return;
  const int pid = bts[int64_t(seg) * mp + pi];
  if (pid < 0 || pid >= P) return;
  PT* row = pool + row_offset(layer, P, page, M, pid, pos % page);
  for (int e = threadIdx.x * 8; e < M; e += blockDim.x * 8) {
    typename IO::Raw val = IO::zero();
    if (e < khalf)
      val = IO::from_bf16(ld16(k + int64_t(t) * khalf + e));
    else if (e < 2 * khalf)
      val = IO::from_bf16(ld16(v + int64_t(t) * khalf + e - khalf));
    IO::store(row + e, val);
  }
}

// ---------------------------------------------------------------------------
// B5 and B2 (second launch): prefill attention of a query block against
// the paged context. Grid (T / BQ, KV), 8 warps; a block holds BQ tokens x
// G heads = R <= 64 query rows (row r = token r / G, head r % G), warp w
// owns rows 8w..8w+7. Per 64-key tile: lane computes the scores of keys
// lane and lane+32 for its warp's 8 rows from a padded K tile (conflict-
// free column reads), then accumulates P.V with lane owning D/32 dims.
//
// packed == 0 (B5): one sequence, token t at position q_pos[0] + t,
//   context `total`, table `bts` [mp].
// packed == 1 (B2): token t belongs to Tq-block t / Tq of segment
//   block_seg[block] (-1 = dead block: output 0), position
//   block_qstart[block] + t % Tq, context total_lens[seg], table
//   bts[seg].
// ---------------------------------------------------------------------------

constexpr int PF_WARPS = 8;
constexpr int PF_ROWS = 64;
constexpr int PF_RPW = PF_ROWS / PF_WARPS;

template <int D>
constexpr size_t prefill_smem_bytes() {
  return size_t(PF_ROWS) * D * 4      // qs (f32)
         + size_t(PF_ROWS) * BK * 4   // ps
         + size_t(BK) * D * 2         // vs
         + size_t(BK) * (D + 2) * 2;  // ks (padded rows)
}

template <int D, typename PT>
__global__ void __launch_bounds__(PF_WARPS * 32)
prefill_attend_kernel(const bf16* __restrict__ q, const PT* __restrict__ pool,
                      const int* __restrict__ bts,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ block_seg,
                      const int* __restrict__ block_qstart,
                      const int* __restrict__ total_lens, int total_scalar,
                      bf16* __restrict__ out, int packed, int Tq, int BQ,
                      int layer, int P, int page, int M, int mp, int KV,
                      int G, float scale, int window, float softcap) {
  using IO = PoolIO<PT>;
  constexpr int DPL = D / 32;
  constexpr int CH = D / 8;
  constexpr int KS = D + 2;  // padded K row (elements)
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                 // [64][D]
  float* ps = qs + PF_ROWS * D;                               // [64][BK]
  bf16* vs = reinterpret_cast<bf16*>(ps + PF_ROWS * BK);      // [BK][D]
  bf16* ks = vs + BK * D;                                     // [BK][KS]

  const int h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = KV * G, khalf = KV * D;
  const int R = BQ * G;
  const int t_base = blockIdx.x * BQ;

  int q_start, total;
  const int* bt;
  if (packed) {
    const int blk = t_base / Tq;
    const int seg = block_seg[blk];
    if (seg < 0) {  // dead block: zero output, nothing read
      for (int e = tid; e < R * D; e += PF_WARPS * 32) {
        const int r = e / D, d = e % D;
        out[(int64_t(t_base + r / G) * H + h * G + r % G) * D + d] =
            __float2bfloat16(0.f);
      }
      return;
    }
    q_start = block_qstart[blk] + t_base % Tq;
    total = total_lens[seg];
    bt = bts + int64_t(seg) * mp;
  } else {
    q_start = q_pos[0] + t_base;
    total = total_scalar;
    bt = bts;
  }

  // stage the block's queries as f32 (rows >= R are zero)
  for (int e = tid; e < PF_ROWS * CH; e += PF_WARPS * 32) {
    const int r = e / CH, c = e % CH;
    float* dst = qs + r * D + c * 8;
    if (r < R) {
      const uint4 raw = reinterpret_cast<const uint4*>(
          q + (int64_t(t_base + r / G) * H + h * G + r % G) * D)[c];
      const bf16* hv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(hv[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = 0.f;
    }
  }

  float acc[PF_RPW][DPL], m[PF_RPW], l[PF_RPW];
#pragma unroll
  for (int i = 0; i < PF_RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[i][d] = 0.f;
  }

  const int kend = min(q_start + BQ, total);
  const int kstart = window > 0 ? max(q_start - window + 1, 0) : 0;
  for (int t0 = kstart; t0 < kend; t0 += BK) {
    const int n = min(BK, kend - t0);
    __syncthreads();  // previous tile fully consumed (and qs staged)
    // staged one chunk at a time: register-buffering the whole tile, as
    // the decode kernel does, pushed this kernel past 128 registers
    for (int e = tid; e < n * CH; e += PF_WARPS * 32) {
      const int r = e / CH, c = e % CH, pos = t0 + r;
      const int pi = pos / page;
      const int pid = pi < mp ? max(bt[pi], 0) : 0;
      const PT* row = pool + row_offset(layer, P, page, M, pid, pos % page);
      const uint4 kv = IO::to_bf16(IO::load(row + h * D + c * 8));
      const uint4 vv = IO::to_bf16(IO::load(row + khalf + h * D + c * 8));
      uint32_t* kd = reinterpret_cast<uint32_t*>(ks + r * KS + c * 8);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      reinterpret_cast<uint4*>(vs + r * D)[c] = vv;
    }
    __syncthreads();

    // scores: this lane's keys j0 = lane, j1 = lane + 32, for 8 rows
    float s[PF_RPW][2];
#pragma unroll
    for (int i = 0; i < PF_RPW; ++i) s[i][0] = s[i][1] = 0.f;
    const __nv_bfloat162* k0 =
        reinterpret_cast<const __nv_bfloat162*>(ks + lane * KS);
    const __nv_bfloat162* k1 =
        reinterpret_cast<const __nv_bfloat162*>(ks + (lane + 32) * KS);
    const float* qw = qs + warp * PF_RPW * D;
#pragma unroll 4
    for (int d2 = 0; d2 < D / 2; ++d2) {
      const float2 a = __bfloat1622float2(k0[d2]);
      const float2 bb = __bfloat1622float2(k1[d2]);
#pragma unroll
      for (int i = 0; i < PF_RPW; ++i) {
        const float2 qv = reinterpret_cast<const float2*>(qw + i * D)[d2];
        s[i][0] += qv.x * a.x + qv.y * a.y;
        s[i][1] += qv.x * bb.x + qv.y * bb.y;
      }
    }

#pragma unroll
    for (int i = 0; i < PF_RPW; ++i) {
      const int r = warp * PF_RPW + i;
      const int qp = q_start + r / G;
      float sv[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j = lane + 32 * kk, kp = t0 + j;
        bool ok = j < n && kp < total && kp <= qp && kp / page < mp;
        if (window > 0) ok = ok && kp > qp - window;
        sv[kk] = ok ? capped(s[i][kk] * scale, softcap) : -INFINITY;
      }
      float p0, p1;
      const float alpha = online_update(m[i], l[i], sv[0], sv[1], p0, p1);
      ps[r * BK + lane] = p0;
      ps[r * BK + lane + 32] = p1;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
    }
    __syncwarp();

    for (int j = 0; j < n; ++j) {
      float vv[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        vv[d] = __bfloat162float(vs[j * D + lane * DPL + d]);
#pragma unroll
      for (int i = 0; i < PF_RPW; ++i) {
        const float p = ps[(warp * PF_RPW + i) * BK + j];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] += p * vv[d];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PF_RPW; ++i) {
    const int r = warp * PF_RPW + i;
    if (r < R) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      bf16* op = out + (int64_t(t_base + r / G) * H + h * G + r % G) * D +
                 lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) op[d] = __float2bfloat16(acc[i][d] * inv);
    }
  }
}

template <int D, typename PT>
int launch_prefill(const void* q, const void* pool, const void* bts,
                   const void* q_pos, const void* block_seg,
                   const void* block_qstart, const void* total_lens,
                   int total, void* out, int packed, int T, int Tq, int BQ,
                   int layer, int P, int page, int M, int mp, int KV, int G,
                   float scale, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = prefill_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        prefill_attend_kernel<D, PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  dim3 grid(T / BQ, KV);
  prefill_attend_kernel<D, PT><<<grid, PF_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const PT*>(pool),
      static_cast<const int*>(bts), static_cast<const int*>(q_pos),
      static_cast<const int*>(block_seg),
      static_cast<const int*>(block_qstart),
      static_cast<const int*>(total_lens), total, static_cast<bf16*>(out),
      packed, Tq, BQ, layer, P, page, M, mp, KV, G, scale, window, softcap);
  return int(cudaGetLastError());
}

template <int D, typename PT>
int launch_decode(const void* q, void* pool, const void* k, const void* v,
                  const void* block_tables, const void* seq_lens,
                  const void* valid, void* out, int fused, int B, int layer,
                  int P, int page, int M, int mp, int KV, int G, float scale,
                  int window, float softcap, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<D, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  dim3 grid(B, KV);
  decode_kernel<D, PT><<<grid, DEC_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<PT*>(pool),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(out), fused,
      layer, P, page, M, mp, KV, G, scale, window, softcap);
  return int(cudaGetLastError());
}

template <typename PT>
int launch_append_packed(void* pool, const void* k, const void* v,
                         const void* bts, const void* block_seg,
                         const void* block_qstart, const void* total_lens,
                         int T, int Tq, int layer, int P, int page, int M,
                         int mp, int khalf, cudaStream_t stream) {
  append_packed_kernel<PT><<<T, 128, 0, stream>>>(
      static_cast<PT*>(pool), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(bts),
      static_cast<const int*>(block_seg),
      static_cast<const int*>(block_qstart),
      static_cast<const int*>(total_lens), Tq, layer, P, page, M, mp, khalf);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The MLA merged latent row (B1, B3, B4 and B5 with split_kv=False).
// One KV "head" of LQK = 576 live lanes ([c_kv | k_pe]) is shared by all H
// query heads, and its first LDV = 512 lanes are the value. Scores and
// values are products with inner dimensions of 576 and 64, so both run on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums); the online
// softmax runs in f32 in between, as in the split kernels.
//
// Grid (row blocks, H / HT): a block owns LR = 32 query rows, HT heads
// (32, or 16 when H is no multiple of 32) of LR / HT query tokens (decode:
// one batch row and HT heads). It stages each 64-key tile of the latent
// rows ONCE (64 x 576 bf16, 72 KB) and uses it for both the scores and the
// values. What bounds it: the context bytes at a decode batch, the
// tensor-core rate at prefill. Every head tile re-reads the context (H / HT
// times: 4x for DeepSeek-R1's 128 heads), which L2 absorbs at the contexts
// served here. Per tile, 8 warps: scores S[32 x 64] = Q K^T, warp w the
// 16 x 16 block (w / 4, w % 4), to shared memory; softmax, warp w rows
// 4w..4w+3 (probabilities rounded to bf16 for the next product); then
// O[32 x 512] += P V, warp w the 16 x 128 block (w / 4, w % 4) in
// registers, rescaled row by row (the accumulator's row of each register
// is fixed by the mma layout). An e4m3 pool's tile arrives as bytes (64 x
// 576, 36 KB) by cp.async into a byte tile, and every thread then converts
// its chunks into the bf16 K=V tile once, before the products read it.
// Not done yet: split K over a long context at batch 1, TMA and wgmma.
// ---------------------------------------------------------------------------

constexpr int LQK = 576;        // live lanes of a latent row (score dims)
constexpr int LDV = 512;        // value lanes (kv_lora_rank)
constexpr int LR = 32;          // query rows a block
constexpr int LWARPS = 8;
constexpr int LLD = LQK + 8;    // row stride of the q and K=V tiles (bf16)
constexpr int LSLD = BK + 4;    // row stride of the score tile (f32)
constexpr int LPLD = BK + 8;    // row stride of the probability tile (bf16)
constexpr size_t LATENT_SMEM =
    size_t(LR) * LLD * 2 + size_t(BK) * LLD * 2 + size_t(LR) * LSLD * 4 +
    size_t(LR) * LPLD * 2 + 2 * LR * 4;
// an e4m3 pool adds the byte tile the staging lands in
template <typename PT>
constexpr size_t latent_smem_bytes() {
  return LATENT_SMEM + (std::is_same<PT, e4m3>::value ? size_t(BK) * LQK : 0);
}

enum LatentMode { L_DECODE_FUSED = 0, L_DECODE = 1, L_PREFILL = 2, L_PACKED = 3 };

__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragments of two n8 tiles (columns n0..n0+15) for rows k0..k0+15 of a
// row-major [k][n] bf16 tile, transposed on the way: lane l addresses row
// k0 + (l & 15), column n0 + 8 * (l >> 4).
__device__ __forceinline__ void ldsm_x4_trans(const bf16* p, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

template <typename PT>
__global__ void __launch_bounds__(LWARPS * 32)
latent_kernel(int mode, const bf16* __restrict__ q, PT* __restrict__ pool,
              const bf16* __restrict__ knew, const int* __restrict__ bts,
              const int* __restrict__ pos_in,  // seq_lens [B] or q_pos [T]
              const uint8_t* __restrict__ valid,
              const int* __restrict__ block_seg,
              const int* __restrict__ block_qstart,
              const int* __restrict__ total_lens, int total_scalar,
              bf16* __restrict__ out, int Tq, int H, int HT, int layer, int P,
              int page, int M, int mp, float scale, int window,
              float softcap) {
  using IO = PoolIO<PT>;
  constexpr bool FP8 = std::is_same<PT, e4m3>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                // [LR][LLD]
  bf16* ks = qs + LR * LLD;                                // [BK][LLD]
  float* ss = reinterpret_cast<float*>(ks + BK * LLD);     // [LR][LSLD]
  bf16* ps = reinterpret_cast<bf16*>(ss + LR * LSLD);      // [LR][LPLD]
  float* alpha_s = reinterpret_cast<float*>(ps + LR * LPLD);  // [LR]
  float* l_s = alpha_s + LR;                                  // [LR]
  e4m3* kb = reinterpret_cast<e4m3*>(smem + LATENT_SMEM);     // [BK][LQK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = blockIdx.y * HT;
  const bool decode = mode == L_DECODE_FUSED || mode == L_DECODE;
  const int BQ = decode ? 1 : LR / HT;  // query tokens of the block
  const int R = BQ * HT;                // live rows
  const int t_base = blockIdx.x * BQ;   // first token (decode: batch row)

  // the block's context: keys [kstart, kend); row r's query position is
  // q_start + r / HT (decode: tot for every row)
  int q_start, total, kstart, kend;
  const int* bt;
  if (decode) {
    q_start = pos_in[t_base];
    total = q_start + 1;
    kstart = window > 0 ? max(q_start + 1 - window, 0) : 0;
    kend = total;
    bt = bts + int64_t(t_base) * mp;
  } else {
    if (mode == L_PACKED) {
      const int blk = t_base / Tq;
      const int seg = block_seg[blk];
      if (seg < 0) {  // dead block: zero output, nothing read
        for (int e = tid; e < R * LDV; e += LWARPS * 32) {
          const int r = e / LDV;
          out[(int64_t(t_base + r / HT) * H + h0 + r % HT) * LDV + e % LDV] =
              __float2bfloat16(0.f);
        }
        return;
      }
      q_start = block_qstart[blk] + t_base % Tq;
      total = total_lens[seg];
      bt = bts + int64_t(seg) * mp;
    } else {
      q_start = pos_in[0] + t_base;
      total = total_scalar;
      bt = bts;
    }
    kend = min(q_start + BQ, total);
    kstart = window > 0 ? max(q_start - window + 1, 0) : 0;
  }

  // stage the block's queries (rows >= R are zero)
  for (int e = tid; e < LR * (LQK / 8); e += LWARPS * 32) {
    const int r = e / (LQK / 8), c = e % (LQK / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < R)
      v = reinterpret_cast<const uint4*>(
          q + (int64_t(t_base + r / HT) * H + h0 + r % HT) * LQK)[c];
    *reinterpret_cast<uint4*>(qs + r * LLD + c * 8) = v;
  }

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  const int sm = (warp >> 2) * 16;  // score / value row tile of this warp
  const int sn = (warp & 3) * 16;   // score key columns
  const int vd = (warp & 3) * 128;  // value lanes

  for (int t0 = kstart; t0 < kend; t0 += BK) {
    const int n = min(BK, kend - t0);
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    // 8 lanes a chunk: 16 bytes of bf16 straight into the K=V tile, or
    // 8 bytes of e4m3 into the byte tile
    for (int e = tid; e < BK * (LQK / 8); e += LWARPS * 32) {
      const int r = e / (LQK / 8), c = e % (LQK / 8);
      const int pos = t0 + r;
      PT* dst;
      if constexpr (FP8)
        dst = kb + r * LQK + c * 8;
      else
        dst = ks + r * LLD + c * 8;
      if (r >= n) {
        IO::store(dst, IO::zero());
      } else if (mode == L_DECODE_FUSED && pos == q_start) {
        // the new token at the value its pool encoding holds
        IO::store(dst, IO::from_bf16(ld16(knew + int64_t(t_base) * LQK + c * 8)));
      } else {
        const int pi = pos / page;
        const int pid = pi < mp ? max(bt[pi], 0) : 0;
        __pipeline_memcpy_async(
            dst, pool + row_offset(layer, P, page, M, pid, pos % page) + c * 8,
            sizeof(typename IO::Raw));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if constexpr (FP8) {  // the byte tile -> the bf16 tile, once
      for (int e = tid; e < BK * (LQK / 8); e += LWARPS * 32) {
        const int r = e / (LQK / 8), c = e % (LQK / 8);
        *reinterpret_cast<uint4*>(ks + r * LLD + c * 8) = IO::to_bf16(
            *reinterpret_cast<const typename IO::Raw*>(kb + r * LQK + c * 8));
      }
      __syncthreads();
    }

    // scores: the warp's 16 x 16 block, 36 k-steps over the live lanes
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
    const bf16* qa = qs + (sm + g) * LLD + 2 * t4;
    const bf16* kb = ks + (sn + g) * LLD + 2 * t4;
#pragma unroll 4
    for (int k0 = 0; k0 < LQK; k0 += 16) {
      const uint32_t a0 = lds32(qa + k0), a1 = lds32(qa + 8 * LLD + k0);
      const uint32_t a2 = lds32(qa + k0 + 8), a3 = lds32(qa + 8 * LLD + k0 + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* kp = kb + j * 8 * LLD + k0;
        mma_bf16_16816(sc[j], a0, a1, a2, a3, lds32(kp), lds32(kp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* s0 = ss + (sm + g) * LSLD + sn + j * 8 + 2 * t4;
      s0[0] = sc[j][0];
      s0[1] = sc[j][1];
      s0[8 * LSLD] = sc[j][2];
      s0[8 * LSLD + 1] = sc[j][3];
    }
    __syncthreads();

    // online softmax: warp w rows 4w..4w+3, keys lane and lane + 32
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      const int qp = decode ? q_start : q_start + r / HT;
      float sv[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j = lane + 32 * kk, kp = t0 + j;
        bool ok = j < n && kp <= qp && kp < total;
        if (!(mode == L_DECODE_FUSED && kp == q_start)) ok = ok && kp / page < mp;
        if (window > 0) ok = ok && kp > qp - window;
        sv[kk] = ok ? capped(ss[r * LSLD + j] * scale, softcap) : -INFINITY;
      }
      float p0, p1;
      const float alpha = online_update(m[i], l[i], sv[0], sv[1], p0, p1);
      ps[r * LPLD + lane] = __float2bfloat16(p0);
      ps[r * LPLD + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // O += P V: the warp's 16 x 128 block, rescaled first
    const float al0 = alpha_s[sm + g], al1 = alpha_s[sm + g + 8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    const bf16* pa = ps + (sm + g) * LPLD + 2 * t4;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      const uint32_t a0 = lds32(pa + k0), a1 = lds32(pa + 8 * LPLD + k0);
      const uint32_t a2 = lds32(pa + k0 + 8), a3 = lds32(pa + 8 * LPLD + k0 + 8);
      const bf16* vb = ks + (k0 + (lane & 15)) * LLD + vd + 8 * (lane >> 4);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(vb + jj * 16, b0, b1, b2, b3);
        mma_bf16_16816(acc[2 * jj], a0, a1, a2, a3, b0, b1);
        mma_bf16_16816(acc[2 * jj + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane == 0) l_s[warp * 4 + i] = l[i];
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = sm + g + 8 * half;
    if (r < R) {
      const float inv = l_s[r] > 0.f ? 1.f / l_s[r] : 0.f;
      bf16* op = out + (int64_t(t_base + r / HT) * H + h0 + r % HT) * LDV + vd +
                 2 * t4;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + j * 8) = __floats2bfloat162_rn(
            acc[j][2 * half] * inv, acc[j][2 * half + 1] * inv);
    }
  }

  // B1: append the new latent row [c_kv | k_pe | 0-pad] after the reads (no
  // block reads slot `tot` of this batch row from the pool)
  if (mode == L_DECODE_FUSED && blockIdx.y == 0 && valid[t_base]) {
    const int pi = q_start / page;
    const int pid = pi < mp ? bt[pi] : -1;
    if (pid >= 0 && pid < P) {
      PT* row = pool + row_offset(layer, P, page, M, pid, q_start % page);
      for (int c = tid; c < M / 8; c += LWARPS * 32) {
        typename IO::Raw v = IO::zero();
        if (c < LQK / 8)
          v = IO::from_bf16(ld16(knew + int64_t(t_base) * LQK + c * 8));
        IO::store(row + c * 8, v);
      }
    }
  }
}

template <typename PT>
int launch_latent(int mode, const void* q, void* pool, const void* knew,
                  const void* bts, const void* pos_in, const void* valid,
                  const void* block_seg, const void* block_qstart,
                  const void* total_lens, int total, void* out, int nrows,
                  int Tq, int H, int layer, int P, int page, int M, int mp,
                  float scale, int window, float softcap,
                  cudaStream_t stream) {
  const int HT = H % 32 == 0 ? 32 : 16;
  const bool decode = mode == L_DECODE_FUSED || mode == L_DECODE;
  const int BQ = decode ? 1 : LR / HT;
  if (H % 16 || M < LQK || nrows % BQ || (mode == L_PACKED && Tq % BQ))
    return 100000;
  const size_t smem = latent_smem_bytes<PT>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        latent_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  dim3 grid(nrows / BQ, H / HT);
  latent_kernel<PT><<<grid, LWARPS * 32, smem, stream>>>(
      mode, static_cast<const bf16*>(q), static_cast<PT*>(pool),
      static_cast<const bf16*>(knew), static_cast<const int*>(bts),
      static_cast<const int*>(pos_in), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(block_seg),
      static_cast<const int*>(block_qstart),
      static_cast<const int*>(total_lens), total, static_cast<bf16*>(out), Tq,
      H, HT, layer, P, page, M, mp, scale, window, softcap);
  return int(cudaGetLastError());
}

template <typename T>
struct Tag {
  typedef T type;
};

// f(Tag<pool element type>) for the pool of the call: bf16 or e4m3 bits
template <typename F>
int with_pool(int fp8, F f) {
  return fp8 ? f(Tag<e4m3>()) : f(Tag<bf16>());
}

// f(integral_constant<head size>) for every head size built
template <typename F>
int with_head_dim(int D, F f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 192: return f(std::integral_constant<int, 192>());
  }
  return 100000;
}

}  // namespace

constexpr int kUnsupported = 100000;

// Every entry takes `fp8`: 0 for a bf16 pool, 1 for int8 lanes of e4m3
// bits. The split-layout entries take head sizes 32, 64, 128 and 192.

extern "C" int chitu_attend_decode_fused(
    const void* q, void* pool, const void* k, const void* v,
    const void* block_tables, const void* seq_lens, const void* valid,
    void* out, int B, int layer, int P, int page, int M, int mp, int KV,
    int G, int D, float scale, int window, float softcap, int fp8,
    void* stream) {
  if (G > DEC_WARPS * DEC_HPW) return kUnsupported;
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return with_head_dim(D, [&](auto d) {
      return launch_decode<decltype(d)::value, PT>(
          q, pool, k, v, block_tables, seq_lens, valid, out, 1, B, layer, P,
          page, M, mp, KV, G, scale, window, softcap,
          static_cast<cudaStream_t>(stream));
    });
  });
}

extern "C" int chitu_attend_decode(const void* q, const void* pool,
                                   const void* block_tables,
                                   const void* seq_lens, void* out, int B,
                                   int layer, int P, int page, int M, int mp,
                                   int KV, int G, int D, float scale,
                                   int window, float softcap, int fp8,
                                   void* stream) {
  if (G > DEC_WARPS * DEC_HPW) return kUnsupported;
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return with_head_dim(D, [&](auto d) {
      return launch_decode<decltype(d)::value, PT>(
          q, const_cast<void*>(pool), nullptr, nullptr, block_tables,
          seq_lens, nullptr, out, 0, B, layer, P, page, M, mp, KV, G, scale,
          window, softcap, static_cast<cudaStream_t>(stream));
    });
  });
}

extern "C" int chitu_attend_prefill(const void* q, const void* pool,
                                    const void* block_table,
                                    const void* q_pos, void* out, int T,
                                    int BQ, int layer, int P, int page, int M,
                                    int mp, int KV, int G, int D, int total,
                                    float scale, int window, float softcap,
                                    int fp8, void* stream) {
  if (BQ * G > PF_ROWS || T % BQ) return kUnsupported;
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return with_head_dim(D, [&](auto d) {
      return launch_prefill<decltype(d)::value, PT>(
          q, pool, block_table, q_pos, nullptr, nullptr, nullptr, total, out,
          0, T, T, BQ, layer, P, page, M, mp, KV, G, scale, window, softcap,
          static_cast<cudaStream_t>(stream));
    });
  });
}

extern "C" int chitu_attend_prefill_packed_fused(
    const void* q, void* pool, const void* k, const void* v, const void* bts,
    const void* block_seg, const void* block_qstart, const void* total_lens,
    void* out, int T, int NB, int BQ, int layer, int P, int page, int M,
    int mp, int KV, int G, int D, float scale, int window, float softcap,
    int fp8, void* stream) {
  const int Tq = T / NB;
  if (BQ * G > PF_ROWS || Tq * NB != T || Tq % BQ) return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return with_head_dim(D, [&](auto d) {
      const int err = launch_append_packed<PT>(
          pool, k, v, bts, block_seg, block_qstart, total_lens, T, Tq, layer,
          P, page, M, mp, KV * D, s);
      if (err) return err;
      return launch_prefill<decltype(d)::value, PT>(
          q, pool, bts, nullptr, block_seg, block_qstart, total_lens, 0, out,
          1, T, Tq, BQ, layer, P, page, M, mp, KV, G, scale, window, softcap,
          s);
    });
  });
}

extern "C" int chitu_attend_prefill_packed(
    const void* q, const void* pool, const void* bts, const void* block_seg,
    const void* block_qstart, const void* total_lens, void* out, int T,
    int NB, int BQ, int layer, int P, int page, int M, int mp, int KV, int G,
    int D, float scale, int window, float softcap, int fp8, void* stream) {
  const int Tq = T / NB;
  if (BQ * G > PF_ROWS || Tq * NB != T || Tq % BQ) return kUnsupported;
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return with_head_dim(D, [&](auto d) {
      return launch_prefill<decltype(d)::value, PT>(
          q, pool, bts, nullptr, block_seg, block_qstart, total_lens, 0, out,
          1, T, Tq, BQ, layer, P, page, M, mp, KV, G, scale, window, softcap,
          static_cast<cudaStream_t>(stream));
    });
  });
}

// The merged latent row (kv_heads 1, live width 576, value width 512):
// mode 0 B1 (fused append + decode), 1 B4 (decode), 2 B5 (one sequence's
// chunk, pos_in = q_pos), 3 B3 (packed slab). nrows: batch rows (decode) or
// query tokens (prefill); q [nrows, H, 576], out [nrows, H, 512], knew
// [nrows, 576] (mode 0 only).
extern "C" int chitu_attend_latent(
    int mode, const void* q, void* pool, const void* knew, const void* bts,
    const void* pos_in, const void* valid, const void* block_seg,
    const void* block_qstart, const void* total_lens, int total, void* out,
    int nrows, int NB, int H, int layer, int P, int page, int M, int mp,
    float scale, int window, float softcap, int fp8, void* stream) {
  if (mode < 0 || mode > 3) return kUnsupported;
  const int Tq = mode == 3 ? nrows / NB : nrows;
  if (mode == 3 && Tq * NB != nrows) return kUnsupported;
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return launch_latent<PT>(mode, q, pool, knew, bts, pos_in, valid,
                             block_seg, block_qstart, total_lens, total, out,
                             nrows, Tq, H, layer, P, page, M, mp, scale,
                             window, softcap,
                             static_cast<cudaStream_t>(stream));
  });
}
