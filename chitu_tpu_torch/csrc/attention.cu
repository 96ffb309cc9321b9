// Paged-KV attention kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels, each the counterpart of one Pallas TPU kernel of
// chitu_tpu/ops/pallas_attention.py (their Python wrappers and plain
// PyTorch versions live in chitu_tpu_torch/ops/attention_kernels.py):
//
//   B1 decode_fused_kernel   <- attend_decode_fused (_decode_fused_kernel)
//   B2 append_packed_kernel + prefill_attend_kernel (packed mode)
//                            <- attend_prefill_packed_fused
//                               (_prefill_packed_fused_kernel)
//   B5 prefill_attend_kernel (single-sequence mode)
//                            <- attend_prefill (_prefill_grouped_kernel)
//
// Pool layout (as in the JAX package): [L, P, page, M] bf16 with
// K-half-then-V-half rows [K_0..K_{KV-1} V_0..V_{KV-1} | pad], M =
// pad128(2*KV*D). Offsets into the pool are 64-bit: a full-size pool holds
// more than 2^31 elements.
//
// What bounds them on the card: the bytes of context K/V read from the
// pool (each page row of the KV head's K and V slices; q and out are small
// beside it), at the card's memory rate. The design answers that in two
// ways. First, grouped-query sharing: one block per (query row or query
// block, KV head) loads every K/V tile of that head ONCE into shared memory
// for all G query heads that read it (the TPU kernels' expanded-query and
// mask/fold matrices are not carried over). Second, each tile is fetched
// with 16-byte loads from every thread before any arithmetic, so a block
// keeps a whole 64-key tile of K and V in flight. Arithmetic is scalar fp32
// FMA with fp32 softmax statistics; tensor cores (mma/wgmma) and TMA
// pipelines are left for later work.
//
// The TPU grid runs in order, and the fused packed-prefill kernel relies on
// that: block b+1 of a segment reads the rows block b appended. Blocks on
// Hopper run in any order, so B2 is two launches on one stream: the append
// of every live row, then the attention. The decode kernel never reads
// back the row it writes: the new token's column comes from the input k/v,
// as on the TPU (pallas_attention.py:652-679).
//
// Every entry returns cudaGetLastError() after its launch (0 = launched);
// the wrappers raise on anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;  // keys per shared-memory tile

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
// 16-byte loads before it stores any, so a block keeps the whole tile of
// K and V in flight. K rows are padded by one bf16 pair (KS = D + 2) so
// that lanes reading the same column of consecutive rows hit distinct
// banks; V rows are dense (lanes read consecutive columns of one row).
// src(r, &k, &v) gives the global 16-byte chunk pointers of tile row r.
// ---------------------------------------------------------------------------

template <int D, int NT, typename Src>
__device__ __forceinline__ void stage_tile(bf16* ks, bf16* vs, int n, int tid,
                                           Src src) {
  constexpr int CH = D / 8, KS = D + 2, PER = BK * CH / NT;
  uint4 kr[PER], vr[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * NT, r = e / CH, c = e % CH;
    if (r < n) {
      const uint4 *kp, *vp;
      src(r, kp, vp);
      kr[i] = kp[c];
      vr[i] = vp[c];
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * NT, r = e / CH, c = e % CH;
    if (r < n) {
      uint32_t* kd = reinterpret_cast<uint32_t*>(ks + r * KS + c * 8);
      kd[0] = kr[i].x;
      kd[1] = kr[i].y;
      kd[2] = kr[i].z;
      kd[3] = kr[i].w;
      reinterpret_cast<uint4*>(vs + r * D)[c] = vr[i];
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
// B1: fused append + one-token decode attention.
// Grid (B, KV), 4 warps. Warp w serves query heads g = w, w+4, ... of the
// KV head: per 64-key tile its lanes score keys lane and lane+32, then
// accumulate P.V with each lane owning D/32 dims. Keys are positions
// [lo, tot]: rows < tot from the pool, the new token (position tot) from
// k/v.
// ---------------------------------------------------------------------------

constexpr int DEC_WARPS = 4;
constexpr int DEC_HPW = 4;  // heads per warp -> G <= 16

template <int D>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_fused_kernel(const bf16* __restrict__ q, bf16* __restrict__ pool,
                    const bf16* __restrict__ knew,
                    const bf16* __restrict__ vnew,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens,
                    const uint8_t* __restrict__ valid, bf16* __restrict__ out,
                    int layer, int P, int page, int M, int mp, int KV, int G,
                    float scale, int window, float softcap) {
  constexpr int DPL = D / 32;
  constexpr int CH = D / 8;  // 16-byte chunks in one head's row slice
  constexpr int NT = DEC_WARPS * 32;
  __shared__ __align__(16) bf16 ks[BK * (D + 2)];
  __shared__ __align__(16) bf16 vs[BK * D];
  __shared__ __align__(16) float qs[DEC_WARPS * DEC_HPW][D];
  __shared__ float ps[DEC_WARPS][BK];

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
    qs[e / D][e % D] =
        __bfloat162float(q[(int64_t(b) * H + h * G + e / D) * D + e % D]);

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
    stage_tile<D, NT>(ks, vs, n, tid,
                      [&](int r, const uint4*& kp, const uint4*& vp) {
      const int pos = t0 + r;
      if (pos < tot) {
        const int pi = pos / page;
        const int pid = pi < mp ? max(bt[pi], 0) : 0;
        const bf16* row = pool + row_offset(layer, P, page, M, pid, pos % page);
        kp = reinterpret_cast<const uint4*>(row + h * D);
        vp = reinterpret_cast<const uint4*>(row + khalf + h * D);
      } else {  // the new token, from the input (never read back)
        kp = reinterpret_cast<const uint4*>(krow);
        vp = reinterpret_cast<const uint4*>(vrow);
      }
    });
    __syncthreads();

#pragma unroll
    for (int i = 0; i < DEC_HPW; ++i) {
      const int g = warp + i * DEC_WARPS;
      if (g < G) {  // warp-uniform
        float sv[2];
        tile_scores<D>(ks, qs[g], lane, sv[0], sv[1]);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int j = lane + 32 * kk, pos = t0 + j;
          const bool ok = j < n && (pos == tot || pos / page < mp);
          sv[kk] = ok ? capped(sv[kk] * scale, softcap) : -INFINITY;
        }
        float p0, p1;
        const float alpha = online_update(m[i], l[i], sv[0], sv[1], p0, p1);
        ps[warp][lane] = p0;
        ps[warp][lane + 32] = p1;
        __syncwarp();
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] *= alpha;
        for (int j = 0; j < n; ++j) {
          const float p = ps[warp][j];
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
  if (valid[b]) {
    const int pi = tot / page;
    const int pid = pi < mp ? bt[pi] : -1;
    if (pid >= 0 && pid < P) {
      bf16* row = pool + row_offset(layer, P, page, M, pid, tot % page);
      for (int c = tid; c < CH; c += DEC_WARPS * 32) {
        reinterpret_cast<uint4*>(row + h * D)[c] =
            reinterpret_cast<const uint4*>(knew + (int64_t(b) * KV + h) * D)[c];
        reinterpret_cast<uint4*>(row + khalf + h * D)[c] =
            reinterpret_cast<const uint4*>(vnew + (int64_t(b) * KV + h) * D)[c];
      }
      if (h == 0) {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (int e = 2 * khalf + tid * 8; e < M; e += DEC_WARPS * 32 * 8)
          *reinterpret_cast<uint4*>(row + e) = zero;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B2 (first launch): packed prefill append. One block per packed token;
// the token's row [k | v | 0-pad] lands in its segment's page if the token
// is live (its block's segment >= 0 and its position < the segment's
// total), else nothing is written.
// ---------------------------------------------------------------------------

__global__ void append_packed_kernel(bf16* __restrict__ pool,
                                     const bf16* __restrict__ k,
                                     const bf16* __restrict__ v,
                                     const int* __restrict__ bts,
                                     const int* __restrict__ block_seg,
                                     const int* __restrict__ block_qstart,
                                     const int* __restrict__ total_lens,
                                     int Tq, int layer, int P, int page,
                                     int M, int mp, int khalf) {
  const int t = blockIdx.x, b = t / Tq;
  const int seg = block_seg[b];
  if (seg < 0) return;
  const int pos = block_qstart[b] + t % Tq;
  if (pos < 0 || pos >= total_lens[seg]) return;
  const int pi = pos / page;
  if (pi >= mp) return;
  const int pid = bts[int64_t(seg) * mp + pi];
  if (pid < 0 || pid >= P) return;
  bf16* row = pool + row_offset(layer, P, page, M, pid, pos % page);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x * 8; e < M; e += blockDim.x * 8) {
    uint4 val = zero;
    if (e < khalf)
      val = *reinterpret_cast<const uint4*>(k + int64_t(t) * khalf + e);
    else if (e < 2 * khalf)
      val = *reinterpret_cast<const uint4*>(v + int64_t(t) * khalf + e - khalf);
    *reinterpret_cast<uint4*>(row + e) = val;
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

template <int D>
__global__ void __launch_bounds__(PF_WARPS * 32)
prefill_attend_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pool,
                      const int* __restrict__ bts,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ block_seg,
                      const int* __restrict__ block_qstart,
                      const int* __restrict__ total_lens, int total_scalar,
                      bf16* __restrict__ out, int packed, int Tq, int BQ,
                      int layer, int P, int page, int M, int mp, int KV,
                      int G, float scale, int window, float softcap) {
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
      const bf16* row = pool + row_offset(layer, P, page, M, pid, pos % page);
      const uint4 kv = reinterpret_cast<const uint4*>(row + h * D)[c];
      const uint4 vv = reinterpret_cast<const uint4*>(row + khalf + h * D)[c];
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

template <int D>
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
        prefill_attend_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  dim3 grid(T / BQ, KV);
  prefill_attend_kernel<D><<<grid, PF_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pool),
      static_cast<const int*>(bts), static_cast<const int*>(q_pos),
      static_cast<const int*>(block_seg),
      static_cast<const int*>(block_qstart),
      static_cast<const int*>(total_lens), total, static_cast<bf16*>(out),
      packed, Tq, BQ, layer, P, page, M, mp, KV, G, scale, window, softcap);
  return int(cudaGetLastError());
}

}  // namespace

constexpr int kUnsupported = 100000;
// the one head size built; others wait for the expanded variants
constexpr int kHeadDim = 128;

extern "C" int chitu_attend_decode_fused(
    const void* q, void* pool, const void* k, const void* v,
    const void* block_tables, const void* seq_lens, const void* valid,
    void* out, int B, int layer, int P, int page, int M, int mp, int KV,
    int G, int D, float scale, int window, float softcap, void* stream) {
  if (G > DEC_WARPS * DEC_HPW || D != kHeadDim) return kUnsupported;
  dim3 grid(B, KV);
  decode_fused_kernel<kHeadDim>
      <<<grid, DEC_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<bf16*>(pool),
          static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const int*>(block_tables),
          static_cast<const int*>(seq_lens),
          static_cast<const uint8_t*>(valid), static_cast<bf16*>(out), layer,
          P, page, M, mp, KV, G, scale, window, softcap);
  return int(cudaGetLastError());
}

extern "C" int chitu_attend_prefill(const void* q, const void* pool,
                                    const void* block_table,
                                    const void* q_pos, void* out, int T,
                                    int BQ, int layer, int P, int page, int M,
                                    int mp, int KV, int G, int D, int total,
                                    float scale, int window, float softcap,
                                    void* stream) {
  if (BQ * G > PF_ROWS || T % BQ || D != kHeadDim) return kUnsupported;
  return launch_prefill<kHeadDim>(
      q, pool, block_table, q_pos, nullptr, nullptr, nullptr, total, out, 0,
      T, T, BQ, layer, P, page, M, mp, KV, G, scale, window, softcap,
      static_cast<cudaStream_t>(stream));
}

extern "C" int chitu_attend_prefill_packed_fused(
    const void* q, void* pool, const void* k, const void* v, const void* bts,
    const void* block_seg, const void* block_qstart, const void* total_lens,
    void* out, int T, int NB, int BQ, int layer, int P, int page, int M,
    int mp, int KV, int G, int D, float scale, int window, float softcap,
    void* stream) {
  const int Tq = T / NB;
  if (BQ * G > PF_ROWS || Tq * NB != T || Tq % BQ || D != kHeadDim)
    return kUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  append_packed_kernel<<<T, 128, 0, s>>>(
      static_cast<bf16*>(pool), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(bts),
      static_cast<const int*>(block_seg),
      static_cast<const int*>(block_qstart),
      static_cast<const int*>(total_lens), Tq, layer, P, page, M, mp, KV * D);
  const int err = int(cudaGetLastError());
  if (err) return err;
  return launch_prefill<kHeadDim>(q, pool, bts, nullptr, block_seg,
                                  block_qstart, total_lens, 0, out, 1, T, Tq,
                                  BQ, layer, P, page, M, mp, KV, G, scale,
                                  window, softcap, s);
}
