// Paged-KV attention kernels for Hopper (sm_90a), plain C interface.
//
// Five entry points, each the counterpart of one Pallas TPU kernel of
// chitu_tpu/ops/pallas_attention.py (their Python wrappers and plain
// PyTorch versions live in chitu_tpu_torch/ops/attention_kernels.py):
//
//   B1 decode_kernel (fused), + decode_merge_kernel when split
//                             <- attend_decode_fused (_decode_fused_kernel)
//   B2 append_packed_kernel + prefill_attend_kernel (packed mode)
//                             <- attend_prefill_packed_fused
//                                (_prefill_packed_fused_kernel)
//   B3 prefill_attend_kernel (packed mode) alone
//                             <- attend_prefill_packed (_prefill_packed_kernel)
//   B4 decode_kernel (not fused), + decode_merge_kernel when split
//                             <- attend_decode (_decode_kernel)
//   B5 prefill_attend_kernel (single-sequence mode)
//                             <- attend_prefill (_prefill_grouped_kernel)
//
// and, for B1, B3, B4 and B5 on the MLA merged latent row, latent_kernel
// (+ latent_merge_kernel when a decode is split; below, TMA and wgmma). Two pool layouts, as in the JAX package, [L, P, page, M]: split
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
// fp8-e4m3 bits. An e4m3 pool tile lands in shared memory as bytes
// (cp.async; the latent kernel's by TMA) and is converted to bf16 there once, with the card's native
// e4m3 convert (e4m3 values are exact in bf16), so everything after the
// convert is the bf16 kernel. The appends (B1's in-kernel append, B2's append
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

#include "gemm_common.cuh"  // TMA, mbarrier and wgmma primitives, tensor maps

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

__device__ __forceinline__ int64_t row_offset(int layer, int P, int page,
                                              int M, int pid, int off) {
  return ((int64_t(layer) * P + pid) * page + off) * int64_t(M);
}

// ---------------------------------------------------------------------------
// Tensor-core helpers (mma.sync m16n8k16, bf16 in, f32 sums) and ldmatrix
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// B fragments of two n8 tiles (rows n0..n0+15 of a row-major [n][k] bf16
// tile, i.e. K rows for S = Q K^T) at depth k0..k0+15: lane l addresses row
// n0 + 8 * ((l >> 4) & 1) + (l & 7), column k0 + 8 * ((l >> 3) & 1);
// r0, r1 feed n-tile n0, r2, r3 n-tile n0 + 8.
__device__ __forceinline__ void ldsm_x4(const bf16* p, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
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

// ---------------------------------------------------------------------------
// The split-layout attention kernels (B1-B5 at head sizes 32-192): one
// design for prefill and decode, FlashAttention-2 style on mma.sync.
//
// Query rows of one KV head (prefill: BQ tokens x G heads; decode: the G
// heads of one batch row) sit 16 to a warp as A fragments in registers for
// the whole key loop. Keys come in tiles of 64 through a ring of 2 or 3
// shared-memory stages filled by 16-byte cp.async copies (every page id of
// a tile loaded before its first copy), so the next tiles are in flight
// while tile i is computed. A bf16 pool lands straight in the
// bf16 K and V tiles ([64][D + 8]: the 16-byte row pad makes the ldmatrix
// row reads conflict-free at every head size); an e4m3 pool lands as bytes
// and is converted once per tile into one bf16 K/V pair, after its copy
// has landed and before the next tile's copy is issued into another stage.
// Per tile and warp: S = Q K^T on the tensor cores (K rows by ldmatrix),
// scale, softcap and mask in the accumulator layout (row g and g + 8 of the
// warp's 16 rows, key columns 2 * (lane & 3) + {0, 1} of each n8 tile), the
// online softmax in f32 over quad shuffles (base-2 exponentials), P packed
// to bf16 A fragments in registers, O += P V (V by ldmatrix.trans). When a
// block has fewer than 16 rows a warp, its warps split each tile's keys
// instead (16, 32 or 64 keys a warp) and the partial (m, l, O) of the warps
// that share rows merge in shared memory at the end, in a fixed order. A
// tile wholly inside every row's causal, window and table range skips the
// mask. What bounds them: bytes at decode, the tensor-core rate at prefill.
//
// Registers a thread (ptxas -v, CUDA 12.8, sm_90a) and dynamic shared
// memory a block, bf16 / e4m3 pool (prefill: 4 and 8 warps alike but where
// given as a range):
//   prefill D 32:  128 / 128;          31.0 / 23.0 KB (3 stages)
//   prefill D 64:  159-175 / 155-174;  55.0 / 43.0 KB (3 stages)
//   prefill D 128: 228-242 / 217-232; 103.0 / 83.0 KB (3 stages)
//   prefill D 192: 255 / 254-255;     100.8 / 98.8-99.8 KB (2 stages); the
//                  4-warp builds spill 140 (bf16) and 12 (e4m3) bytes
//   decode D 32:   64 / 64 (8 bytes spilled);  20.8 / 18.8 KB (2 stages)
//   decode D 64:   128 (4 bytes spilled) / 119; 36.8 / 34.8 KB
//   decode D 128:  160 / 162;          68.8 / 66.8 KB
//   decode D 192:  238 / 220;         100.8 / 98.8 KB
// ---------------------------------------------------------------------------

constexpr int ATT_WARPS = 4;  // the decode kernel's; prefill: 4 or 8
// cp.async ring depth: the prefill kernel's 3 stages up to head size 128,
// 2 at 192 (a stage is 51 KB); the decode kernel's 2 (one tile in flight a
// block, more blocks an SM: 3 stages and fewer, longer splits measured
// slower on the card)
template <int D>
constexpr int kPrefillStages = D <= 128 ? 3 : 2;
constexpr int DEC_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 16);
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// The shared-memory ring of one kernel of NW warps: NST stages of a K and
// a V tile of 64 key rows of one head, in the pool's element type (bf16
// tiles [64][KST], or byte tiles [64][D] and one bf16 pair [64][KST] they
// are converted into).
template <int D, typename PT, int NST, int NW>
struct Ring {
  static constexpr bool FP8 = std::is_same<PT, e4m3>::value;
  static constexpr int KST = D + 8;             // bf16 tile row stride
  static constexpr int EPC = 16 / sizeof(PT);   // pool values a 16-byte copy
  static constexpr int CPR = D / EPC;           // copies a head's row slice
  static constexpr int TILE = BK * KST;         // bf16 elements of a tile
  static constexpr int NT = NW * 32;
  static constexpr int PER = (BK * CPR + NT - 1) / NT;  // copies a thread
  static constexpr bool EXACT = BK * CPR % NT == 0;
  static constexpr size_t BYTES = FP8 ? size_t(NST) * 2 * BK * D : 0;
  static constexpr size_t TILES =
      size_t(FP8 ? 1 : NST) * 2 * TILE * sizeof(bf16);
  // the warps' partial (m, l, O) after the key loop reuse the ring
  static constexpr int OST = D + 4;  // f32 row stride of a partial O
  static constexpr size_t STASH = size_t(NW) * 16 * (OST + 2) * sizeof(float);
  static constexpr size_t RING = BYTES + TILES > STASH ? BYTES + TILES : STASH;
  // after the ring: the page ids of the key rows of NST + 1 tiles (tile t
  // in slot t % (NST + 1)); a tile's copies read its slot
  static constexpr int SLOTS = NST + 1;
  static constexpr size_t SMEM = RING + size_t(SLOTS) * BK * sizeof(int);

  unsigned char* base;

  __device__ int* ptab(int tile) const {
    return reinterpret_cast<int*>(base + RING) + (tile % SLOTS) * BK;
  }

  __device__ PT* kdst(int st, int r, int c) const {
    if constexpr (FP8)
      return reinterpret_cast<PT*>(base) + (size_t(st) * 2 * BK + r) * D +
             c * EPC;
    else
      return reinterpret_cast<PT*>(base) + st * 2 * TILE + r * KST + c * EPC;
  }
  __device__ PT* vdst(int st, int r, int c) const {
    if constexpr (FP8)
      return kdst(st, r, c) + BK * D;
    else
      return kdst(st, r, c) + TILE;
  }
  __device__ bf16* ktile(int st) const {
    if constexpr (FP8)
      return reinterpret_cast<bf16*>(base + BYTES);
    else
      return reinterpret_cast<bf16*>(base) + st * 2 * TILE;
  }
  __device__ bf16* vtile(int st) const { return ktile(st) + TILE; }

  // chunk c of tile row r: the pool row's K and V slices of head h (`row`
  // points at the row's first lane), or zeros when row is null
  __device__ void stage(int st, int r, int c, const PT* row, int h,
                        int khalf) const {
    PT* kd = kdst(st, r, c);
    PT* vd = vdst(st, r, c);
    if (row) {
      cp16(kd, row + h * D + c * EPC);
      cp16(vd, row + khalf + h * D + c * EPC);
    } else {
      zero16(kd);
      zero16(vd);
    }
  }

  // Wait until tile `st` has landed and every warp is done with the tile
  // before it (all threads); an e4m3 stage is then converted into the
  // bf16 pair. The next copy may be issued after this returns.
  __device__ void land(int st, int tid, int nt) const {
    __pipeline_wait_prior(NST - 2);
    __syncthreads();
    if constexpr (FP8) {
      convert(st, tid, nt);
      __syncthreads();
    }
  }

  // an e4m3 stage's bytes -> the bf16 K/V pair (all threads; the caller
  // syncs before and after)
  __device__ void convert(int st, int tid, int nt) const {
    if constexpr (FP8) {
      using IO = PoolIO<e4m3>;
      for (int e = tid; e < 2 * BK * CPR; e += nt) {
        const int kv = e / (BK * CPR), r = (e / CPR) % BK, c = e % CPR;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            kv ? vdst(st, r, c) : kdst(st, r, c));
        bf16* d = (kv ? vtile(st) : ktile(st)) + r * KST + c * 16;
        reinterpret_cast<uint4*>(d)[0] = IO::to_bf16(make_uint2(raw.x, raw.y));
        reinterpret_cast<uint4*>(d)[1] = IO::to_bf16(make_uint2(raw.z, raw.w));
      }
    }
  }
};

// A fragments of a warp's 16 query rows (row pointers q0 for row g, q1 for
// row g + 8; null = a padding row of zeros), held for the whole key loop.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4],
                                       const bf16* q0, const bf16* q1,
                                       int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int c = kd * 16 + 2 * t4;
    qa[kd][0] = q0 ? lds32(q0 + c) : 0u;
    qa[kd][1] = q1 ? lds32(q1 + c) : 0u;
    qa[kd][2] = q0 ? lds32(q0 + c + 8) : 0u;
    qa[kd][3] = q1 ? lds32(q1 + c + 8) : 0u;
  }
}

// One warp's share of a staged tile: keys [kw, kw + NK) of the tile against
// its 16 query rows. ok(key in tile, half) says whether row g (half 0) or
// g + 8 (half 1) attends that key; a `full` tile skips the test. Scores
// are kept in base 2 (scale and softcap folded in); m, l and o are the
// rows' running max, sum (this thread's columns) and output.
template <int D, int NK, typename Ok>
__device__ __forceinline__ void warp_tile(
    const uint32_t (&qa)[D / 16][4], const bf16* kt, const bf16* vt, int kw,
    bool full, float scale, float softcap, Ok ok, float (&o)[D / 8][4],
    float (&m)[2], float (&l)[2], int lane) {
  constexpr int KST = D + 8, NJ = NK / 8;
  const int t4 = lane & 3;
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int jj = 0; jj < NK / 16; ++jj) {
    const bf16* kp = kt + (kw + jj * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * KST +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(kp + kd * 16, b0, b1, b2, b3);
      mma_bf16_16816(s[2 * jj], qa[kd][0], qa[kd][1], qa[kd][2], qa[kd][3], b0,
                     b1);
      mma_bf16_16816(s[2 * jj + 1], qa[kd][0], qa[kd][1], qa[kd][2], qa[kd][3],
                     b2, b3);
    }
  }
  // scale (and softcap) into base 2, then the mask, each loop behind a
  // warp-uniform branch
  if (softcap > 0.f) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = tanhf(s[j][e] * (scale / softcap)) * (softcap * LOG2E);
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale * LOG2E;
  }
  if (!full) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!ok(kw + 8 * j + 2 * t4 + (e & 1), e >> 1)) s[j][e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    const float mn = fmaxf(m[hf], mx[hf]);
    alpha[hf] = mn == -INFINITY ? 1.f : ex2(m[hf] - mn);  // m -inf -> 0
    m[hf] = mn;
  }
  // a row with every key masked so far subtracts 0: its p are all 0
  const float m0 = m[0] == -INFINITY ? 0.f : m[0];
  const float m1 = m[1] == -INFINITY ? 0.f : m[1];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[j][e] - (e >> 1 ? m1 : m0));
      s[j][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + rs[hf];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    o[dn][0] *= alpha[0];
    o[dn][1] *= alpha[0];
    o[dn][2] *= alpha[1];
    o[dn][3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const bf16* vp = vt + (kw + kk * 16 + (lane & 15)) * KST + 8 * (lane >> 4);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(vp + dn * 16, b0, b1, b2, b3);
      mma_bf16_16816(o[2 * dn], a0, a1, a2, a3, b0, b1);
      mma_bf16_16816(o[2 * dn + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// A warp's (m, l, O) rows into the stash (l summed over the quad first).
template <int D, int NW>
__device__ __forceinline__ void stash_warp(float* stash, int warp, int lane,
                                           const float (&o)[D / 8][4],
                                           const float (&m)[2], float (&l)[2]) {
  constexpr int OST = D + 4;
  const int g = lane >> 2, t4 = lane & 3;
  float* os = stash + warp * 16 * OST;
  float* ml = stash + NW * 16 * OST + warp * 32;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(os + (g + 8 * hf) * OST + dn * 8 + 2 * t4) =
          make_float2(o[dn][2 * hf], o[dn][2 * hf + 1]);
    if (t4 == 0) {
      ml[2 * (g + 8 * hf)] = m[hf];
      ml[2 * (g + 8 * hf) + 1] = l[hf];
    }
  }
}

// Row rr of row group rg, dims c*8..c*8+7, merged over the ks warps that
// hold it (warp rg + i * rgp, i = 0..ks-1, in that order): returns the
// merged max M and sum L and leaves the unnormalized O in acc.
template <int D, int NW>
__device__ __forceinline__ void merge_row(const float* stash, int rg, int rgp,
                                          int ks, int rr, int c, float& M,
                                          float& L, float (&acc)[8]) {
  constexpr int OST = D + 4;
  const float* ml = stash + NW * 16 * OST;
  M = -INFINITY;
  for (int i = 0; i < ks; ++i)
    M = fmaxf(M, ml[2 * ((rg + i * rgp) * 16 + rr)]);
  L = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) acc[d] = 0.f;
  if (M == -INFINITY) return;
  for (int i = 0; i < ks; ++i) {
    const int w = rg + i * rgp;
    const float mw = ml[2 * (w * 16 + rr)];
    if (mw == -INFINITY) continue;
    const float f = exp2f(mw - M);
    L += f * ml[2 * (w * 16 + rr) + 1];
    const float4* op =
        reinterpret_cast<const float4*>(stash + (w * 16 + rr) * OST + c * 8);
    const float4 a = op[0], b = op[1];
    acc[0] += f * a.x;
    acc[1] += f * a.y;
    acc[2] += f * a.z;
    acc[3] += f * a.w;
    acc[4] += f * b.x;
    acc[5] += f * b.y;
    acc[6] += f * b.z;
    acc[7] += f * b.w;
  }
}

__device__ __forceinline__ void store_bf16x8(bf16* p, const float (&v)[8],
                                             float inv) {
  uint4 w;
  w.x = pack_bf16(v[0] * inv, v[1] * inv);
  w.y = pack_bf16(v[2] * inv, v[3] * inv);
  w.z = pack_bf16(v[4] * inv, v[5] * inv);
  w.w = pack_bf16(v[6] * inv, v[7] * inv);
  *reinterpret_cast<uint4*>(p) = w;
}

// ---------------------------------------------------------------------------
// B1 (fused) and B4: one-token decode attention, split over the context.
// Grid (B, KV, S): split s of batch row b and KV head h covers key
// positions [s * chunk, (s + 1) * chunk) of [lo, tot]; S and chunk come
// from the shapes alone (the wrapper never reads seq_lens), so a launch
// can be captured in a CUDA graph. The block's 4 warps take 16 keys each
// of every 64-key tile for all G query heads of the KV head (the G heads
// are the 16 rows of the mma tiles, so every warp works at G 1 too) and
// merge in shared memory. With S > 1 each block writes its partial (m, l,
// unnormalized O, f32) to scratch and a second launch merges the S
// partials of each (b, h) in split order (bit-equal run to run); a second
// small launch was chosen over a last-block ticket counter because it
// needs no persistent, self-resetting counters and no fences, and the
// kernels stay idempotent under graph replay. With S = 1 the block writes
// the output itself. Fused (B1): rows < tot from the pool, the new token
// (position tot) from k/v at the value its pool encoding holds, and split
// 0 appends the row after its reads (no block reads slot tot from the
// pool). Not fused (B4): every row from the pool, the new token's
// included. A split that starts beyond its row's context writes an empty
// partial (m = -inf, l = 0). PARTIALS (a template parameter, so the
// other instantiations compile to the kernel without it; the ring KV
// decode on a rank's local table): a table entry < 0 is a masked page:
// its keys count nowhere (the new token's too, fused) and the tile that
// holds it takes the masked path; the local tables mark the pages another
// rank owns so. Every split then writes its partial (m in base 2, l,
// unnormalized O) even at S = 1 and no merge follows: the ring merges
// the dp ranks' splits (`decode_merge_kernel`). Without it an entry < 0
// reads page 0, its keys masked by position alone (a padded bucket row
// attends page 0's first key).
// ---------------------------------------------------------------------------

template <int D, typename PT, bool PARTIALS>
__global__ void __launch_bounds__(ATT_WARPS * 32)
decode_kernel(const bf16* __restrict__ q, PT* __restrict__ pool,
              const bf16* __restrict__ knew, const bf16* __restrict__ vnew,
              const int* __restrict__ block_tables,
              const int* __restrict__ seq_lens,
              const uint8_t* __restrict__ valid, bf16* __restrict__ out,
              float* __restrict__ part_o, float2* __restrict__ part_ml,
              int fused, int layer, int P, int page, int M, int mp, int KV,
              int G, float scale, int window, float softcap, int chunk) {
  using IO = PoolIO<PT>;
  constexpr int NST = DEC_STAGES;
  using R = Ring<D, PT, NST, ATT_WARPS>;
  constexpr int NT = R::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const R ring{smem};

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;
  const int H = KV * G, khalf = KV * D;
  const int tot = seq_lens[b];
  const int lo = window > 0 ? max(tot + 1 - window, 0) : 0;
  const int start = max(lo, s * chunk);
  const int end = min(tot + 1, s * chunk + chunk);
  const int ntiles = start < end ? (end - start + BK - 1) / BK : 0;
  const int* bt = block_tables + int64_t(b) * mp;
  const bf16* krow = knew + (int64_t(b) * KV + h) * D;
  const bf16* vrow = vnew + (int64_t(b) * KV + h) * D;

  uint32_t qa[D / 16][4];
  const bf16* qb = q + (int64_t(b) * H + h * G) * D;
  load_q<D>(qa, g < G ? qb + g * D : nullptr,
            g + 8 < G ? qb + (g + 8) * D : nullptr, lane);
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  // page id of key position pos (-1: beyond the split or, PARTIALS, a
  // masked page: zeros, and the key counts nowhere)
  auto pid_of = [&](int pos) {
    const int pi = pos / page;
    return pos >= end ? -1 : pi < mp ? (PARTIALS ? bt[pi] : max(bt[pi], 0)) : 0;
  };
  // the copies of tile i, from the page ids in its slot
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int st = i % NST, t0 = start + i * BK;
      const int* pid = ring.ptab(i);
#pragma unroll
      for (int j = 0; j < R::PER; ++j) {
        const int e = tid + j * NT, r = e / R::CPR, c = e % R::CPR;
        const int pos = t0 + r;
        if (!R::EXACT && e >= BK * R::CPR) break;
        if (fused && pos == tot && pos < end) {  // the new token, from the
          // input (never read back), at the value its pool encoding holds
          typename IO::Raw* kd =
              reinterpret_cast<typename IO::Raw*>(ring.kdst(st, r, c));
          typename IO::Raw* vd =
              reinterpret_cast<typename IO::Raw*>(ring.vdst(st, r, c));
#pragma unroll
          for (int u = 0; u < R::EPC / 8; ++u) {
            kd[u] = IO::from_bf16(ld16(krow + c * R::EPC + 8 * u));
            vd[u] = IO::from_bf16(ld16(vrow + c * R::EPC + 8 * u));
          }
        } else {
          ring.stage(st, r, c,
                     pid[r] < 0 ? nullptr
                                : pool + row_offset(layer, P, page, M, pid[r],
                                                    pos % page),
                     h, khalf);
        }
      }
    }
    __pipeline_commit();
  };

  for (int e = tid; e < NST * BK; e += NT)
    ring.ptab(e / BK)[e % BK] = pid_of(start + e);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) issue(i);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % NST;
    ring.land(st, tid, NT);
    issue(i + NST - 1);
    // the page ids of tile i + NST: loaded now, stored after the compute
    const int nxt = tid < BK ? pid_of(start + (i + NST) * BK + tid) : 0;
    const int t0 = start + i * BK;
    // every key in range, in the table (fused: slot tot needs none) and,
    // PARTIALS, on a page that is not masked
    const int last = t0 + BK - 1;
    const int* pid = ring.ptab(i);
    static_assert(BK == 64, "a lane checks two page ids of a tile");
    bool full = last < end && min(last, fused ? tot - 1 : tot) / page < mp;
    if constexpr (PARTIALS)
      full = __all_sync(0xffffffffu,
                        full && pid[lane] >= 0 && pid[lane + 32] >= 0);
    warp_tile<D, 16>(
        qa, ring.ktile(st), ring.vtile(st), warp * 16, full, scale, softcap,
        [&](int j, int) {
          const int kp = t0 + j;
          return kp < end && (!PARTIALS || pid[j] >= 0) &&
                 ((fused && kp == tot) || kp / page < mp);
        },
        o, m, l, lane);
    if (tid < BK) ring.ptab(i + NST)[tid] = nxt;
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is free: stash the warps' partials
  float* stash = reinterpret_cast<float*>(smem);
  stash_warp<D, ATT_WARPS>(stash, warp, lane, o, m, l);
  __syncthreads();
  for (int e = tid; e < G * (D / 8); e += NT) {
    const int rr = e / (D / 8), c = e % (D / 8);
    float Mx, L, acc[8];
    merge_row<D, ATT_WARPS>(stash, 0, 1, ATT_WARPS, rr, c, Mx, L, acc);
    if (S == 1 && !PARTIALS) {
      store_bf16x8(out + (int64_t(b) * H + h * G + rr) * D + c * 8, acc,
                   L > 0.f ? 1.f / L : 0.f);
    } else {
      const int64_t pr = ((int64_t(b) * KV + h) * S + s) * G + rr;
      float4* po = reinterpret_cast<float4*>(part_o + pr * D + c * 8);
      po[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      po[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      if (c == 0) part_ml[pr] = make_float2(Mx, L);
    }
  }

  // split 0 appends the new token's row (after this block's reads; no
  // block reads slot `tot` of this row from the pool)
  if (fused && s == 0 && valid[b]) {
    const int pi = tot / page;
    const int pid = pi < mp ? bt[pi] : -1;
    if (pid >= 0 && pid < P) {
      PT* row = pool + row_offset(layer, P, page, M, pid, tot % page);
      for (int c = tid; c < D / 8; c += NT) {
        IO::store(row + h * D + c * 8, IO::from_bf16(ld16(krow + c * 8)));
        IO::store(row + khalf + h * D + c * 8, IO::from_bf16(ld16(vrow + c * 8)));
      }
      if (h == 0)
        for (int e = 2 * khalf + tid * 8; e < M; e += NT * 8)
          IO::store(row + e, IO::zero());
    }
  }
}

// The split partials of each output row merged in split order -> out.
// Grid B * KV * G (one block per (b, h, g) row, whose partial s sits at
// ((b * KV + h) * S + s) * G + g), 64 threads over the D lanes.
__global__ void decode_merge_kernel(const float* __restrict__ part_o,
                                    const float2* __restrict__ part_ml,
                                    bf16* __restrict__ out, int G, int D,
                                    int S) {
  const int bh = blockIdx.x / G, gq = blockIdx.x % G;
  const int64_t p0 = int64_t(bh) * S * G + gq;
  float Mx = -INFINITY;
  for (int s = 0; s < S; ++s) Mx = fmaxf(Mx, part_ml[p0 + s * G].x);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, acc = 0.f;
    if (Mx != -INFINITY) {
      for (int s = 0; s < S; ++s) {
        const float2 ml = part_ml[p0 + s * G];
        if (ml.x == -INFINITY) continue;
        const float f = exp2f(ml.x - Mx);
        L += f * ml.y;
        acc += f * part_o[(p0 + s * G) * D + d];
      }
    }
    out[int64_t(blockIdx.x) * D + d] = __float2bfloat16(L > 0.f ? acc / L : 0.f);
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
// B5 and B2 (second launch), B3: prefill attention of a query block
// against the paged context. Grid (T / BQ, KV); a block holds BQ tokens x
// G heads = R <= 128 query rows (row r = token r / G, head r % G), 16 a
// warp in rgp = ceil(R / 16) row groups: 8 warps for more than 64 rows
// (fewer blocks re-read each head's K/V from L2), else 4; there, with
// rgp 1 or 2, ks = 4 / rgp warps share each row group, splitting every
// tile's keys (rgp 3, which the wrapper avoids where it can: warp 3 only
// copies). Keys [kstart, kend): the block stops at its last query's
// position.
//
// packed == 0 (B5): one sequence, token t at position q_pos[0] + t,
//   context `total`, table `bts` [mp].
// packed == 1 (B2, B3): token t belongs to Tq-block t / Tq of segment
//   block_seg[block] (-1 = dead block: output 0), position
//   block_qstart[block] + t % Tq, context total_lens[seg], table
//   bts[seg].
// ---------------------------------------------------------------------------

constexpr int PF_ROWS = 128;

template <int D, typename PT, int NW>
__global__ void __launch_bounds__(NW * 32)
prefill_attend_kernel(const bf16* __restrict__ q, const PT* __restrict__ pool,
                      const int* __restrict__ bts,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ block_seg,
                      const int* __restrict__ block_qstart,
                      const int* __restrict__ total_lens, int total_scalar,
                      bf16* __restrict__ out, int packed, int Tq, int BQ,
                      int layer, int P, int page, int M, int mp, int KV,
                      int G, float scale, int window, float softcap,
                      int rgp) {
  constexpr int NST = kPrefillStages<D>;
  using R = Ring<D, PT, NST, NW>;
  constexpr int NT = R::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const R ring{smem};

  const int h = blockIdx.y;
  const int ks = NW == 4 && rgp <= 2 ? 4 / rgp : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % rgp, kq = warp / rgp, nk = BK / ks;
  const bool active = warp < rgp * ks;  // rgp 3 of 4: warp 3 only copies
  const int g = lane >> 2;
  const int H = KV * G, khalf = KV * D;
  const int Rn = BQ * G;
  const int t_base = blockIdx.x * BQ;

  int q_start, total;
  const int* bt;
  if (packed) {
    const int blk = t_base / Tq;
    const int seg = block_seg[blk];
    if (seg < 0) {  // dead block: zero output, nothing read
      for (int e = tid; e < Rn * (D / 8); e += NT) {
        const int r = e / (D / 8);
        zero16(out + (int64_t(t_base + r / G) * H + h * G + r % G) * D +
               (e % (D / 8)) * 8);
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

  // this warp's rows rg*16 + g and + 8 (rows >= R are zero padding)
  const int r0 = rg * 16 + g, r1 = r0 + 8;
  uint32_t qa[D / 16][4];
  auto qrow = [&](int r) -> const bf16* {
    return r < Rn ? q + (int64_t(t_base + r / G) * H + h * G + r % G) * D
                  : nullptr;
  };
  load_q<D>(qa, qrow(r0), qrow(r1), lane);
  const int qp0 = q_start + r0 / G, qp1 = q_start + r1 / G;
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  const int kend = min(q_start + BQ, total);
  const int kstart = window > 0 ? max(q_start - window + 1, 0) : 0;
  const int ntiles = kstart < kend ? (kend - kstart + BK - 1) / BK : 0;
  const int qlast = q_start + BQ - 1;  // the block's last query position

  // page id of key position pos (-1: beyond the block's keys: zeros)
  auto pid_of = [&](int pos) {
    const int pi = pos / page;
    return pos >= kend ? -1 : pi < mp ? max(bt[pi], 0) : 0;
  };
  // the copies of tile i, from the page ids in its slot
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int st = i % NST, t0 = kstart + i * BK;
      const int* pid = ring.ptab(i);
#pragma unroll
      for (int j = 0; j < R::PER; ++j) {
        const int e = tid + j * NT, r = e / R::CPR;
        if (!R::EXACT && e >= BK * R::CPR) break;
        ring.stage(st, r, e % R::CPR,
                   pid[r] < 0 ? nullptr
                              : pool + row_offset(layer, P, page, M, pid[r],
                                                  (t0 + r) % page),
                   h, khalf);
      }
    }
    __pipeline_commit();
  };

  for (int e = tid; e < NST * BK; e += NT)
    ring.ptab(e / BK)[e % BK] = pid_of(kstart + e);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) issue(i);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % NST;
    ring.land(st, tid, NT);
    issue(i + NST - 1);
    // the page ids of tile i + NST: loaded now, stored after the compute
    const int nxt = tid < BK ? pid_of(kstart + (i + NST) * BK + tid) : 0;
    const int t0 = kstart + i * BK;
    // below the diagonal of every row, inside the window and the table
    const bool full = t0 + BK <= kend && t0 + BK - 1 <= q_start &&
                      (t0 + BK - 1) / page < mp &&
                      (window <= 0 || t0 > qlast - window);
    auto ok = [&](int j, int hf) {
      const int kp = t0 + j, qp = hf ? qp1 : qp0;
      return kp < kend && kp <= qp && kp / page < mp &&
             (window <= 0 || kp > qp - window);
    };
    const bf16* kt = ring.ktile(st);
    const bf16* vt = ring.vtile(st);
    if (active && nk == 64)
      warp_tile<D, 64>(qa, kt, vt, 0, full, scale, softcap, ok, o, m, l, lane);
    else if (active && nk == 32)
      warp_tile<D, 32>(qa, kt, vt, kq * 32, full, scale, softcap, ok, o, m, l,
                       lane);
    else if (active)
      warp_tile<D, 16>(qa, kt, vt, kq * 16, full, scale, softcap, ok, o, m, l,
                       lane);
    if (tid < BK) ring.ptab(i + NST)[tid] = nxt;
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is free: stash the warps' partials
  float* stash = reinterpret_cast<float*>(smem);
  stash_warp<D, NW>(stash, warp, lane, o, m, l);
  __syncthreads();
  for (int e = tid; e < Rn * (D / 8); e += NT) {
    const int r = e / (D / 8), c = e % (D / 8);
    float Mx, L, acc[8];
    merge_row<D, NW>(stash, r / 16, rgp, ks, r % 16, c, Mx, L, acc);
    store_bf16x8(out + (int64_t(t_base + r / G) * H + h * G + r % G) * D + c * 8,
                 acc, L > 0.f ? 1.f / L : 0.f);
  }
}

template <typename K>
int set_smem(K kernel, size_t smem, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  done = true;
  return 0;
}

// NW warps: 4 for blocks of up to 64 query rows, 8 up to 128
template <int D, typename PT, int NW>
int launch_prefill_nw(const void* q, const void* pool, const void* bts,
                      const void* q_pos, const void* block_seg,
                      const void* block_qstart, const void* total_lens,
                      int total, void* out, int packed, int T, int Tq, int BQ,
                      int layer, int P, int page, int M, int mp, int KV, int G,
                      float scale, int window, float softcap,
                      cudaStream_t stream) {
  static bool attr_set = false;
  const size_t smem = Ring<D, PT, kPrefillStages<D>, NW>::SMEM;
  if (const int e =
          set_smem(prefill_attend_kernel<D, PT, NW>, smem, attr_set))
    return e;
  dim3 grid(T / BQ, KV);
  prefill_attend_kernel<D, PT, NW><<<grid, NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const PT*>(pool),
      static_cast<const int*>(bts), static_cast<const int*>(q_pos),
      static_cast<const int*>(block_seg),
      static_cast<const int*>(block_qstart),
      static_cast<const int*>(total_lens), total, static_cast<bf16*>(out),
      packed, Tq, BQ, layer, P, page, M, mp, KV, G, scale, window, softcap,
      (BQ * G + 15) / 16);
  return int(cudaGetLastError());
}

template <int D, typename PT>
int launch_prefill(const void* q, const void* pool, const void* bts,
                   const void* q_pos, const void* block_seg,
                   const void* block_qstart, const void* total_lens,
                   int total, void* out, int packed, int T, int Tq, int BQ,
                   int layer, int P, int page, int M, int mp, int KV, int G,
                   float scale, int window, float softcap,
                   cudaStream_t stream) {
  return (BQ * G > 64 ? launch_prefill_nw<D, PT, 8> : launch_prefill_nw<D, PT, 4>)(
      q, pool, bts, q_pos, block_seg, block_qstart, total_lens, total, out,
      packed, T, Tq, BQ, layer, P, page, M, mp, KV, G, scale, window, softcap,
      stream);
}

template <int D, typename PT, bool PARTIALS = false>
int launch_decode(const void* q, void* pool, const void* k, const void* v,
                  const void* block_tables, const void* seq_lens,
                  const void* valid, void* out, void* part_o, void* part_ml,
                  int fused, int B, int layer, int P, int page, int M, int mp,
                  int KV, int G, float scale, int window, float softcap,
                  int S, int chunk, cudaStream_t stream) {
  static bool attr_set = false;
  const size_t smem = Ring<D, PT, DEC_STAGES, ATT_WARPS>::SMEM;
  if (const int e = set_smem(decode_kernel<D, PT, PARTIALS>, smem, attr_set))
    return e;
  dim3 grid(B, KV, S);
  decode_kernel<D, PT, PARTIALS><<<grid, ATT_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<PT*>(pool),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(out),
      static_cast<float*>(part_o), static_cast<float2*>(part_ml), fused,
      layer, P, page, M, mp, KV, G, scale, window, softcap, chunk);
  if (const cudaError_t e = cudaGetLastError()) return int(e);
  if (S > 1 && !PARTIALS)
    decode_merge_kernel<<<B * KV * G, 64, 0, stream>>>(
        static_cast<const float*>(part_o),
        static_cast<const float2*>(part_ml), static_cast<bf16*>(out), G, D,
        S);
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
// query heads, and its first LDV = 512 lanes are the value.
//
// What bounds it on an H100. Decode: the context's bytes and the tensor
// cores together -- DeepSeek-R1's 128 heads on one 576-lane row do
// 2 * 128 * (576 + 512) operations per 1152 bytes read, 242 a byte, near
// the card's 295 (989 TFLOP/s over 3.35 TB/s) -- so the products must run
// at the wgmma rate while the copies stream. Prefill: the tensor cores,
// and the key tiles' traffic from L2 (each key tile serves the rows of one
// block).
//
// The design. A block owns one tile of 64 (token, head) rows, wgmma's M:
// at decode 64 heads of one batch row (R1's 128 heads are 2 tiles, so the
// context is read twice, not four times; with 16 or 32 heads the rest of
// the tile is dead rows, computed and never stored); at prefill 64
// consecutive (token, head) rows of q (128 heads: 64 heads of one token;
// 32 heads: two tokens), each row under its own causal limit. Thread 0
// loads the block's query tile [64 x 576] once and keeps a ring of 2
// stages of key tiles in flight, each 64 keys x 576 lanes, by
// TMA (`cp.async.bulk.tensor`, a 2-D map over the pool's [L * P * page, M]
// rows, nine 64-lane boxes a tile, one box of page rows a page where a
// page holds fewer than 64 keys), completing on the stage's `full`
// mbarrier. bf16 tiles land in the 128-byte-swizzled layout wgmma reads;
// an e4m3 pool's byte tiles (36 KB, no swizzle) are converted once into
// one bf16 K=V tile by both warpgroups. Warpgroups 0 and 1 compute:
// S = Q K^T by wgmma m64n32k16 (36 k-steps, Q and K both K-major from
// shared memory), warpgroup h scoring keys 32h..32h+31 of the tile; the
// online softmax on the accumulator registers (scale and softcap in f32,
// base-2 exponentials), the row maxima exchanged between the warpgroups
// through shared memory; P rounded to bf16 into a swizzled [64 x 64] tile;
// O += P V by wgmma m64n128k16 with V the first 512 lanes of the same
// tile read MN-major (one tile, one copy, used twice), warpgroup h holding
// O's value lanes 256h..256h+255 in 128 f32 registers a thread (one
// warpgroup's 256 would exceed 255). The row sums are each warpgroup's
// partials, added at the end.
//
// Decode splits the context over blocks (grid (S, head tiles, B); the
// wrapper plans S from shapes alone, so the launch can be captured in a
// CUDA graph): a split covers `chunk` key positions (whole 64-key tiles),
// writes its partial (m, l, O[512]) to f32 scratch, and
// latent_merge_kernel merges a row's live splits in split order
// (deterministic). A split past a row's context exits at once; a row whose
// context one split holds is written by that split, as unsplit. Mode 0
// (B1) takes the new token from `knew` in every block that meets it (the
// tile's row is overwritten in shared memory, at the value its pool
// encoding holds), and exactly one block per batch row (head tile 0, the
// split holding the token) writes the new row to the pool after its own
// reads. Packed prefill's dead blocks zero their output rows and read
// nothing.
//
// A block: 256 threads, one block an SM (230,944 bytes of dynamic shared
// memory: the query tile, two bf16 stages or one bf16 tile and two byte
// stages, P, the exchange and the barriers). No producer warp: thread 0
// issues the copies between the block's barriers, so the two warpgroups
// keep up to 255 registers a thread (O alone is 128; with a producer warp
// in the block ptxas capped them at 168 and serialized the wgmma).
// ---------------------------------------------------------------------------

constexpr int LQK = 576;              // live lanes of a latent row (score dims)
constexpr int LDV = 512;              // value lanes (kv_lora_rank)
constexpr int LROWS = 64;             // (token, head) rows a tile: wgmma's M
constexpr int LNBOX = LQK / 64;       // 64-lane boxes a row
constexpr int LBOX = 64 * 128;        // bytes of a 64-row bf16 box
constexpr int LTILE = LNBOX * LBOX;   // a bf16 tile of 64 rows
constexpr int LSTAGES = 2;            // ring stages
constexpr int LTHREADS = 256;         // two warpgroups; thread 0 also issues the copies

template <typename PT>
struct LatentSmem {
  static constexpr bool FP8 = std::is_same<PT, e4m3>::value;
  static constexpr int STAGE = FP8 ? BK * LQK : LTILE;  // a ring stage
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_T = LTILE;  // e4m3: the bf16 tile the bytes become
  static constexpr int OFF_RING = FP8 ? 2 * LTILE : LTILE;
  static constexpr int OFF_P = OFF_RING + LSTAGES * STAGE;
  static constexpr int OFF_RED = OFF_P + LROWS * 128;  // f32 [2][64]
  static constexpr int OFF_BAR = OFF_RED + 2 * LROWS * 4;
  static constexpr int TOTAL = OFF_BAR + (LSTAGES + 1) * 8 + 1024;
  static_assert(OFF_RING % 1024 == 0 && OFF_P % 1024 == 0, "atoms 1024-aligned");
  static_assert(TOTAL <= 227 * 1024, "shared memory");
};

enum LatentMode { L_DECODE_FUSED = 0, L_DECODE = 1, L_PREFILL = 2, L_PACKED = 3 };

struct LatentArgs {
  const bf16* q;            // [nrows * H, 576]
  void* pool;               // [L, P, page, M]
  const bf16* knew;         // [B, 576] (mode 0)
  const int* bts;
  const int* pos_in;        // seq_lens [B] or q_pos [T]
  const uint8_t* valid;
  const int* block_seg;
  const int* block_qstart;
  const int* total_lens;
  bf16* out;                // [nrows * H, 512]
  float* part_o;            // decode, S > 1: [B, S, H, 512]
  float2* part_ml;          // [B, S, H] (m in log2 units, l)
  int mode, total, nrows, Tq, H, L, layer, P, page, M, mp, window, S, chunk;
  float scale, softcap;
};

template <typename PT>
__global__ void __launch_bounds__(LTHREADS, 1)
latent_kernel(const __grid_constant__ CUtensorMap tmq,
              const __grid_constant__ CUtensorMap tmk, const LatentArgs a) {
  using IO = PoolIO<PT>;
  using Sm = LatentSmem<PT>;
  constexpr bool FP8 = Sm::FP8;
  extern __shared__ uint8_t lsm_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(lsm_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* qs = sm + Sm::OFF_Q;
  uint8_t* ring = sm + Sm::OFF_RING;
  uint8_t* ps = sm + Sm::OFF_P;
  float* red = reinterpret_cast<float*>(sm + Sm::OFF_RED);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Sm::OFF_BAR);
  uint64_t* qbar = full + LSTAGES;

  const int tid = threadIdx.x;
  const int H = a.H;
  const bool decode = a.mode == L_DECODE_FUSED || a.mode == L_DECODE;
  const bool fused = a.mode == L_DECODE_FUSED;

  // the tile: flat q rows [f0, f0 + live), their positions (row r: q_start
  // + r / RT), the context [.., total) and the keys [kbeg, wend) it walks
  int f0, live, q_start, total, kstart, kend, RT, b = 0, split = 0;
  const int* bt;
  if (decode) {
    split = blockIdx.x;
    b = blockIdx.z;
    f0 = b * H + blockIdx.y * LROWS;
    live = min(LROWS, H - int(blockIdx.y) * LROWS);
    RT = LROWS;
    q_start = a.pos_in[b];
    total = q_start + 1;
    kstart = a.window > 0 ? max(total - a.window, 0) : 0;
    kend = total;
    bt = a.bts + int64_t(b) * a.mp;
  } else {
    f0 = blockIdx.x * LROWS;
    live = min(LROWS, a.nrows * H - f0);
    RT = min(H, LROWS);
    const int t_first = f0 / H;
    const int ntok = (live + RT - 1) / RT;
    if (a.mode == L_PACKED) {
      const int blk = t_first / a.Tq;
      const int seg = a.block_seg[blk];
      if (seg < 0) {  // dead block: zero output, nothing read
        for (int e = tid; e < live * (LDV / 8); e += LTHREADS)
          *reinterpret_cast<uint4*>(a.out + int64_t(f0 + e / (LDV / 8)) * LDV +
                                    (e % (LDV / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
        return;
      }
      q_start = a.block_qstart[blk] + t_first % a.Tq;
      total = a.total_lens[seg];
      bt = a.bts + int64_t(seg) * a.mp;
    } else {
      q_start = a.pos_in[0] + t_first;
      total = a.total;
      bt = a.bts;
    }
    kend = min(q_start + ntok, total);
    kstart = a.window > 0 ? max(q_start - a.window + 1, 0) : 0;
  }
  int kbeg = kstart & ~(BK - 1), wend = kend;
  if (decode && a.S > 1) {
    kbeg = max(kbeg, split * a.chunk);
    wend = min(kend, split * a.chunk + a.chunk);
  }
  const int nt = wend > kbeg ? (wend - kbeg + BK - 1) / BK : 0;
  if (decode && a.S > 1 && nt == 0) return;  // a split past the row's context

  if (tid == 0) {
    for (int s = 0; s < LSTAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues the copies: the query tile and the first two key
  // tiles now, tile i + 1 in iteration i once both warpgroups are done
  // with the stage it reuses (no producer warp: the consumers keep every
  // register, 255 a thread)
  const int br = min(a.page, BK);  // key rows a box
  const int64_t lrow = int64_t(a.layer) * a.P;
  auto load_tile = [&](int i) {
    const int s = i % LSTAGES;
    uint8_t* dst = ring + s * Sm::STAGE;
    const int t0 = kbeg + i * BK;
    mbar_arrive_tx(&full[s], Sm::STAGE);
    for (int c = 0; c < BK; c += br) {
      const int pos = t0 + c;
      const int pi = pos / a.page;
      int pid = pi < a.mp ? bt[pi] : 0;
      if (pid < 0 || pid >= a.P) pid = 0;  // a masked page
      const int row = int((lrow + pid) * a.page + pos % a.page);
#pragma unroll
      for (int j = 0; j < LNBOX; ++j) {
        if constexpr (FP8)
          tma_load_2d(dst + j * (BK * 64) + c * 64, &tmk, &full[s], j * 64, row);
        else
          tma_load_2d(dst + j * LBOX + c * 128, &tmk, &full[s], j * 64, row);
      }
    }
  };
  if (tid == 0 && nt > 0) {
    prefetch_tmap(&tmq);
    prefetch_tmap(&tmk);
    mbar_arrive_tx(qbar, LTILE);
    for (int j = 0; j < LNBOX; ++j) tma_load_2d(qs + j * LBOX, &tmq, qbar, j * 64, f0);
    for (int i = 0; i < min(nt, LSTAGES); ++i) load_tile(i);
  }

  const int h = tid >> 7;  // warpgroup: keys 32h.. of a tile's scores, value lanes 256h..
  const int wtid = tid & 127, wq = wtid >> 5, lane = tid & 31;
  // accumulator layout (m64nN): acc[4 * n8 + 2 * hi + e] holds row
  // 16 * wq + lane / 4 + 8 * hi and column 8 * n8 + 2 * (lane % 4) + e
  const int r0 = 16 * wq + (lane >> 2), r1 = r0 + 8;
  const int qp0 = q_start + r0 / RT, qp1 = q_start + r1 / RT;
  float o[2][64];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 64; ++e) o[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (nt > 0) mbar_wait(qbar, 0);
  const uint32_t qa = smem_u32(qs), pa = smem_u32(ps);
  for (int i = 0; i < nt; ++i) {
    const int s = i % LSTAGES;
    const int t0 = kbeg + i * BK;
    const int nr = fused ? q_start - t0 : -1;  // the new token's row of the tile
    const bool patch = nr >= 0 && nr < BK;
    mbar_wait(&full[s], (i / LSTAGES) & 1);
    uint8_t* kv = ring + s * Sm::STAGE;
    if constexpr (FP8) {
      // the byte tile -> the bf16 tile, once (both warpgroups are done
      // with the previous tile first); then the byte stage takes tile i + 2
      uint8_t* tb = sm + Sm::OFF_T;
      named_bar_sync(1, 256);
      for (int e = tid; e < LNBOX * BK * 8; e += 256) {
        const int j = e / (BK * 8), r = (e >> 3) % BK, c = e & 7;
        const uint4 v =
            (patch && r == nr)
                ? IO::to_bf16(IO::from_bf16(ld16(a.knew + int64_t(b) * LQK + j * 64 + c * 8)))
                : IO::to_bf16(*reinterpret_cast<const typename IO::Raw*>(
                      kv + j * (BK * 64) + r * 64 + c * 8));
        *reinterpret_cast<uint4*>(tb + j * LBOX + r * 128 + ((c ^ (r & 7)) << 4)) = v;
      }
      fence_proxy_async();  // wgmma reads what the generic proxy wrote
      named_bar_sync(1, 256);
      if (tid == 0 && i + LSTAGES < nt) load_tile(i + LSTAGES);
      kv = tb;
    } else if (patch) {
      // the new token's row from knew, not from the pool
      for (int e = tid; e < LNBOX * 8; e += 256) {
        const int j = e >> 3, c = e & 7;
        *reinterpret_cast<uint4*>(kv + j * LBOX + nr * 128 + ((c ^ (nr & 7)) << 4)) =
            ld16(a.knew + int64_t(b) * LQK + j * 64 + c * 8);
      }
      fence_proxy_async();
      named_bar_sync(1, 256);
    }
    const uint32_t ka = smem_u32(kv);
    // the descriptors' bases, opaque to the compiler each tile: no Q or P
    // descriptor is hoisted out of the loop to sit in registers O needs
    uint32_t qa_t = qa, pa_t = pa, kb_t = ka + h * 32 * 128;
    asm volatile("" : "+r"(qa_t), "+r"(pa_t), "+r"(kb_t));

    // S = Q K^T over this warpgroup's 32 keys: 36 k-steps of 16 lanes in
    // two accumulator chains (even and odd steps), summed after
    float sc[16], sc2[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] = sc2[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < LQK / 16; kk += 2) {
      const uint32_t off = (kk >> 2) * LBOX + (kk & 3) * 32;
      wgmma_m64n32<0, 0>(sc, sw128_desc(qa_t + off, 16, 1024),
                         sw128_desc(kb_t + off, 16, 1024));
      wgmma_m64n32<0, 0>(sc2, sw128_desc(qa_t + off + 32, 16, 1024),
                         sw128_desc(kb_t + off + 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(sc2);
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] += sc2[e];

    // mask, scale, softcap; row maxima over both warpgroups
    const bool in_table = (t0 + BK - 1) / a.page < a.mp;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = t0 + 32 * h + 8 * n8 + 2 * (lane & 3) + (e & 1);
        const int qp = e >> 1 ? qp1 : qp0;
        bool ok = kp <= qp && kp < total;
        if (!(fused && kp == q_start)) ok = ok && (in_table || kp / a.page < a.mp);
        if (a.window > 0) ok = ok && kp > qp - a.window;
        float v = sc[4 * n8 + e] * a.scale;
        if (a.softcap > 0.f) v = tanhf(v / a.softcap) * a.softcap;
        v = ok ? v * LOG2E : -INFINITY;
        sc[4 * n8 + e] = v;
        if (e >> 1)
          mx1 = fmaxf(mx1, v);
        else
          mx0 = fmaxf(mx0, v);
      }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    if ((lane & 3) == 0) {
      red[h * LROWS + r0] = mx0;
      red[h * LROWS + r1] = mx1;
    }
    named_bar_sync(1, 256);
    // both warpgroups are done with tile i - 1: its bf16 stage takes tile i + 1
    if constexpr (!FP8)
      if (tid == 0 && i >= 1 && i + 1 < nt) load_tile(i + 1);
    const float mn0 = fmaxf(m0, fmaxf(mx0, red[(1 - h) * LROWS + r0]));
    const float mn1 = fmaxf(m1, fmaxf(mx1, red[(1 - h) * LROWS + r1]));
    const float al0 = mn0 == -INFINITY ? 1.f : ex2(m0 - mn0);  // m -inf -> 0
    const float al1 = mn1 == -INFINITY ? 1.f : ex2(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = sc[4 * n8 + e];
        const float p = v == -INFINITY ? 0.f : ex2(v - (e >> 1 ? mn1 : mn0));
        sc[4 * n8 + e] = p;
        if (e >> 1)
          ls1 += p;
        else
          ls0 += p;
      }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
    m0 = mn0;
    m1 = mn1;
    // P in bf16, K-major and swizzled: row r's 64 keys are 128 bytes
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8) {
      const int ch = 4 * h + n8;
      *reinterpret_cast<uint32_t*>(ps + r0 * 128 + ((ch ^ (r0 & 7)) << 4) + 4 * (lane & 3)) =
          pack_bf16(sc[4 * n8], sc[4 * n8 + 1]);
      *reinterpret_cast<uint32_t*>(ps + r1 * 128 + ((ch ^ (r1 & 7)) << 4) + 4 * (lane & 3)) =
          pack_bf16(sc[4 * n8 + 2], sc[4 * n8 + 3]);
    }
    fence_proxy_async();
    named_bar_sync(1, 256);  // both halves of P are written

    // O = O * alpha + P V over this warpgroup's 256 value lanes
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8) {
        o[j][4 * n8] *= al0;
        o[j][4 * n8 + 1] *= al0;
        o[j][4 * n8 + 2] *= al1;
        o[j][4 * n8 + 3] *= al1;
      }
    wgmma_fence();
    const uint32_t va = ka + 4 * h * LBOX;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = sw128_desc(pa_t + kk * 32, 16, 1024);
      wgmma_m64n128<0, 1>(o[0], da, sw128_desc(va + kk * 2048, LBOX, 1024));
      wgmma_m64n128<0, 1>(o[1], da, sw128_desc(va + 2 * LBOX + kk * 2048, LBOX, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o[0]);
    fence_regs(o[1]);
  }

  // row sums: the quad's, then the other warpgroup's
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  if ((lane & 3) == 0) {
    red[h * LROWS + r0] = l0;
    red[h * LROWS + r1] = l1;
  }
  named_bar_sync(1, 256);
  const float L0 = l0 + red[(1 - h) * LROWS + r0];
  const float L1 = l1 + red[(1 - h) * LROWS + r1];

  // a split decode writes partials for the merge, but a row whose context
  // lies in one split (this block's) writes its output here, as unsplit
  const bool partial =
      decode && a.S > 1 && kstart / a.chunk != (kend - 1) / a.chunk;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = hi ? r1 : r0;
    if (r >= live) continue;  // a dead row: never stored
    if (partial) {
      const int64_t pr = (int64_t(b) * a.S + split) * H + blockIdx.y * LROWS + r;
      float* po = a.part_o + pr * LDV + 256 * h + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int n8 = 0; n8 < 16; ++n8)
          *reinterpret_cast<float2*>(po + 128 * j + 8 * n8) =
              make_float2(o[j][4 * n8 + 2 * hi], o[j][4 * n8 + 2 * hi + 1]);
      if (h == 0 && (lane & 3) == 0) a.part_ml[pr] = make_float2(hi ? m1 : m0, hi ? L1 : L0);
    } else {
      const float Lr = hi ? L1 : L0;
      const float inv = Lr > 0.f ? 1.f / Lr : 0.f;
      bf16* op = a.out + int64_t(f0 + r) * LDV + 256 * h + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int n8 = 0; n8 < 16; ++n8)
          *reinterpret_cast<__nv_bfloat162*>(op + 128 * j + 8 * n8) = __floats2bfloat162_rn(
              o[j][4 * n8 + 2 * hi] * inv, o[j][4 * n8 + 2 * hi + 1] * inv);
    }
  }

  // B1: append the new latent row [c_kv | k_pe | 0-pad] after this block's
  // reads; one block per batch row: head tile 0, the split holding the token
  if (fused && blockIdx.y == 0 && (a.S == 1 || split == q_start / a.chunk) && a.valid[b]) {
    const int pi = q_start / a.page;
    const int pid = pi < a.mp ? bt[pi] : -1;
    if (pid >= 0 && pid < a.P) {
      PT* row = static_cast<PT*>(a.pool) +
                row_offset(a.layer, a.P, a.page, a.M, pid, q_start % a.page);
      for (int c = tid; c < a.M / 8; c += 256) {
        typename IO::Raw v = IO::zero();
        if (c < LQK / 8) v = IO::from_bf16(ld16(a.knew + int64_t(b) * LQK + c * 8));
        IO::store(row + c * 8, v);
      }
    }
  }
}

// The split partials of each (batch row, head) merged in split order ->
// out. Grid B * H, 128 threads of 4 value lanes; only the splits the
// row's context reaches (those latent_kernel ran) are read, and a row
// that one split holds is left as latent_kernel wrote it.
__global__ void latent_merge_kernel(const float* __restrict__ part_o,
                                    const float2* __restrict__ part_ml,
                                    const int* __restrict__ seq_lens,
                                    bf16* __restrict__ out, int H, int S,
                                    int chunk, int window) {
  const int b = blockIdx.x / H, head = blockIdx.x % H;
  const int kend = seq_lens[b] + 1;
  const int kstart = window > 0 ? max(kend - window, 0) : 0;
  const int s_lo = kstart / chunk, s_hi = min((kend - 1) / chunk, S - 1);
  if (s_lo == s_hi) return;  // one split: latent_kernel wrote the row
  const int64_t p0 = int64_t(b) * S * H + head;  // split s at p0 + s * H
  const int n = s_hi - s_lo + 1;
  // the splits' (m, l) read in parallel into shared memory, the largest m
  // reduced in split order, then each split's weight f = 2^(m - max)
  extern __shared__ float mw[];  // [n] m, then [n] f
  __shared__ float red_m[LDV / 4 / 32];
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 ml = part_ml[p0 + int64_t(s_lo + i) * H];
    mw[i] = ml.x;
    mw[n + i] = ml.y;
    mx = fmaxf(mx, ml.x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red_m[threadIdx.x >> 5] = mx;
  __syncthreads();
  const float Mx = fmaxf(fmaxf(red_m[0], red_m[1]), fmaxf(red_m[2], red_m[3]));
  for (int i = threadIdx.x; i < n; i += blockDim.x)  // l -> f * l, m -> f
    if (mw[i] == -INFINITY || Mx == -INFINITY) {
      mw[i] = 0.f;
      mw[n + i] = 0.f;
    } else {
      const float f = exp2f(mw[i] - Mx);
      mw[i] = f;
      mw[n + i] *= f;
    }
  __syncthreads();
  const int d = threadIdx.x * 4;
  float L = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float f = mw[i];
    L += mw[n + i];
    if (f == 0.f) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(part_o + (p0 + int64_t(s_lo + i) * H) * LDV + d);
    acc[0] += f * v.x;
    acc[1] += f * v.y;
    acc[2] += f * v.z;
    acc[3] += f * v.w;
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(out + int64_t(blockIdx.x) * LDV + d);
  op[0] = __floats2bfloat162_rn(acc[0] * inv, acc[1] * inv);
  op[1] = __floats2bfloat162_rn(acc[2] * inv, acc[3] * inv);
}

template <typename PT>
int launch_latent(const LatentArgs& a, cudaStream_t stream) {
  using Sm = LatentSmem<PT>;
  constexpr bool FP8 = Sm::FP8;
  const bool decode = a.mode == L_DECODE_FUSED || a.mode == L_DECODE;
  if (a.M < LQK || (a.M * int(sizeof(PT))) % 16 || !aligned16(a.pool) || !aligned16(a.q))
    return NOT_SUPPORTED;
  if (a.H % 16 || (a.H % LROWS && LROWS % a.H)) return NOT_SUPPORTED;
  if (!(a.page % BK == 0 || (BK % a.page == 0 && a.page % 8 == 0))) return NOT_SUPPORTED;
  if (a.mode == L_PACKED && a.Tq % max(1, LROWS / a.H)) return NOT_SUPPORTED;
  if (decode && (a.S < 1 || (a.S > 1 && (a.chunk <= 0 || a.chunk % BK || !a.part_o ||
                                         !a.part_ml))))
    return NOT_SUPPORTED;
  if (a.nrows <= 0) return 0;
  CUtensorMap tmq, tmk;
  MapKey kq;
  memset(&kq, 0, sizeof(kq));
  kq.base = a.q;
  kq.rows = uint64_t(a.nrows) * a.H;
  kq.cols = LQK;
  kq.box0 = 64;
  kq.box1 = LROWS;
  kq.bf16 = 1;
  kq.swz = 1;
  if (const int rc = cached_map<ACT_MAPS>(&tmq, kq)) return rc;
  MapKey kk;
  memset(&kk, 0, sizeof(kk));
  kk.base = a.pool;
  kk.rows = uint64_t(a.L) * a.P * a.page;
  kk.cols = uint64_t(a.M);
  kk.box0 = 64;
  kk.box1 = uint32_t(min(a.page, BK));
  kk.bf16 = !FP8;
  kk.swz = !FP8;
  if (const int rc = cached_map<WEIGHT_MAPS>(&tmk, kk)) return rc;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        latent_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::TOTAL);
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  const int htiles = (a.H + LROWS - 1) / LROWS;
  const dim3 grid = decode ? dim3(a.S, htiles, a.nrows)
                           : dim3((a.nrows * a.H + LROWS - 1) / LROWS, 1, 1);
  latent_kernel<PT><<<grid, LTHREADS, Sm::TOTAL, stream>>>(tmq, tmk, a);
  if (const cudaError_t e = cudaGetLastError()) return int(e);
  if (decode && a.S > 1)
    latent_merge_kernel<<<a.nrows * a.H, LDV / 4, 2 * a.S * sizeof(float), stream>>>(
        a.part_o, a.part_ml, a.pos_in, a.out, a.H, a.S, a.chunk, a.window);
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

// decode geometry: G <= 16 query heads a KV head (the mma rows), S >= 1
// splits of `chunk` key positions (a multiple of 64), and the partials'
// scratch when S > 1: part_o [B, KV, S, G, D] f32, part_ml [B, KV, S, G]
// (m, l) f32 pairs
static bool decode_ok(int G, int S, int chunk, const void* part_o,
                      const void* part_ml) {
  return G >= 1 && G <= 16 && S >= 1 && chunk > 0 && chunk % BK == 0 &&
         (S == 1 || (part_o && part_ml));
}

extern "C" int chitu_attend_decode_fused(
    const void* q, void* pool, const void* k, const void* v,
    const void* block_tables, const void* seq_lens, const void* valid,
    void* out, void* part_o, void* part_ml, int B, int layer, int P,
    int page, int M, int mp, int KV, int G, int D, float scale, int window,
    float softcap, int fp8, int S, int chunk, void* stream) {
  if (!decode_ok(G, S, chunk, part_o, part_ml)) return kUnsupported;
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return with_head_dim(D, [&](auto d) {
      return launch_decode<decltype(d)::value, PT>(
          q, pool, k, v, block_tables, seq_lens, valid, out, part_o, part_ml,
          1, B, layer, P, page, M, mp, KV, G, scale, window, softcap, S,
          chunk, static_cast<cudaStream_t>(stream));
    });
  });
}

extern "C" int chitu_attend_decode(
    const void* q, const void* pool, const void* block_tables,
    const void* seq_lens, void* out, void* part_o, void* part_ml, int B,
    int layer, int P, int page, int M, int mp, int KV, int G, int D,
    float scale, int window, float softcap, int fp8, int S, int chunk,
    void* stream) {
  if (!decode_ok(G, S, chunk, part_o, part_ml)) return kUnsupported;
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return with_head_dim(D, [&](auto d) {
      return launch_decode<decltype(d)::value, PT>(
          q, const_cast<void*>(pool), nullptr, nullptr, block_tables,
          seq_lens, nullptr, out, part_o, part_ml, 0, B, layer, P, page, M,
          mp, KV, G, scale, window, softcap, S, chunk,
          static_cast<cudaStream_t>(stream));
    });
  });
}

// B1 (fused 1) or B4 (fused 0) in its partials mode: every split's partial
// into part_o [B, KV, S, G, D] f32 and part_ml [B, KV, S, G] (m in base 2,
// l), S = 1 included; no merge. The ring KV decode runs it on a rank's
// local table (entries < 0: pages of other ranks).
extern "C" int chitu_attend_decode_partials(
    const void* q, void* pool, const void* k, const void* v,
    const void* block_tables, const void* seq_lens, const void* valid,
    void* part_o, void* part_ml, int fused, int B, int layer, int P,
    int page, int M, int mp, int KV, int G, int D, float scale, int window,
    float softcap, int fp8, int S, int chunk, void* stream) {
  if (!decode_ok(G, S, chunk, part_o, part_ml) || !part_o || !part_ml ||
      (fused && !(k && v && valid)))
    return kUnsupported;
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return with_head_dim(D, [&](auto d) {
      return launch_decode<decltype(d)::value, PT, true>(
          q, pool, k, v, block_tables, seq_lens, valid, nullptr, part_o,
          part_ml, fused, B, layer, P, page, M, mp, KV, G, scale, window,
          softcap, S, chunk, static_cast<cudaStream_t>(stream));
    });
  });
}

// S partials of each of the rows (b, h) x G merged in split order ->
// out [rows, G, D] bf16 (the second launch of B1 / B4, alone: the ring
// KV decode's merge of every dp rank's splits).
extern "C" int chitu_decode_merge(const void* part_o, const void* part_ml,
                                  void* out, int rows, int G, int D, int S,
                                  void* stream) {
  if (rows < 1 || G < 1 || G > 16 || S < 1 || D % 8) return kUnsupported;
  decode_merge_kernel<<<rows * G, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_o), static_cast<const float2*>(part_ml),
      static_cast<bf16*>(out), G, D, S);
  return int(cudaGetLastError());
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
// [nrows, 576] (mode 0 only); the pool [L, P, page, M]. Decode splits the
// context into S splits of `chunk` key positions (a multiple of 64) when
// S > 1, its partials in part_o [nrows, S, H, 512] f32 and part_ml
// [nrows, S, H] (m, l) f32 pairs.
extern "C" int chitu_attend_latent(
    int mode, const void* q, void* pool, const void* knew, const void* bts,
    const void* pos_in, const void* valid, const void* block_seg,
    const void* block_qstart, const void* total_lens, int total, void* out,
    void* part_o, void* part_ml, int nrows, int NB, int H, int L, int layer,
    int P, int page, int M, int mp, float scale, int window, float softcap,
    int fp8, int S, int chunk, void* stream) {
  if (mode < 0 || mode > 3) return kUnsupported;
  const int Tq = mode == 3 ? nrows / NB : nrows;
  if (mode == 3 && Tq * NB != nrows) return kUnsupported;
  LatentArgs a;
  memset(&a, 0, sizeof(a));
  a.q = static_cast<const bf16*>(q);
  a.pool = pool;
  a.knew = static_cast<const bf16*>(knew);
  a.bts = static_cast<const int*>(bts);
  a.pos_in = static_cast<const int*>(pos_in);
  a.valid = static_cast<const uint8_t*>(valid);
  a.block_seg = static_cast<const int*>(block_seg);
  a.block_qstart = static_cast<const int*>(block_qstart);
  a.total_lens = static_cast<const int*>(total_lens);
  a.out = static_cast<bf16*>(out);
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float2*>(part_ml);
  a.mode = mode;
  a.total = total;
  a.nrows = nrows;
  a.Tq = Tq;
  a.H = H;
  a.L = L;
  a.layer = layer;
  a.P = P;
  a.page = page;
  a.M = M;
  a.mp = mp;
  a.window = window;
  a.S = mode <= 1 ? S : 1;
  a.chunk = chunk;
  a.scale = scale;
  a.softcap = softcap;
  return with_pool(fp8, [&](auto pt) {
    using PT = typename decltype(pt)::type;
    return launch_latent<PT>(a, static_cast<cudaStream_t>(stream));
  });
}
