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
// fp8-e4m3 bits. An e4m3 pool tile lands in shared memory as bytes
// (cp.async) and is converted to bf16 there once, with the card's native
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
// partial (m = -inf, l = 0).
// ---------------------------------------------------------------------------

template <int D, typename PT>
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

  // page id of key position pos (-1: beyond the split: zeros)
  auto pid_of = [&](int pos) {
    const int pi = pos / page;
    return pos >= end ? -1 : pi < mp ? max(bt[pi], 0) : 0;
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
    // every key in range and in the table (fused: slot tot needs none)
    const int last = t0 + BK - 1;
    const bool full =
        last < end && min(last, fused ? tot - 1 : tot) / page < mp;
    warp_tile<D, 16>(
        qa, ring.ktile(st), ring.vtile(st), warp * 16, full, scale, softcap,
        [&](int j, int) {
          const int kp = t0 + j;
          return kp < end && ((fused && kp == tot) || kp / page < mp);
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
    if (S == 1) {
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

template <int D, typename PT>
int launch_decode(const void* q, void* pool, const void* k, const void* v,
                  const void* block_tables, const void* seq_lens,
                  const void* valid, void* out, void* part_o, void* part_ml,
                  int fused, int B, int layer, int P, int page, int M, int mp,
                  int KV, int G, float scale, int window, float softcap,
                  int S, int chunk, cudaStream_t stream) {
  static bool attr_set = false;
  const size_t smem = Ring<D, PT, DEC_STAGES, ATT_WARPS>::SMEM;
  if (const int e = set_smem(decode_kernel<D, PT>, smem, attr_set)) return e;
  dim3 grid(B, KV, S);
  decode_kernel<D, PT><<<grid, ATT_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<PT*>(pool),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(out),
      static_cast<float*>(part_o), static_cast<float2*>(part_ml), fused,
      layer, P, page, M, mp, KV, G, scale, window, softcap, chunk);
  if (const cudaError_t e = cudaGetLastError()) return int(e);
  if (S > 1)
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
