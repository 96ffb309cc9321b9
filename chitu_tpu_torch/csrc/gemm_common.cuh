// Pieces shared by the GEMM kernels of quant_gemm.cu, moe_gemm.cu,
// dense_gemm.cu and absorb.cu and by the latent attention kernel of
// attention.cu: the block geometry, the 16-byte unions, the TMA, mbarrier
// and wgmma primitives, the tensor maps, and the Hopper GEMM mainloop (TMA
// + wgmma) that the dequant GEMM (B6+B7), the W8A8 int8 GEMM (B10), the
// grouped expert GEMM (B8) and the dense stacked-layer GEMM (B13) run; the
// MLA absorb kernel (B9) walks its own items with the same primitives. Every
// source that includes this header is rebuilt when it changes (the build
// hashes the headers with the source, ops/cuda_build.py).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int BN = 128;
constexpr int NOT_SUPPORTED = 100000;
constexpr int MAP_FAILED = 100001;  // cuTensorMapEncodeTiled refused the map

union Bytes16 {
  uint4 v;
  uint8_t b[16];
};

union Words4 {
  uint4 v;
  uint32_t u[4];
};

// two floats -> two bf16 (round to nearest even) in one word, a in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // one cvt.rn.bf16x2.f32
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

__host__ __device__ inline int aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }


// ===========================================================================
// The Hopper GEMM mainloop of B6+B7 (quant_gemm.cu), B8 (moe_gemm.cu) and
// B13 (dense_gemm.cu)
// ===========================================================================
//
//   out[m, n] = sum_k x[m, k] * W[k, n],   x bf16 [rows, K], W stored as
//   e4m3 / int8 / int4 (one nibble a byte, or packed two a byte) with scales
//   (and zeros), or bf16; f32 sums, f32 or bf16 out (+ a bias). B10
//   (MODE_S8): x int8 [rows, K] and W int8 [K, N], exact int32 sums by
//   `wgmma ... .s32.s8.s8` (k32), then f32(sum) * x_scale[m] * w_scale[n]
//   (+ a bias), or the raw sums.
//
// One block of 384 threads: warpgroups 0 and 1 consume, warp 8 (in
// warpgroup 2) produces; `setmaxnreg` gives the producer warpgroup 40
// registers and the consumers 232. The producer walks the block's K tiles
// through a ring of STAGES shared-memory stages: the weight tile and the x
// tile arrive by TMA (`cp.async.bulk.tensor`, one tensor map each, 128-byte
// swizzle), the tile's scale (and zero) rows by 4-byte cp.async, and all of
// it completes on the stage's `full` mbarrier (33 arrivals: the producer
// lane 0's expect_tx and one cp.async arrival a lane). A consumer
// warpgroup waits on `full`, converts its 64-column half of the raw tile to
// bf16 once -- one 16-byte shared load, the card's e4m3x2 convert (or the
// integer unpack), the scale (and zero) in f32, one bf16x2 round a pair,
// two 16-byte stores -- into a converted tile in the layout wgmma reads
// (MN-major, 128-byte swizzle), fences the async proxy, and issues
// `wgmma.mma_async` straight from shared memory. The products of tile i run
// while the warps convert tile i + 1; `wgmma.wait_group 1` then frees tile
// i - 1's stage (`empty` mbarrier, one arrival a consumer warp). bf16
// weights skip the conversion: TMA writes them in the converted layout.
//
// B10's operands: wgmma takes 8-bit A and B K-major only. x [T, K] is
// K-major as it lies and arrives by TMA as it is; W [K, N] (the JAX
// package's layout, N-major) arrives raw and the conversion step becomes a
// byte transpose: each warpgroup turns its 64 columns of the [128 k][128 n]
// raw tile into [64 n][128 k] K-major rows (16 4-byte loads, 4x4 byte
// transposes by `prmt`, 16-byte stores into the 128-byte swizzle). K tile
// 256 bytes at decode (half the per-tile handshakes of 128), 128 at the
// slab; the split-K partials are int32, summed in split order, exact.
//
// Two regimes (TN is the template's rows a tile):
// - slab (more than 64 rows; TN 128 or 256): a TN x 128 output tile, x is
//   A (K-major, one TN x 64 TMA box a stage), the converted weight is B
//   (MN-major, transpose bit set); each warpgroup owns TN / 2 rows in one
//   or two m64n128k16 tiles (64 f32 accumulators a thread each). K tile
//   64. Both warpgroups read the whole converted tile, so it is
//   triple-buffered; at 256 rows one conversion serves twice the products.
// - decode (64 rows or fewer): A and B swap. The converted weight tile is A
//   (64 output columns a warpgroup as wgmma's M, MN-major), x is B (the
//   TN = 16, 32 or 64 tokens as wgmma's N, K-major), so a 16-row decode
//   step wastes no tensor-core rows. K tile 128. K may be split over
//   grid.x: every split writes its partial tile to its own slab of a
//   workspace, takes a ticket, and the block that draws the last ticket
//   sums the slabs in split order (deterministic) and puts the counter
//   back to zero, so a launch can be captured and replayed in a CUDA graph.
//
// What bounds it on an H100 (scripts/torch_gemm_ablate.py, PERF.md): at
// decode the weight bytes and the per-tile handshake of one block an SM;
// at the slab the copies of x through L2 (every column tile reads all of
// x), the converted tile's round trip through shared memory and the
// conversion, before the tensor cores.
//
// What can go wrong, and what holds it:
// - wgmma descriptors: start address >> 4, LBO and SBO in 16-byte units,
//   layout 1 (128-byte swizzle). MN-major: LBO is the stride between
//   64-element atoms along M/N, SBO the stride between 8-row groups along
//   K (1024 bytes); K-major: SBO 1024 between 8-row groups, a k16 step
//   moves the start by 32 bytes inside the 1024-aligned atom. Every atom is
//   1024-byte aligned (base_offset 0). The converter writes 16-byte chunk
//   q of row r at chunk q ^ (r & 7), TMA's SWIZZLE_128B pattern.
// - mbarrier phases: a stage's k-th use waits parity k & 1; the producer's
//   k-th reuse waits `empty` for parity (k - 1) & 1.
// - tensor maps: weight maps are cached by pointer, shape and box; x's is
//   built every call (its pointer changes every call, so a cache would
//   only miss; the encode is a few hundred host nanoseconds). Maps go by
//   value as `const __grid_constant__ CUtensorMap`. A weight or x that a
//   map cannot describe (base not 16-byte aligned, row stride no multiple
//   of 16 bytes) is copied by the producer warp through cp.async (plain
//   loads at an unaligned edge) into the same layouts; the caller chooses
//   that by shape and pointer alone.
// - CUDA graphs: no launch reads device memory on the host or allocates;
//   the split-K counters return to zero in the launch that used them.

enum { MODE_FP8 = 0, MODE_INT8 = 1, MODE_INT4 = 2, MODE_INT4P = 3, MODE_BF16 = 4,
       MODE_S8 = 5 };
enum { SCALE_BLOCK = 0, SCALE_ROW = 1, SCALE_CHAN = 2 };
constexpr int WG_THREADS = 384;

struct WgParams {
  const __nv_bfloat16* x;    // [x_rows, K] (B10: int8)
  const uint8_t* w;          // w_rows rows of w_ld elements (bytes, or bf16)
  const float* scale;        // scale rows (per expert: scale_expert floats); B10: [N]
  const float* x_scale;      // B10: [x_rows]
  const float* zeros;        // int4: [K/B, N]
  const __nv_bfloat16* bias; // [N] or null
  const int* block_expert;   // [groups] (B8), or null (one group)
  void* out;                 // [x_rows, N] f32 or bf16
  float* ws;                 // split-K partial tiles
  int* counters;             // split-K tickets, one an output tile
  long long scale_expert;
  int x_rows, K, N, w_ld, w_rows;
  int bm;                    // rows of a group (B8: a dispatch block; B6/B7: T)
  int E, layer;              // B8: experts a layer; B8 and B13: the stack's layer
  int scale_mode, block, scale_ld, out_bf16;
  int out_i32;               // B10: store the raw int32 sums
  int ncol, splits;
  int tma_w, tma_x;
};

// TN: rows a tile. 16, 32, 64: the swapped decode tiles (TN tokens as
// wgmma's N); 128, 256: slab tiles (each warpgroup owns TN / 2 rows, in
// NSUB m64 tiles).
template <int MODE, int TN>
struct WgSmem {
  static constexpr bool SLAB = TN >= 128;
  static constexpr bool S8 = MODE == MODE_S8;              // B10: int8 x and W
  // K tile (elements); B10's decode tile 256 bytes deep, half the handshakes
  static constexpr int BK = S8 ? (SLAB ? 128 : 256) : (SLAB ? 64 : 128);
  static constexpr int XES = S8 ? 1 : 2;                   // bytes an x element
  static constexpr int ROWS = TN;                          // x rows a tile
  static constexpr int NSUB = SLAB ? TN / 128 : 1;         // m64 tiles a warpgroup
  static constexpr bool CONVERT = MODE != MODE_BF16;
  static constexpr bool ZEROS = MODE == MODE_INT4 || MODE == MODE_INT4P;
  static constexpr int RAWROW = MODE == MODE_INT4P ? 64 : 128;  // raw bytes a W row
  static constexpr int WSTAGE = CONVERT ? BK * RAWROW : 2 * BK * 128;
  static constexpr int XSTAGE = ROWS * BK * XES;
  static constexpr int GROUPS = CONVERT && !S8 ? BK / 32 : 0;  // most scale rows a tile
  static constexpr int SSTAGE = GROUPS * BN * 4 * (ZEROS ? 2 : 1);
  static constexpr int NC = CONVERT ? (SLAB ? 3 : 2) : 0;  // converted tiles
  // two 64-column bf16 atoms, or B10's [128 n][128 k] bytes
  static constexpr int CBUF = S8 ? BN * BK : BK * 128 * 2;
  static constexpr int PER = WSTAGE + XSTAGE + SSTAGE;
  static constexpr int FIXED = NC * CBUF + 1024 + 256;
  static constexpr int S0 = (227 * 1024 - FIXED) / PER;
  static constexpr int STAGES = S0 > 6 ? 6 : S0;
  static constexpr int OFF_X = STAGES * WSTAGE;
  static constexpr int OFF_C = OFF_X + STAGES * XSTAGE;
  static constexpr int OFF_S = OFF_C + NC * CBUF;
  static constexpr int OFF_BAR = OFF_S + STAGES * SSTAGE;
  static constexpr int TOTAL = OFF_BAR + 2 * STAGES * 8 + 16 + 1024;
  static_assert(STAGES >= 3, "ring too shallow");
  static_assert(WSTAGE % 1024 == 0 && XSTAGE % 1024 == 0 && CBUF % 1024 == 0,
                "atoms must stay 1024-byte aligned");
  static_assert(TOTAL <= 227 * 1024, "shared memory");
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait that has not ended after four seconds traps: a fault in the
// ring's phases shows as a launch error, never as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  uint64_t t0 = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if ((polls & 255) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// 4 bytes, zero-filled when src_bytes is 0 (nothing is read then)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// shared -> global through a 3-D tensor map; boxes past the tensor's edge
// are clipped (nothing is written there)
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared-memory sources (their
// global writes complete with the grid)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// fetch a tensor map's descriptor ahead of its first use
__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// ---- wgmma.mma_async (bf16 x bf16 -> f32, operands in shared memory) ----

// D[64 x N] += A * B, bf16 in, f32 sums, both operands in shared memory.
// TA / TB: 1 where A / B is MN-major (transposed), 0 where K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D[64 x TN] += A * B for a token tile of TN = 16, 32, 64 or 128 columns
template <int TN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[TN / 2], uint64_t da, uint64_t db) {
  if constexpr (TN == 16) wgmma_m64n16<TA, TB>(d, da, db);
  if constexpr (TN == 32) wgmma_m64n32<TA, TB>(d, da, db);
  if constexpr (TN == 64) wgmma_m64n64<TA, TB>(d, da, db);
  if constexpr (TN == 128) wgmma_m64n128<TA, TB>(d, da, db);
}


// ---- wgmma.mma_async (s8 x s8 -> s32, both operands K-major in shared memory) ----

__device__ __forceinline__ void wgmma_s8_m64n16(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n32(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x TN] += A * B in int32 for a token tile of TN = 16, 32, 64 or 128 columns
template <int TN>
__device__ __forceinline__ void wgmma_s8_tile(int (&d)[TN / 2], uint64_t da, uint64_t db) {
  if constexpr (TN == 16) wgmma_s8_m64n16(d, da, db);
  if constexpr (TN == 32) wgmma_s8_m64n32(d, da, db);
  if constexpr (TN == 64) wgmma_s8_m64n64(d, da, db);
  if constexpr (TN == 128) wgmma_s8_m64n128(d, da, db);
}

// ---- conversion -----------------------------------------------------------

// logical output column of local column j (0..127) of column tile bx.
// Packed int4 (`pack_int4_storage`): within each 512-column tile, byte
// column c holds column c in its low nibble and c + 256 in its high one; a
// tile reads 64 byte columns, local columns 0..63 are their low nibbles and
// 64..127 their high ones.
template <int MODE>
__device__ __forceinline__ int wg_col(int bx, int j) {
  if (MODE == MODE_INT4P) {
    const int c = bx * 64 + (j & 63);
    return ((c >> 8) << 9) + (c & 255) + (j >= 64 ? 256 : 0);
  }
  return bx * BN + j;
}

// e4m3 pair -> two floats through the card's e4m3x2 convert (exact)
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t pair) {
  __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)pair, __NV_E4M3);
  return __half22float2(*reinterpret_cast<__half2*>(&hr));
}

// 16 stored values (16 bytes; packed int4: this warpgroup's nibble of 16
// bytes) -> 16 bf16 (w - zero) * scale, rounded once as QTensor.dequantize
// rounds, in 8 words
template <int MODE>
__device__ __forceinline__ void convert16(uint4 raw, int hi, const float* sc,
                                          const float* zr, uint32_t* o) {
  const uint32_t wv[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t w = wv[q];
    float f[4];
    if (MODE == MODE_FP8) {
      const float2 a = e4m3x2_to_float2(w & 0xFFFFu);
      const float2 b = e4m3x2_to_float2(w >> 16);
      f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    } else if (MODE == MODE_INT4P) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t n = (w >> (8 * i + 4 * hi)) & 0xFu;
        f[i] = (float)n;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = (float)(int8_t)(w >> (8 * i));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = f[i];
      if (MODE == MODE_INT4 || MODE == MODE_INT4P) v -= zr[4 * q + i];
      f[i] = v * sc[4 * q + i];
    }
    o[2 * q] = pack_bf16x2(f[0], f[1]);
    o[2 * q + 1] = pack_bf16x2(f[2], f[3]);
  }
}

// ---- the kernel -----------------------------------------------------------

__device__ __forceinline__ void wg_put(const WgParams& p, int row, int n, float v) {
  if (p.bias) v += __bfloat162float(p.bias[n]);
  const size_t o = (size_t)row * p.N + n;
  if (p.out_bf16)
    reinterpret_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(p.out)[o] = v;
}

// B10: the raw int32 sum, or f32(sum) * x_scale[row] * w_scale[n] (+ bias)
__device__ __forceinline__ void wg_put(const WgParams& p, int row, int n, int v) {
  if (p.out_i32)
    reinterpret_cast<int*>(p.out)[(size_t)row * p.N + n] = v;
  else
    wg_put(p, row, n, (float)v * p.x_scale[row] * p.scale[n]);
}

// SITE names the caller (0 the dequant GEMM, 1 the grouped expert GEMM, 2
// the dense stacked-layer GEMM) so that a profiler tells them apart; the
// code is the same.
template <int MODE, int TN, int SITE>
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_gemm_kernel(const __grid_constant__ CUtensorMap tmw,
               const __grid_constant__ CUtensorMap tmx, const WgParams p) {
  using L = WgSmem<MODE, TN>;
  constexpr bool SLAB = L::SLAB;
  constexpr int BK = L::BK, S = L::STAGES;
  using Acc = typename std::conditional<L::S8, int, float>::type;  // the sums

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* empty = full + S;
  int* ticket = reinterpret_cast<int*>(empty + S);

  const int tid = threadIdx.x;
  const int g = blockIdx.y, bx = blockIdx.z;
  const int split = SLAB ? 0 : blockIdx.x;
  const int nsplit = SLAB ? 1 : p.splits;
  const int m0 = g * p.bm + (SLAB ? blockIdx.x * TN : 0);
  const int row_end = min((g + 1) * p.bm, p.x_rows);

  // the block's weight matrix in the stack's rows: B13's layer (B6: 0);
  // B8: its expert, read on the device; a dead block reads no weight and
  // writes zeros (bf16 output, N a multiple of 128)
  int expert = p.layer;
  if (p.block_expert != nullptr) {
    const int e = p.block_expert[g];
    if (e < 0 || e >= p.E) {
      if (split == 0) {
        const int rows = SLAB ? TN : p.bm;
        for (int i = tid; i < rows * (BN / 8); i += WG_THREADS) {
          const int r = m0 + i / (BN / 8);
          if (r < row_end)
            *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(p.out) +
                                      (size_t)r * p.N + bx * BN + (i % (BN / 8)) * 8) =
                make_uint4(0u, 0u, 0u, 0u);
        }
      }
      return;
    }
    expert = p.layer * p.E + e;
  }

  // this block's K tiles
  const int ntot = (p.K + BK - 1) / BK;
  const int base = ntot / nsplit, rem = ntot % nsplit;
  const int t_begin = split * base + min(split, rem);
  const int t_cnt = base + (split < rem ? 1 : 0);
  // scale rows a K tile spans (the caller lets blocks tile with BK)
  const int ngroups =
      (!L::CONVERT || p.scale_mode == SCALE_CHAN || p.block >= BK) ? 1 : BK / p.block;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ===================== producer warpgroup =====================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid >= 288) return;  // warp 8 alone issues the loads
    const int lane = tid & 31;
    const long long wrow0 = (long long)expert * p.K;
    const float* scale = p.scale ? p.scale + expert * p.scale_expert : nullptr;
    const bool plain = !p.tma_w || !p.tma_x;
    // this lane's 4 columns (lane + 32 q) of every scale row: the offsets
    // within a row, worked out once
    int scol[4], zcol[4];
    bool ncol_ok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = wg_col<MODE>(bx, lane + 32 * q);
      ncol_ok[q] = n < p.N;
      zcol[q] = n;
      scol[q] = p.scale_mode == SCALE_BLOCK ? n / p.block : n;
    }
    for (int i = 0; i < t_cnt; ++i) {
      const int s = i % S;
      if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
      const int k0 = (t_begin + i) * BK;
      uint8_t* wdst = smem + s * L::WSTAGE;
      uint8_t* xdst = smem + L::OFF_X + s * L::XSTAGE;
      if (lane == 0) {
        mbar_arrive_tx(&full[s], (p.tma_w ? L::WSTAGE : 0) + (p.tma_x ? L::XSTAGE : 0));
        if (p.tma_w) {
          const int wr = (int)(wrow0 + k0);
          if (MODE == MODE_BF16) {
            tma_load_2d(wdst, &tmw, &full[s], bx * BN, wr);
            tma_load_2d(wdst + BK * 128, &tmw, &full[s], bx * BN + 64, wr);
          } else {
            tma_load_2d(wdst, &tmw, &full[s], bx * L::RAWROW, wr);
          }
        }
        if (p.tma_x) {
          // boxes of 128 bytes of x rows
#pragma unroll
          for (int a = 0; a < BK * L::XES / 128; ++a)
            tma_load_2d(xdst + a * L::ROWS * 128, &tmx, &full[s], k0 + (128 / L::XES) * a, m0);
        }
      }
      if constexpr (L::GROUPS > 0) {
        // the tile's scale (and zero) rows at every local column, zero
        // outside the weight
        float* ss = reinterpret_cast<float*>(smem + L::OFF_S + s * L::SSTAGE);
        const int kb0 = k0 / p.block;
        for (int gi = 0; gi < ngroups; ++gi) {
          const bool krow = k0 + gi * p.block < p.K;
          const long long row = p.scale_mode == SCALE_CHAN ? 0 : (long long)(kb0 + gi) * p.scale_ld;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool ok = krow && ncol_ok[q];
            cp_async4(&ss[gi * BN + lane + 32 * q], scale + (ok ? row + scol[q] : 0), ok ? 4 : 0);
            if (L::ZEROS)
              cp_async4(&ss[(L::GROUPS + gi) * BN + lane + 32 * q],
                        p.zeros + (ok ? (long long)(kb0 + gi) * p.scale_ld + zcol[q] : 0),
                        ok ? 4 : 0);
          }
        }
      }
      if constexpr (L::CONVERT) {
        if (!p.tma_w) {
          // the raw tile through cp.async (plain loads at an unaligned edge)
          constexpr int Q = L::RAWROW / 16;
          for (int c = lane; c < BK * Q; c += 32) {
            const int r = c / Q, q = c % Q;
            const int k = k0 + r;
            const long long col = (long long)bx * L::RAWROW + q * 16;
            uint8_t* dst = wdst + r * L::RAWROW + ((L::RAWROW == 128 ? (q ^ (r & 7)) : q) << 4);
            const uint8_t* src = p.w + (wrow0 + k) * p.w_ld + col;
            if (k < p.K && col + 16 <= p.w_ld && aligned16(src)) {
              cp_async16(dst, src);
            } else {
              Bytes16 u;
#pragma unroll
              for (int b = 0; b < 16; ++b)
                u.b[b] = (k < p.K && col + b < p.w_ld) ? src[b] : (uint8_t)0;
              *reinterpret_cast<uint4*>(dst) = u.v;
            }
          }
        }
      }
      if (!p.tma_x && L::S8) {
        // B10's int8 x rows: 16-byte chunks into 128-byte swizzled boxes
        constexpr int KC = BK / 16;
        for (int c = lane; c < L::ROWS * KC; c += 32) {
          const int m = c / KC, q = c % KC;
          uint8_t* dst = xdst + (q >> 3) * L::ROWS * 128 + m * 128 + (((q & 7) ^ (m & 7)) << 4);
          const int t = m0 + m, k = k0 + q * 16;
          const uint8_t* src = reinterpret_cast<const uint8_t*>(p.x) + (size_t)t * p.K + k;
          if (t < p.x_rows && k + 16 <= p.K && aligned16(src)) {
            cp_async16(dst, src);
          } else {
            Bytes16 u;
#pragma unroll
            for (int b = 0; b < 16; ++b)
              u.b[b] = (t < p.x_rows && k + b < p.K) ? src[b] : (uint8_t)0;
            *reinterpret_cast<uint4*>(dst) = u.v;
          }
        }
      } else if (!p.tma_x) {
        constexpr int KC = BK / 8;  // 16-byte chunks of an x row
        for (int c = lane; c < L::ROWS * KC; c += 32) {
          const int m = c / KC, kc = c % KC;
          const int a = kc / 8, q = kc % 8;
          uint8_t* dst = xdst + a * L::ROWS * 128 + m * 128 + ((q ^ (m & 7)) << 4);
          const int t = m0 + m, k = k0 + kc * 8;
          const __nv_bfloat16* src = p.x + (size_t)t * p.K + k;
          if (t < p.x_rows && k + 8 <= p.K && aligned16(src)) {
            cp_async16(dst, src);
          } else {
            Words4 u;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint16_t lo = (t < p.x_rows && k + 2 * e < p.K)
                                      ? __bfloat16_as_ushort(src[2 * e]) : (uint16_t)0;
              const uint16_t hi = (t < p.x_rows && k + 2 * e + 1 < p.K)
                                      ? __bfloat16_as_ushort(src[2 * e + 1]) : (uint16_t)0;
              u.u[e] = lo | ((uint32_t)hi << 16);
            }
            *reinterpret_cast<uint4*>(dst) = u.v;
          }
        }
      }
      if (plain) {
        cp_async_wait_all();
        fence_proxy_async();  // wgmma reads what the generic proxy wrote
        mbar_arrive(&full[s]);
      } else {
        cp_async_arrive(&full[s]);
      }
    }
    return;
  }

  // ===================== consumer warpgroups =====================
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int h = tid >> 7;  // warpgroup: its 64 weight columns (decode), its 64 rows (slab)
  const int wtid = tid & 127, wq = wtid >> 5, lane = tid & 31;
  constexpr int NSUB = L::NSUB, NACC = SLAB ? 64 : TN / 2;
  Acc acc[NSUB][NACC];
#pragma unroll
  for (int mh = 0; mh < NSUB; ++mh)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[mh][i] = 0;

  // converter: column chunk cc of rows r0, r0 + 32, ...; the 8 threads of
  // a quarter-warp take rows r and r + 4, so their 16-byte loads of the
  // swizzled raw rows and their stores into the converted tile (in the
  // order hi2 picks) fall on 8 distinct bank groups
  const int cc = wtid & 3, hi2 = (wtid >> 2) & 1, qw = wtid >> 3;
  const int r0 = ((qw >> 2) << 3) | (hi2 << 2) | (qw & 3);
  for (int i = 0; i < t_cnt; ++i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    const uint8_t* wst = smem + s * L::WSTAGE;
    const uint8_t* xst = smem + L::OFF_X + s * L::XSTAGE;
    const uint8_t* bt = wst;  // the bf16 weight tile the products read
    if constexpr (L::S8) {
      // B10: this warpgroup's 64 columns of the raw [BK k][128 n] tile ->
      // [64 n][BK k] K-major rows, in 128-k atoms [128 n][128 bytes]. A
      // thread takes 4 columns and 16 k of each atom: 16 words (4 columns
      // of one k each), four 4x4 byte transposes, 4 chunks of 16 k (one
      // column each) into the 128-byte swizzle.
      uint8_t* cb = smem + L::OFF_C + (i % L::NC) * L::CBUF;
      const int ng = wtid & 15, kc = wtid >> 4;
      const int nb = h * 64 + 4 * ng;
#pragma unroll
      for (int at = 0; at < BK / 128; ++at) {
        uint32_t w[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = 128 * at + 16 * kc + j;
          w[j] = *reinterpret_cast<const uint32_t*>(
              wst + k * 128 + (((nb >> 4) ^ (k & 7)) << 4) + (nb & 15));
        }
        uint32_t t[4][4];  // [column][k group of 4]
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const uint32_t lo01 = __byte_perm(w[4 * g], w[4 * g + 1], 0x5140);
          const uint32_t hi01 = __byte_perm(w[4 * g], w[4 * g + 1], 0x7362);
          const uint32_t lo23 = __byte_perm(w[4 * g + 2], w[4 * g + 3], 0x5140);
          const uint32_t hi23 = __byte_perm(w[4 * g + 2], w[4 * g + 3], 0x7362);
          t[0][g] = __byte_perm(lo01, lo23, 0x5410);
          t[1][g] = __byte_perm(lo01, lo23, 0x7632);
          t[2][g] = __byte_perm(hi01, hi23, 0x5410);
          t[3][g] = __byte_perm(hi01, hi23, 0x7632);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = nb + c;
          *reinterpret_cast<uint4*>(cb + at * BN * 128 + n * 128 + ((kc ^ (n & 7)) << 4)) =
              make_uint4(t[c][0], t[c][1], t[c][2], t[c][3]);
        }
      }
      fence_proxy_async();  // the transposed tile is read by wgmma (async proxy)
      if (SLAB)
        named_bar_sync(1, 256);  // both halves of the tile are written
      else
        named_bar_sync(2 + h, 128);
      bt = cb;
    } else if constexpr (L::CONVERT) {
      uint8_t* cb = smem + L::OFF_C + (i % L::NC) * L::CBUF;
      uint8_t* atom = cb + h * BK * 128;
      const float* ss = reinterpret_cast<const float*>(smem + L::OFF_S + s * L::SSTAGE);
      const int jcol = h * 64 + cc * 16;
      float sc[16], zr[16];
#pragma unroll
      for (int jr = 0; jr < BK / 32; ++jr) {
        const int r = r0 + 32 * jr;
        if (jr == 0 || ngroups > 1) {
          const int gi = ngroups > 1 ? r / p.block : 0;
#pragma unroll
          for (int e = 0; e < 16; e += 4) {
            const float4 v = *reinterpret_cast<const float4*>(&ss[gi * BN + jcol + e]);
            sc[e] = v.x; sc[e + 1] = v.y; sc[e + 2] = v.z; sc[e + 3] = v.w;
            if (L::ZEROS) {
              const float4 z =
                  *reinterpret_cast<const float4*>(&ss[(L::GROUPS + gi) * BN + jcol + e]);
              zr[e] = z.x; zr[e + 1] = z.y; zr[e + 2] = z.z; zr[e + 3] = z.w;
            }
          }
        }
        const uint4 raw =
            L::RAWROW == 128
                ? *reinterpret_cast<const uint4*>(wst + r * 128 + (((h * 4 + cc) ^ (r & 7)) << 4))
                : *reinterpret_cast<const uint4*>(wst + r * 64 + cc * 16);
        uint32_t o[8];
        convert16<MODE>(raw, h, sc, zr, o);
        uint8_t* drow = atom + r * 128;
        const uint4 lo = make_uint4(o[0], o[1], o[2], o[3]);
        const uint4 up = make_uint4(o[4], o[5], o[6], o[7]);
        *reinterpret_cast<uint4*>(drow + (((2 * cc + hi2) ^ (r & 7)) << 4)) = hi2 ? up : lo;
        *reinterpret_cast<uint4*>(drow + (((2 * cc + 1 - hi2) ^ (r & 7)) << 4)) = hi2 ? lo : up;
      }
      fence_proxy_async();  // the converted tile is read by wgmma (async proxy)
      if (SLAB)
        named_bar_sync(1, 256);  // both halves of the tile are written
      else
        named_bar_sync(2 + h, 128);
      bt = cb;
    }
    wgmma_fence();
    const uint32_t xa = smem_u32(xst), wa = smem_u32(bt);
    if constexpr (L::S8) {
      // k32 steps of 32 bytes inside the 128-byte rows of both operands'
      // 128-k atoms
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint32_t wk = wa + (kk >> 2) * BN * 128 + (kk & 3) * 32;
        const uint32_t xk = xa + (kk >> 2) * L::ROWS * 128 + (kk & 3) * 32;
        if constexpr (SLAB) {
          const uint64_t db = sw128_desc(wk, 16, 1024);
#pragma unroll
          for (int mh = 0; mh < NSUB; ++mh)
            wgmma_s8_m64n128(acc[mh], sw128_desc(xk + (h * NSUB + mh) * 64 * 128, 16, 1024),
                             db);
        } else {
          wgmma_s8_tile<TN>(acc[0], sw128_desc(wk + h * 64 * 128, 16, 1024),
                            sw128_desc(xk, 16, 1024));
        }
      }
    } else if constexpr (SLAB) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(wa + kk * 2048, BK * 128, 1024);
#pragma unroll
        for (int mh = 0; mh < NSUB; ++mh) {
          const uint64_t da = sw128_desc(xa + (h * NSUB + mh) * 64 * 128 + kk * 32, 16, 1024);
          wgmma_m64n128<0, 1>(acc[mh], da, db);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = sw128_desc(wa + h * BK * 128 + kk * 2048, BK * 128, 1024);
        const uint64_t db = sw128_desc(xa + (kk / 4) * TN * 128 + (kk % 4) * 32, 16, 1024);
        wgmma_tile<TN, 1, 0>(acc[0], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of tile i - 1 are done: free its stage
#pragma unroll
    for (int mh = 0; mh < NSUB; ++mh) fence_regs(acc[mh]);
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % S]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mh = 0; mh < NSUB; ++mh) fence_regs(acc[mh]);

  // accumulator layout (m64nN): acc[4 * n8 + 2 * hi + b] holds row
  // 16 * wq + lane / 4 + 8 * hi of the warpgroup's 64 and column
  // 8 * n8 + 2 * (lane % 4) + b
  if constexpr (SLAB) {
#pragma unroll
    for (int mh = 0; mh < NSUB; ++mh)
#pragma unroll
      for (int n8 = 0; n8 < 16; ++n8)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = m0 + (h * NSUB + mh) * 64 + wq * 16 + (lane >> 2) + 8 * hi;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int n = wg_col<MODE>(bx, n8 * 8 + 2 * (lane & 3) + b);
            if (n < p.N && row < row_end) wg_put(p, row, n, acc[mh][4 * n8 + 2 * hi + b]);
          }
        }
    return;
  }
  // decode: rows of the accumulator are weight columns, columns are tokens
  if (nsplit == 1) {
#pragma unroll
    for (int n8 = 0; n8 < TN / 8; ++n8)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int n = wg_col<MODE>(bx, h * 64 + wq * 16 + (lane >> 2) + 8 * hi);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int row = m0 + n8 * 8 + 2 * (lane & 3) + b;
          if (row < row_end && n < p.N) wg_put(p, row, n, acc[0][4 * n8 + 2 * hi + b]);
        }
      }
    return;
  }
  // split-K: the partial tile [TN tokens][128 columns] goes to this split's
  // slab; the last block to take a ticket sums the slabs in split order
  const int tile = g * p.ncol + bx;
  Acc* slabs = reinterpret_cast<Acc*>(p.ws) + (size_t)tile * nsplit * (TN * BN);
#pragma unroll
  for (int n8 = 0; n8 < TN / 8; ++n8)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int j = h * 64 + wq * 16 + (lane >> 2) + 8 * hi;
        const int t = n8 * 8 + 2 * (lane & 3) + b;
        slabs[(size_t)split * (TN * BN) + t * BN + j] = acc[0][4 * n8 + 2 * hi + b];
      }
  __threadfence();
  named_bar_sync(1, 256);
  if (tid == 0) *ticket = atomicAdd(&p.counters[tile], 1);
  named_bar_sync(1, 256);
  if (*ticket != nsplit - 1) return;
  __threadfence();
  for (int e = tid; e < TN * BN; e += 256) {
    Acc v = 0;
    for (int sp = 0; sp < nsplit; ++sp) v += __ldcg(&slabs[(size_t)sp * (TN * BN) + e]);
    const int row = m0 + e / BN, n = wg_col<MODE>(bx, e % BN);
    if (row < row_end && n < p.N) wg_put(p, row, n, v);
  }
  if (tid == 0) p.counters[tile] = 0;
}

// ---- host side: tensor maps and the launch -----------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                      cudaEnableDefault, &q);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                             cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)f;
  }
  return fn;
}

struct MapKey {
  const void* base;
  uint64_t rows, cols;
  uint32_t box0, box1;
  int bf16, swz;
};

// a 2-D map over `rows` rows of `cols` elements (row stride `cols`)
inline int encode_map(CUtensorMap* m, const MapKey& k) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return MAP_FAILED;
  const int es = k.bf16 ? 2 : 1;
  cuuint64_t dims[2] = {k.cols, k.rows};
  cuuint64_t strides[1] = {k.cols * es};
  cuuint32_t box[2] = {k.box0, k.box1};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(m, k.bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                  2, const_cast<void*>(k.base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  k.swz ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_FAILED;
}

// a 3-D bf16 map with 128-byte swizzle: dims[0] contiguous elements;
// strides[0] and strides[1] the byte strides of dims 1 and 2 (a strided
// view is described where it lies)
struct Map3Key {
  const void* base;
  uint64_t dims[3], strides[2];
  uint32_t box[3];
};

inline Map3Key map3_key(const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                        uint64_t s1, uint64_t s2, uint32_t b0, uint32_t b1, uint32_t b2) {
  Map3Key k;
  memset(&k, 0, sizeof(k));  // the padding too: keys are compared by memcmp
  k.base = base;
  k.dims[0] = d0;
  k.dims[1] = d1;
  k.dims[2] = d2;
  k.strides[0] = s1;
  k.strides[1] = s2;
  k.box[0] = b0;
  k.box[1] = b1;
  k.box[2] = b2;
  return k;
}

inline int encode_map(CUtensorMap* m, const Map3Key& k) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return MAP_FAILED;
  cuuint64_t d[3] = {k.dims[0], k.dims[1], k.dims[2]};
  cuuint64_t st[2] = {k.strides[0], k.strides[1]};
  cuuint32_t b[3] = {k.box[0], k.box[1], k.box[2]};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(k.base), d, st,
                  b, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_FAILED;
}

// Tensor maps by the key that makes them: a map is a function of its key
// alone, so a call that repeats a pointer, shape and box takes the map made
// before. Weights keep their pointers; the caching allocator hands a step's
// activations the same few blocks again. Each table holds 128 maps, filled
// round robin; weights and activations have tables of their own, so the
// activations a step passes through cannot push the weights' maps out.
enum { WEIGHT_MAPS = 0, ACT_MAPS = 1 };

template <int TABLE, typename Key>
inline int cached_map(CUtensorMap* m, const Key& k) {
  struct Entry {
    Key k;
    CUtensorMap m;
    int used;
  };
  static Entry cache[128];
  static int next = 0;
  for (auto& e : cache)
    if (e.used && memcmp(&e.k, &k, sizeof(Key)) == 0) {
      *m = e.m;
      return 0;
    }
  const int rc = encode_map(m, k);
  if (rc == 0) {
    Entry& e = cache[next];
    next = (next + 1) % 128;
    memcpy(&e.k, &k, sizeof(Key));
    e.m = *m;
    e.used = 1;
  }
  return rc;
}

template <int MODE, int TN, int SITE>
int wg_launch(const WgParams& p, const CUtensorMap& tmw, const CUtensorMap& tmx,
              dim3 grid, cudaStream_t stream) {
  using L = WgSmem<MODE, TN>;
  static bool ready = false;
  if (!ready) {
    const int rc = allow_smem(wg_gemm_kernel<MODE, TN, SITE>, L::TOTAL);
    if (rc != 0) return rc;
    ready = true;
  }
  wg_gemm_kernel<MODE, TN, SITE><<<grid, WG_THREADS, L::TOTAL, stream>>>(tmw, tmx, p);
  return (int)cudaGetLastError();
}

// tn: rows a tile, 16 / 32 / 64 (decode, grid.x = p.splits) or 128 / 256
// (slab, grid.x = row_tiles tiles a group); groups on grid.y, p.ncol
// column tiles on grid.z. p.tma_w / p.tma_x say whether a tensor map loads the operand.
template <int MODE, int SITE>
int wg_gemm(const WgParams& p, int tn, int groups, int row_tiles, cudaStream_t stream) {
  constexpr int ES = MODE == MODE_BF16 ? 2 : 1;
  constexpr bool S8 = MODE == MODE_S8;
  constexpr int XES = S8 ? 1 : 2;
  if (p.tma_w && !(aligned16(p.w) && ((long long)p.w_ld * ES) % 16 == 0)) return NOT_SUPPORTED;
  if (p.tma_x && !(aligned16(p.x) && (p.K * XES) % 16 == 0)) return NOT_SUPPORTED;
  if (MODE == MODE_BF16 && !(p.tma_w && p.tma_x)) return NOT_SUPPORTED;
  if (tn != 16 && tn != 32 && tn != 64 && tn != 128 && tn != 256) return NOT_SUPPORTED;
  const bool slab = tn >= 128;
  if (p.splits < 1 || (slab && p.splits != 1)) return NOT_SUPPORTED;
  const int bk = S8 ? (slab ? 128 : 256) : (slab ? 64 : 128);
  if (p.scale_mode != SCALE_CHAN && MODE != MODE_BF16 && !S8 &&
      !(p.block % bk == 0 || (bk % p.block == 0 && bk / p.block <= bk / 32)))
    return NOT_SUPPORTED;
  CUtensorMap tmw, tmx;
  memset(&tmw, 0, sizeof(tmw));
  memset(&tmx, 0, sizeof(tmx));
  if (p.tma_w) {
    MapKey k;
    memset(&k, 0, sizeof(k));
    k.base = p.w;
    k.rows = (uint64_t)p.w_rows;
    k.cols = (uint64_t)p.w_ld;
    k.box0 = MODE == MODE_BF16 ? 64 : (MODE == MODE_INT4P ? 64 : 128);
    k.box1 = bk;
    k.bf16 = MODE == MODE_BF16;
    k.swz = MODE != MODE_INT4P;
    const int rc = cached_map<WEIGHT_MAPS>(&tmw, k);
    if (rc) return rc;
  }
  if (p.tma_x) {
    MapKey k;
    memset(&k, 0, sizeof(k));
    k.base = p.x;
    k.rows = (uint64_t)p.x_rows;
    k.cols = (uint64_t)p.K;
    k.box0 = 128 / XES;  // 128 bytes
    k.box1 = tn;
    k.bf16 = !S8;
    k.swz = 1;
    const int rc = cached_map<ACT_MAPS>(&tmx, k);
    if (rc) return rc;
  }
  const dim3 grid(slab ? row_tiles : p.splits, groups, p.ncol);
  switch (tn) {
    case 128: return wg_launch<MODE, 128, SITE>(p, tmw, tmx, grid, stream);
    case 256: return wg_launch<MODE, 256, SITE>(p, tmw, tmx, grid, stream);
    case 16: return wg_launch<MODE, 16, SITE>(p, tmw, tmx, grid, stream);
    case 32: return wg_launch<MODE, 32, SITE>(p, tmw, tmx, grid, stream);
    case 64: return wg_launch<MODE, 64, SITE>(p, tmw, tmx, grid, stream);
  }
  return NOT_SUPPORTED;
}

}  // namespace
