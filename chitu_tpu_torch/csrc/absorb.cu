// MLA absorb projections for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel of chitu_tpu/ops/pallas_absorb.py
// (`absorb_matmul`, body `_absorb_body`, B9). For the stacked wkv_b leaf
// w [L, C, H*S] (S = dn + dv: per head, dn "uk" lanes then dv "uv" lanes):
//
//   uk (q absorb):    out[t,h,c] = sum_d x[t,h,d] * w[l, c, h*S + d]
//   uv (v un-absorb): out[t,h,d] = sum_c x[t,h,c] * w[l, c, h*S + dn + d]
//
// that is one GEMM per head over strided slices of w[layer], f32 sums, bf16
// out. x [T, H, K] is read through its strides (uk's is a view of the
// [T, H, dn + rope] query rows) and out [T, H, N] is written in place: no
// head-major transpose and no pad of T, which the TPU kernel needed.
//
// What bounds it on this card: at T <= 128 (the model's gate) the bytes of
// the half of w[layer] a call reads (dn or dv lanes of every head's C
// rows, 16.8 MB for DeepSeek-R1), each read once: a weight stream. The
// first version gave each (head, 128-column tile) its own block; uk's has
// one 128-deep K tile, so a block spent its life filling its ring and
// storing its tile. This kernel is persistent: about one block an SM walks
// a run of items through one TMA ring, so the next item's tiles are in
// flight while this item multiplies and stores.
//
// - Items: (head h, 128-column tile ct of the output), ordered head-major
//   (u = h * ncol + ct), a block taking the contiguous run [b * per_block,
//   (b + 1) * per_block) with per_block = ceil(items / SMs) (DeepSeek-R1:
//   uk 512 items, 4 a block, one head each; uv 128 items of 4 K tiles).
//   An item is never split over K, so every output element is summed by
//   one warpgroup in one order: launches repeat bit for bit.
// - Tiles: swap-AB, as the shared GEMM mainloop's decode tiles: the weight
//   is wgmma's A (64 output columns a consumer warpgroup as M), the TN
//   tokens are its N (16, 32, 64, or 128 for T 65..128: one 128 x 128 slab
//   tile, still with x as B, so one descriptor path serves every T). K tile
//   128: two 64-lane TMA boxes of 128 rows (128-byte swizzle) of the weight
//   map over the stack's [L * C, H * S] rows, two 64-lane boxes of a 3-D
//   map of x (lanes, head, row) with the caller's strides. uk's tile is
//   K-major (row c holds the head's dn contraction lanes), so wgmma reads
//   A untransposed; uv's is MN-major (rows are K = c), A transposed.
// - Roles: 384 threads; one producer thread issues the TMA loads of every
//   item's K tiles into a ring of 3-6 stages (`full` mbarrier: its
//   expect_tx; `empty`: one arrival a consumer warp); two consumer
//   warpgroups wait on `full`, issue the tile's eight k16 products from
//   shared memory, wait for them and free the stage. After an item's last
//   tile each warpgroup rounds its 64 x TN accumulators to bf16 into its
//   own staging tile (token rows of 128 bytes, 128-byte swizzle, so the
//   stores from the accumulator layout hit distinct banks) and one thread
//   stores it by TMA through a 3-D map of out (lanes, head, row): whole
//   128-byte row segments, rows past T clipped, the store running while
//   the next item multiplies. (Stores of each bf16 straight from the
//   accumulators write 16-byte pieces of a row: at uk, T 128, where out is
//   as large as the weight half, they took 1.75x the einsum's time on an
//   H100 80GB HBM3 at 700 W.)

#include "gemm_common.cuh"

namespace {

constexpr int AB_T = 128;   // K tile, and output columns an item
constexpr int AB_BOX = 64;  // lanes a TMA box: one 128-byte swizzle atom

template <int TN>
struct AbSmem {
  static constexpr int WSTAGE = 2 * AB_T * 128;  // two 64-lane atoms of 128 rows
  static constexpr int XSTAGE = 2 * TN * 128;    // two 64-lane atoms of TN rows
  static constexpr int OSTAGE = TN * 128;        // a warpgroup's TN x 64 bf16 outputs
  static constexpr int S0 = (227 * 1024 - 2048 - 2 * OSTAGE) / (WSTAGE + XSTAGE);
  static constexpr int STAGES = S0 > 6 ? 6 : S0;
  static constexpr int OFF_X = STAGES * WSTAGE;
  static constexpr int OFF_O = OFF_X + STAGES * XSTAGE;
  static constexpr int OFF_BAR = OFF_O + 2 * OSTAGE;
  static constexpr int TOTAL = OFF_BAR + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 3, "ring too shallow");
  static_assert(XSTAGE % 1024 == 0, "atoms must stay 1024-byte aligned");
  static_assert(TOTAL <= 227 * 1024, "shared memory");
};

struct AbParams {
  int H, C, dn, dv, layer;
  int nk;         // K tiles an item: dn / 128 (uk) or C / 128 (uv)
  int ncol;       // column tiles a head: C / 128 (uk) or dv / 128 (uv)
  int items;      // H * ncol
  int per_block;  // items a block walks
};

template <int UK, int TN>
__global__ void __launch_bounds__(WG_THREADS, 1)
absorb_wg_kernel(const __grid_constant__ CUtensorMap tmw,
                 const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmo, const AbParams p) {
  using L = AbSmem<TN>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int u_begin = blockIdx.x * p.per_block;
  const int u_end = min(u_begin + p.per_block, p.items);
  const int hs = p.dn + p.dv;  // lanes a head in a wkv_b row

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ===================== producer =====================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 256) return;
    prefetch_tmap(&tmw);
    prefetch_tmap(&tmx);
    prefetch_tmap(&tmo);
    int i = 0;  // the block's running tile count: stage i % S, lap i / S
    for (int u = u_begin; u < u_end; ++u) {
      const int h = u / p.ncol, ct = u % p.ncol;
      for (int j = 0; j < p.nk; ++j, ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
        uint8_t* wdst = smem + s * L::WSTAGE;
        uint8_t* xdst = smem + L::OFF_X + s * L::XSTAGE;
        mbar_arrive_tx(&full[s], L::WSTAGE + L::XSTAGE);
        // the weight tile in the [L * C, H * S] map. uk: the item's 128 c
        // rows, the head's dn lanes of K tile j (two K atoms); uv: the 128
        // c rows of K tile j, the head's dv lanes of column tile ct (two M
        // atoms)
        const int row = p.layer * p.C + (UK ? ct : j) * AB_T;
        const int col = h * hs + (UK ? j * AB_T : p.dn + ct * AB_T);
        tma_load_2d(wdst, &tmw, &full[s], col, row);
        tma_load_2d(wdst + AB_T * 128, &tmw, &full[s], col + AB_BOX, row);
        // x: K tile j's lanes of head h, rows 0..TN-1 (rows past T: zeros)
        tma_load_3d(xdst, &tmx, &full[s], j * AB_T, h, 0);
        tma_load_3d(xdst + TN * 128, &tmx, &full[s], j * AB_T + AB_BOX, h, 0);
      }
    }
    return;
  }

  // ===================== consumer warpgroups =====================
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = tid >> 7;  // warpgroup: output columns 64g..64g+63 of an item
  const int wtid = tid & 127, wq = wtid >> 5, lane = tid & 31;
  uint8_t* stg = smem + L::OFF_O + g * L::OSTAGE;  // token t's 64 outputs: row t
  float acc[TN / 2];
  int i = 0;
  for (int u = u_begin; u < u_end; ++u) {
    const int h = u / p.ncol, ct = u % p.ncol;
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[e] = 0.f;
    for (int j = 0; j < p.nk; ++j, ++i) {
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      const uint32_t wa = smem_u32(smem + s * L::WSTAGE);
      const uint32_t xa = smem_u32(smem + L::OFF_X + s * L::XSTAGE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < AB_T / 16; ++kk) {
        // A, the weight. uk (K-major): atom kk / 4, the warpgroup's 64 rows,
        // 32 bytes a k16 step; uv (MN-major): atom g, 16 K rows a k16 step
        const uint64_t da =
            UK ? sw128_desc(wa + (kk / 4) * (AB_T * 128) + g * (64 * 128) + (kk % 4) * 32,
                            16, 1024)
               : sw128_desc(wa + g * (AB_T * 128) + kk * 2048, AB_T * 128, 1024);
        // B, x (K-major): atom kk / 4, 32 bytes a k16 step
        const uint64_t db = sw128_desc(xa + (kk / 4) * (TN * 128) + (kk % 4) * 32, 16, 1024);
        wgmma_tile<TN, UK ? 0 : 1, 0>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // acc[4 * n8 + 2 * hi + b]: output column 16 * wq + lane / 4 + 8 * hi of
    // the warpgroup's 64, token 8 * n8 + 2 * (lane % 4) + b; column c of
    // row t lies in 16-byte chunk (c / 8) ^ (t % 8) of the row
    if (wtid == 0) bulk_wait_read();  // the last item's store has read stg
    named_bar_sync(1 + g, 128);
#pragma unroll
    for (int n8 = 0; n8 < TN / 8; ++n8)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int t = n8 * 8 + 2 * (lane & 3) + b;
          const int c = wq * 16 + (lane >> 2) + 8 * hi;
          *reinterpret_cast<__nv_bfloat16*>(stg + t * 128 + (((c >> 3) ^ (t & 7)) << 4) +
                                            (c & 7) * 2) =
              __float2bfloat16(acc[4 * n8 + 2 * hi + b]);
        }
    fence_proxy_async();  // the staging tile is read by TMA (async proxy)
    named_bar_sync(1 + g, 128);
    if (wtid == 0) {
      tma_store_3d(&tmo, stg, ct * AB_T + g * 64, h, 0);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait_read();  // stg stays until the last store has read it
}

template <int UK, int TN>
int launch(const CUtensorMap& tmw, const CUtensorMap& tmx, const CUtensorMap& tmo,
           const AbParams& p, int blocks, cudaStream_t s) {
  using L = AbSmem<TN>;
  static bool ready = false;
  if (!ready) {
    const int rc = allow_smem(absorb_wg_kernel<UK, TN>, L::TOTAL);
    if (rc) return rc;
    ready = true;
  }
  absorb_wg_kernel<UK, TN><<<blocks, WG_THREADS, L::TOTAL, s>>>(tmw, tmx, tmo, p);
  return int(cudaGetLastError());
}

template <int UK>
int dispatch(int tn, const CUtensorMap& tmw, const CUtensorMap& tmx, const CUtensorMap& tmo,
             const AbParams& p, int blocks, cudaStream_t s) {
  switch (tn) {
    case 16: return launch<UK, 16>(tmw, tmx, tmo, p, blocks, s);
    case 32: return launch<UK, 32>(tmw, tmx, tmo, p, blocks, s);
    case 64: return launch<UK, 64>(tmw, tmx, tmo, p, blocks, s);
    case 128: return launch<UK, 128>(tmw, tmx, tmo, p, blocks, s);
  }
  return NOT_SUPPORTED;
}

}  // namespace

// kind 0 = uk, 1 = uv. x [T, H, dn] (uk) or [T, H, C] (uv), element (t, h,
// k) at x + t*sxt + h*sxh + k (a view of a wider row passes its strides);
// w [L, C, H*S] and out [T, H, C] (uk) or [T, H, dv] (uv) contiguous; all
// bf16. The plan (ops/gemm_plan.absorb_plan): tn, the token tile (16, 32,
// 64 or 128, at least T), and per_block items a block over `blocks`
// blocks.
extern "C" int chitu_absorb_matmul(const void* x, const void* w, void* out,
                                   int64_t sxt, int64_t sxh, int kind, int T,
                                   int H, int C, int dn, int dv, int L, int layer,
                                   int tn, int per_block, int blocks,
                                   void* stream) {
  const int uk = kind == 0;
  const int K = uk ? dn : C, N = uk ? C : dv;
  if (T < 1 || T > tn || tn > 128 || H < 1 || layer < 0 || layer >= L || K % AB_T ||
      N % AB_T || dn % AB_T || dv % AB_T || sxt % 8 || sxh % 8 || !aligned16(x) ||
      !aligned16(w) || !aligned16(out) || per_block < 1 || blocks < 1)
    return NOT_SUPPORTED;
  AbParams p;
  p.H = H;
  p.C = C;
  p.dn = dn;
  p.dv = dv;
  p.layer = layer;
  p.nk = K / AB_T;
  p.ncol = N / AB_T;
  p.items = H * p.ncol;
  p.per_block = per_block;
  if ((long long)per_block * blocks < p.items) return NOT_SUPPORTED;
  CUtensorMap tmw, tmx;
  MapKey k;
  memset(&k, 0, sizeof(k));
  k.base = w;
  k.rows = (uint64_t)L * C;
  k.cols = (uint64_t)H * (dn + dv);
  k.box0 = AB_BOX;
  k.box1 = AB_T;
  k.bf16 = 1;
  k.swz = 1;
  int rc = cached_map<WEIGHT_MAPS>(&tmw, k);
  if (rc) return rc;
  // x and out: (lanes, head, row) maps with the tensors' own strides, a box
  // of 64 lanes of one head for TN rows
  CUtensorMap tmo;
  rc = cached_map<ACT_MAPS>(&tmx, map3_key(x, K, H, T, sxh * 2, sxt * 2, AB_BOX, 1, tn));
  if (rc) return rc;
  rc = cached_map<ACT_MAPS>(&tmo, map3_key(out, N, H, T, (uint64_t)N * 2,
                                           (uint64_t)H * N * 2, AB_BOX, 1, tn));
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return uk ? dispatch<1>(tn, tmw, tmx, tmo, p, blocks, s)
            : dispatch<0>(tn, tmw, tmx, tmo, p, blocks, s);
}
