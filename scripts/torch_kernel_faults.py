#!/usr/bin/env python3
"""Shows that the limits `chip_smoke.py` holds the quantized, grouped,
absorb and dense GEMM kernels, the activation quantizers and the
attention kernels (the latent row,
the e4m3 pool, the split layout at head sizes 192 and 64, the split decode
and the tensor-core prefill) to reject broken kernels. Needs an NVIDIA GPU and nvcc.

    python3 scripts/torch_kernel_faults.py [words ...]

With words, only the faults whose name holds one of them, or whose source
file a word names (`absorb.cu`, `gemm_common.cuh`, ...), are planted.

For each planted fault it copies `chitu_tpu_torch/csrc/` into a temporary
directory, edits one source there (a line, or two for a fault that moves
a wait; the repository's sources are never touched), builds that copy, points the wrappers at it and runs
the comparison with the plain version that `chip_smoke.py` runs for the
mode the fault touches, at a Llama-3-8B projection shape (the dequant
GEMM at T 16, where `[4096 -> 6144]` splits K in two, and at T 512 for a
fault of the slab tiles; the grouped GEMM:
layer 1 of a two-layer Mixtral-8x7B `[4096 -> 14336]` expert stack at the
16-token decode geometry, where two of ten blocks are dead; B9: layer 1
of DeepSeek-R1's `wkv_b` [2, 512, 128*256] at T 16, uk reading q_nope as a
view of the [T, 128, 192] query rows; the latent row: B4 at DeepSeek-R1's
16-row decode geometry, contexts 1 to 2048 (split over the context, the
partials merged), B4 at deepseek-mid-bench's 32 heads (half of each tile
dead rows), B5 for a 128-token chunk at q_pos 512; B10: the int8 GEMM at
T 16 `[4096 -> 6144]`, where K splits in two; the e4m3 pool: B4 over
one-token contexts holding every finite code, which must decode exactly,
B1's append bytes against the plain append's for edge values and for
values beyond e4m3's range, the latent B4 on an e4m3 pool; head size 192:
B4 at DeepSeek-R1's dense MLA, 128 heads; head size 64: B5 at
tiny-llama-debug's 32 heads on 4; B13: layer 1 of a two-layer
`[4096 -> 6144]` stack at T 16, where K splits in two; the split decode: B4 at Llama-3-8B's
16-row decode geometry, contexts up to 2048 in five splits, on a bf16 and
on an e4m3 pool; the tensor-core prefill: B5 for a 128-token chunk at
q_pos 512; the activation quantizers: B11 at T 16 and 512 (D 4096), T 4
(D 29568, split over a cluster) and T 3 (D 4100) against its three
limits, B12 bit-equal at T 16 and 512 (F 14336), T 16 (F 29568, a
cluster), T 1 and, 2 bytes off a 16-byte boundary, T 16 (D 4096), T 3 (D
4100) and on rows of rounding ties; the exit-barrier fault runs B12 at
[16, 29568] with one cluster of 4 walking all rows and its odd ranks held
back 20 us before they read the partials, in the sound kernel too; a
broken kernel's launch error counts as a rejection, and as the context is
lost with it, such a fault comes last). It prints one
JSON line per fault with the measured error beside the limit, first for
the sound kernel and then for the broken one, and exits non-zero if a
sound kernel fails its limit or a fault passes it.
"""

import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROW_RTOL = 1e-2  # chip_smoke.py's limit on every GEMM output row
# the activation quantizers' odd cluster ranks read the amax partials 20 us
# late
SLOW_READ = (
    "  const float o = lane < p.cluster ? *cl.map_shared_rank(red + slot, lane) : 0.f;",
    "  if (MAX && (cl.block_rank() & 1)) __nanosleep(20000);\n"
    "  const float o = lane < p.cluster ? *cl.map_shared_rank(red + slot, lane) : 0.f;")

FAULTS = [
    # (name, source, old text, new text, check[, control old texts, control
    # new texts]); a tuple of old texts and one of new texts make several
    # edits; a control's edits are made to the sound kernel too
    ("scale block index off by one", "gemm_common.cuh",
     "scol[q] = p.scale_mode == SCALE_BLOCK ? n / p.block : n;",
     "scol[q] = p.scale_mode == SCALE_BLOCK ? (n / p.block > 0 ? n / p.block - 1 : 0) : n;",
     "e4m3_blockwise"),
    ("last K block skipped", "gemm_common.cuh",
     "const int t_cnt = base + (split < rem ? 1 : 0);",
     "const int t_cnt = base + (split < rem ? 1 : 0) - (split == nsplit - 1 ? 1 : 0);",
     "e4m3_blockwise"),
    ("low and high nibbles swapped", "gemm_common.cuh",
     "const uint32_t n = (w >> (8 * i + 4 * hi)) & 0xFu;",
     "const uint32_t n = (w >> (8 * i + 4 * (1 - hi))) & 0xFu;",
     "int4_packed"),
    ("zeros dropped", "gemm_common.cuh",
     "if (MODE == MODE_INT4 || MODE == MODE_INT4P) v -= zr[4 * q + i];", "",
     "int4_unpacked"),
    ("x_scale left out", "gemm_common.cuh",
     "(float)v * p.x_scale[row] * p.scale[n]",
     "(float)v * p.scale[n]", "int8"),
    ("truncation instead of round-half-to-even", "norm_quant.cu",
     "rintf(y / s)", "truncf(y / s)", "acts"),
    ("expert index off by one", "gemm_common.cuh",
     "expert = p.layer * p.E + e;", "expert = p.layer * p.E + (e + 1) % p.E;",
     "moe_bf16"),
    ("layer offset dropped", "gemm_common.cuh",
     "expert = p.layer * p.E + e;", "expert = e;", "moe_bf16"),
    ("dead block left unzeroed", "gemm_common.cuh",
     "if (split == 0) {", "if (split < 0) {", "moe_dead"),
    ("expert scale block index off by one", "gemm_common.cuh",
     "scol[q] = p.scale_mode == SCALE_BLOCK ? n / p.block : n;",
     "scol[q] = p.scale_mode == SCALE_BLOCK ? (n / p.block > 0 ? n / p.block - 1 : 0) : n;",
     "moe_e4m3"),
    ("last K tile of the grouped GEMM skipped", "gemm_common.cuh",
     "const int t_cnt = base + (split < rem ? 1 : 0);",
     "const int t_cnt = base + (split < rem ? 1 : 0) - (split == nsplit - 1 ? 1 : 0);",
     "moe_e4m3"),
    # the TMA + wgmma mainloop
    ("decode A descriptor's swizzle off by one chunk", "gemm_common.cuh",
     "sw128_desc(wa + h * BK * 128 + kk * 2048, BK * 128, 1024)",
     "sw128_desc(wa + h * BK * 128 + kk * 2048 + 16, BK * 128, 1024)",
     "e4m3_blockwise"),
    ("slab B descriptor's swizzle off by one chunk", "gemm_common.cuh",
     "sw128_desc(wa + kk * 2048, BK * 128, 1024)",
     "sw128_desc(wa + kk * 2048 + 16, BK * 128, 1024)", "e4m3_slab"),
    ("a stage's full mbarrier not waited on the ring's first lap",
     "gemm_common.cuh",
     "    mbar_wait(&full[s], (i / S) & 1);\n    const uint8_t* wst",
     "    if (i >= S) mbar_wait(&full[s], (i / S) & 1);\n    const uint8_t* wst",
     "e4m3_poisoned"),
    ("the converted tile written before its TMA lands", "gemm_common.cuh",
     ("    mbar_wait(&full[s], (i / S) & 1);\n    const uint8_t* wst",
      "    wgmma_fence();\n    const uint32_t xa"),
     ("    const uint8_t* wst",
      "    mbar_wait(&full[s], (i / S) & 1);\n    wgmma_fence();\n    const uint32_t xa"),
     "e4m3_blockwise"),
    ("the swapped output read at the transposed stride", "gemm_common.cuh",
     "const int row = m0 + e / BN, n = wg_col<MODE>(bx, e % BN);",
     "const int row = m0 + e % TN, n = wg_col<MODE>(bx, e / TN);", "e4m3_blockwise"),
    ("the last split of K dropped", "gemm_common.cuh",
     "for (int sp = 0; sp < nsplit; ++sp) v +=",
     "for (int sp = 0; sp < nsplit - 1; ++sp) v +=", "e4m3_blockwise"),
    ("B8's expert row coordinate off by one expert", "gemm_common.cuh",
     "const long long wrow0 = (long long)expert * p.K;",
     "const long long wrow0 = (long long)((expert + 1) % (p.w_rows / p.K)) * p.K;",
     "moe_e4m3"),
    # B9, the persistent TMA + wgmma absorb kernel
    ("B9 head stride off by one head", "absorb.cu",
     "const int col = h * hs + (UK ? j * AB_T : p.dn + ct * AB_T);",
     "const int col = ((h + 1) % p.H) * hs + (UK ? j * AB_T : p.dn + ct * AB_T);",
     "absorb_uk"),
    ("B9 uv dn offset dropped", "absorb.cu",
     "const int col = h * hs + (UK ? j * AB_T : p.dn + ct * AB_T);",
     "const int col = h * hs + (UK ? j * AB_T : ct * AB_T);", "absorb_uv"),
    ("B9 layer offset dropped", "absorb.cu",
     "const int row = p.layer * p.C + (UK ? ct : j) * AB_T;",
     "const int row = (UK ? ct : j) * AB_T;", "absorb_uk"),
    ("B9 uk weight tile read MN-major (the transpose bit flipped)", "absorb.cu",
     "wgmma_tile<TN, UK ? 0 : 1, 0>(acc, da, db);",
     "wgmma_tile<TN, 1, 0>(acc, da, db);", "absorb_uk"),
    ("B9 item walk skips its last item", "absorb.cu",
     "const int u_end = min(u_begin + p.per_block, p.items);",
     "const int u_end = min(u_begin + p.per_block, p.items - 1);", "absorb_uk"),
    ("B9 x head stride off by one head", "absorb.cu",
     ("tma_load_3d(xdst, &tmx, &full[s], j * AB_T, h, 0);",
      "tma_load_3d(xdst + TN * 128, &tmx, &full[s], j * AB_T + AB_BOX, h, 0);"),
     ("tma_load_3d(xdst, &tmx, &full[s], j * AB_T, (h + 1) % p.H, 0);",
      "tma_load_3d(xdst + TN * 128, &tmx, &full[s], j * AB_T + AB_BOX, (h + 1) % p.H, 0);"),
     "absorb_uv"),
    ("latent V read from the k_pe lanes", "attention.cu",
     "const uint32_t va = ka + 4 * h * LBOX;",
     "const uint32_t va = ka + 4 * h * LBOX + LBOX;",
     "latent_decode"),
    ("latent last head tile skipped", "attention.cu",
     "const int htiles = (a.H + LROWS - 1) / LROWS;",
     "const int htiles = (a.H + LROWS - 1) / LROWS - 1;",
     "latent_decode"),
    ("B4 new-token column not read", "attention.cu",
     "    total = q_start + 1;\n",
     "    total = a.mode == L_DECODE ? q_start : q_start + 1;\n",
     "latent_decode"),
    # the redesigned latent kernel (TMA + wgmma, split decode + merge)
    ("latent: the last context split skipped by the merge", "attention.cu",
     "const int n = s_hi - s_lo + 1;", "const int n = s_hi - s_lo;",
     "latent_decode"),
    ("latent: merge weights swapped between splits", "attention.cu",
     "    const float f = mw[i];\n", "    const float f = mw[n - 1 - i];\n",
     "latent_decode"),
    ("latent: the second value warpgroup's lanes left unwritten", "attention.cu",
     "    if (r >= live) continue;  // a dead row: never stored",
     "    if (r >= live || h == 1) continue;", "latent_decode"),
    ("latent: prefill causal limit one key off", "attention.cu",
     "bool ok = kp <= qp && kp < total;", "bool ok = kp <= qp + 1 && kp < total;",
     "latent_prefill"),
    ("latent: a dead mid-bench row stored", "attention.cu",
     "    if (r >= live) continue;  // a dead row: never stored",
     "    if (r >= LROWS) continue;", "latent_mid_decode"),
    ("latent: an e4m3 byte stage left unconverted (the k_pe box)", "attention.cu",
     "for (int e = tid; e < LNBOX * BK * 8; e += 256) {",
     "for (int e = tid; e < (LNBOX - 1) * BK * 8; e += 256) {", "latent_e4m3"),
    ("B10's transpose one byte off", "gemm_common.cuh",
     "t[0][g] = __byte_perm(lo01, lo23, 0x5410);",
     "t[0][g] = __byte_perm(lo01, lo23, 0x5401);", "int8"),
    ("B10's last K split dropped", "gemm_common.cuh",
     "for (int sp = 0; sp < nsplit; ++sp) v +=",
     "for (int sp = 0; sp < nsplit - 1; ++sp) v +=", "int8"),
    ("e4m3 decode drops the sign", "attention.cu",
     "__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)pair, __NV_E4M3);",
     "__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(pair & 0x7F7Fu), __NV_E4M3);",
     "e4m3_exact"),
    ("e4m3 decode flushes the subnormals", "attention.cu",
     "__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)pair, __NV_E4M3);",
     "__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)("
     "((pair & 0x78u) ? pair & 0xFFu : 0u) | ((pair & 0x7800u) ? pair & 0xFF00u : 0u)),"
     " __NV_E4M3);",
     "e4m3_exact"),
    ("fused append writes bf16 bytes into the e4m3 pool", "attention.cu",
     "w[j] |= e4m3_byte(__bfloat162float(h[4 * j + i])) << (8 * i);",
     "w[j] |= (uint32_t)(__bfloat16_as_ushort(h[4 * j + i]) >> 8) << (8 * i);",
     "e4m3_append"),
    ("e4m3 encode saturates to 448", "attention.cu",
     "if (!(fabsf(f) <= 464.f)) return (__float_as_uint(f) >> 31) ? 0xFFu : 0x7Fu;",
     "", "e4m3_overflow"),
    ("latent e4m3 tile: last 8 key rows left unconverted", "attention.cu",
     "*reinterpret_cast<uint4*>(tb + j * LBOX + r * 128 + ((c ^ (r & 7)) << 4)) = v;",
     "if (r < BK - 8) *reinterpret_cast<uint4*>(tb + j * LBOX + r * 128 + ((c ^ (r & 7)) << 4)) = v;",
     "latent_e4m3"),
    ("D-192 kernel reads V at lane offset 128 a head", "attention.cu",
     "cp16(vd, row + khalf + h * D + c * EPC);",
     "cp16(vd, row + khalf + h * (D == 192 ? 128 : D) + c * EPC);",
     "d192_decode"),
    ("head size 64 dispatched to the 32 instantiation", "attention.cu",
     "case 64: return f(std::integral_constant<int, 64>());",
     "case 64: return f(std::integral_constant<int, 32>());",
     "d64_prefill"),
    ("split decode: the last split's partial dropped", "attention.cu",
     "if (ml.x == -INFINITY) continue;",
     "if (ml.x == -INFINITY || s == S - 1) continue;", "split_decode"),
    ("split decode: the merge without its rescale", "attention.cu",
     "const float f = exp2f(ml.x - Mx);", "const float f = 1.f;",
     "split_decode"),
    ("split decode: a split ends one key short", "attention.cu",
     "const int end = min(tot + 1, s * chunk + chunk);",
     "const int end = min(tot + 1, s * chunk + chunk - 1);", "split_decode"),
    ("mask columns swapped within a pair of the mma layout", "attention.cu",
     "if (!ok(kw + 8 * j + 2 * t4 + (e & 1), e >> 1)) s[j][e] = -INFINITY;",
     "if (!ok(kw + 8 * j + 2 * t4 + 1 - (e & 1), e >> 1)) s[j][e] = -INFINITY;",
     "d128_prefill"),
    ("causal mask lets a row see the next key", "attention.cu",
     "return kp < kend && kp <= qp && kp / page < mp &&",
     "return kp < kend && kp <= qp + 1 && kp / page < mp &&", "d128_prefill"),
    ("the ring's newest stage not waited", "attention.cu",
     "__pipeline_wait_prior(NST - 2);",
     "__pipeline_wait_prior(NST - 1);", "split_decode"),
    ("e4m3 tile converted before its copy lands", "attention.cu",
     "    __pipeline_wait_prior(NST - 2);\n    __syncthreads();\n"
     "    if constexpr (FP8) {\n      convert(st, tid, nt);\n      __syncthreads();\n    }",
     "    if constexpr (FP8) convert(st, tid, nt);\n"
     "    __pipeline_wait_prior(NST - 2);\n    __syncthreads();",
     "e4m3_decode"),
    # B13 on the shared mainloop (bf16 tiles, the stack's [L * K, N] rows)
    ("B13 layer stride wrong", "gemm_common.cuh",
     "const long long wrow0 = (long long)expert * p.K;",
     "const long long wrow0 = (long long)expert * (p.K - 128);", "dense"),
    ("B13 last K tile skipped", "gemm_common.cuh",
     "const int t_cnt = base + (split < rem ? 1 : 0);",
     "const int t_cnt = base + (split < rem ? 1 : 0) - (split == nsplit - 1 ? 1 : 0);",
     "dense"),
    ("B13 layer row offset dropped", "gemm_common.cuh",
     "int expert = p.layer;", "int expert = 0;", "dense"),
    ("B13 last split dropped", "gemm_common.cuh",
     "for (int sp = 0; sp < nsplit; ++sp) v +=",
     "for (int sp = 0; sp < nsplit - 1; ++sp) v +=", "dense"),
    # the redesigned activation quantizers (B11, B12): vectors, a cluster
    # split at few rows
    ("quantizers: a cluster rank's partial sum of squares left out",
     "norm_quant.cu",
     "for (int c = 1; c < p.cluster; ++c) r = fold<MAX>",
     "for (int c = 1; c < p.cluster - (MAX ? 0 : 1); ++c) r = fold<MAX>", "acts"),
    ("quantizers: the amax combined over the local rank only", "norm_quant.cu",
     "const float o = lane < p.cluster ? *cl.map_shared_rank(red + slot, lane) : 0.f;",
     "const float o = lane < p.cluster ? (MAX ? red[slot] : "
     "*cl.map_shared_rank(red + slot, lane)) : 0.f;", "quant_acts"),
    ("quantizers: the scalar tail after the vector body skipped",
     "norm_quant.cu", "const int tail = p.D - head - (nvec << 3);",
     "const int tail = 0;", "quant_acts"),
    ("quantizers: a product with 1 / s in place of the division",
     "norm_quant.cu", "rintf(y / s)", "rintf(y * (1.f / s))", "quant_acts"),
    # odd ranks held back 20 us before they read the partials (in the sound
    # kernel too, as its control): without the barrier the even ranks run on
    # to the next row and overwrite theirs first
    ("quantizers: the exit barrier removed", "norm_quant.cu",
     ("    if (p.cluster > 1) cl.sync();\n", SLOW_READ[0]), ("", SLOW_READ[1]),
     "quant_acts_race", (SLOW_READ[0],), (SLOW_READ[1],)),
]


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from chitu_tpu_torch.models import moe
    from chitu_tpu_torch.ops import absorb_kernels as ab
    from chitu_tpu_torch.ops import attention as plain
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chip_smoke import (E4M3_EDGES, E4M3_OVERFLOW, e4m3_decode_exact, tie_rows,
                            with_values)
    from chitu_tpu_torch.models.common import kv_encode
    from chitu_tpu_torch.ops import cuda_build
    from chitu_tpu_torch.ops import dense_gemm_kernels as dg
    from chitu_tpu_torch.ops import moe_gemm_kernels as mg
    from chitu_tpu_torch.ops import norm_quant as nq
    from chitu_tpu_torch.ops import quant_gemm_kernels as qg
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf = torch.bfloat16
    randn = lambda *s, k=1.0: (torch.randn(s, generator=g, device=dev) * k).to(bf)
    T, K, N = 16, 4096, 6144
    x = randn(T, K)
    w = randn(K, N, k=0.02)
    w4 = qt.quantize_weight(w, QuantKind.W4A16)
    weights = {
        "e4m3_blockwise": qt.quantize_weight(w, QuantKind.SOFT_FP8),
        "e4m3_other": qt.quantize_weight(w.flip(0) * 3, QuantKind.SOFT_FP8),
        "int4_packed": qt.pack_int4_storage({"w": w4})["w"],
        "int4_unpacked": qt.quantize_weight(w[:, : N - 128], QuantKind.W4A16),
        "int8": qt.quantize_weight(w, QuantKind.W8A8),
    }
    x512 = randn(512, K)  # the slab tiles
    xa = nq.quant_acts_plain(x)
    nw = (1.0 + 0.1 * randn(29568).float()).to(bf)
    # the quantizers: decode rows (a cluster split), slab rows, an odd
    # width (row heads and tails), x 2 bytes past a 16-byte boundary, rows
    # of rounding ties
    acts_x = [randn(16, 14336), randn(1, 4096), randn(512, 14336),
              randn(3, 4100), randn(16 * 4096 + 1)[1:].view(16, 4096),
              tie_rows(torch, 16, 14336)[0].to(dev), randn(16, 29568)]
    # F 29568 (Qwen2-72B's FFN): split over a cluster at few rows
    acts_nx = [x, randn(4, 29568), randn(512, K), randn(3, 4100)]

    # the grouped GEMM: layer 1 of [2, 8, 4096, 14336], 16 tokens, top-2
    E, k, Tm = 8, 2, 16
    wm = torch.empty((2, E, K, 14336), dtype=bf, device=dev)
    for l in range(2):
        wm[l] = randn(E, K, 14336, k=0.02)
    wm8 = qt.quantize_stacked(
        wm, lambda t: qt.quantize_weight(t, QuantKind.SOFT_FP8))
    sel = torch.stack(
        [torch.randperm(E, generator=g, device=dev)[:k] for _ in range(Tm)]
    ).to(torch.int32)
    bm, NB = moe.dispatch_geometry(Tm, k, E)
    row_assign, block_expert = moe.sorted_dispatch(sel, E, bm)
    xs = randn(NB * bm, K)
    live = torch.repeat_interleave(block_expert >= 0, bm)
    assert int((~live).sum()) > 0

    # B9 at DeepSeek-R1's wkv_b, T 16
    Ha, C, dn, dv = 128, 512, 128, 128
    wkv = randn(2, C, Ha * (dn + dv), k=0.02)
    q_nope = randn(16, Ha, dn + 64)[..., :dn]
    o_lat = randn(16, Ha, C)

    # the latent row at DeepSeek-R1's decode geometry: 16 rows, H 128
    B, MP, PAGE, QK = 16, 33, 64, tk.LATENT_QK
    lpool = randn(2, B * MP, PAGE, 640, k=0.5)
    lpool[..., QK:] = 0
    lbt = torch.arange(B * MP, device=dev, dtype=torch.int32).reshape(B, MP)
    lseq = torch.randint(0, MP * PAGE - PAGE, (B,), generator=g,
                         device=dev).to(torch.int32)
    lseq[0], lseq[1] = 2047, 0
    plain.append_decode(lpool, 1, randn(B, 1, QK), None, lbt, lseq,
                        torch.ones(B, dtype=torch.bool, device=dev), PAGE)
    lq = randn(B, Ha, QK)
    lq_mid = randn(B, 32, QK)
    lqp = randn(128, Ha, QK)
    lkw = dict(kv_heads=1, head_dim=QK, split_kv=False, v_dim=tk.LATENT_DV,
               scale=0.1352)

    # the e4m3 pool at Llama-3-8B's geometry (32 heads on 8, 16 rows)
    KV8, D8 = 8, 128
    epool = kv_encode(randn(2, B * MP, PAGE, 2 * KV8 * D8, k=0.5), torch.int8)
    eq = randn(B, 32, D8)
    ek = with_values(torch, randn(B, KV8, D8), E4M3_EDGES)
    ev = with_values(torch, randn(B, KV8, D8), E4M3_EDGES[::-1])
    evalid = torch.ones(B, dtype=torch.bool, device=dev)
    lepool = kv_encode(lpool, torch.int8)
    # head size 192 (DeepSeek-R1 dense MLA, 128 heads, 4 rows) and 64
    B2 = 4
    dpool = randn(1, B2 * MP, PAGE, 2 * 128 * 192, k=0.5)
    dbt = torch.arange(B2 * MP, device=dev, dtype=torch.int32).reshape(B2, MP)
    dseq = lseq[:B2].clone()
    dq = randn(B2, 128, 192)
    spool = randn(2, 20, PAGE, 2 * 4 * 64, k=0.5)
    sbt = torch.arange(20, device=dev, dtype=torch.int32)
    sq = randn(128, 32, 64)
    spos = torch.arange(512, 640, device=dev, dtype=torch.int32)
    # the split decode and the tensor-core prefill at Llama-3-8B's
    # geometry: 16 decode rows of context up to 2048 (5 splits of 448
    # keys), a 128-token chunk at q_pos 512
    bpool = randn(2, B * MP, PAGE, 2 * KV8 * D8, k=0.5)
    pq = randn(128, 32, D8)
    ppos = torch.arange(512, 640, device=dev, dtype=torch.int32)
    # B13: layer 1 of [2, 4096, 6144]
    wd = randn(2, K, N, k=0.02)

    def row_rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()

    def check(kind):
        """-> (measured error, limit, what it is)."""
        if kind == "acts":
            # B11's three limits as one: each error over its limit
            worst = 0.0
            for xx in acts_nx:
                w_ = nw[: xx.shape[1]]
                got = nq.rms_norm_quant(xx, w_, 1e-5)
                want = nq.rms_norm_quant_plain(xx, w_, 1e-5)
                rel = ((got.scale - want.scale).abs() / want.scale).max().item()
                d = (got.data.int() - want.data.int()).abs()
                worst = max(worst, rel / 1e-6, (d != 0).float().mean().item() / 1e-3,
                            d.max().item() / 1.0)
            return (worst, 1.0, "largest of scale rel err / 1e-6, share of int8 "
                    "values off / 1e-3, int8 difference / 1")
        if kind == "quant_acts":
            bad = 0
            for xx in acts_x:
                junk = torch.full((xx.numel() // 2 + 1,), 7.0, dtype=bf, device=dev)
                del junk  # the int8 output lands on 7.0s
                got, want = nq.quant_acts(xx), nq.quant_acts_plain(xx)
                bad += int((got.data != want.data).sum()) + int(
                    (got.scale != want.scale).sum())
            return bad, 0, "int8 values and scales unlike the plain version's"
        if kind == "quant_acts_race":
            # one cluster of 4 walks all 16 rows of [16, 29568] (a plan
            # forced for this check), so a rank that skips the exit barrier
            # runs on to the next row
            xx = acts_x[-1]
            plan = nq.ActsPlan(4, 256, 1, 4, -(-(xx.shape[1] // 8) // 4), 4)
            committed = nq.plan_for
            nq.plan_for = lambda t: plan
            try:
                got = nq.quant_acts(xx)
            finally:
                nq.plan_for = committed
            want = nq.quant_acts_plain(xx)
            bad = int((got.data != want.data).sum()) + int((got.scale != want.scale).sum())
            return bad, 0, "int8 values and scales unlike the plain version's"
        if kind.startswith("moe"):
            wq = wm if kind == "moe_bf16" else wm8
            junk = torch.full((NB * bm, 14336), 7.0, dtype=bf, device=dev)
            del junk  # the output lands on this memory: dead rows must be written
            got = mg.grouped_matmul(xs, wq, 1, block_expert, bm)
            if kind == "moe_dead":
                return got[~live].float().abs().max().item(), 0.0, "largest value in a dead block"
            want = mg.grouped_matmul_plain(xs, wq, 1, block_expert, bm)
            return row_rel(got[live], want[live]), ROW_RTOL, "row relative error"
        if kind.startswith("absorb"):
            xin = q_nope if kind == "absorb_uk" else o_lat
            k_ = kind[-2:]
            junk = torch.full((16, Ha, C if k_ == "uk" else dv), 7.0,
                              dtype=bf, device=dev)
            del junk
            return (row_rel(ab.absorb_matmul(xin, wkv, 1, k_, dn, dv),
                            ab.absorb_matmul_plain(xin, wkv, 1, k_, dn, dv)),
                    ROW_RTOL, "row relative error")
        if kind == "latent_decode":
            # the output lands on memory that held 7.0s (see chip_smoke.poison)
            junk = torch.full((B, Ha, tk.LATENT_DV), 7.0, dtype=bf, device=dev)
            del junk
            got = tk.attend_decode(lq, lpool, 1, lbt, lseq, PAGE, **lkw)
            want = tk._vlanes(plain.attend_decode(
                lq, lpool, 1, lbt, lseq, PAGE, 1, QK, scale=lkw["scale"],
                split_kv=False), tk.LATENT_DV)
            return row_rel(got, want), ROW_RTOL, "row relative error"
        if kind == "latent_mid_decode":
            # deepseek-mid-bench's 32 heads: half of each decode tile dead
            junk = torch.full((B, 32, tk.LATENT_DV), 7.0, dtype=bf, device=dev)
            del junk
            got = tk.attend_decode(lq_mid, lpool, 1, lbt, lseq, PAGE, **lkw)
            want = tk.attend_decode_plain(lq_mid, lpool, 1, lbt, lseq, PAGE, **lkw)
            return row_rel(got, want), ROW_RTOL, "row relative error"
        if kind == "latent_prefill":
            junk = torch.full((128, Ha, tk.LATENT_DV), 7.0, dtype=bf, device=dev)
            del junk
            a = (lqp, lpool, 1, lbt[2], ppos, 640, PAGE)
            return (row_rel(tk.attend_prefill(*a, **lkw), tk.attend_prefill_plain(*a, **lkw)),
                    ROW_RTOL, "row relative error")
        if kind == "e4m3_exact":
            return (e4m3_decode_exact(torch, tk, dev), 0, "values decoded wrong")
        if kind in ("e4m3_append", "e4m3_overflow"):
            kk, vv = ek, ev
            if kind == "e4m3_overflow":
                kk = with_values(torch, ek, E4M3_OVERFLOW + E4M3_EDGES)
                vv = with_values(torch, ev, E4M3_EDGES + E4M3_OVERFLOW)
            pk, pp = epool.clone(), epool.clone()
            args = (1, kk, vv, lbt, lseq, evalid, PAGE, KV8, D8)
            tk.attend_decode_fused(eq, pk, *args)
            tk.attend_decode_fused_plain(eq, pp, *args)
            return int((pk != pp).sum().item()), 0, "pool bytes unlike the plain append's"
        if kind == "latent_e4m3":
            junk = torch.full((B, Ha, tk.LATENT_DV), 7.0, dtype=bf, device=dev)
            del junk
            return (row_rel(tk.attend_decode(lq, lepool, 1, lbt, lseq, PAGE, **lkw),
                            tk.attend_decode_plain(lq, lepool, 1, lbt, lseq, PAGE,
                                                   **lkw)),
                    ROW_RTOL, "row relative error")
        if kind in ("split_decode", "e4m3_decode"):
            pool = bpool if kind == "split_decode" else epool
            junk = torch.full((B, 32, D8), 7.0, dtype=bf, device=dev)
            del junk
            a = (eq, pool, 1, lbt, lseq, PAGE, KV8, D8)
            return (row_rel(tk.attend_decode(*a), tk.attend_decode_plain(*a)),
                    ROW_RTOL, "row relative error")
        if kind == "d128_prefill":
            a = (pq, bpool, 1, lbt[2], ppos, 640, PAGE, KV8, D8)
            return (row_rel(tk.attend_prefill(*a), tk.attend_prefill_plain(*a)),
                    ROW_RTOL, "row relative error")
        if kind == "d192_decode":
            a = (dq, dpool, 0, dbt, dseq, PAGE, 128, 192)
            return (row_rel(tk.attend_decode(*a), tk.attend_decode_plain(*a)),
                    ROW_RTOL, "row relative error")
        if kind == "d64_prefill":
            a = (sq, spool, 1, sbt, spos, 640, PAGE, 4, 64)
            return (row_rel(tk.attend_prefill(*a), tk.attend_prefill_plain(*a)),
                    ROW_RTOL, "row relative error")
        if kind == "dense":
            junk = torch.full((T, 2 * N), 7.0, dtype=bf, device=dev)
            del junk
            return (row_rel(dg.dense_matmul_stacked(x, 1, wd),
                            dg.dense_matmul_stacked_plain(x, 1, wd)),
                    ROW_RTOL, "row relative error")
        if kind == "int8":
            q = weights["int8"]
            return (row_rel(qg.int8_gemm(xa.data, xa.scale, q),
                            qg.int8_gemm_plain(xa.data, xa.scale, q)),
                    1e-5, "row relative error")
        if kind == "e4m3_poisoned":
            # a launch on other data first, so that shared memory a block
            # reads before its copies land holds other values (a race that
            # reads the previous launch's tiles of the same inputs passes)
            qg.quant_gemm(x, weights["e4m3_other"])
            q = weights["e4m3_blockwise"]
            return (row_rel(qg.quant_gemm(x, q), qg.quant_gemm_plain(x, q)),
                    ROW_RTOL, "row relative error")
        if kind == "e4m3_slab":
            q = weights["e4m3_blockwise"]
            return (row_rel(qg.quant_gemm(x512, q), qg.quant_gemm_plain(x512, q)),
                    ROW_RTOL, "row relative error")
        q = weights[kind]
        return (row_rel(qg.quant_gemm(x, q), qg.quant_gemm_plain(x, q)),
                ROW_RTOL, "row relative error")

    def use_sources(csrc):
        cuda_build.CSRC = csrc
        cuda_build._LIBS.clear()
        qg._LIB = nq._LIB = mg._LIB = ab._LIB = tk._LIB = dg._LIB = None

    sound_dir = cuda_build.CSRC
    ok = True
    words = sys.argv[1:]
    def edited(src, olds, news, name):
        """A temporary copy of the sources with `src` edited."""
        tmp = tempfile.mkdtemp(prefix="faults-")
        for f in os.listdir(sound_dir):
            shutil.copy(os.path.join(sound_dir, f), tmp)
        path = os.path.join(tmp, src)
        text = open(path).read()
        for o, n in zip(olds, news):
            if text.count(o) != 1:
                raise SystemExit(f"{name}: the line to break is not unique in {src}")
            text = text.replace(o, n)
        with open(path, "w") as f:
            f.write(text)
        return tmp

    for name, src, old, new, kind, *control in FAULTS:
        if words and not any(w in name or w == src for w in words):
            continue
        tmps, failed = [], None
        try:
            if control:  # the sound kernel with the control's edits
                tmps.append(edited(src, *control, name))
                use_sources(tmps[-1])
            else:
                use_sources(sound_dir)
            sound, limit, what = check(kind)
            olds, news = ((old, new) if isinstance(old, tuple)
                          else ((old,), (new,)))
            tmps.append(edited(src, olds, news, name))
            use_sources(tmps[-1])
            try:
                broken, _, _ = check(kind)
                torch.cuda.synchronize()
            except torch.AcceleratorError as e:  # the broken kernel faulted
                broken, failed = float("inf"), str(e).splitlines()[0]
        finally:
            use_sources(sound_dir)
            for tmp in tmps:
                shutil.rmtree(tmp, ignore_errors=True)
        rejected = not broken <= limit
        ok = ok and rejected and sound <= limit
        print(json.dumps(dict(
            fault=name, source=src, check=kind, control=bool(control),
            measure=what, limit=limit, launch_error=failed,
            sound=sound, broken=broken, rejected=rejected,
            card=torch.cuda.get_device_name(0),
        )), flush=True)
        if failed:  # the context is lost with the launch: no later fault can run
            print(f"stopped after a launch error: {failed}", flush=True)
            ok = ok and name == FAULTS[-1][0]
            break
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
