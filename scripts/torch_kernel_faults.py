#!/usr/bin/env python3
"""Shows that the limits `chip_smoke.py` holds the quantized, grouped,
absorb and dense GEMM kernels and the attention kernels (the latent row,
the e4m3 pool, the split layout at head sizes 192 and 64, the split decode
and the tensor-core prefill) to reject broken kernels. Needs an NVIDIA GPU and nvcc.

    python3 scripts/torch_kernel_faults.py [words ...]

With words, only the faults whose name holds one of them are planted.

For each planted fault it copies `chitu_tpu_torch/csrc/` into a temporary
directory, edits one line of one source there (the repository's sources
are never touched), builds that copy, points the wrappers at it and runs
the comparison with the plain version that `chip_smoke.py` runs for the
mode the fault touches, at a Llama-3-8B projection shape (the grouped GEMM:
layer 1 of a two-layer Mixtral-8x7B `[4096 -> 14336]` expert stack at the
16-token decode geometry, where two of ten blocks are dead; B9: layer 1
of DeepSeek-R1's `wkv_b` [2, 512, 128*256] at T 16, uk reading q_nope as a
view of the [T, 128, 192] query rows; the latent row: B4 at DeepSeek-R1's
16-row decode geometry, contexts 1 to 2048; the e4m3 pool: B4 over
one-token contexts holding every finite code, which must decode exactly,
B1's append bytes against the plain append's for edge values and for
values beyond e4m3's range, the latent B4 on an e4m3 pool; head size 192:
B4 at DeepSeek-R1's dense MLA, 128 heads; head size 64: B5 at
tiny-llama-debug's 32 heads on 4; B13: layer 1 of a two-layer
`[4096 -> 6144]` stack at T 16; the split decode: B4 at Llama-3-8B's
16-row decode geometry, contexts up to 2048 in five splits, on a bf16 and
on an e4m3 pool; the tensor-core prefill: B5 for a 128-token chunk at
q_pos 512). It prints one
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

FAULTS = [
    # (name, source, old text, new text, check)
    ("scale block index off by one", "quant_gemm.cu",
     "return (size_t)kb * a.scale_ld + n / a.block;",
     "return (size_t)kb * a.scale_ld + (n / a.block > 0 ? n / a.block - 1 : 0);",
     "e4m3_blockwise"),
    ("last K block skipped", "quant_gemm.cu",
     "const int t_cnt = base + (split < rem ? 1 : 0);",
     "const int t_cnt = base + (split < rem ? 1 : 0) - (split == a.splits - 1 ? 1 : 0);",
     "e4m3_blockwise"),
    ("low and high nibbles swapped", "quant_gemm.cu",
     "f[i] = (float)(u.b[i] & 0xF);\n      f[8 + i] = (float)(u.b[i] >> 4);",
     "f[8 + i] = (float)(u.b[i] & 0xF);\n      f[i] = (float)(u.b[i] >> 4);",
     "int4_packed"),
    ("zeros dropped", "quant_gemm.cu",
     "if (MODE >= MODE_INT4) v -= z[e];", "", "int4_unpacked"),
    ("x_scale left out", "quant_gemm.cu",
     "(float)cw[idx] * a.x_scale[t] * a.w_scale[n]",
     "(float)cw[idx] * a.w_scale[n]", "int8"),
    ("truncation instead of round-half-to-even", "norm_quant.cu",
     "rintf(y / s)", "truncf(y / s)", "acts"),
    ("expert index off by one", "moe_gemm.cu",
     "const uint8_t* w = a.w + (size_t)e * a.K * a.N * wbytes;",
     "const uint8_t* w = a.w + (size_t)((e + 1) % a.E) * a.K * a.N * wbytes;",
     "moe_bf16"),
    ("layer offset dropped", "moe_gemm.cu",
     "a.w = (const uint8_t*)w + (size_t)layer * E * K * N * (fp8 ? 1 : 2);",
     "a.w = (const uint8_t*)w;", "moe_bf16"),
    ("dead block left unzeroed", "moe_gemm.cu",
     "if (split == 0) {", "if (split < 0) {", "moe_dead"),
    ("expert scale block index off by one", "moe_gemm.cu",
     "(a.scale_rowwise ? n : n / QBLK);",
     "(a.scale_rowwise ? n : (n / QBLK > 0 ? n / QBLK - 1 : 0));", "moe_e4m3"),
    ("last K tile of the grouped GEMM skipped", "moe_gemm.cu",
     "const int t_cnt = base + (split < rem ? 1 : 0);",
     "const int t_cnt = base + (split < rem ? 1 : 0) - (split == nsplit - 1 ? 1 : 0);",
     "moe_e4m3"),
    ("B9 head stride off by one head", "absorb.cu",
     "w + int64_t(layer) * C * HS + int64_t(h) * S;",
     "w + int64_t(layer) * C * HS + int64_t((h + 1) % H) * S;", "absorb_uk"),
    ("B9 uv dn offset dropped", "absorb.cu",
     "wl + int64_t(k0 + k) * HS + dn + nt * BN + c * 8, 16);",
     "wl + int64_t(k0 + k) * HS + nt * BN + c * 8, 16);", "absorb_uv"),
    ("B9 layer offset dropped", "absorb.cu",
     "w + int64_t(layer) * C * HS + int64_t(h) * S;",
     "w + int64_t(h) * S;", "absorb_uk"),
    ("latent V read from the k_pe lanes", "attention.cu",
     "const bf16* vb = ks + (k0 + (lane & 15)) * LLD + vd + 8 * (lane >> 4);",
     "const bf16* vb = ks + (k0 + (lane & 15)) * LLD + vd + 64 + 8 * (lane >> 4);",
     "latent_decode"),
    ("latent last head tile skipped", "attention.cu",
     "dim3 grid(nrows / BQ, H / HT);", "dim3 grid(nrows / BQ, H / HT - 1);",
     "latent_decode"),
    ("B4 new-token column not read", "attention.cu",
     "    kend = total;\n", "    kend = mode == L_DECODE ? q_start : total;\n",
     "latent_decode"),
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
     "*reinterpret_cast<uint4*>(ks + r * LLD + c * 8) = IO::to_bf16(",
     "if (r < BK - 8) *reinterpret_cast<uint4*>(ks + r * LLD + c * 8) = IO::to_bf16(",
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
    ("B13 layer stride wrong", "dense_gemm.cu",
     "w + (size_t)layer * K * N;", "w + (size_t)layer * K * (N - 128);",
     "dense"),
    ("B13 last K tile skipped", "dense_gemm.cu",
     "const int ntiles = K / BK;", "const int ntiles = K / BK - 1;", "dense"),
]


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from chitu_tpu_torch.models import moe
    from chitu_tpu_torch.ops import absorb_kernels as ab
    from chitu_tpu_torch.ops import attention as plain
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chip_smoke import E4M3_EDGES, E4M3_OVERFLOW, e4m3_decode_exact, with_values
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
        "int4_packed": qt.pack_int4_storage({"w": w4})["w"],
        "int4_unpacked": qt.quantize_weight(w[:, : N - 128], QuantKind.W4A16),
        "int8": qt.quantize_weight(w, QuantKind.W8A8),
    }
    xa = nq.quant_acts_plain(x)
    nw = (1.0 + 0.1 * randn(K).float()).to(bf)

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
            got, want = nq.rms_norm_quant(x, nw, 1e-5), nq.rms_norm_quant_plain(x, nw, 1e-5)
            d = (got.data.int() - want.data.int()).abs()
            return (d != 0).float().mean().item(), 1e-3, "share of int8 values off"
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
            return (row_rel(dg.dense_matmul_stacked(x, 1, wd),
                            dg.dense_matmul_stacked_plain(x, 1, wd)),
                    ROW_RTOL, "row relative error")
        if kind == "int8":
            q = weights["int8"]
            return (row_rel(qg.int8_gemm(xa.data, xa.scale, q),
                            qg.int8_gemm_plain(xa.data, xa.scale, q)),
                    1e-5, "row relative error")
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
    for name, src, old, new, kind in FAULTS:
        if words and not any(w in name for w in words):
            continue
        use_sources(sound_dir)
        sound, limit, what = check(kind)
        tmp = tempfile.mkdtemp(prefix="faults-")
        try:
            for f in os.listdir(sound_dir):
                shutil.copy(os.path.join(sound_dir, f), tmp)
            path = os.path.join(tmp, src)
            text = open(path).read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the line to break is not unique in {src}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
            use_sources(tmp)
            broken, _, _ = check(kind)
            torch.cuda.synchronize()
        finally:
            use_sources(sound_dir)
            shutil.rmtree(tmp, ignore_errors=True)
        rejected = not broken <= limit
        ok = ok and rejected and sound <= limit
        print(json.dumps(dict(
            fault=name, source=src, check=kind, measure=what, limit=limit,
            sound=sound, broken=broken, rejected=rejected,
            card=torch.cuda.get_device_name(0),
        )), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
