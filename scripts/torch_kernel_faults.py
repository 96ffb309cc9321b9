#!/usr/bin/env python3
"""Shows that the limits `chip_smoke.py` holds the quantized, grouped and
absorb GEMM kernels and the latent-row attention kernel to reject broken
kernels. Needs an NVIDIA GPU and nvcc.

    python3 scripts/torch_kernel_faults.py

For each planted fault it copies `chitu_tpu_torch/csrc/` into a temporary
directory, edits one line of one source there (the repository's sources
are never touched), builds that copy, points the wrappers at it and runs
the comparison with the plain version that `chip_smoke.py` runs for the
mode the fault touches, at a Llama-3-8B projection shape (the grouped GEMM:
layer 1 of a two-layer Mixtral-8x7B `[4096 -> 14336]` expert stack at the
16-token decode geometry, where two of ten blocks are dead; B9: layer 1
of DeepSeek-R1's `wkv_b` [2, 512, 128*256] at T 16, uk reading q_nope as a
view of the [T, 128, 192] query rows; the latent row: B4 at DeepSeek-R1's
16-row decode geometry, contexts 1 to 2048). It prints one
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
]


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from chitu_tpu_torch.models import moe
    from chitu_tpu_torch.ops import absorb_kernels as ab
    from chitu_tpu_torch.ops import attention as plain
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chitu_tpu_torch.ops import cuda_build
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
        qg._LIB = nq._LIB = mg._LIB = ab._LIB = tk._LIB = None

    sound_dir = cuda_build.CSRC
    ok = True
    for name, src, old, new, kind in FAULTS:
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
