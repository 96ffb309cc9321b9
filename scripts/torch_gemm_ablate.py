#!/usr/bin/env python3
"""What holds the TMA + wgmma GEMM kernels back, on one GPU: the dequant
GEMM (B6+B7), the W8A8 int8 GEMM (B10), the grouped expert GEMM (B8) and
the dense stacked-layer GEMM (B13), which share the mainloop of
`gemm_common.cuh`, and the MLA absorb kernel (B9, `absorb.cu`), with parts
taken out.

    python3 scripts/torch_gemm_ablate.py [variant name ...]

The card has no kernel profiler that reads stall reasons here, so this
script takes parts out of the kernels instead. For each variant it copies
`chitu_tpu_torch/csrc/` into a temporary directory, edits the copies of
`gemm_common.cuh` and `absorb.cu` (the repository's sources are never
touched), builds the four sources from them, points the wrappers at the
copy and times, as device time (CUDA-graph replay, as `chip_smoke.py`
takes it, the weights warm in L2 where they fit): `quant_gemm` with e4m3
blockwise weights at Llama-3-8B's three projection shapes and
`int8_gemm` (B10) at the same shapes with W8A8 weights (its conversion
is the byte transpose), `grouped_gemm` over Mixtral-8x7B's merged e4m3
gate/up stack `[4096 -> 28672]` (8 experts, top-2), each at T 16 (the
swapped decode tiles) and T 512 (the slab tiles); `dense_matmul_stacked` at Llama-3-8B's four stacked
shapes at T 16 and 512; `absorb_matmul` uk and uv at DeepSeek-R1's wkv_b
(128 heads) at T 16 and 128. A variant leaves the kernels it does not
touch as they are. The variants compute wrong results on purpose; only
their times are read. Prints one JSON line per variant with the card's
name and power limit.
"""

import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (file, old text, new text)
NO_WGMMA = [
    ("gemm_common.cuh", "wgmma_m64n128<0, 1>(acc[mh], da, db);", "{ (void)da; (void)db; }"),
    ("gemm_common.cuh", "wgmma_tile<TN, 1, 0>(acc[0], da, db);", "{ (void)da; (void)db; }"),
    ("gemm_common.cuh",
     "wgmma_s8_m64n128(acc[mh], sw128_desc(xk + (h * NSUB + mh) * 64 * 128, 16, 1024),\n"
     "                             db);", "(void)db;"),
    ("gemm_common.cuh",
     "wgmma_s8_tile<TN>(acc[0], sw128_desc(wk + h * 64 * 128, 16, 1024),\n"
     "                            sw128_desc(xk, 16, 1024));", ";"),
    ("absorb.cu", "wgmma_tile<TN, UK ? 0 : 1, 0>(acc, da, db);", "{ (void)da; (void)db; }"),
]
NO_CONVERT = [(
    "gemm_common.cuh",
    "convert16<MODE>(raw, h, sc, zr, o);",
    "o[0] = o[4] = raw.x; o[1] = o[5] = raw.y; o[2] = o[6] = raw.z; "
    "o[3] = o[7] = raw.w;",
), (  # B10: the raw words stored as they were loaded, no byte transposes
    "gemm_common.cuh",
    "make_uint4(t[c][0], t[c][1], t[c][2], t[c][3]);",
    "make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);",
)]
MAINLOOP_W_TMA = [
    ("gemm_common.cuh", "            tma_load_2d(wdst, &tmw, &full[s], bx * BN, wr);", ""),
    ("gemm_common.cuh",
     "            tma_load_2d(wdst + BK * 128, &tmw, &full[s], bx * BN + 64, wr);", ""),
    ("gemm_common.cuh", "            tma_load_2d(wdst, &tmw, &full[s], bx * L::RAWROW, wr);",
     ""),
]
ABSORB_W_TMA = [
    ("absorb.cu", "        tma_load_2d(wdst, &tmw, &full[s], col, row);", ""),
    ("absorb.cu", "        tma_load_2d(wdst + AB_T * 128, &tmw, &full[s], col + AB_BOX, row);",
     ""),
]
NO_WEIGHT_COPY = [
    ("gemm_common.cuh",
     "mbar_arrive_tx(&full[s], (p.tma_w ? L::WSTAGE : 0) + (p.tma_x ? L::XSTAGE : 0));",
     "mbar_arrive_tx(&full[s], p.tma_x ? L::XSTAGE : 0);"),
    ("absorb.cu", "mbar_arrive_tx(&full[s], L::WSTAGE + L::XSTAGE);",
     "mbar_arrive_tx(&full[s], L::XSTAGE);"),
] + MAINLOOP_W_TMA + ABSORB_W_TMA
NO_COPIES = [
    ("gemm_common.cuh",
     "mbar_arrive_tx(&full[s], (p.tma_w ? L::WSTAGE : 0) + (p.tma_x ? L::XSTAGE : 0));",
     "mbar_arrive_tx(&full[s], 0);"),
    ("gemm_common.cuh",
     "            tma_load_2d(xdst + a * L::ROWS * 128, &tmx, &full[s], k0 + (128 / L::XES) * a, m0);",
     "            ;"),
    ("absorb.cu", "mbar_arrive_tx(&full[s], L::WSTAGE + L::XSTAGE);",
     "mbar_arrive_tx(&full[s], 0);"),
    ("absorb.cu", "        tma_load_3d(xdst, &tmx, &full[s], j * AB_T, h, 0);", ""),
    ("absorb.cu",
     "        tma_load_3d(xdst + TN * 128, &tmx, &full[s], j * AB_T + AB_BOX, h, 0);", ""),
] + MAINLOOP_W_TMA + ABSORB_W_TMA
NO_SYNC = [(
    "gemm_common.cuh",
    "      fence_proxy_async();  // the converted tile is read by wgmma (async proxy)\n"
    "      if (SLAB)\n"
    "        named_bar_sync(1, 256);  // both halves of the tile are written\n"
    "      else\n"
    "        named_bar_sync(2 + h, 128);\n",
    "",
)]
VARIANTS = {
    "as committed": [],
    "without the conversion (raw bytes stored as the bf16 tile)": NO_CONVERT,
    "without the wgmma": NO_WGMMA,
    "without the weight copies (no weight TMA)": NO_WEIGHT_COPY,
    "without any copies (no TMA)": NO_COPIES,
    "without the conversion and the wgmma": NO_CONVERT + NO_WGMMA,
    "without the converted tile's fence and barrier": NO_SYNC,
}
SOURCES = ("quant_gemm", "moe_gemm", "dense_gemm", "absorb")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from chitu_tpu_torch.models import moe
    from chitu_tpu_torch.ops import absorb_kernels as ab
    from chitu_tpu_torch.ops import cuda_build
    from chitu_tpu_torch.ops import dense_gemm_kernels as dg
    from chitu_tpu_torch.ops import moe_gemm_kernels as mg
    from chitu_tpu_torch.ops import quant_gemm_kernels as qg
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

    card = chip_smoke.card_line()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf = torch.bfloat16
    randn = lambda *s, k=1.0: (torch.randn(s, generator=g, device=dev) * k).to(bf)
    shapes = [(4096, 28672), (4096, 6144), (14336, 4096)]
    ws = {s: qt.quantize_weight(randn(*s, k=0.02), QuantKind.SOFT_FP8) for s in shapes}
    xs = {T: {s: randn(T, s[0]) for s in shapes} for T in (16, 512)}
    from chitu_tpu_torch.ops import norm_quant as nq

    w8s = {s: qt.quantize_weight(randn(*s, k=0.02), QuantKind.W8A8) for s in shapes}
    x8s = {T: {s: nq.quant_acts_plain(xs[T][s]) for s in shapes} for T in (16, 512)}

    E, k, K, N = 8, 2, 4096, 28672
    wm = torch.empty((1, E, K, N), dtype=bf, device=dev)
    wm[0].normal_(0.0, 0.02, generator=g)
    wm8 = qt.quantize_stacked(wm, lambda t: qt.quantize_weight(t, QuantKind.SOFT_FP8))
    del wm
    rng = np.random.default_rng(0)
    moe_cases = {}
    for T in (16, 512):
        sel = torch.tensor(np.stack([rng.permutation(E)[:k] for _ in range(T)]),
                           dtype=torch.int32, device=dev)
        bm, NB = moe.dispatch_geometry(T, k, E)
        _, be = moe.sorted_dispatch(sel, E, bm)
        moe_cases[T] = (randn(NB * bm, K), be, bm)
    dense = {s: randn(2, *s, k=0.02) for s in chip_smoke.DENSE_PROJ}
    xd = {T: {s: randn(T, s[0]) for s in dense} for T in (16, 512)}
    H, C, dn, dv = 128, 512, 128, 128
    wkv = randn(2, C, H * (dn + dv), k=0.02)
    xab = {(T, kind): (randn(T, H, dn + 64)[..., :dn] if kind == "uk" else randn(T, H, C))
           for T in (16, 128) for kind in ("uk", "uv")}

    def use(csrc):
        cuda_build.CSRC = csrc
        cuda_build._LIBS.clear()
        qg._LIB = mg._LIB = dg._LIB = ab._LIB = None

    sound = cuda_build.CSRC
    for name, edits in VARIANTS.items():
        if sys.argv[1:] and name not in sys.argv[1:]:
            continue
        tmp = tempfile.mkdtemp(prefix="gemm-variant-")
        try:
            for f in os.listdir(sound):
                shutil.copy(os.path.join(sound, f), tmp)
            texts = {}
            for f, old, new in edits:
                if f not in texts:
                    texts[f] = open(os.path.join(tmp, f)).read()
                if texts[f].count(old) != 1:
                    raise SystemExit(f"{name}: the line to edit is not unique in {f}")
                texts[f] = texts[f].replace(old, new)
            for f, text in texts.items():
                with open(os.path.join(tmp, f), "w") as fh:
                    fh.write(text)
            use(tmp)
            cuda_build.build_all(SOURCES)
            ms = {}
            for T in (16, 512):
                for kk, n in shapes:
                    x, q = xs[T][(kk, n)], ws[(kk, n)]
                    ms[f"quant_gemm T={T} {kk}->{n}"] = chip_smoke.device_ms_sized(
                        torch, lambda: qg.quant_gemm(x, q))
                    xa, w8 = x8s[T][(kk, n)], w8s[(kk, n)]
                    ms[f"int8_gemm T={T} {kk}->{n}"] = chip_smoke.device_ms_sized(
                        torch, lambda: qg.int8_gemm(xa.data, xa.scale, w8))
                xm, be, bm = moe_cases[T]
                ms[f"grouped_gemm T={T} {K}->{N} e4m3 bm={bm}"] = (
                    chip_smoke.device_ms_sized(
                        torch, lambda: mg.grouped_matmul(xm, wm8, 0, be, bm)))
                for (kk, n), wd in dense.items():
                    x = xd[T][(kk, n)]
                    ms[f"dense_matmul_stacked T={T} {kk}->{n}"] = chip_smoke.device_ms_sized(
                        torch, lambda: dg.dense_matmul_stacked(x, 1, wd))
            for (T, kind), x in xab.items():
                ms[f"absorb_matmul R1 {kind} T={T}"] = chip_smoke.device_ms_sized(
                    torch, lambda: ab.absorb_matmul(x, wkv, 1, kind, dn, dv))
            print(json.dumps(dict(variant=name, ms=ms, card=card)), flush=True)
        finally:
            use(sound)
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
