#!/usr/bin/env python3
"""What holds the TMA + wgmma GEMM mainloop back, on one GPU: the dequant
GEMM (B6+B7) and the grouped expert GEMM (B8) with parts taken out.

    python3 scripts/torch_gemm_ablate.py [variant name ...]

The card has no kernel profiler that reads stall reasons here, so this
script takes parts out of the shared mainloop instead. For each variant it
copies `chitu_tpu_torch/csrc/` into a temporary directory, edits the copy
of `gemm_common.cuh` (the repository's sources are never touched), builds
`quant_gemm.cu` and `moe_gemm.cu` from it, points the wrappers at the copy
and times, as device time (CUDA-graph replay, as `chip_smoke.py` takes
it): `quant_gemm` with e4m3 blockwise weights at Llama-3-8B's three
projection shapes, and `grouped_gemm` over Mixtral-8x7B's merged e4m3
gate/up stack `[4096 -> 28672]` (8 experts, top-2), each at T 16 (the
swapped decode tiles) and T 512 (the slab tiles). The variants compute
wrong results on purpose; only their times are read. Prints one JSON line
per variant with the card's name and power limit.
"""

import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WGMMA_CALLS = [
    "wgmma_m64n128_t01(acc[mh], da, db);",
    "wgmma_m64n16_t10(acc[0], da, db);",
    "wgmma_m64n32_t10(acc[0], da, db);",
    "wgmma_m64n64_t10(acc[0], da, db);",
]
NO_WGMMA = [(c, "{ (void)da; (void)db; }") for c in WGMMA_CALLS]
NO_CONVERT = [(
    "convert16<MODE>(raw, h, sc, zr, o);",
    "o[0] = o[4] = raw.x; o[1] = o[5] = raw.y; o[2] = o[6] = raw.z; "
    "o[3] = o[7] = raw.w;",
)]
NO_WEIGHT_COPY = [
    ("mbar_arrive_tx(&full[s], (p.tma_w ? L::WSTAGE : 0) + (p.tma_x ? L::XSTAGE : 0));",
     "mbar_arrive_tx(&full[s], p.tma_x ? L::XSTAGE : 0);"),
    ("            tma_load_2d(wdst, &tmw, &full[s], bx * L::RAWROW, wr);", ""),
]
NO_SYNC = [(
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
    "without the conversion and the wgmma": NO_CONVERT + NO_WGMMA,
    "without the converted tile's fence and barrier": NO_SYNC,
}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from chitu_tpu_torch.models import moe
    from chitu_tpu_torch.ops import cuda_build
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

    sound = cuda_build.CSRC
    for name, edits in VARIANTS.items():
        if sys.argv[1:] and name not in sys.argv[1:]:
            continue
        tmp = tempfile.mkdtemp(prefix="gemm-variant-")
        try:
            for f in os.listdir(sound):
                shutil.copy(os.path.join(sound, f), tmp)
            path = os.path.join(tmp, "gemm_common.cuh")
            text = open(path).read()
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: the line to edit is not unique")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            cuda_build.CSRC = tmp
            cuda_build._LIBS.clear()
            qg._LIB = mg._LIB = None
            cuda_build.build_all(("quant_gemm", "moe_gemm"))
            ms = {}
            for T in (16, 512):
                for kk, n in shapes:
                    x, q = xs[T][(kk, n)], ws[(kk, n)]
                    ms[f"quant_gemm T={T} {kk}->{n}"] = chip_smoke.device_ms_sized(
                        torch, lambda: qg.quant_gemm(x, q))
                xm, be, bm = moe_cases[T]
                ms[f"grouped_gemm T={T} {K}->{N} e4m3 bm={bm}"] = (
                    chip_smoke.device_ms_sized(
                        torch, lambda: mg.grouped_matmul(xm, wm8, 0, be, bm)))
            print(json.dumps(dict(variant=name, ms=ms, card=card)), flush=True)
        finally:
            cuda_build.CSRC = sound
            cuda_build._LIBS.clear()
            qg._LIB = mg._LIB = None
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
