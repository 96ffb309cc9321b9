#!/usr/bin/env python3
"""Which part of the decode-shape dequant GEMM costs its time, on one GPU.

    python3 scripts/torch_quant_gemm_variants.py [variant name ...]

The card has no kernel profiler that reads stall reasons here, so this
script takes parts out of the T <= 16 kernel instead. For each variant it
copies `chitu_tpu_torch/csrc/` into a temporary directory, edits the copy
of `quant_gemm.cu` (the repository's sources are never touched), builds
it, points the wrapper at it and times `quant_gemm` with e4m3 blockwise
weights at T 16 for the three Llama-3-8B projection shapes (device time,
CUDA-graph replay, as `chip_smoke.py` takes it). The variants compute
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

MMA = "wmma::mma_sync(acc[fi][fj], af[fi], bf, acc[fi][fj]);"
VARIANTS = {
    "as committed": [],
    "no tensor-core products": [(MMA, ";")],
    "no products and no fragment loads": [
        (MMA, ";"),
        ("wmma::load_matrix_sync(bf, &sB[(kk * 16) * L::LDB + (wn * FN + fj) * 16], L::LDB);",
         "wmma::fill_fragment(bf, 0.f);"),
        ("wmma::load_matrix_sync(af[fi], &xt[((wm * FM + fi) * 16) * L::LDX + kk * 16], L::LDX);",
         "wmma::fill_fragment(af[fi], 0.f);"),
    ],
    "no dequant arithmetic (raw bytes copied to the bf16 tile)": [
        ("      decode_chunk<MODE>(chunk, f);\n      apply_scales<MODE>(f, sc, zr);\n"
         "      store_bf16<MODE>(&sB[row * L::LDB], cc, f);",
         "      *reinterpret_cast<uint4*>(&sB[row * L::LDB + local_col<MODE>(cc, 0)]) = chunk;"),
    ],
    "no weight bytes read from device memory": [
        ("        __pipeline_memcpy_async(dst, a.w + (size_t)k * a.w_ld + wcol, CB);",
         "        ;"),
    ],
    "four stages (one block per SM)": [
        ("constexpr int P_STAGES = 3;", "constexpr int P_STAGES = 4;"),
    ],
}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from chitu_tpu_torch.ops import cuda_build
    from chitu_tpu_torch.ops import quant_gemm_kernels as qg
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

    card = chip_smoke.card_line()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    randn = lambda *s, k=1.0: (
        torch.randn(s, generator=g, device=dev) * k).to(torch.bfloat16)
    shapes = [(4096, 28672), (4096, 6144), (14336, 4096)]
    ws = {s: qt.quantize_weight(randn(*s, k=0.02), QuantKind.SOFT_FP8)
          for s in shapes}
    xs = {s: randn(16, s[0]) for s in shapes}

    sound = cuda_build.CSRC
    for name, edits in VARIANTS.items():
        if sys.argv[1:] and name not in sys.argv[1:]:
            continue
        tmp = tempfile.mkdtemp(prefix="variant-")
        try:
            for f in os.listdir(sound):
                shutil.copy(os.path.join(sound, f), tmp)
            path = os.path.join(tmp, "quant_gemm.cu")
            text = open(path).read()
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"{name}: line to edit not found")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            cuda_build.CSRC = tmp
            cuda_build._LIBS.clear()
            qg._LIB = None
            ms = {
                f"{k}->{n}": chip_smoke.device_ms_sized(
                    torch, lambda: qg.quant_gemm(xs[(k, n)], ws[(k, n)]))
                for k, n in shapes
            }
            print(json.dumps(dict(variant=name, T=16, ms=ms, card=card)),
                  flush=True)
        finally:
            cuda_build.CSRC = sound
            cuda_build._LIBS.clear()
            qg._LIB = None
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
