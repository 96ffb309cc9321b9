#!/usr/bin/env python3
"""Shows that the limits `chip_smoke.py` holds the quantized kernels to
reject broken kernels. Needs an NVIDIA GPU and nvcc.

    python3 scripts/torch_kernel_faults.py

For each planted fault it copies `chitu_tpu_torch/csrc/` into a temporary
directory, edits one line of one source there (the repository's sources
are never touched), builds that copy, points the wrappers at it and runs
the comparison with the plain version that `chip_smoke.py` runs for the
mode the fault touches, at a Llama-3-8B projection shape. It prints one
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
]


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from chitu_tpu_torch.ops import cuda_build
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

    def row_rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()

    def check(kind):
        """-> (measured error, limit, what it is)."""
        if kind == "acts":
            got, want = nq.rms_norm_quant(x, nw, 1e-5), nq.rms_norm_quant_plain(x, nw, 1e-5)
            d = (got.data.int() - want.data.int()).abs()
            return (d != 0).float().mean().item(), 1e-3, "share of int8 values off"
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
        qg._LIB = nq._LIB = None

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
