#!/usr/bin/env python3
"""Where the split-layout attention kernels spend their time on the card.
Needs an NVIDIA GPU and nvcc.

    python3 scripts/torch_attention_ablate.py

Two parts, each printing one JSON line per measurement with the card's
name and power limit:

1. The split decode (B1 at Llama-3-8B's 16-row decode geometry, context
   up to 2047, and at tiny-llama-debug's head size 64) against the split
   rule's blocks-an-SM target `attention_kernels.DECODE_BLOCKS_PER_SM`, a
   Python constant: no rebuild.
2. Ablations of `csrc/attention.cu`: each variant edits one temp copy of
   the sources (the repository's are never touched), builds it, and times
   B5 (a 512-token chunk at q_pos 512) and B4 (the decode geometry above)
   at head size 128. A variant computes wrong results by design (no
   tensor-core products, no exponentials, no copies, no compute): the
   times say what each part costs, nothing else.

Device times as in `chip_smoke.py`: calls captured in a CUDA graph and
replayed between two events.
"""

import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (name, [(old text, new text)]) edits of attention.cu
VARIANTS = [
    ("sound", []),
    ("no S products", [(
        "      mma_bf16_16816(s[2 * jj], qa[kd][0], qa[kd][1], qa[kd][2], qa[kd][3], b0,\n"
        "                     b1);\n"
        "      mma_bf16_16816(s[2 * jj + 1], qa[kd][0], qa[kd][1], qa[kd][2], qa[kd][3],\n"
        "                     b2, b3);",
        "      s[2 * jj][0] += __uint_as_float(b0 ^ b1 ^ qa[kd][0]);\n"
        "      s[2 * jj + 1][0] += __uint_as_float(b2 ^ b3);")]),
    ("no PV products", [(
        "      mma_bf16_16816(o[2 * dn], a0, a1, a2, a3, b0, b1);\n"
        "      mma_bf16_16816(o[2 * dn + 1], a0, a1, a2, a3, b2, b3);",
        "      o[2 * dn][0] += __uint_as_float(b0 ^ b1 ^ a0);\n"
        "      o[2 * dn + 1][0] += __uint_as_float(b2 ^ b3);")]),
    ("no exponentials", [(
        "const float p = ex2(s[j][e] - (e >> 1 ? m1 : m0));",
        "const float p = s[j][e];")]),
    ("no copies", [(
        "      cp16(kd, row + h * D + c * EPC);\n"
        "      cp16(vd, row + khalf + h * D + c * EPC);", "")]),
    ("no compute", [
        ("    if (active && nk == 64)", "    if (false && nk == 64)"),
        ("    else if (active && nk == 32)", "    else if (false && nk == 32)"),
        ("    else if (active)\n", "    else if (false)\n"),
        ("    warp_tile<D, 16>(\n        qa, ring.ktile(st)",
         "    if (false) warp_tile<D, 16>(\n        qa, ring.ktile(st)")]),
    ("prefill ring of 2 stages", [(
        "constexpr int kPrefillStages = D <= 128 ? 3 : 2;",
        "constexpr int kPrefillStages = 2;")]),
]


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chitu_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    B, MP, PAGE = 16, 33, 64
    bts = torch.arange(B * MP, device=dev, dtype=torch.int32).reshape(B, MP)
    seq = torch.randint(1, MP * PAGE - PAGE, (B,), generator=g,
                        device=dev).to(torch.int32)
    seq[0] = 2047
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    sms = tk._sm_count(dev)
    tk.build_kernels()

    # 1. the split rule's target
    default = tk.DECODE_BLOCKS_PER_SM
    for H, KV, D in ((32, 8, 128), (32, 4, 64)):
        pool = randn(2, B * MP, PAGE, 2 * KV * D, s=0.5)
        q, k = randn(B, H, D), randn(B, KV, D)
        for bps in (2, 4, 8, 16, 32):
            tk.DECODE_BLOCKS_PER_SM = bps
            S, chunk = tk.decode_split(B, KV, MP, PAGE, sms)
            ms = cs.device_ms(torch, lambda: tk.attend_decode_fused(
                q, pool, 1, k, k, bts, seq, valid, PAGE, KV, D))
            print(json.dumps(dict(part="split", D=D, blocks_per_sm=bps,
                                  splits=S, chunk=chunk, b1_ms=ms,
                                  card=card)), flush=True)
    tk.DECODE_BLOCKS_PER_SM = default

    # 2. ablations at head size 128
    H, KV, D = 32, 8, 128
    pool = randn(2, B * MP, PAGE, 2 * KV * D, s=0.5)
    T, start = 512, 512
    bt = torch.arange(16, device=dev, dtype=torch.int32) + 100
    q_pos = (start + torch.arange(T, device=dev)).to(torch.int32)
    qp, qd = randn(T, H, D), randn(B, H, D)
    sound = cuda_build.CSRC
    try:
        for name, edits in VARIANTS:
            tmp = tempfile.mkdtemp(prefix="ablate-")
            try:
                for f in os.listdir(sound):
                    shutil.copy(os.path.join(sound, f), tmp)
                path = os.path.join(tmp, "attention.cu")
                text = open(path).read()
                for old, new in edits:
                    if text.count(old) != 1:
                        raise SystemExit(f"{name}: the text to edit is not unique")
                    text = text.replace(old, new)
                with open(path, "w") as f:
                    f.write(text)
                cuda_build.CSRC = tmp
                cuda_build._LIBS.clear()
                tk._LIB = None
                b5 = cs.device_ms(torch, lambda: tk.attend_prefill(
                    qp, pool, 1, bt, q_pos, start + T, PAGE, KV, D))
                b4 = cs.device_ms(torch, lambda: tk.attend_decode(
                    qd, pool, 1, bts, seq, PAGE, KV, D))
                print(json.dumps(dict(part="ablation", variant=name,
                                      b5_d128_ms=b5, b4_d128_ms=b4,
                                      card=card)), flush=True)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    finally:
        cuda_build.CSRC = sound
        cuda_build._LIBS.clear()
        tk._LIB = None


if __name__ == "__main__":
    main()
