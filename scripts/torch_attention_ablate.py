#!/usr/bin/env python3
"""Where the attention kernels spend their time on the card. Needs an
NVIDIA GPU and nvcc.

    python3 scripts/torch_attention_ablate.py [split] [latent]

Parts (all by default; name some to run those), each printing one JSON
line per measurement with the card's name and power limit:

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
3. `latent`: the MLA latent kernel (TMA + wgmma) at DeepSeek-R1's shapes
   (128 heads, 576 live lanes, bf16 pool): the split rule's target
   `attention_kernels.LATENT_BLOCKS_PER_SM` and its least split
   `LATENT_MIN_SPLIT_TILES` (no rebuild) on B4 over `chip_smoke.py`'s 16
   rows of context up to 2047 (22,387 rows), over one row of 16,384 and
   at deepseek-mid-bench's 32 heads; then ablations
   of `latent_kernel` timing that decode and B5 (a 512-token chunk at
   q_pos 512): without the score products, without the P V products,
   without the key tiles' copies (the barriers complete at once), without
   the exponentials, the score loop unrolled by 4 only.

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

# (name, [(old text, new text)]) edits of latent_kernel in attention.cu
LATENT_VARIANTS = [
    ("sound", []),
    ("no S products", [(
        "      wgmma_m64n32<0, 0>(sc, sw128_desc(qa_t + off, 16, 1024),\n"
        "                         sw128_desc(kb_t + off, 16, 1024));\n"
        "      wgmma_m64n32<0, 0>(sc2, sw128_desc(qa_t + off + 32, 16, 1024),\n"
        "                         sw128_desc(kb_t + off + 32, 16, 1024));", "")]),
    ("S in one accumulator chain", [(
        "      wgmma_m64n32<0, 0>(sc2, sw128_desc(qa_t + off + 32, 16, 1024),",
        "      wgmma_m64n32<0, 0>(sc, sw128_desc(qa_t + off + 32, 16, 1024),")]),
    ("no PV products", [(
        "      wgmma_m64n128<0, 1>(o[0], da, sw128_desc(va + kk * 2048, LBOX, 1024));\n"
        "      wgmma_m64n128<0, 1>(o[1], da, sw128_desc(va + 2 * LBOX + kk * 2048, LBOX, 1024));",
        "")]),
    ("no key copies", [
        ("    mbar_arrive_tx(&full[s], Sm::STAGE);\n    for (int c = 0; c < BK; c += br) {",
         "    mbar_arrive(&full[s]);\n    for (int c = 0; c < 0; c += br) {")]),
    ("no exponentials", [(
        "const float p = v == -INFINITY ? 0.f : ex2(v - (e >> 1 ? mn1 : mn0));",
        "const float p = v == -INFINITY ? 0.f : v - (e >> 1 ? mn1 : mn0);")]),
    ("no barriers in the tile loop", [
        ("    named_bar_sync(1, 256);\n    // both warpgroups are done with tile i - 1",
         "    // both warpgroups are done with tile i - 1"),
        ("    named_bar_sync(1, 256);  // both halves of P are written", "")]),
    ("no page-table reads", [(
        "      int pid = pi < a.mp ? bt[pi] : 0;", "      int pid = pi % a.P;")]),
    ("no P stores", [
        ("      *reinterpret_cast<uint32_t*>(ps + r0 * 128 + ((ch ^ (r0 & 7)) << 4) + 4 * (lane & 3)) =\n"
         "          pack_bf16(sc[4 * n8], sc[4 * n8 + 1]);\n"
         "      *reinterpret_cast<uint32_t*>(ps + r1 * 128 + ((ch ^ (r1 & 7)) << 4) + 4 * (lane & 3)) =\n"
         "          pack_bf16(sc[4 * n8 + 2], sc[4 * n8 + 3]);", "      (void)ch;")]),
    ("no O rescale", [(
        "        o[j][4 * n8] *= al0;\n        o[j][4 * n8 + 1] *= al0;\n"
        "        o[j][4 * n8 + 2] *= al1;\n        o[j][4 * n8 + 3] *= al1;", "")]),
    ("score loop unrolled by 4", [(
        "#pragma unroll\n    for (int kk = 0; kk < LQK / 16; kk += 2) {",
        "#pragma unroll 4\n    for (int kk = 0; kk < LQK / 16; kk += 2) {")]),
]


def edited_sources(sound, edits, name):
    """A temp copy of the sources with `edits` made to attention.cu."""
    tmp = tempfile.mkdtemp(prefix="ablate-")
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
    return tmp


def latent_part(torch, cs, tk, cuda_build, randn, dev, card):
    """Part 3: the latent kernel's split target, then its ablations."""
    from chip_smoke import R1_SCALE

    H, QK, M, PAGE, B, MP = 128, tk.LATENT_QK, 640, 64, 16, 33
    kw = dict(kv_heads=1, head_dim=QK, split_kv=False, v_dim=tk.LATENT_DV,
              scale=R1_SCALE)
    # chip_smoke.py's R1 decode rows: the same generator, the same draws
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    rnd = lambda *shape, s=1.0: (torch.randn(shape, generator=g, device=dev) * s).to(
        torch.bfloat16)
    pool = rnd(2, B * MP, PAGE, M, s=0.5)
    pool[..., QK:] = 0
    bts = torch.arange(B * MP, device=dev, dtype=torch.int32).reshape(B, MP)
    seq = torch.randint(1, MP * PAGE - PAGE, (B,), generator=g,
                        device=dev).to(torch.int32)
    seq[0] = 2047
    q = rnd(B, H, QK)
    q_mid = randn(B, 32, QK)
    mp1 = 16384 // PAGE + 1
    pool1 = randn(2, mp1, PAGE, M, s=0.5)
    pool1[..., QK:] = 0
    bt1 = torch.arange(mp1, device=dev, dtype=torch.int32)[None]
    seq1 = torch.full((1,), 16383, dtype=torch.int32, device=dev)
    q1 = randn(1, H, QK)
    T, start = 512, 512
    bt = torch.arange(16, device=dev, dtype=torch.int32) + 100
    q_pos = (start + torch.arange(T, device=dev)).to(torch.int32)
    qp = randn(T, H, QK)
    b4 = lambda: tk.attend_decode(q, pool, 1, bts, seq, PAGE, **kw)
    b4_mid = lambda: tk.attend_decode(q_mid, pool, 1, bts, seq, PAGE, **kw)
    b4_16k = lambda: tk.attend_decode(q1, pool1, 1, bt1, seq1, PAGE, **kw)
    b5 = lambda: tk.attend_prefill(qp, pool, 1, bt, q_pos, start + T, PAGE, **kw)
    default = tk.LATENT_BLOCKS_PER_SM, tk.LATENT_MIN_SPLIT_TILES
    sms = tk._sm_count(dev)
    for bps, least in ((1, 1), (1, 4), (1, 8), (2, 4), (2, 8), (2, 16), (4, 4),
                       (4, 8)):
        tk.LATENT_BLOCKS_PER_SM, tk.LATENT_MIN_SPLIT_TILES = bps, least
        tk.latent_split.cache_clear()  # the plan is memoized
        print(json.dumps(dict(
            part="latent split", blocks_per_sm=bps, min_split_tiles=least,
            splits=tk.latent_split(B, H, MP, PAGE, sms)[0],
            splits_16k=tk.latent_split(1, H, mp1, PAGE, sms)[0],
            splits_mid=tk.latent_split(B, 32, MP, PAGE, sms)[0],
            b4_ms=cs.device_ms(torch, b4), b4_16k_ms=cs.device_ms(torch, b4_16k),
            b4_mid_ms=cs.device_ms(torch, b4_mid), card=card)), flush=True)
    tk.LATENT_BLOCKS_PER_SM, tk.LATENT_MIN_SPLIT_TILES = default
    tk.latent_split.cache_clear()
    sound = cuda_build.CSRC
    words = [a for a in sys.argv[1:] if a not in ("split", "latent")]
    try:
        for name, edits in LATENT_VARIANTS:
            if words and name not in words and name != "sound":
                continue
            tmp = edited_sources(sound, edits, name)
            try:
                cuda_build.CSRC = tmp
                cuda_build._LIBS.clear()
                tk._LIB = None
                print(json.dumps(dict(
                    part="latent ablation", variant=name,
                    b4_r1_ms=cs.device_ms(torch, b4),
                    b4_mid_ms=cs.device_ms(torch, b4_mid),
                    b4_16k_ms=cs.device_ms(torch, b4_16k),
                    b5_r1_ms=cs.device_ms(torch, b5), card=card)), flush=True)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    finally:
        cuda_build.CSRC = sound
        cuda_build._LIBS.clear()
        tk._LIB = None


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
    parts = [a for a in sys.argv[1:] if a in ("split", "latent")] or ["split", "latent"]
    if "latent" in parts:
        latent_part(torch, cs, tk, cuda_build, randn, dev, card)
    if "split" not in parts:
        return

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
            tmp = edited_sources(sound, edits, name)
            try:
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
