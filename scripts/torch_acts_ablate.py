#!/usr/bin/env python3
"""What holds the activation quantizers back (`csrc/norm_quant.cu`,
`norm_quant_kernel`: B11 `rms_norm_quant`, B12 `quant_acts`), on one GPU:
the kernel with parts taken out, and under other plans than `acts_plan`'s.

    python3 scripts/torch_acts_ablate.py [variant name ...]

For each source variant it copies `chitu_tpu_torch/csrc/` into a
temporary directory, edits the copy of `norm_quant.cu` (the repository's
sources are never touched), builds it, points the wrappers at it and
times, as device time (CUDA-graph replay, as `chip_smoke.py` takes it;
the input warm in L2, as on the main path), B11 and B12 at the `SHAPES`
(D 4096 and 8192, F 14336 and 29568, Qwen2-72B's FFN; T 1 to 512) under
the committed plan; with the committed source also under each plan of
`PLANS` (a cluster split of 1, 2, 4 or 8 CTAs at T 1 to 16, other rows a
CTA and vectors a thread at T 512). The variants that
take a part out compute wrong results on purpose; only their times are
read. Prints one JSON line per variant and plan with the launch floor (a
one-element in-place add) and the card's name and power limit.
"""

import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "as committed": [],
    "the IEEE division for every value (no hoisted reciprocal)": [
        ("  const float q = y * d.r;\n  return fmaf(d.r, fmaf(-d.s, q, y), q);",
         "  return y / d.s;")],
    "rounded by adding 1.5 * 2^23 (no rintf, no conversion)": [
        ("  return (uint32_t)(int)rintf(y / s) & 0xffu;",
         "  return __float_as_uint(y / s + 12582912.f) & 0xffu;")],
    "rintf, then the addition (no conversion)": [
        ("  return (uint32_t)(int)rintf(y / s) & 0xffu;",
         "  return __float_as_uint(rintf(y / s) + 12582912.f) & 0xffu;")],
    "without the int8 stores": [
        ("*reinterpret_cast<uint2*>(dst) = b;",
         "if ((b.x ^ b.y) == 0x12345678u) *reinterpret_cast<uint2*>(dst) = b;")],
    "without the amax reduction": [
        ("    amax = fmaxf(row_reduce<true>(amax, part[1][it], red[1], slot, t, p, cl),\n"
         "                 1e-8f);", "    amax = fmaxf(amax, 1e-8f);")],
    "without the exit barrier": [("    if (p.cluster > 1) cl.sync();\n", "")],
    "without the sum-of-squares reduction": [
        ("      ss = row_reduce<false>(ss, part[0][it], red[0], slot, t, p, cl);", "")],
}
# the shapes timed under the committed plan: (T, D, B11 too)
SHAPES = [(T, D, D <= 8192) for T in (1, 16, 64, 512) for D in (4096, 14336)] + [
    (16, 8192, True), (512, 8192, True), (1, 29568, False), (16, 29568, False)]
# (T, D) -> plans to try beside the committed one: (cluster, threads,
# rows, vecs); slice and grid follow. Plans run only with the committed
# source.
PLANS = {
    (16, 4096): [(1, 256, 1, 2), (1, 128, 1, 4), (2, 256, 1, 1)],
    (64, 4096): [(1, 256, 1, 2), (1, 128, 1, 4)],
    (512, 4096): [(1, 256, 1, 2), (1, 128, 1, 4), (1, 128, 2, 4), (1, 64, 4, 8)],
    (512, 14336): [(1, 256, 1, 8), (1, 448, 1, 4)],
    **{(T, D): [(1, 256, 1, 8) if D <= 16384 else (1, 480, 1, 8), (2, 256, 1, 8),
                (4, 256, 1, 4), (8, 256, 1, 2)]
       for T in (1, 2, 4, 8) for D in (14336, 18432, 29568)},
    **{(T, 8192): [(1, 256, 1, 4), (2, 256, 1, 2), (4, 256, 1, 1)] for T in (1, 4, 16)},
}


def plan_of(nq, T, D, cluster, threads, rows, vecs):
    nv = max(1, D // nq.VEC)
    sl = -(-nv // cluster)
    assert threads * vecs >= sl and rows * threads <= nq.MAX_THREADS
    return nq.ActsPlan(cluster, threads, rows, vecs, sl, cluster * -(-T // rows))


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from chitu_tpu_torch.ops import cuda_build
    from chitu_tpu_torch.ops import norm_quant as nq

    card = chip_smoke.card_line()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf = torch.bfloat16
    xs = {}

    def x_of(T, D):
        if (T, D) not in xs:
            xs[(T, D)] = torch.randn((T, D), generator=g, device=dev).to(bf)
        return xs[(T, D)]

    w = (1.0 + 0.1 * torch.randn(8192, generator=g, device=dev)).to(bf)
    one = torch.zeros(1, device=dev)
    floor = chip_smoke.device_ms(torch, lambda: one.add_(1.0))
    committed = nq.plan_for

    def times(shapes, forced=None):
        nq.plan_for = (lambda x: forced) if forced else committed
        ms = {}
        try:
            for T, D, norm in shapes:
                x = x_of(T, D)
                if norm:
                    wd = w[:D]
                    ms[f"rms_norm_quant T={T} D={D}"] = chip_smoke.device_ms(
                        torch, lambda: nq.rms_norm_quant(x, wd, 1e-5))
                ms[f"quant_acts T={T} D={D}"] = chip_smoke.device_ms(
                    torch, lambda: nq.quant_acts(x))
        finally:
            nq.plan_for = committed
        return ms

    sound = cuda_build.CSRC
    for name, edits in VARIANTS.items():
        if sys.argv[1:] and name not in sys.argv[1:]:
            continue
        tmp = tempfile.mkdtemp(prefix="acts-variant-")
        try:
            for f in os.listdir(sound):
                shutil.copy(os.path.join(sound, f), tmp)
            path = os.path.join(tmp, "norm_quant.cu")
            text = open(path).read()
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: the line to edit is not unique")
                text = text.replace(old, new)
            with open(path, "w") as fh:
                fh.write(text)
            cuda_build.CSRC = tmp
            cuda_build._LIBS.clear()
            nq._LIB = None
            print(json.dumps(dict(variant=name, plan="committed", ms=times(SHAPES),
                                  launch_floor_ms=floor, card=card)), flush=True)
            if edits:
                continue
            for (T, D), plans in PLANS.items():
                for pl in plans:
                    p = plan_of(nq, T, D, *pl)
                    print(json.dumps(dict(
                        variant=name, plan=p.__dict__,
                        ms=times([(T, D, D <= 8192)], p),
                        launch_floor_ms=floor, card=card)), flush=True)
        finally:
            cuda_build.CSRC = sound
            cuda_build._LIBS.clear()
            nq._LIB = None
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
