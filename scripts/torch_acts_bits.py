#!/usr/bin/env python3
"""The activation quantizers (B11 `rms_norm_quant`, B12 `quant_acts`) of
several trees, bit for bit and timed.

    python3 scripts/torch_acts_bits.py TREE [TREE ...]

A tree is the root of a checkout of the repository, for example the
parent commit unpacked with `git archive` into a git-ignored directory.
Each tree runs in a process of its own, builds its own
`csrc/norm_quant.cu` and calls its two wrappers on the same inputs (drawn
on the CPU from a seed) at every shape the serving paths give them: B11
at Llama-3-8B's hidden size (T 1, 16, 64, 65, 512), at 8192 and at an odd
4100, on an x 2 bytes past a 16-byte boundary; B12 at the FFN width
14336 and wo's input 4096 (the same T), at Qwen2-72B's 29568 (a row split
over a cluster, T 16 and 1), at 4100, on the unaligned x, and on rows of
rounding ties. Prints, for each tree after the first, whether every
case's int8 values and scales equal the first tree's bit for bit, and
whether the machine code (`cuobjdump -sass` of the built library) of
each `norm_quant_kernel` instantiation these wrappers launch (B11 and
B12 at each vector count) equals the first tree's, and for each tree
each call's device time (50 calls captured in a CUDA graph, the median
of 20 replays, as `chip_smoke.py` times a kernel; name two trees as
`A B B A` to see the drift between processes). Exits non-zero if
anything differs.
"""

import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import zlib

TS = (1, 16, 64, 65, 512)
CASES = (  # (label, kernel, T, D, x offset in elements)
    [(f"b11_d4096_t{t}", "rms_norm_quant", t, 4096, 0) for t in TS]
    + [("b11_d8192_t16", "rms_norm_quant", 16, 8192, 0),
       ("b11_d4100_t16", "rms_norm_quant", 16, 4100, 0),
       ("b11_x+2B_t16", "rms_norm_quant", 16, 4096, 1)]
    + [(f"b12_f14336_t{t}", "quant_acts", t, 14336, 0) for t in TS]
    + [(f"b12_d4096_t{t}", "quant_acts", t, 4096, 0) for t in TS]
    + [("b12_f29568_t16", "quant_acts", 16, 29568, 0),
       ("b12_f29568_t1", "quant_acts", 1, 29568, 0),
       ("b12_d4100_t16", "quant_acts", 16, 4100, 0),
       ("b12_x+2B_t16", "quant_acts", 16, 4096, 1),
       ("b12_ties_t16", "quant_acts", 16, 14336, 0)])


def inputs(torch, label, T, D, off):
    g = torch.Generator().manual_seed(zlib.crc32(label.encode()))
    if "ties" in label:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import chip_smoke

        return chip_smoke.tie_rows(torch, T, D)[0]
    x = (torch.randn(T * D + off, generator=g) * 2).to(torch.bfloat16)
    return x


def ms_per_call(torch, fn, calls=50, reps=20):
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return sorted(times)[reps // 2]


def sass(tree):
    """{(NORM, V): the instantiation's SASS, its name line dropped} of the
    tree's built `norm_quant` library (the whole-row mode only: a third
    template argument, where the tree has one, of 0)."""
    lib = glob.glob(os.path.join(tree, "chitu_tpu_torch", "build",
                                 "norm_quant*.so"))
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    if len(lib) != 1 or not os.path.exists(cuobjdump):
        return None
    text = subprocess.run([cuobjdump, "-sass", lib[0]], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        m = re.search(r"norm_quant_kernelILb([01])ELi(\d+)E(?:Li(\d+)E)?E",
                      part.split("\n", 1)[0])
        if m and (m.group(3) or "0") == "0":
            out[(m.group(1), m.group(2))] = part.split("\n", 1)[1]
    return out


def one(tree, out):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from chitu_tpu_torch.ops import norm_quant as nq

    if not os.path.abspath(nq.__file__).startswith(os.path.abspath(tree)):
        sys.exit(f"{nq.__file__} is not {tree}'s")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(3)
    w = (1.0 + 0.1 * torch.randn(8192, generator=g)).to(torch.bfloat16)
    res = {}
    for label, kernel, T, D, off in CASES:
        flat = inputs(torch, label, T, D, off).to(dev)
        x = flat.reshape(T, D) if flat.dim() == 2 else flat[off:].view(T, D)
        if kernel == "rms_norm_quant":
            wd = w[:D].to(dev).contiguous()
            run = lambda x=x, wd=wd: nq.rms_norm_quant(x, wd, 1e-5)  # noqa: E731
        else:
            run = lambda x=x: nq.quant_acts(x)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        res[label] = dict(data=got.data.cpu(), scale=got.scale.cpu(),
                          ms=ms_per_call(torch, run))
    torch.save(dict(cases=res, sass=sass(tree)), out)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(args[1], args[2])
        return
    if not args:
        sys.exit(__doc__)
    import torch

    d = tempfile.mkdtemp(prefix="acts_bits_")
    got = []
    for i, tree in enumerate(args):
        path = os.path.join(d, f"{i}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree, path], check=True)
        got.append(torch.load(path))
    code = [g["sass"] for g in got]
    got = [g["cases"] for g in got]
    bad = 0
    for i, tree in enumerate(args):
        print("ms " + json.dumps(dict(tree=tree, run=i, **{
            label: r["ms"] for label, r in got[i].items()})), flush=True)
    for i in range(1, len(args)):
        for label in got[0]:
            a, b = got[0][label], got[i][label]
            eq = dict(data_equal=bool(torch.equal(a["data"], b["data"])),
                      scale_equal=bool(torch.equal(a["scale"], b["scale"])))
            bad += not all(eq.values())
            print("bits " + json.dumps(dict(case=label, first=args[0],
                                            tree=args[i], **eq)), flush=True)
        if code[0] is not None and code[i] is not None:
            same = {f"{k[0]},{k[1]}": code[0][k] == code[i].get(k)
                    for k in sorted(code[0])}
            bad += not all(same.values())
            print("sass " + json.dumps(dict(first=args[0], tree=args[i],
                                            equal=same)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
