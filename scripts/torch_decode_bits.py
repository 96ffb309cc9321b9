#!/usr/bin/env python3
"""The split decode kernels (B1 fused, B4) of several trees, bit for bit.

    python3 scripts/torch_decode_bits.py TREE [TREE ...]

A tree is the root of a checkout of the repository, for example the
parent commit unpacked with `git archive` into a git-ignored directory.
Each tree runs in a process of its own, builds its own
`csrc/attention.cu` and calls its `attend_decode_fused` and
`attend_decode` wrappers on the same inputs (drawn on the CPU from a
seed): the batch shapes of the Llama-3-8B serving path (16 rows, 32 query
heads on 8 KV heads, pages of 64, contexts up to 2,047, a row that is not
valid, a padded bucket row whose table is all -1), on bf16 and e4m3
pools, with and without window and softcap, and at head sizes 64, 32 and
192. Prints, for each case and tree after the first, whether the outputs
and the pool equal the first tree's bit for bit, and how many output
rows differ, and for each tree each call's device time (50 calls
captured in a CUDA graph, the median of 20 replays, as `chip_smoke.py`
times a kernel; name two trees as `A B B A` to see the drift between
processes). Exits non-zero if anything differs.
"""

import json
import os
import subprocess
import sys
import tempfile

CASES = [  # (label, H, KV, D, fp8, window, softcap)
    ("llama3_8b", 32, 8, 128, False, 0, 0.0),
    ("llama3_8b_e4m3", 32, 8, 128, True, 0, 0.0),
    ("window_softcap", 32, 8, 128, False, 512, 30.0),
    ("d64", 32, 4, 64, False, 0, 0.0),
    ("d32", 4, 2, 32, False, 0, 0.0),
    ("d192", 16, 16, 192, False, 0, 0.0),
]


def inputs(torch, H, KV, D, fp8):
    from chitu_tpu_torch.models.common import kv_encode

    g = torch.Generator().manual_seed(16)
    B, MP, PAGE, L = 16, 33, 64, 2
    P = B * MP
    M = 2 * KV * D

    def randn(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    pool = randn(L, P, PAGE, M) * 0.5
    if fp8:
        pool = kv_encode(pool, torch.int8)
    bts = torch.arange(P, dtype=torch.int32).reshape(B, MP)
    seq = torch.randint(1, MP * PAGE - PAGE, (B,), generator=g).to(torch.int32)
    seq[0] = 2047
    # the executor's tables: -1 past each row's pages
    used = torch.arange(MP)[None, :] <= (seq[:, None] // PAGE)
    bts = torch.where(used, bts, torch.full_like(bts, -1))
    valid = torch.ones(B, dtype=torch.bool)
    valid[3] = False
    valid[B - 1] = False
    bts[B - 1] = -1
    seq[B - 1] = 0
    return dict(q=randn(B, H, D), k=randn(B, KV, D), v=randn(B, KV, D),
                pool=pool, bts=bts, seq=seq, valid=valid, PAGE=PAGE)


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


def one(tree, out):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from chitu_tpu_torch.ops import attention_kernels as tk

    dev = torch.device("cuda", 0)
    res = {}
    for label, H, KV, D, fp8, window, softcap in CASES:
        x = {k: v.to(dev) if torch.is_tensor(v) else v
             for k, v in inputs(torch, H, KV, D, fp8).items()}
        kw = dict(window=window, softcap=softcap)
        pool = x["pool"].clone()
        fused = tk.attend_decode_fused(
            x["q"], pool, 1, x["k"], x["v"], x["bts"], x["seq"], x["valid"],
            x["PAGE"], KV, D, **kw)
        after = tk.attend_decode(x["q"], pool, 1, x["bts"], x["seq"], x["PAGE"],
                                 KV, D, **kw)
        torch.cuda.synchronize()
        res[label] = dict(fused=fused.cpu(), after=after.cpu(), pool=pool.cpu())
        # every further call writes the same new rows again
        res[label]["ms"] = dict(
            fused=ms_per_call(torch, lambda: tk.attend_decode_fused(
                x["q"], pool, 1, x["k"], x["v"], x["bts"], x["seq"],
                x["valid"], x["PAGE"], KV, D, **kw)),
            after=ms_per_call(torch, lambda: tk.attend_decode(
                x["q"], pool, 1, x["bts"], x["seq"], x["PAGE"], KV, D, **kw)))
    torch.save(res, out)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(args[1], args[2])
        return
    if not args:
        sys.exit(__doc__)
    import torch

    d = tempfile.mkdtemp(prefix="decode_bits_")
    got = []
    for i, tree in enumerate(args):
        path = os.path.join(d, f"{i}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree, path], check=True)
        got.append(torch.load(path))
    bad = 0
    for i, tree in enumerate(args):
        print("ms " + json.dumps(dict(tree=tree, run=i, **{
            label: r["ms"] for label, r in got[i].items()})), flush=True)
    for i in range(1, len(args)):
        for label in got[0]:
            a, b = got[0][label], got[i][label]
            rows = {}
            for key in ("fused", "after"):
                differ = int((a[key] != b[key]).flatten(1).any(1).sum())
                rows[key] = dict(equal=differ == 0, rows_differing=differ)
                bad += differ > 0
            rows["pool_equal"] = bool(torch.equal(a["pool"], b["pool"]))
            bad += not rows["pool_equal"]
            print("bits " + json.dumps(dict(case=label, first=args[0],
                                            tree=args[i], **rows)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
