#!/usr/bin/env python3
"""Decode time a step with one kernel wrapper taken from another tree of
the port, the two alternated chain by chain in one process, on one GPU.

    python3 scripts/torch_decode_ab.py TREE CALLER:NAME:WRAPPER \
        [batch] [prompt_len] [model card] [layers] [pairs] [quant_method]

for example, B13 of the parent commit (unpacked with `git archive` into a
git-ignored directory) against this checkout's, in Llama-3-8B's decode:

    CHITU_TPU_DENSE_KERNEL=1 python3 scripts/torch_decode_ab.py .proof/parent \
        ops.linear:dense_matmul_stacked:ops.dense_gemm_kernels 16 256 \
        Llama-3-8B-Instruct 32

Builds this checkout's engine of a model card at full width (random
weights, bf16 or quantized on load by `quant_method`, `batch` greedy
requests of `prompt_len` random tokens put into decode), then imports `chitu_tpu_torch.<WRAPPER>` from TREE (its
package imported afresh beside this one, its kernels built from its own
sources) and takes NAME from it. `chitu_tpu_torch.<CALLER>` is the module
that calls NAME (it imported the name, so the swap sets it there). Decode
chains then run in turns A B, B A, ... for `pairs` pairs (default 8): A
with this checkout's NAME, B with TREE's. Each chain gives its wall clock
and the process's CPU time a decode step. The host's speed drifts between
processes on a shared host by more than the wrappers differ, so the two
are compared inside one process, pair by pair. Prints one JSON line: the
medians of each, the median of the paired differences B - A, and the
card's name and power limit. Needs a CUDA device.
"""

import importlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PKG = "chitu_tpu_torch"


def _ours():
    return {k: v for k, v in sys.modules.items() if k == PKG or k.startswith(PKG + ".")}


def load_other(tree: str, module: str):
    """`chitu_tpu_torch.<module>` of another tree, imported with that
    tree's package in place of this one; this one is restored after."""
    tree = os.path.abspath(tree)
    saved = _ours()
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, tree)
    try:
        mod = importlib.import_module(f"{PKG}.{module}")
    finally:
        sys.path.remove(tree)
        for k in _ours():
            del sys.modules[k]
        sys.modules.update(saved)
    if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
        sys.exit(f"{module} imported from {mod.__file__}, not {tree}")
    return mod


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    args = sys.argv[1:]
    tree, swap = args[0], args[1]
    caller_name, name, wrapper = swap.split(":")
    batch = int(args[2]) if len(args) > 2 else 16
    plen = int(args[3]) if len(args) > 3 else 256
    model = args[4] if len(args) > 4 else "Llama-3-8B-Instruct"
    depth = [f"models.n_layers={int(args[5])}"] if len(args) > 5 else []
    pairs = int(args[6]) if len(args) > 6 else 8
    method = args[7] if len(args) > 7 else "none"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine

    caller = importlib.import_module(f"{PKG}.{caller_name}")
    mine = getattr(caller, name)
    other = getattr(load_other(tree, wrapper), name)
    cfg = load_config(overrides=[
        f"models={model}", "infer.stop_with_eos=false",
        "infer.adaptive_window=false", f"infer.max_reqs={batch}", *depth,
        f"quant.method={method}", f"quant.quant_on_load={str(method != 'none').lower()}",
    ])
    eng = Engine(cfg)
    rng = np.random.default_rng(0)
    V = cfg.models.vocab_size
    p = SampleParams(temperature=0.0, max_new_tokens=4096)
    reqs = [eng.submit("", p, prompt_tokens=[int(t) for t in rng.integers(1, V, size=plen)])
            for _ in range(batch)]
    eng.step()  # prefill all
    live = [eng.pool[f"task-{r.request_id}"] for r in reqs]

    def chain(fn):
        """-> (wall ms, CPU ms) a decode step of one decode chain with fn."""
        setattr(caller, name, fn)
        before = len(live[0].response_tokens)
        torch.cuda.synchronize()
        w0, c0 = time.perf_counter(), time.process_time()
        eng.executor.decode_step(live)
        torch.cuda.synchronize()
        wall, cpu = time.perf_counter() - w0, time.process_time() - c0
        n = len(live[0].response_tokens) - before
        return wall / n * 1e3, cpu / n * 1e3

    try:
        chain(mine)  # warm: each side's kernels built and its caches filled
        chain(other)
        runs = {"A": [], "B": []}
        for i in range(pairs):
            for v in ("AB" if i % 2 == 0 else "BA"):
                runs[v].append(chain(mine if v == "A" else other))
    finally:
        setattr(caller, name, mine)
    med = statistics.median
    out = dict(card=card, model=cfg.models.name, layers=cfg.models.n_layers,
               batch=batch, prompt_len=plen, quant=method, swap=swap, tree_b=os.path.abspath(tree),
               pairs=pairs)
    for i, metric in enumerate(("wall", "cpu")):
        a = [r[i] for r in runs["A"]]
        b = [r[i] for r in runs["B"]]
        out[f"{metric}_ms_per_step_a"] = med(a)
        out[f"{metric}_ms_per_step_b"] = med(b)
        out[f"{metric}_ms_per_step_b_minus_a"] = med(y - x for x, y in zip(a, b))
        out[f"{metric}_a"], out[f"{metric}_b"] = a, b
    print(json.dumps(out), flush=True)
    eng.terminate()


if __name__ == "__main__":
    main()
