#!/usr/bin/env python3
"""Kernels of several trees of the port, timed in turns on one GPU.

    python3 scripts/torch_kernel_compare.py [--cases GEN:MODULE,...] [tree ...]

A tree is the root of a checkout of the repository (default: this one),
for example an earlier commit unpacked with `git archive` into a
git-ignored directory; give parent, change, change, parent to take turns.
`--cases` names case generators of this checkout's `chip_smoke.py`, each
with the wrapper module of `chitu_tpu_torch.ops` it drives (default:
`absorb_cases:absorb_kernels,dense_gemm_cases:dense_gemm_kernels`, B9 and
B13); a generator is called as `gen(torch, module, device)` and yields one
result dict a case. Each tree runs in a process of its own: its wrappers
are imported from it and its kernels built from its own sources, and this
checkout's generators drive them, so every tree gets the same inputs, the
same checks against the plain versions and the same timings (for B9 and
B13: warm, `ms` and `library_ms`, and cold in L2, `ms_cold` and
`library_ms_cold`). Prints one JSON line a case with its tree, then the
card's name and power limit. Exits non-zero if a tree fails.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CASES = "absorb_cases:absorb_kernels,dense_gemm_cases:dense_gemm_kernels"


def one(tree, cases):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    gens = []
    for item in cases.split(","):
        gen, mod_name = item.split(":")
        mod = importlib.import_module(f"chitu_tpu_torch.ops.{mod_name}")
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            sys.exit(f"{mod.__name__} imported from {mod.__file__}, not {tree}")
        gens.append((getattr(cs, gen), mod))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    with torch.no_grad():
        for gen, mod in gens:
            for res in gen(torch, mod, dev):
                res.update(tree=tree, card=card)
                print("case " + json.dumps(res), flush=True)


def main():
    args = sys.argv[1:]
    cases = DEFAULT_CASES
    if args[:1] == ["--cases"]:
        cases, args = args[1], args[2:]
    if args[:1] == ["--one"]:
        one(args[1], cases)
        return
    rc = 0
    for tree in args or [ROOT]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--cases", cases, "--one", tree]).returncode
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
