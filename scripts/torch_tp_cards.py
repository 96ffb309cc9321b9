#!/usr/bin/env python3
"""Tensor parallelism of the port with a card a rank (NCCL).

    python3 scripts/torch_tp_cards.py [layers]     # on a host with 4 GPUs

The TP phases of `chip_smoke.py` (`tp_phase`) on a host where every rank
has a card of its own, so the backend is nccl: Llama-3-8B-Instruct at
tp=2 and tp=4 (32 layers by default), random bf16 weights from the tp=1
engine's seed. Each phase holds what the smoke holds (per-rank weight
and pool bytes total / tp, rank 0's streams against the tp=1 engine's
under the near-tie rule, every shadowed kernel call within its limit)
and prints its burst wall time and batch-1 decode rate beside the tp=1
engine's, with every card's name and power limit.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chitu_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("torch_tp_cards: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--tp-rank"]:
        cs.tp_rank_main(sys.argv[2])
        return
    n_cards = torch.cuda.device_count()
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    # the ranks run this file (`--tp-rank`), which hands them to the smoke
    cs.__file__ = os.path.abspath(__file__)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(cards, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    tk.build_kernels()
    cuda_build.build_host("hostops")
    print(f"build {time.time() - t0:.1f} s", flush=True)
    card = cards.splitlines()[0]
    for n in (2, 4):
        if n > n_cards:
            raise SystemExit(f"tp={n} needs {n} cards, have {n_cards}")
        cs.tp_phase(torch, np, tk, card, f"tp{n}_nccl", n,
                    [f"models.n_layers={layers}"], cs.ATTN_KERNELS,
                    backend="nccl")
    print(f"total {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
