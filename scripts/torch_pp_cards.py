#!/usr/bin/env python3
"""Pipeline parallelism of the port with a card a rank (NCCL).

    python3 scripts/torch_pp_cards.py [phase ...]   # on a host with 4 GPUs

Phases (all by default):
- `pp2_nccl`, `pp2_tp2_nccl`: the smoke's `pp_phase` for
  Llama-3-8B-Instruct at its 32 layers, random bf16 weights from the
  one-rank engine's seed, each rank on a card of its own: per-rank
  weight and pool bytes the stage's share, the kernels launching on every
  stage, the lone request equal to the one-rank engine's at pp2, the
  burst's streams held against the one-rank engine's under the near-tie
  rule at every position.
- `qwen`: Qwen2-72B-Instruct (80 layers, 145.4 GB in bf16: no card holds
  it) in three worlds of four ranks on the same weights, drawn layer by
  layer on each rank (`chip_smoke.seeded_params`): tp4 (slice 13's
  layout), pp4 and pp2 x tp2.
- `mixtral`: Mixtral-8x7B-Instruct at its full 32 layers in bf16 (about
  93 GB: no card holds it), expert parallelism in two worlds on the same
  seeded weights: tp4 (two experts a rank) and tp2 (four).
The later worlds' streams (the burst's eight and the lone request) are
held against the first world's (tp4): equal, or
  parting at a near tie on the tp4 world's own teacher-forced row (the
  two tokens within 1e-2 of the row's spread or within 3 sigma, sigma
  the rms difference between the two worlds' rows of that position: no
  one card holds the model for the smoke's plain-versions sigma). Printed:
  every rank's weight and pool bytes against the stage share, the rows'
  rms difference over the streams' common prefixes (in units of the row's
  spread), and decode tokens/s at batch 1 and batch 16 beside tp4's.
Every card's name and power limit is printed first.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

QWEN = "Qwen2-72B-Instruct"
QWEN_BASE = [f"models={QWEN}", "infer.stop_with_eos=false",
             "infer.max_seq_len=2048", "infer.max_reqs=16"]
QWEN_GRIDS = (("qwen_tp4", 1, 4), ("qwen_pp4", 4, 1), ("qwen_pp2_tp2", 2, 2))
MIXTRAL_BASE = ["models=Mixtral-8x7B-Instruct-v0.1", "infer.stop_with_eos=false",
                "infer.max_seq_len=2048", "infer.max_reqs=16"]
MIXTRAL_GRIDS = (("mixtral_tp4", 1, 4), ("mixtral_tp2", 1, 2))


def predicted_bytes(cs, cfg, pp, tp):
    """Each rank's weight bytes in a pp x tp world of a bf16 Llama-family
    or Mixtral card, from the full leaf shapes: of each stacked leaf 1 /
    (pp tp) (1 / pp of the leaves every rank of a stage holds whole,
    `chip_smoke.held_whole`: the norms, the router), the embedding / tp on
    stage 0, the head / tp and the norm on the last."""
    import math

    from chitu_tpu_torch.models import build_model

    m = build_model(cfg.models, cfg, device="cpu")
    size = {k: 2 * math.prod(v) for k, v in m._shapes(local=False).items()}
    layers = sum(v if cs.held_whole(m.layout, k) else v // tp
                 for k, v in size.items() if k in m.LAYER_LEAVES)
    out = []
    for r in range(pp * tp):
        p = r // tp
        w = layers // pp
        w += size["embed"] // tp if p == 0 else 0
        w += size["lm_head"] // tp + size["norm"] if p == pp - 1 else 0
        out.append(w)
    return out


def seeded_phase(torch, np, cs, card, base, grids):
    """Worlds of one card on seeded weights, each held to the first."""
    from chitu_tpu_torch import load_config

    cfg = load_config(overrides=base)
    prompts = cs.tp_prompts(np, cfg.models.vocab_size)
    worlds = {}
    for label, pp, tp in grids:
        t0 = time.time()
        ranks, rows = cs.tp_world(label, pp * tp, [], prompts, base=base,
                                  grid=[f"infer.pp_size={pp}", f"infer.tp_size={tp}"],
                                  seeded=True, batch=16)
        worlds[label] = (ranks, rows)
        want = predicted_bytes(cs, cfg, pp, tp)
        r0 = ranks[0]
        for res, wb in zip(ranks, want):
            print(f"[{label}] rank {res['rank']} stage {res['stage']} on "
                  f"{res['device']} ({res['backend']}): weights "
                  f"{res['weight_bytes']} bytes ({res['weight_bytes'] / 2**30:.3f} "
                  f"GiB; predicted {wb}), pool {res['pool_bytes'] / 2**30:.3f} "
                  f"GiB, peak {res['peak_gib']:.2f} GiB, bring-up "
                  f"{res['bringup_s']:.1f} s, pipelined windows "
                  f"{res['pipelined_windows']}", flush=True)
            if res["weight_bytes"] != wb or res["backend"] != "nccl":
                raise AssertionError(f"[{label}] rank {res['rank']}: "
                                     f"{res['weight_bytes']} bytes, not {wb}")
        print(f"[{label}] burst {r0['burst_wall_s']:.2f} s; decode tokens/s at "
              f"batch 1 {r0['decode_tokens_per_s_batch1']:.2f}, at batch 16 "
              f"{r0['decode_tokens_per_s_batch16']:.2f}; world {time.time() - t0:.1f} s",
              flush=True)
    first = grids[0][0]
    t_ranks, t_rows = worlds[first]
    t0 = t_ranks[0]
    want = t0["api"] + [t0["http"], t0["lone"]]
    for label, _, _ in grids[1:]:
        ranks, rows = worlds[label]
        r0 = ranks[0]
        if r0["http_prompt"] != t0["http_prompt"]:
            raise AssertionError(f"[{label}] the HTTP request's prompt differs")
        got = r0["api"] + [r0["http"], r0["lone"]]
        same, rms, far = 0, [], []
        for i, (a, b) in enumerate(zip(got, want)):
            j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
            n = len(a) if j is None else j
            ref, row = t_rows[i].float(), rows[i].float()
            if n:  # the rows of the common prefix
                spread = (ref.max(-1).values - ref.min(-1).values)[:n]
                rms.append(((row[:n] - ref[:n]).pow(2).mean(-1).sqrt()
                            / spread).max().item())
            if a == b:
                same += 1
                continue
            if j is None:
                raise AssertionError(f"[{label}] stream {i}: lengths differ")
            gap = (ref[j, b[j]] - ref[j, a[j]]).item()
            rel = gap / (ref[j].max() - ref[j].min()).item()
            sigma = (row[j] - ref[j]).pow(2).mean().sqrt().item()
            own = (row[j, a[j]] - row[j, b[j]]).item()
            print(f"[{label}] stream {i} parts from {first}'s at token {j} of "
                  f"{len(b)}: {a[j]} against {b[j]}, gap {gap:.5g} = {rel:.3e} "
                  f"of {first}'s row spread (limit {cs.NEAR_TIE}) = "
                  f"{gap / sigma:.3f} sigma (sigma {sigma:.5g}, the two worlds' "
                  f"rows apart; limit {cs.NOISE_SIGMAS}); the world's own row "
                  f"prefers its token by {own:.5g}", flush=True)
            if rel > cs.NEAR_TIE and gap > cs.NOISE_SIGMAS * sigma:
                far.append(i)
        print(f"[{label}] streams equal to {first}'s: {same} of {len(got)}; rows' "
              f"rms difference over the common prefix, largest {max(rms):.3e} of "
              f"the spread", flush=True)
        if far:
            raise AssertionError(f"[{label}] streams {far} part beyond a near tie")


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chitu_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("torch_pp_cards: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--tp-rank"]:
        cs.tp_rank_main(sys.argv[2])
        return
    want = sys.argv[1:] or ["pp2_nccl", "pp2_tp2_nccl", "qwen", "mixtral"]
    if torch.cuda.device_count() < 4:
        raise SystemExit(f"needs 4 cards, have {torch.cuda.device_count()}")
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
    for label, pp, tp in (("pp2_nccl", 2, 1), ("pp2_tp2_nccl", 2, 2)):
        if label in want:
            t1 = time.time()
            cs.pp_phase(torch, np, tk, card, label, cs.LLAMA, pp, tp, [],
                        cs.ATTN_KERNELS, backend="nccl")
            print(f"{label} {time.time() - t1:.1f} s", flush=True)
    for name, base, grids in (("qwen", QWEN_BASE, QWEN_GRIDS),
                              ("mixtral", MIXTRAL_BASE, MIXTRAL_GRIDS)):
        if name in want:
            t1 = time.time()
            seeded_phase(torch, np, cs, card, base, grids)
            print(f"{name} {time.time() - t1:.1f} s", flush=True)
    print(f"total {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
