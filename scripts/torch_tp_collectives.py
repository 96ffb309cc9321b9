#!/usr/bin/env python3
"""Where a tensor-parallel decode step of the port spends its time.

    python3 scripts/torch_tp_collectives.py [tp] [layers]   # tp cards

Starts `tp` ranks (a card each: nccl; sharing cards: gloo), each with a
Llama-3-8B-Instruct engine at tp (32 layers by default, random bf16
weights), and on every rank in lockstep times, with CUDA events after a
synchronize: the group's f32 all-reduce of [T, 4096] (T 1, 16, 512) and
the vocab gather of [T, 128256] logits, 200 calls each; then one decode
forward of the model at batch 1 and 16 (`model.decode`, 50 calls); then
one decode forward under torch.profiler (CPU and CUDA), whose top entries
by host and by device time rank 0 prints. Rank 0 prints every card's
name and power limit and one JSON line of the times.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank_main(tp, layers):
    import torch

    from chitu_tpu_torch import load_config
    from chitu_tpu_torch.engine import Engine

    cfg = load_config(overrides=[
        "models=Llama-3-8B-Instruct", f"models.n_layers={layers}",
        f"infer.tp_size={tp}", "infer.max_seq_len=2048", "infer.max_reqs=16",
        "infer.stop_with_eos=false"])
    eng = Engine(cfg)
    g, m, dev = eng.group, eng.model, eng.device
    V = cfg.models.vocab_size

    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n, (time.perf_counter() - t0) * 1e3 / n

    out = dict(backend=g.backend, tp=tp, layers=layers)
    for T in (1, 16, 512):
        x = torch.randn(T, cfg.models.dim, device=dev, dtype=torch.bfloat16)
        out[f"all_reduce_f32_T{T}_ms"] = timed(lambda: g.all_reduce_f32(x), 200)
        lg = torch.randn(T, V // tp, device=dev)
        out[f"vocab_gather_T{T}_ms"] = timed(
            lambda: g.gather_last(lg, g.rank * (V // tp), V), 200 if T < 512 else 20)
    pool = dict(eng.cache.arrays)
    page = cfg.infer.page_size
    for B in (1, 16):
        toks = torch.ones(B, dtype=torch.int32, device=dev)
        seq = torch.full((B,), 100, dtype=torch.int32, device=dev)
        bt = torch.arange(B * 8, dtype=torch.int32, device=dev).reshape(B, 8)
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        with torch.no_grad():
            out[f"decode_B{B}_ms"] = timed(
                lambda: m.decode(pool, toks, seq, bt, valid, page), 50)
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        m.decode(pool, toks, seq, bt, valid, page)
        torch.cuda.synchronize()
    if g.rank == 0:
        ka = prof.key_averages()
        print(ka.table(sort_by="self_cpu_time_total", row_limit=15), flush=True)
        print(ka.table(sort_by="self_cuda_time_total", row_limit=12), flush=True)
        print("times " + json.dumps(out), flush=True)
        eng.terminate()  # releases the ranks that follow
    else:
        eng.follow()
    from chitu_tpu_torch.parallel import distributed

    distributed.shutdown()


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_tp_collectives: no CUDA device", file=sys.stderr)
        sys.exit(2)
    tp = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    layers = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    if os.environ.get("CHITU_TPU_PROCESS_ID") is not None:
        rank_main(tp, layers)
        return
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chitu_tpu_torch.ops import cuda_build
    from chitu_tpu_torch.parallel import distributed

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    tk.build_kernels()
    cuda_build.build_host("hostops")
    procs = distributed.spawn_ranks(
        [sys.executable, os.path.abspath(__file__), *sys.argv[1:]], tp,
        distributed.local_coordinator(), first=0)
    t0 = time.time()
    # every rank is killed when one fails or the run outlasts 600 s
    while any(p.poll() is None for p in procs):
        if time.time() - t0 > 600 or any(p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise SystemExit(f"ranks exited with {rcs}")


if __name__ == "__main__":
    main()
