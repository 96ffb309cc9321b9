#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/CUDA port, on one GPU.

    python3 scripts/torch_decode_profile.py [batch] [prompt_len]

Builds the Llama-3-8B-Instruct engine at full width and depth with random
weights, puts `batch` greedy requests of `prompt_len` random tokens into
decode, then times decode steps twice: plain wall clock (decode tokens
per second at that batch), and under `torch.profiler` to split device
kernel time into the port's attention kernels, GEMMs and everything else.
The device's busy share is kernel time per step over the unprofiled wall
time per step (the kernels run on one stream, so they do not overlap);
its idle share is the rest. Prints one JSON line
with the card's name and power limit. Needs a CUDA device.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def category(name: str) -> str:
    if any(k in name for k in ("decode_fused_kernel", "prefill_attend_kernel",
                                "append_packed_kernel")):
        return "attention_kernels"
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "gemm"
    return "other"


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    plen = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = load_config(overrides=[
        "models=Llama-3-8B-Instruct", "infer.stop_with_eos=false",
        "infer.adaptive_window=false", f"infer.max_reqs={max(batch, 1)}",
    ])
    eng = Engine(cfg)
    rng = np.random.default_rng(0)
    V = cfg.models.vocab_size
    p = SampleParams(temperature=0.0, max_new_tokens=4096)

    def submit_batch():
        return [eng.submit("", p, prompt_tokens=[int(x) for x in
                rng.integers(1, V, size=plen)]) for _ in range(batch)]

    reqs = submit_batch()
    eng.step()  # prefill all
    ex = eng.executor
    window = cfg.infer.decode_window

    live = [eng.pool[f"task-{r.request_id}"] for r in reqs]

    def decode_steps(n_chains):
        """-> (wall seconds, decode steps) of n_chains decode chains."""
        before = len(live[0].response_tokens)
        t0 = time.perf_counter()
        for _ in range(n_chains):
            ex.decode_step(live)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, len(live[0].response_tokens) - before

    decode_steps(1)  # warm
    wall, steps = decode_steps(3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pwall, psteps = decode_steps(1)
    from torch.autograd import DeviceType

    kern = {}  # device kernels only (operator rows also carry device time)
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        if t > 0 and e.device_type == DeviceType.CUDA:
            kern[e.key] = kern.get(e.key, 0.0) + t
    busy_us = sum(kern.values())
    cats = {}
    for k, t in kern.items():
        cats[category(k)] = cats.get(category(k), 0.0) + t
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps(dict(
        card=card, batch=batch, prompt_len=plen, window=window,
        steps_timed=steps, steps_profiled=psteps,
        decode_ms_per_step=wall / steps * 1e3,
        decode_tokens_per_s=batch * steps / wall,
        profiled_ms_per_step=pwall / psteps * 1e3,
        device_kernel_ms_per_step=busy_us / psteps / 1e3,
        # kernel time per step over the unprofiled wall time per step
        device_busy_share=(busy_us / psteps / 1e3) / (wall / steps * 1e3),
        device_ms_per_step={k: v / psteps / 1e3 for k, v in cats.items()},
        top_kernels_ms_per_step=[(k[:80], v / psteps / 1e3) for k, v in top],
    )), flush=True)
    eng.terminate()


if __name__ == "__main__":
    main()
