#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/CUDA port, on one GPU.

    python3 scripts/torch_decode_profile.py [batch] [prompt_len] \
        [quant_method] [model card] [layers] [kv_dtype] [mla_absorb]
    python3 scripts/torch_decode_profile.py --prefill [same arguments]
    python3 scripts/torch_decode_profile.py --host [same arguments]

Builds the engine of a model card (default Llama-3-8B-Instruct) at full
width and at `layers` deep (default: the card's depth) with random
weights (quantized on load when a `quant.method` such as soft_fp8 is
named; `infer.kv_dtype` bf16 or fp8, default bf16; `infer.mla_absorb`
absorb or none for a DeepSeek card, default absorb), puts `batch` greedy
requests of `prompt_len` random tokens into
decode, then times decode steps twice: plain wall clock (decode tokens
per second at that batch), and under `torch.profiler` to split device
kernel time into the port's attention kernels (the DeepSeek latent-row
kernel on its own), the MLA absorb projections (B9), its quantized GEMMs
and activation quantizers, the grouped expert GEMM, the MoE glue (every
other kernel launched between the router and the combine: router,
dispatch, gather, SwiGLU, combine), library GEMMs and everything else. The glue is
told apart by where it is launched, not by name: the model's calls to
`route` and `moe_ffn_auto` run inside a profiler range, and a kernel
counts as glue when the operator that launched it lies in that range.
It also gives the process's CPU time a decode step over the same
steps (`host_cpu_ms_per_step`: the host's own work, less disturbed by
other loads on the host than the wall clock). The device's busy share is
kernel time per step over the unprofiled wall time per step (the kernels run on one stream, so they do not overlap);
its idle share is the rest. With --prefill it times the prefill step of
one prompt of `prompt_len` tokens instead (the 512-token slab at the
default 512; one new token, so the step is the prefill and its sampling),
split the same way. With --host it also runs one more decode chain under
cProfile and adds the host's own time a step by Python function
(`host_top`: calls and self time a step, the time of any ctypes or C call
a function makes counted in its own). Prints one JSON line
with the card's name and power limit. Needs a CUDA device.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def category(name: str) -> str:
    if "latent_kernel" in name or "latent_merge_kernel" in name:
        return "latent_attention_kernel"
    if "absorb_wg_kernel" in name:
        return "absorb_matmul_kernel"
    if any(k in name for k in ("decode_kernel", "decode_merge_kernel",
                                "prefill_attend_kernel",
                                "append_packed_kernel")):
        return "attention_kernels"
    # the shared TMA + wgmma mainloop: its third template argument is the
    # call site (0 the dequant GEMM and the int8 GEMM, 1 the grouped expert
    # GEMM, 2 the dense stacked-layer GEMM)
    if "wg_gemm_kernel" in name:
        site = name.split("wg_gemm_kernel<", 1)[-1].split(">", 1)[0]
        site = site.replace(" ", "")
        if site.endswith(",1"):
            return "grouped_gemm_kernel"
        if site.endswith(",2"):
            return "dense_gemm_kernel"
        return "quant_gemm_kernels"
    if "norm_quant_kernel" in name:
        return "act_quant_kernels"
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "gemm"
    return "other"


GLUE = "moe_router_dispatch_combine"


def range_moe_calls(torch, model_type: str):
    """Run the model module's calls into `models.moe` (Mixtral's or
    DeepSeek's) inside a profiler range named GLUE."""
    from chitu_tpu_torch.models import deepseek_v3, mixtral

    mod = deepseek_v3 if model_type == "deepseek-v3" else mixtral

    def ranged(fn):
        def call(*a, **kw):
            with torch.profiler.record_function(GLUE):
                return fn(*a, **kw)

        return call

    mod.route = ranged(mod.route)
    mod.moe_ffn_auto = ranged(mod.moe_ffn_auto)


def glue_us(prof):
    """Device time, by name category, of the kernels launched inside a
    GLUE range other than the grouped GEMM itself."""
    out = {}
    for e in prof.events():
        kernels = getattr(e, "kernels", None)
        if not kernels:
            continue
        p, inside = e, False
        while p is not None and not inside:
            inside = p.name == GLUE
            p = p.cpu_parent
        if not inside:
            continue
        for k in kernels:
            c = category(k.name)
            if c != "grouped_gemm_kernel":
                out[c] = out.get(c, 0.0) + k.duration
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine

    prefill = "--prefill" in sys.argv
    host = "--host" in sys.argv
    sys.argv = [a for a in sys.argv if a not in ("--prefill", "--host")]
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else (1 if prefill else 16)
    plen = int(sys.argv[2]) if len(sys.argv) > 2 else (512 if prefill else 256)
    method = sys.argv[3] if len(sys.argv) > 3 else "none"
    model = sys.argv[4] if len(sys.argv) > 4 else "Llama-3-8B-Instruct"
    depth = [f"models.n_layers={int(sys.argv[5])}"] if len(sys.argv) > 5 else []
    kv_dtype = sys.argv[6] if len(sys.argv) > 6 else "bf16"
    absorb = sys.argv[7] if len(sys.argv) > 7 else "absorb"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = load_config(overrides=[
        f"models={model}", "infer.stop_with_eos=false",
        "infer.adaptive_window=false", f"infer.max_reqs={max(batch, 1)}",
        f"quant.method={method}", f"quant.quant_on_load={str(method != 'none').lower()}",
        f"infer.kv_dtype={kv_dtype}", f"infer.mla_absorb={absorb}", *depth,
    ])
    moe = cfg.models.moe is not None
    if moe:
        range_moe_calls(torch, cfg.models.type)
    t0 = time.perf_counter()
    eng = Engine(cfg)
    torch.cuda.synchronize()
    bringup = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2**30 - eng.cache.bytes() / 2**30
    rng = np.random.default_rng(0)
    V = cfg.models.vocab_size
    p = SampleParams(temperature=0.0, max_new_tokens=4096)

    def submit_batch():
        return [eng.submit("", p, prompt_tokens=[int(x) for x in
                rng.integers(1, V, size=plen)]) for _ in range(batch)]

    ex = eng.executor
    window = cfg.infer.decode_window
    if prefill:
        one = SampleParams(temperature=0.0, max_new_tokens=1)

        def decode_steps(n):
            """-> (wall seconds, prefill steps) of n prefill steps, each a
            new batch of prompts that ends with its first token."""
            t = 0.0
            for _ in range(n):
                for _ in range(batch):
                    eng.submit("", one, prompt_tokens=[
                        int(x) for x in rng.integers(1, V, size=plen)])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                t += time.perf_counter() - t0
                eng.run_until_complete()
            return t, n
    else:
        reqs = submit_batch()
        eng.step()  # prefill all
        live = [eng.pool[f"task-{r.request_id}"] for r in reqs]

    def decode_chains(n_chains):
        """-> (wall seconds, decode steps) of n_chains decode chains."""
        before = len(live[0].response_tokens)
        t0 = time.perf_counter()
        for _ in range(n_chains):
            ex.decode_step(live)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, len(live[0].response_tokens) - before

    if not prefill:
        decode_steps = decode_chains
    decode_steps(1)  # warm
    cpu0 = time.process_time()
    wall, steps = decode_steps(3)
    cpu = time.process_time() - cpu0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pwall, psteps = decode_steps(1)
    from torch.autograd import DeviceType

    kern = {}  # device kernels only (operator rows also carry device time)
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        # the GLUE range has a device-side twin that is no kernel
        if t > 0 and e.device_type == DeviceType.CUDA and e.key != GLUE:
            kern[e.key] = kern.get(e.key, 0.0) + t
    busy_us = sum(kern.values())
    cats = {}
    for k, t in kern.items():
        cats[category(k)] = cats.get(category(k), 0.0) + t
    if moe:
        # move the glue out of the name categories its kernels fell into
        glue = glue_us(prof)
        for c, t in glue.items():
            cats[c] = cats.get(c, 0.0) - t
        cats[GLUE] = sum(glue.values()) if glue else None
    launches = sum(
        e.count for e in prof.key_averages()
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernelEx")
    )
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    host_top = None
    if host:
        import cProfile
        import pstats

        prof_host = cProfile.Profile()
        prof_host.enable()
        _, hsteps = decode_steps(1)
        prof_host.disable()
        stats = pstats.Stats(prof_host).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)
        rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]
        host_top = [(f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", v[1] / hsteps,
                     v[2] / hsteps * 1e6) for k, v in rows]
    print(json.dumps(dict(
        card=card, model=cfg.models.name, layers=cfg.models.n_layers,
        step="prefill" if prefill else "decode", batch=batch, prompt_len=plen, window=window, quant=method,
        kv_dtype=kv_dtype, mla_absorb=absorb,
        kv_pool_gib=eng.cache.bytes() / 2**30,
        bringup_s=bringup, weights_gib=weights_gib,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        steps_timed=steps, steps_profiled=psteps,
        decode_ms_per_step=wall / steps * 1e3,
        decode_tokens_per_s=batch * steps / wall,
        # the process's CPU time over the same steps: the host's own work,
        # which other loads on the host do not inflate as they do the wall
        # clock (it counts any spin while waiting on the card); decode only
        host_cpu_ms_per_step=None if prefill else cpu / steps * 1e3,
        profiled_ms_per_step=pwall / psteps * 1e3,
        device_kernel_ms_per_step=busy_us / psteps / 1e3,
        # kernel time per step over the unprofiled wall time per step
        device_busy_share=(busy_us / psteps / 1e3) / (wall / steps * 1e3),
        device_idle_share=1.0 - (busy_us / psteps / 1e3) / (wall / steps * 1e3),
        kernel_launches_per_step=launches / psteps,
        device_ms_per_step={
            k: None if v is None else v / psteps / 1e3 for k, v in cats.items()},
        top_kernels_ms_per_step=[(k[:80], v / psteps / 1e3) for k, v in top],
        # (function, calls a step, self us a step) under cProfile, with --host
        host_top=host_top,
    )), flush=True)
    eng.terminate()


if __name__ == "__main__":
    main()
