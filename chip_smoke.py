#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`chitu_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each fatal on failure:
1. Card: name and power limit; TF32 off; build the CUDA kernels from
   `chitu_tpu_torch/csrc/` (nvcc, sm_90a) and report the build time.
2. Kernels: B1 attend_decode_fused, B2 attend_prefill_packed_fused and
   B5 attend_prefill at the shapes Llama-3-8B-Instruct serving gives them,
   each case held against its plain PyTorch version on the same inputs:
   pool bytes equal, and for every (token, head) output row
   ||kernel - plain|| <= 1e-2 * ||plain|| (bf16 outputs; a relative limit,
   because at these contexts the outputs are averages over hundreds of
   keys and far below 1 in size). Times: the kernel and
   `scaled_dot_product_attention` on the gathered K/V (the library
   yardstick) as device time, 30 calls captured in one CUDA graph and
   replayed between two CUDA events (median of 20 replays, divided by 30),
   so the host's launch cost is not in them; the plain version, which
   syncs with the host and cannot be captured, as the median of 20 calls,
   each between two events. The bound is the larger of bytes moved / 3.35 TB/s
   and attention FLOPs / 989 TFLOP/s (H100 SXM data sheet, bf16 dense).
3. Engine: `Engine` at the full width and depth of Llama-3-8B-Instruct
   with random weights on the GPU serves one lone prompt, then a burst of
   six mixed-length prompts (one longer than the 512-token slab) that
   arrives while the first decodes; 32 new tokens each. Checks that every
   request completes, the pages and slots come back, and two identical
   greedy generates agree. The kernel launch counters are zeroed just
   before this phase and read just after: every kernel must have run.
4. One `kernels` JSON line, then the device JSON as the last line.

It imports nothing of JAX or of `chitu_tpu`, exits non-zero without a
CUDA device, and fails when run outside a checkout of the repository.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense
ROW_RTOL = 1e-2
REPS = 20  # timings per case; the median is reported
GRAPH_CALLS = 30  # calls per captured graph


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def _events_ms(torch, fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def device_ms(torch, fn):
    """Device time of one fn() call: GRAPH_CALLS calls captured in one
    CUDA graph, replayed between two events; median of REPS replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    times = sorted(_events_ms(torch, graph.replay) for _ in range(REPS))
    return times[REPS // 2] / GRAPH_CALLS


def call_ms(torch, fn):
    """Median over REPS calls of one fn() call between two events, after
    3 warm-ups (host time included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = sorted(_events_ms(torch, fn) for _ in range(REPS))
    return times[REPS // 2]


def bound_ms(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(torch, tk, plain, dev):
    """Yields one result dict per case; the first case of each kernel is
    the one reported in the kernels line."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    H, KV, D, PAGE, L, LAYER = 32, 8, 128, 64, 2, 1
    M = 2 * KV * D
    G = H // KV
    B, MP = 16, 33  # max_reqs rows, max_seq_len 2048 // 64 + 1 pages
    P = B * MP
    scale = D ** -0.5
    bf = torch.bfloat16

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev)

    pool0 = randn(L, P, PAGE, M, s=0.5)

    def gathered_kv(bts):
        """[R, mp*page] rows of the kernel's layer -> K, V [R, KV, S, D]."""
        rows = plain._gather(pool_k, LAYER, bts)
        k, v = plain.unpack_pool(rows, KV, D)
        return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    def compare(name, out_k, out_p, rows, pool_kernel, pool_plain):
        """-> (max abs err, max per-row relative err) over the live rows;
        raises unless every (token, head) row is within ROW_RTOL."""
        if pool_kernel is not None and not torch.equal(pool_kernel, pool_plain):
            raise AssertionError(f"{name}: pool bytes differ from the plain version")
        a, b = out_k[rows].float(), out_p[rows].float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = (a - b).abs().max().item()
        rel = ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()
        if not rel <= ROW_RTOL:
            raise AssertionError(
                f"{name}: per-row relative err {rel} over {ROW_RTOL} "
                f"(max abs err {err})"
            )
        return err, rel

    # ---- B1: decode rows of mixed context up to 2048, dead rows --------
    bts = torch.arange(P, device=dev, dtype=torch.int32).reshape(B, MP)
    seq = randint(1, MP * PAGE - PAGE, B).to(torch.int32)
    seq[0] = 2047  # the longest context the card serves
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    valid[3] = False  # a row that appends nothing
    valid[B - 1] = False  # a padded bucket row: no pages, no context
    bts[B - 1] = -1
    seq[B - 1] = 0
    q = randn(B, H, D)
    k = randn(B, KV, D)
    v = randn(B, KV, D)
    live = valid.clone()
    for window, softcap in ((0, 0.0), (512, 30.0)):
        name = "attend_decode_fused" + ("" if not window else "[window,softcap]")
        kw = dict(scale=scale, window=window, softcap=softcap)
        pool_k = pool0.clone()
        pool_p = pool0.clone()
        args = (LAYER, k, v, bts, seq, valid, PAGE, KV, D)
        out_k = tk.attend_decode_fused(q, pool_k, *args, **kw)
        out_p = tk.attend_decode_fused_plain(q, pool_p, *args, **kw)
        err, rel = compare(name, out_k, out_p, live, pool_k, pool_p)
        ms = device_ms(torch, lambda: tk.attend_decode_fused(q, pool_k, *args, **kw))
        plain_ms = call_ms(
            torch, lambda: tk.attend_decode_fused_plain(q, pool_p, *args, **kw)
        )
        # library: SDPA over the gathered context incl. the new token
        kg, vg = gathered_kv(bts)
        S = kg.shape[2]
        cols = torch.arange(S, device=dev)[None, :]
        mask = cols <= seq[:, None].long()
        if window:
            mask &= cols > seq[:, None].long() - window
        lib_ms = None
        if not softcap:
            lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kg, vg, attn_mask=mask[:, None, None, :],
                scale=scale, enable_gqa=True,
            ))
        lo = (seq - window + 1).clamp(min=0) if window else torch.zeros_like(seq)
        ctx = (seq - lo).clamp(min=0).sum().item()  # pool rows read
        n_live = int(valid.sum().item())
        nbytes = (ctx * 2 * KV * D * 2 + 2 * q.numel() * 2
                  + 2 * k.numel() * 2 + n_live * M * 2)
        flops = 4 * H * D * (ctx + B)
        bnd, by = bound_ms(nbytes, flops)
        yield dict(name=name, kernel="attend_decode_fused", route="cuda",
                   source="chitu_tpu_torch/csrc/attention.cu",
                   replaces="chitu_tpu/ops/pallas_attention.py:727",
                   max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                   bound_by=by, library_ms=lib_ms,
                   shape=f"B={B} H={H} KV={KV} D={D} page={PAGE} mp={MP} "
                         f"ctx_rows={ctx}")

    # ---- B2: packed slab of 3 ragged segments, one mid-context ---------
    T, TQ = 512, tk.packed_q_block(H, M, PAGE, D, kv_heads=KV)
    NB = T // TQ
    R = B
    segs = [(0, 100), (256, 150), (0, 60)]  # (start, new tokens)
    mp_p = 8
    bts_p = torch.full((R, mp_p), -1, dtype=torch.int32, device=dev)
    block_seg = torch.full((NB,), -1, dtype=torch.int32, device=dev)
    block_q = torch.zeros((NB,), dtype=torch.int32, device=dev)
    total = torch.zeros((R,), dtype=torch.int32, device=dev)
    tok_live = torch.zeros((T,), dtype=torch.bool, device=dev)
    off = 0
    for r, (s, n) in enumerate(segs):
        bts_p[r] = torch.arange(r * mp_p, (r + 1) * mp_p, device=dev)
        nb = (n + TQ - 1) // TQ
        b0 = off // TQ
        block_seg[b0 : b0 + nb] = r
        block_q[b0 : b0 + nb] = s + torch.arange(nb, device=dev) * TQ
        total[r] = s + n
        tok_live[off : off + n] = True
        off += nb * TQ
    q = randn(T, H, D)
    k = randn(T, KV, D)
    v = randn(T, KV, D)
    for window, softcap in ((0, 0.0), (128, 30.0)):
        name = "attend_prefill_packed_fused" + (
            "" if not window else "[window,softcap]"
        )
        kw = dict(scale=scale, window=window, softcap=softcap)
        pool_k = pool0.clone()
        pool_p = pool0.clone()
        args = (LAYER, k, v, bts_p, block_seg, block_q, total, PAGE, KV, D)
        out_k = tk.attend_prefill_packed_fused(q, pool_k, *args, **kw)
        out_p = tk.attend_prefill_packed_fused_plain(q, pool_p, *args, **kw)
        err, rel = compare(name, out_k, out_p, tok_live, pool_k, pool_p)
        dead = ~torch.repeat_interleave(block_seg >= 0, TQ)
        if out_k[dead].abs().max().item() != 0.0:
            raise AssertionError(f"{name}: dead blocks not zero")
        ms = device_ms(
            torch, lambda: tk.attend_prefill_packed_fused(q, pool_k, *args, **kw)
        )
        plain_ms = call_ms(
            torch,
            lambda: tk.attend_prefill_packed_fused_plain(q, pool_p, *args, **kw),
        )
        # library: SDPA over each segment's gathered context, padded to
        # one batch with per-segment causal masks
        kg, vg = gathered_kv(bts_p[: len(segs)])
        S = kg.shape[2]
        nmax = max(n for _, n in segs)
        qs = torch.zeros((len(segs), H, nmax, D), dtype=bf, device=dev)
        mask = torch.zeros((len(segs), 1, nmax, S), dtype=torch.bool, device=dev)
        off = 0
        pairs = 0
        for r, (s, n) in enumerate(segs):
            qs[r, :, :n] = q[off : off + n].transpose(0, 1)
            qp = s + torch.arange(n, device=dev)[:, None]
            cols = torch.arange(S, device=dev)[None, :]
            mr = (cols <= qp) & (cols < s + n)
            if window:
                mr &= cols > qp - window
            mask[r, 0, :n] = mr
            mask[r, 0, n:, 0] = True
            pairs += int(mr.sum().item())
            off += (n + TQ - 1) // TQ * TQ
        lib_ms = None
        if not softcap:
            lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True,
            ))
        n_new = sum(n for _, n in segs)
        ctx = sum(s + n for s, n in segs)
        nbytes = (ctx * 2 * KV * D * 2 + 2 * q.numel() * 2 + n_new * M * 2
                  + n_new * 2 * KV * D * 2)
        bnd, by = bound_ms(nbytes, 4 * H * D * pairs)
        yield dict(name=name, kernel="attend_prefill_packed_fused",
                   route="cuda", source="chitu_tpu_torch/csrc/attention.cu",
                   replaces="chitu_tpu/ops/pallas_attention.py:1424",
                   max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                   bound_by=by, library_ms=lib_ms,
                   shape=f"T={T} Tq={TQ} NB={NB} segs={segs} H={H} KV={KV} D={D}")

    # ---- B5: a 512-token chunk at q_pos 512 ------------------------------
    T, start = 512, 512
    totl = start + T
    mp_s = 16
    bt = torch.arange(mp_s, device=dev, dtype=torch.int32) + 100
    q_pos = (start + torch.arange(T, device=dev)).to(torch.int32)
    q = randn(T, H, D)
    pool_k = pool0
    for window, softcap in ((0, 0.0), (256, 30.0)):
        name = "attend_prefill" + ("" if not window else "[window,softcap]")
        kw = dict(scale=scale, window=window, softcap=softcap)
        args = (pool0, LAYER, bt, q_pos, totl, PAGE, KV, D)
        out_k = tk.attend_prefill(q, *args, **kw)
        out_p = plain.attend_prefill(q, *args, **kw)
        rows = torch.ones(T, dtype=torch.bool, device=dev)
        err, rel = compare(name, out_k, out_p, rows, None, None)
        ms = device_ms(torch, lambda: tk.attend_prefill(q, *args, **kw))
        plain_ms = call_ms(torch, lambda: plain.attend_prefill(q, *args, **kw))
        kg, vg = gathered_kv(bt[None])
        S = kg.shape[2]
        cols = torch.arange(S, device=dev)[None, :]
        mask = (cols <= q_pos[:, None].long()) & (cols < totl)
        if window:
            mask &= cols > q_pos[:, None].long() - window
        pairs = int(mask.sum().item())
        lib_ms = None
        if not softcap:
            lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                q.transpose(0, 1)[None], kg, vg, attn_mask=mask[None, None],
                scale=scale, enable_gqa=True,
            ))
        nbytes = totl * 2 * KV * D * 2 + 2 * q.numel() * 2
        bnd, by = bound_ms(nbytes, 4 * H * D * pairs)
        yield dict(name=name, kernel="attend_prefill", route="cuda",
                   source="chitu_tpu_torch/csrc/attention.cu",
                   replaces="chitu_tpu/ops/pallas_attention.py:1137",
                   max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                   bound_by=by, library_ms=lib_ms,
                   shape=f"T={T} q_pos0={start} total={totl} H={H} KV={KV} D={D}")


# ---------------------------------------------------------------------------
# phase 3: the engine at full width
# ---------------------------------------------------------------------------


def engine_phase(torch, np, tk, card):
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine

    cfg = load_config(overrides=[
        "models=Llama-3-8B-Instruct", "infer.stop_with_eos=false",
    ])
    t0 = time.time()
    eng = Engine(cfg)
    torch.cuda.synchronize()
    print(f"engine bring-up {time.time() - t0:.1f} s "
          f"({cfg.models.name}, {cfg.models.n_layers} layers, random weights, "
          f"KV pool {eng.cache.bytes() / 2**30:.2f} GiB)", flush=True)
    rng = np.random.default_rng(0)
    V = cfg.models.vocab_size

    def prompt(n):
        return [int(x) for x in rng.integers(1, V, size=n)]

    greedy = SampleParams(temperature=0.0, max_new_tokens=32)
    sampled = SampleParams(temperature=0.8, top_k=16, top_p=0.9,
                           frequency_penalty=0.1, max_new_tokens=32)
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t_start = time.time()
    reqs = [eng.submit("", greedy, prompt_tokens=prompt(300))]
    eng.step()  # the lone prompt prefills alone (B5)
    eng.step()  # ... and decodes (B1)
    lens = [40, 100, 200, 130, 60, 700]  # 700 > the 512-token slab
    for i, n in enumerate(lens):
        reqs.append(eng.submit("", greedy if i % 2 == 0 else sampled,
                               prompt_tokens=prompt(n)))
    eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.time() - t_start
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        if r.finish_reason is None or len(r.async_stream.tokens) != 32:
            raise AssertionError(
                f"request {r.request_id} incomplete: "
                f"{len(r.async_stream.tokens)} tokens, {r.finish_reason}"
            )
    if eng.cache.allocator.num_free() != eng.cache.num_pages:
        raise AssertionError("KV pages not all returned")
    if len(eng.pool) != 0 or len(eng.executor.slots.free) != cfg.infer.max_reqs:
        raise AssertionError("tasks or slots left behind")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the engine")

    # time to first token: arrival to the end of the request's prefill
    ttft = [r.prefill_end_time - r.arrival_time for r in reqs]
    toks = sum(len(r.async_stream.tokens) for r in reqs)
    p = [int(x) for x in rng.integers(1, V, size=64)]
    a = eng.generate("", SampleParams(temperature=0.0, max_new_tokens=16),
                     prompt_tokens=p)
    b = eng.generate("", SampleParams(temperature=0.0, max_new_tokens=16),
                     prompt_tokens=p)
    if a != b:
        raise AssertionError(f"greedy generates differ: {a} vs {b}")
    # a lone request: its decode rate at batch 1 (64 tokens after the
    # first, over the time from its first token to its last)
    lone = eng.submit("", SampleParams(temperature=0.0, max_new_tokens=65),
                      prompt_tokens=p)
    eng.run_until_complete()
    torch.cuda.synchronize()
    stats = dict(
        card=card,
        requests=len(reqs),
        new_tokens=toks,
        burst_wall_s=wall,
        burst_tokens_per_s=toks / wall,
        ttft_s=sorted(ttft),
        decode_tokens_per_s_batch1=64 / (lone.finish_time - lone.prefill_end_time),
        peak_mem_gib=peak / 2**30,
        launches=launches,
    )
    print("engine " + json.dumps(stats), flush=True)
    return launches


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    from chitu_tpu_torch.ops import attention as plain
    from chitu_tpu_torch.ops import attention_kernels as tk

    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device {name}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    tk.build_kernels()
    print(f"kernel build {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    first = {}
    for res in kernel_cases(torch, tk, plain, dev):
        res["card"] = card
        print("case " + json.dumps(res), flush=True)
        first.setdefault(res["kernel"], res)

    launches = engine_phase(torch, np, tk, card)

    rows = []
    for kname in ("attend_decode_fused", "attend_prefill_packed_fused",
                  "attend_prefill"):
        r = first[kname]
        rows.append(dict(
            name=kname, route=r["route"], source=r["source"],
            replaces=r["replaces"], launches=launches[kname],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
