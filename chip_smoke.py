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
   The quantized GEMMs (B6+B7 `quant_gemm`, B10 `int8_gemm`) and the
   activation quantizers (B11 `rms_norm_quant`, B12 `quant_acts`) at the
   same model's projection shapes ([4096 -> 6144], [4096 -> 28672],
   [14336 -> 4096]; T 1, 16 and 512): every weight mode (e4m3 blockwise,
   e4m3 rowwise as layer 1 of a stack, int8 per-channel, int4 packed,
   int4 one nibble a byte at a width that is no multiple of 512, and an
   odd 576-wide output). Limits: each GEMM output row within 1e-2 of the
   plain row's norm; the int8 GEMM's int32 sums equal; activation scales
   within 1e-6 relative and int8 values equal but for at most 0.1 % that
   differ by 1. Library yardsticks: `torch.matmul` on weights dequantized
   beforehand, `torch._int_mm` (timed only). Bound: bytes of weights,
   scales, x and y / 3.35 TB/s against 2TKN / 989 TFLOP/s (bf16) or
   / 1979 TOP/s (int8).
3. Engine: `Engine` at the full width and depth of Llama-3-8B-Instruct
   with random weights on the GPU serves one lone prompt, then a burst of
   six mixed-length prompts (one longer than the 512-token slab) that
   arrives while the first decodes; 32 new tokens each. Checks that every
   request completes, the pages and slots come back, and two identical
   greedy generates agree. The kernel launch counters are zeroed just
   before this phase and read just after: every kernel must have run.
   Then the same burst with `quant.method=soft_fp8 quant.quant_on_load=true`
   at full width and depth (the dequant GEMM must have run), and at full
   width and 4 layers one short burst each for fp8 with e4m3 activations,
   w8a16 (with a quantized head), w4a16 (packed), w8a8 and llmint8. In
   each 4-layer phase one 64-token prefill runs through the kernels with
   every quantized-kernel call shadowed by its plain version on the same
   inputs (held to the limits of phase 2), and its logits are held
   against the same model through the plain versions of the quantized
   GEMMs and activation quantizers on the card: every row within 2e-2 of
   the plain row's norm. Two exceptions, reported but not held: fp8 with
   e4m3 activations and w8a8, whose activation rounding is a step
   function that turns a last-bit difference into whole steps. (Not at
   full depth either: through 32 layers of random weights a last-bit
   difference grows to 5-6 % of a logits row, whichever of two sound
   implementations made it.)
4. One `kernels` JSON line, then the device JSON as the last line.

It imports nothing of JAX or of `chitu_tpu`, exits non-zero without a
CUDA device, and fails when run outside a checkout of the repository.
"""

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense
INT8_OP_PER_S = 1979e12  # H100 SXM, dense
ROW_RTOL = 1e-2
LOGITS_RTOL = 2e-2  # engine phases: kernels against plain versions
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


def device_ms(torch, fn, calls=GRAPH_CALLS, reps=REPS):
    """Device time of one fn() call: `calls` calls captured in one CUDA
    graph, replayed between two events; median of `reps` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = sorted(_events_ms(torch, graph.replay) for _ in range(reps))
    return times[reps // 2] / calls


def device_ms_sized(torch, fn):
    """`device_ms` with the graph sized to the call: about 20 ms of work a
    replay (3 to 30 calls), 10 replays."""
    fn()
    torch.cuda.synchronize()
    one = _events_ms(torch, fn)
    calls = max(3, min(GRAPH_CALLS, int(20.0 / max(one, 1e-3))))
    return device_ms(torch, fn, calls=calls, reps=10)


def call_ms(torch, fn, reps=REPS):
    """Median over `reps` calls of one fn() call between two events, after
    3 warm-ups (host time included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = sorted(_events_ms(torch, fn) for _ in range(reps))
    return times[reps // 2]


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
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
# phase 2b: the quantized GEMMs and activation quantizers
# ---------------------------------------------------------------------------

QGEMM_SRC = "chitu_tpu_torch/csrc/quant_gemm.cu"
NQ_SRC = "chitu_tpu_torch/csrc/norm_quant.cu"
PROJ = [(4096, 28672), (4096, 6144), (14336, 4096)]  # w_gate_up, wqkv, w_down
TS = [16, 1, 512]


def _row_rel(torch, name, got, want, limit):
    a, b = got.float(), want.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (a - b).abs().max().item()
    rel = ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()
    if not rel <= limit:
        raise AssertionError(
            f"{name}: per-row relative err {rel} over {limit} (max abs err {err})"
        )
    return err, rel


def quant_kernel_cases(torch, qg, nq, qt, QuantKind, dev):
    """One result dict per case; the first case of each kernel is the one
    reported in the kernels line (the shape the soft-fp8 engine's decode
    gives it)."""
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    def weight(mode, K, N):
        """-> (QTensor of one layer, description)."""
        if mode == "e4m3_rowwise_layer1":
            w = randn(2, K, N, s=0.02)
            q = qt.expand_fp8_scales_rowwise(
                {"w": qt.quantize_stacked(
                    w, lambda t: qt.quantize_weight(t, QuantKind.FP8))}
            )["w"]
            assert q.scale.shape == (2, K // 128, N)
            return q[1]
        w = randn(K, N, s=0.02)
        if mode == "e4m3_blockwise":
            return qt.quantize_weight(w, QuantKind.SOFT_FP8)
        if mode == "int8_channel":
            return qt.quantize_weight(w, QuantKind.W8A16)
        q = qt.quantize_weight(w, QuantKind.W4A16)
        if mode == "int4_packed":
            q = qt.pack_int4_storage({"w": q})["w"]
            assert q.packed
        else:
            assert not q.packed
        return q

    def gemm_case(mode, T, K, N, timed=True):
        q = weight(mode, K, N)
        x = randn(T, K)
        name = f"quant_gemm[{mode},T={T},{K}->{N}]"
        got = qg.quant_gemm(x, q)
        want = qg.quant_gemm_plain(x, q)
        err, rel = _row_rel(torch, name, got, want, ROW_RTOL)
        # bf16 output with a bias through the same kernel
        bias = randn(N)
        _row_rel(torch, name + "+bias", qg.quant_gemm(x, q, bias, bf),
                 qg.quant_gemm_plain(x, q, bias, bf), ROW_RTOL)
        nbytes = q.nbytes() + x.numel() * 2 + T * N * 4
        bnd, by = bound_ms(nbytes, 2.0 * T * K * N)
        res = dict(name=name, kernel="quant_gemm", route="cuda",
                   source=QGEMM_SRC,
                   replaces="chitu_tpu/ops/pallas_quant_gemm.py:282",
                   max_abs_err=err, max_row_rel_err=rel, bound_ms=bnd,
                   bound_by=by, ms=None, plain_ms=None, library_ms=None,
                   shape=f"T={T} K={K} N={N} mode={mode} "
                         f"weight_bytes={q.nbytes()}")
        if timed:
            res["ms"] = device_ms_sized(torch, lambda: qg.quant_gemm(x, q))
            res["plain_ms"] = call_ms(
                torch, lambda: qg.quant_gemm_plain(x, q), reps=5)
            wd = q.dequantize(bf)
            res["library_ms"] = device_ms_sized(torch, lambda: torch.matmul(x, wd))
            del wd
        return res

    # the soft-fp8 engine's own shapes first, then every other mode
    for K, N in PROJ:
        for T in TS:
            yield gemm_case("e4m3_blockwise", T, K, N)
    for mode in ("e4m3_rowwise_layer1", "int8_channel", "int4_packed",
                 "int4_unpacked"):
        for K, N in PROJ:
            if mode == "int4_unpacked":
                N -= 128  # no multiple of 512: stays one nibble a byte
            for T in TS:
                yield gemm_case(mode, T, K, N)
    for mode in ("e4m3_blockwise", "int4_unpacked", "int8_channel"):
        yield gemm_case(mode, 16, 4096, 576)  # an odd output width
    yield gemm_case("e4m3_blockwise", 16, 4000, 6144, timed=False)  # ragged K
    torch.cuda.empty_cache()

    # ---- B10: int8 x int8 -> int32, then the two scales ------------------
    for K, N in PROJ:
        w8 = qt.quantize_weight(randn(K, N, s=0.02), QuantKind.W8A8)
        for T in TS:
            name = f"int8_gemm[T={T},{K}->{N}]"
            xa = nq.quant_acts_plain(randn(T, K))
            acc = qg.int8_matmul(xa.data, w8.data)
            acc_p = qg.int8_matmul_plain(xa.data, w8.data)
            if not torch.equal(acc, acc_p):
                bad = (acc != acc_p).sum().item()
                raise AssertionError(f"{name}: {bad} int32 sums differ")
            got = qg.int8_gemm(xa.data, xa.scale, w8)
            want = qg.int8_gemm_plain(xa.data, xa.scale, w8)
            err, rel = _row_rel(torch, name, got, want, 1e-5)
            nbytes = w8.nbytes() + T * K + T * 4 + T * N * 4
            bnd, by = bound_ms(nbytes, 2.0 * T * K * N, INT8_OP_PER_S)
            lib = None
            if T > 16:  # torch._int_mm takes more than 16 rows only
                lib = device_ms_sized(
                    torch, lambda: torch._int_mm(xa.data, w8.data))
            yield dict(
                name=name, kernel="int8_gemm", route="cuda", source=QGEMM_SRC,
                replaces="chitu_tpu/ops/pallas_quant_gemm.py:501",
                max_abs_err=err, max_row_rel_err=rel, int32_sums_equal=True,
                ms=device_ms_sized(
                    torch, lambda: qg.int8_gemm(xa.data, xa.scale, w8)),
                plain_ms=call_ms(
                    torch, lambda: qg.int8_gemm_plain(xa.data, xa.scale, w8),
                    reps=5),
                bound_ms=bnd, bound_by=by, library_ms=lib,
                shape=f"T={T} K={K} N={N}")
        del w8

    # ---- B11 / B12: activation quantizers ---------------------------------
    def acts_check(name, got, want):
        rel = ((got.scale - want.scale).abs() / want.scale).max().item()
        d = (got.data.int() - want.data.int()).abs()
        off = (d != 0).float().mean().item()
        if not (rel <= 1e-6 and d.max().item() <= 1 and off <= 1e-3):
            raise AssertionError(
                f"{name}: scale rel err {rel}, max int8 diff {d.max().item()}, "
                f"share off by one {off}"
            )
        return rel, off, float(d.max().item())

    for T in (16, 512):
        D = 4096
        x, w = randn(T, D), (1.0 + 0.1 * randn(D).float()).to(bf)
        name = f"rms_norm_quant[T={T},D={D}]"
        rel, off, dmax = acts_check(name, nq.rms_norm_quant(x, w, 1e-5),
                                    nq.rms_norm_quant_plain(x, w, 1e-5))
        bnd, by = bound_ms(T * D * 3 + D * 2 + T * 4, 0.0)
        yield dict(
            name=name, kernel="rms_norm_quant", route="cuda", source=NQ_SRC,
            replaces="chitu_tpu/ops/pallas_norm_quant.py:79",
            max_abs_err=dmax, scale_rel_err=rel, int8_off_by_one_share=off,
            ms=device_ms(torch, lambda: nq.rms_norm_quant(x, w, 1e-5)),
            plain_ms=call_ms(torch, lambda: nq.rms_norm_quant_plain(x, w, 1e-5)),
            bound_ms=bnd, bound_by=by, library_ms=None, shape=f"T={T} D={D}")
    for T in (16, 512):
        D = 14336
        x = randn(T, D)
        name = f"quant_acts[T={T},F={D}]"
        rel, off, dmax = acts_check(
            name, nq.quant_acts(x), nq.quant_acts_plain(x))
        bnd, by = bound_ms(T * D * 3 + T * 4, 0.0)
        yield dict(
            name=name, kernel="quant_acts", route="cuda", source=NQ_SRC,
            replaces="chitu_tpu/ops/pallas_norm_quant.py:107",
            max_abs_err=dmax, scale_rel_err=rel, int8_off_by_one_share=off,
            ms=device_ms(torch, lambda: nq.quant_acts(x)),
            plain_ms=call_ms(torch, lambda: nq.quant_acts_plain(x)),
            bound_ms=bnd, bound_by=by, library_ms=None, shape=f"T={T} F={D}")


# ---------------------------------------------------------------------------
# phase 3: the engine at full width
# ---------------------------------------------------------------------------


ATTN_KERNELS = ("attend_decode_fused", "attend_prefill_packed_fused",
                "attend_prefill")


def _swap_targets():
    """(module, name) of every call the model makes into this slice's
    kernels, each with its plain version."""
    from chitu_tpu_torch.models import llama
    from chitu_tpu_torch.ops import linear, norm_quant, quant_gemm_kernels

    return [
        (linear, "quant_gemm", quant_gemm_kernels.quant_gemm_plain),
        (linear, "int8_gemm", quant_gemm_kernels.int8_gemm_plain),
        (linear, "quant_acts", norm_quant.quant_acts_plain),
        (llama, "quant_acts", norm_quant.quant_acts_plain),
        (llama, "rms_norm_quant", norm_quant.rms_norm_quant_plain),
    ]


@contextlib.contextmanager
def _swapped(make):
    """Replace each target `mod.name` by `make(kernel_fn, plain_fn, name)`
    for the duration of the block."""
    targets = _swap_targets()
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    try:
        for (mod, name, plain_fn), (_, _, kernel_fn) in zip(targets, old):
            setattr(mod, name, make(kernel_fn, plain_fn, name))
        yield
    finally:
        for mod, name, fn in old:
            setattr(mod, name, fn)


def plain_versions():
    """Route the model through the plain PyTorch versions of the
    quantized GEMMs and activation quantizers on the card. Attention stays
    on its kernel (it is held against its own plain version in phase 2)."""
    return _swapped(lambda kernel_fn, plain_fn, name: plain_fn)


def shadowed(torch, errs):
    """Every call into one of this slice's kernels also runs the plain
    version on the same inputs and is held to the kernel cases' limits;
    the kernel's result goes on. `errs[name]` collects the largest error
    (GEMM: row relative; quantizers: share of int8 values off by one)."""

    def make(kernel_fn, plain_fn, name):
        def both(*args, **kw):
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            if name.endswith("gemm"):
                limit = ROW_RTOL if name == "quant_gemm" else 1e-5
                _, e = _row_rel(torch, f"{name} in the model", got, want, limit)
            else:
                rel = ((got.scale - want.scale).abs() / want.scale).max().item()
                d = (got.data.int() - want.data.int()).abs()
                e = (d != 0).float().mean().item()
                if not (rel <= 1e-6 and d.max().item() <= 1 and e <= 1e-3):
                    raise AssertionError(
                        f"{name} in the model: scale rel err {rel}, max int8 "
                        f"diff {d.max().item()}, share off by one {e}"
                    )
            errs[name] = max(errs.get(name, 0.0), e)
            return got

        return both

    return _swapped(make)


# Activations that pass through a step function (e4m3 rounding: steps of
# 6-12 % of a value; per-token int8: 0.8 % of a row's largest) turn a
# last-bit difference between two sound implementations into whole steps,
# so logits of two such runs are reported, not held to LOGITS_RTOL. Every
# kernel call inside those runs is still held to its limit on equal inputs.
STEP_ACTS = ("fp8_e4m3", "w8a8")


def logits_against_plain(torch, np, eng, label):
    """One 64-token prefill of the idle engine's model. First through the
    kernels, each quantized-kernel call shadowed by its plain version on
    the same inputs (fatal over the kernel limits); then through the plain
    versions. -> (largest per-call errors, max per-row relative err of the
    [64, vocab] logits between the two runs; over LOGITS_RTOL it raises,
    except for step-function activations)."""
    cfg = eng.cfg
    dev = eng.device
    rng = np.random.default_rng(7)
    toks = torch.tensor(rng.integers(1, cfg.models.vocab_size, size=64),
                        dtype=torch.int32, device=dev)
    mp = cfg.infer.max_seq_len // cfg.infer.page_size + 1
    bt = torch.arange(mp, dtype=torch.int32, device=dev)  # free pages
    cache = {"kv": eng.cache.arrays["kv"]}
    args = (cache, toks, bt, 0, 64, cfg.infer.page_size)
    errs = {}
    with torch.no_grad():
        with shadowed(torch, errs):
            got, _ = eng.model.prefill(*args, return_all_logits=True)
        with plain_versions():
            want, _ = eng.model.prefill(*args, return_all_logits=True)
    torch.cuda.synchronize()
    if got.shape != (64, cfg.models.vocab_size):
        raise AssertionError(f"{label}: logits shape {tuple(got.shape)}")
    if not errs:
        raise AssertionError(f"{label}: the prefill reached no quantized kernel")
    limit = float("inf") if label in STEP_ACTS else LOGITS_RTOL
    _, rel = _row_rel(torch, f"{label} prefill logits", got, want, limit)
    return errs, rel


def engine_phase(torch, np, tk, card, label="bf16", overrides=(),
                 lens=(40, 100, 200, 130, 60, 700), new_tokens=32,
                 need=ATTN_KERNELS, check_plain=False):
    """Bring up an engine, serve one lone prompt and then a burst that
    arrives while it decodes, check everything came back, and return the
    kernel launch counts of that run (zeroed just before it)."""
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine

    cfg = load_config(overrides=[
        "models=Llama-3-8B-Instruct", "infer.stop_with_eos=false",
        *overrides,
    ])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = Engine(cfg)
    torch.cuda.synchronize()
    bringup = time.time() - t0
    print(f"engine[{label}] bring-up {bringup:.1f} s "
          f"({cfg.models.name}, {cfg.models.n_layers} layers, random weights, "
          f"quant {cfg.quant.method}, KV pool {eng.cache.bytes() / 2**30:.2f} GiB, "
          f"peak during bring-up "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)", flush=True)
    rng = np.random.default_rng(0)
    V = cfg.models.vocab_size

    def prompt(n):
        return [int(x) for x in rng.integers(1, V, size=n)]

    greedy = SampleParams(temperature=0.0, max_new_tokens=new_tokens)
    sampled = SampleParams(temperature=0.8, top_k=16, top_p=0.9,
                           frequency_penalty=0.1, max_new_tokens=new_tokens)
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t_start = time.time()
    reqs = [eng.submit("", greedy, prompt_tokens=prompt(300))]
    eng.step()  # the lone prompt prefills alone (B5)
    eng.step()  # ... and decodes (B1)
    for i, n in enumerate(lens):
        reqs.append(eng.submit("", greedy if i % 2 == 0 else sampled,
                               prompt_tokens=prompt(n)))
    eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.time() - t_start
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        if r.finish_reason is None or len(r.async_stream.tokens) != new_tokens:
            raise AssertionError(
                f"[{label}] request {r.request_id} incomplete: "
                f"{len(r.async_stream.tokens)} tokens, {r.finish_reason}"
            )
    if eng.cache.allocator.num_free() != eng.cache.num_pages:
        raise AssertionError(f"[{label}] KV pages not all returned")
    if len(eng.pool) != 0 or len(eng.executor.slots.free) != cfg.infer.max_reqs:
        raise AssertionError(f"[{label}] tasks or slots left behind")
    for name in need:
        if launches.get(name, 0) <= 0:
            raise AssertionError(
                f"[{label}] kernel {name} was not launched by the engine")

    # time to first token: arrival to the end of the request's prefill
    ttft = [r.prefill_end_time - r.arrival_time for r in reqs]
    toks = sum(len(r.async_stream.tokens) for r in reqs)
    p = [int(x) for x in rng.integers(1, V, size=64)]
    a = eng.generate("", SampleParams(temperature=0.0, max_new_tokens=16),
                     prompt_tokens=p)
    b = eng.generate("", SampleParams(temperature=0.0, max_new_tokens=16),
                     prompt_tokens=p)
    if a != b:
        raise AssertionError(f"[{label}] greedy generates differ: {a} vs {b}")
    stats = dict(
        phase=label, card=card, layers=cfg.models.n_layers,
        bringup_s=bringup, requests=len(reqs), new_tokens=toks,
        burst_wall_s=wall, burst_tokens_per_s=toks / wall,
        ttft_s=sorted(ttft), peak_mem_gib=peak / 2**30, launches=launches,
    )
    if new_tokens >= 32:
        # a lone request: its decode rate at batch 1 (64 tokens after the
        # first, over the time from its first token to its last)
        lone = eng.submit("", SampleParams(temperature=0.0, max_new_tokens=65),
                          prompt_tokens=p)
        eng.run_until_complete()
        torch.cuda.synchronize()
        stats["decode_tokens_per_s_batch1"] = 64 / (
            lone.finish_time - lone.prefill_end_time)
    if check_plain:
        errs, rel = logits_against_plain(torch, np, eng, label)
        stats["kernel_call_err_vs_plain"] = errs
        stats["logits_row_rel_err_vs_plain"] = rel
    print("engine " + json.dumps(stats), flush=True)
    eng.terminate()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


QUANT_PHASES = [
    # (label, overrides, kernels that must have launched)
    ("fp8_e4m3", ["quant.method=fp8", "quant.fp8_act=e4m3"], ("quant_gemm",)),
    ("w8a16_head", ["quant.method=w8a16", "quant.quantize_head=true"],
     ("quant_gemm",)),
    ("w4a16_packed", ["quant.method=w4a16"], ("quant_gemm",)),
    ("w8a8", ["quant.method=w8a8"],
     ("int8_gemm", "rms_norm_quant", "quant_acts")),
    ("llmint8", ["quant.method=llmint8"], ("quant_gemm",)),
]
KERNEL_ORDER = ATTN_KERNELS + (
    "quant_gemm", "int8_gemm", "rms_norm_quant", "quant_acts")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    from chitu_tpu_torch.ops import attention as plain
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chitu_tpu_torch.ops import norm_quant as nq
    from chitu_tpu_torch.ops import quant_gemm_kernels as qg
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

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
    t0 = time.time()
    with torch.no_grad():
        for cases in (kernel_cases(torch, tk, plain, dev),
                      quant_kernel_cases(torch, qg, nq, qt, QuantKind, dev)):
            for res in cases:
                res["card"] = card
                print("case " + json.dumps(res), flush=True)
                first.setdefault(res["kernel"], res)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"kernel cases {time.time() - t0:.1f} s", flush=True)

    # the launches reported for a kernel are those of the phase that is its
    # main path: bf16 serving for the attention kernels, soft-fp8 serving
    # for the dequant GEMM, W8A8 serving for the int8 GEMM and quantizers
    launches = engine_phase(torch, np, tk, card)
    quant = ["quant.quant_on_load=true"]
    soft = engine_phase(
        torch, np, tk, card, "soft_fp8", ["quant.method=soft_fp8"] + quant,
        need=ATTN_KERNELS + ("quant_gemm",),
    )
    launches["quant_gemm"] = soft["quant_gemm"]
    for label, ovr, need in QUANT_PHASES:
        got = engine_phase(
            torch, np, tk, card, label, ovr + quant + ["models.n_layers=4"],
            lens=(40, 100, 200), new_tokens=8, need=ATTN_KERNELS + need,
            check_plain=True,
        )
        if label == "w8a8":
            for k in need:
                launches[k] = got[k]

    rows = []
    for kname in KERNEL_ORDER:
        r = first[kname]
        if launches.get(kname, 0) <= 0:
            raise AssertionError(f"kernel {kname} has no launches to report")
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
