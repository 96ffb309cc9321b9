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
   keys and far below 1 in size); two launches on equal inputs give equal
   bits. Times: the kernel and
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
   [14336 -> 4096]; T 1, 16 and 512; B10 also at T 64 and 65, each on
   memory filled with 7.0, two launches and a graph replay bit-equal,
   timed warm and cold as B9 is): every weight mode (e4m3 blockwise,
   e4m3 rowwise as layer 1 of a stack, int8 per-channel, int4 packed,
   int4 one nibble a byte at a width that is no multiple of 512, and an
   odd 576-wide output). Limits: each GEMM output row within 1e-2 of the
   plain row's norm; the int8 GEMM's int32 sums equal; B11's scales
   within 1e-6 relative and int8 values equal but for at most 0.1 % that
   differ by 1, B12 bit-equal (`acts_cases`: T 1-512, the
   launch floor beside them). Library yardsticks: `torch.matmul` on weights dequantized
   beforehand, `torch._int_mm` (timed only). Bound: bytes of weights,
   scales, x and y / 3.35 TB/s against 2TKN / 989 TFLOP/s (bf16) or
   / 1979 TOP/s (int8). Since slice 7 B6/B7 and B8 run the TMA + wgmma
   mainloop: the e4m3 cases add T 64 and 65 (the edge of its decode and
   slab regimes) and 128, two shapes go through its cp.async path (a
   4100-byte weight row, an 8002-byte x row, at T 16 and 512), every
   B6/B7 output lands on memory filled with 7.0, and every B6/B7/B8 case
   also holds two launches bit-equal and a replay of a captured CUDA
   graph bit-equal to an eager launch; each case line names the plan
   (regime, rows a tile, K splits, TMA or cp.async for each operand).
   The grouped expert GEMM of the MoE path (B8 `grouped_gemm`) at the
   expert stacks of Mixtral-8x7B (8 experts; `[4096 -> 28672]` gate/up
   merged in e4m3, `[4096 -> 14336]` in bf16, `[14336 -> 4096]` in both)
   and of moe-16x-bench (16 experts; `[2048 -> 2816]` e4m3, `[2048 ->
   1408]` bf16, `[1408 -> 2048]` both), top-2 routing from a numpy seed
   through the port's own `sorted_dispatch`, at the geometry of a 16-token
   decode step (bm 16; 10 or 18 blocks, some dead), of a 512-token slab
   (bm 256 or 128), of one request (T 1, where K is split) and, at
   Mixtral-8x7B, T 64, 65 (bm 32) and 128 (bm 64); layer 1 of
   a two-layer stack, rowwise scales, an unstacked weight, the other row
   tiles (bm 32, 64) and a skewed routing where every token picks the
   same two experts. Limits: every row of a live block within 1e-2 of the
   plain row's norm, dead blocks exactly zero on memory that held other
   values, two launches bit-equal. Library yardstick: one `torch.matmul`
   per live expert over its rows on bf16 weights dequantized beforehand
   (timed only). Bound: bytes of the live experts' weights and scales, xs
   and out / 3.35 TB/s against 2 x assigned rows x K x N / 989 TFLOP/s.
3. Engine: `Engine` at the full width and depth of Llama-3-8B-Instruct
   with random weights on the GPU serves one lone prompt, then a burst of
   six mixed-length prompts (one longer than the 512-token slab) in two
   waves, the second arriving while the first decodes (a hybrid step); 32
   new tokens each. Checks that every
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
   Then the plain route: the same short burst at 4 layers in soft-fp8 with
   `infer.attn_type=ref infer.op_impl=xla`, in which no attention kernel
   and no kernel that op_impl governs (B6/B7, B10-B13, B9) may launch; its
   64-token prefill logits are held against the same model switched back
   to the kernels: every row within 2e-2 of the plain row's norm.
   Then MoE serving, the same lone prompt and burst of six at full width:
   Mixtral-8x7B-Instruct-v0.1 in bf16 at 8 layers (a layer of its experts
   is 2.82 GB in bf16, so the 32 layers do not fit 80 GB) and in soft-fp8
   at 20 layers (the engine draws the bf16 tree, 2.82 GB a layer, before
   it quantizes leaf by leaf; the printed peak of bring-up says how close
   to the card's 80 GB that comes); moe-16x-bench in bf16 and in soft-fp8
   at its full 24 layers; and Mixtral-8x7B in fp8 with e4m3 activations
   at 4 layers, where the 64-token prefill runs with every grouped-GEMM
   call shadowed by its plain version too (logits reported, not held:
   besides the step-function activations, a router that picks another
   second expert for one token changes that token's whole row). Each MoE
   phase requires the grouped GEMM and the three attention kernels to
   have launched, and the dequant GEMM under a quant method. The earlier
   phases run at the depth they had.
   The MLA kernels of DeepSeek serving: B9 `absorb_matmul` at
   DeepSeek-R1's `wkv_b` [8, 512, 128*256] (layer 1) and
   deepseek-mid-bench's (32 heads, 26 layers), uk (reading q_nope as a
   view of the query rows) and uv at T 16, 1 and 128, two launches
   bit-equal and a graph replay bit-equal to an eager launch; the
   merged latent row (128 heads on one KV head of 576 live lanes, 512 value
   lanes, 640-lane rows) through B4 `attend_decode` and B1 (16 rows of
   context up to 2047, the new token appended by the plain append before
   B4), B3 `attend_prefill_packed` (a 512-token slab of three prompts) and
   B5 (a 512-token chunk at q_pos 512), then the decode where its split
   over the context matters (one row of a 16,384-token context; 16 rows of
   4,096-8,191, 113-151 MB of rows; four rows whose contexts end one key
   past a split boundary, on it and one short of it) and
   deepseek-mid-bench's 32 heads (decode, B5, B3), every latent output
   also two launches and a graph replay bit-equal, the decode timed warm
   and cold as B9 is; B4 and B3 again at Llama-3-8B's
   split geometry; B8 at DeepSeek-R1's expert stacks (256 experts, top-8:
   `[7168 -> 4096]` merged e4m3, `[2048 -> 7168]` e4m3 and bf16; T 16, 512
   and 1). Same limits as above; each checked output lands on memory
   filled with 7.0 just before (a tile left unwritten cannot pass). Library
   yardsticks, timed only: SDPA on
   the gathered latent rows (K = V = the 576 lanes), one `torch.einsum` on
   the layer's half of `wkv_b`. Bounds: bytes of the leaf half, x and out
   for B9; for the latent row the 576 live lanes of each context row read
   once against 2 x H x (576 + 512) FLOPs a (query, key) pair. B9 and B13
   are timed twice: warm (`ms`, `library_ms`: the graph's calls reread one
   layer, which a 50 MB L2 keeps) and cold (`ms_cold`, `library_ms_cold`:
   the calls cycle over the stack's layers, sized so the others read more
   than twice the L2 between two calls on one, as a decode step finds a
   layer's weight); their cases also carry the host time of one eager
   call of the wrapper and of the library call (`host_us`,
   `library_host_us`). Any byte-bound case of phase 2 whose `ms` or
   `library_ms` reads below its byte bound (data read from L2) carries
   `"l2_resident": true`.
   Then DeepSeek serving, the same lone prompt and burst of six at full
   width: DeepSeek-R1 in bf16 and in soft-fp8 at 5 of 61 layers (3 dense,
   2 MoE: a layer of its experts is 22.5 GB in bf16 and the engine draws
   the bf16 tree before it quantizes, so 5 layers, 53 GB, is what 80 GB
   holds; the printed bring-up peak and resident memory say how close);
   deepseek-mid-bench at its full 16 layers in bf16 and soft-fp8; and
   DeepSeek-R1 in fp8 with e4m3 activations at 4 layers, the 64-token
   prefill shadowed call by call (B9 too; logits reported, not held). Each
   DeepSeek phase requires B1, B3, B4, B5, B9 and B8 to have launched, and
   the dequant GEMM under a quant method.
   Slice 5's variants, each against its plain version at the same limits:
   the e4m3 KV pool (int8 lanes of e4m3 bits) under B1, B2 and B5 at
   Llama-3-8B's shapes and under the latent B1, B3, B4 and B5 at
   DeepSeek-R1's, the appends fed e4m3 edge values (ties, subnormals,
   +-448, +-464) and, in a second launch, values beyond the range (the
   pool bytes must equal the plain append's, NaN codes included), and B4
   over one-token contexts holding every finite code, which must decode
   exactly; the split layout at head size 192 with 128 heads on 128
   (DeepSeek-R1's dense MLA, V in 128 of the 192 lanes) under B1, B4, B5
   and B3 (a 256-token slab), at 64 (tiny-llama-debug: 32 heads on 4)
   under B1 and B5, and at 32 (micro-llama-debug: 4 heads on 2) under
   B1, B2 and B5 at phase 2's Llama shapes (16 decode rows, the 512-token
   slab of three prompts, the 512-token chunk); B13 `dense_matmul_stacked`
   at Llama-3-8B's four stacked shapes, T 16, 512, 1, 64 and 65, each on
   output memory filled with 7.0, two launches and a graph replay
   bit-equal (yardstick: one `torch.mm` on the layer's view with an f32
   output; warm and cold as B9). Library yardsticks for attention: SDPA on
   the gathered, decoded K/V (the split B3 too). Bounds count a pool
   element as one byte in e4m3.
   Then slice 5's serving, each the same lone prompt and two-wave burst
   at full width, then a short shadowed burst in which every attention
   and B13 call also runs its plain version on equal inputs (the appending
   kernels' on a copy of the layer's pool slice, which must come out
   byte-equal): Llama-3-8B with `infer.kv_dtype=fp8` at 32 layers,
   DeepSeek-R1 with `infer.kv_dtype=fp8` at 5 layers, DeepSeek-R1 with
   `infer.mla_absorb=none` at 4 layers (3 dense, 1 MoE: its pool holds 96
   KiB a token a layer), Llama-3-8B with the dense kernel switched on
   (`linear.set_dense_kernel`) at 4 layers, and the debug cards
   tiny-llama-debug (head size 64) and micro-llama-debug (32) at their
   own widths. Each requires its variants' launches.
   Then slice 11's checkpoints, each written from draws seeded by the
   tensor's name with the port's own safetensors writer into a temporary
   directory (synced and dropped from the page cache, so the load reads
   the disk), served from there through `infer.do_load=true
   models.ckpt_dir=<dir>` with the burst above, and deleted after:
   Llama-3-8B-Instruct in HF naming, bf16, 8 layers in two files with a
   `model.safetensors.index.json` (5.6 GB); the same at 4 layers as AWQ
   and as GPTQ packed int4, group 128 (GPTQ with a shuffled `g_idx` that
   q/k/v share and another that gate/up share), `quant.method=w4a16`
   without `quant_on_load` (B6/B7 in its packed int4 mode must launch);
   DeepSeek-R1 at 4 layers (3 dense, 1 MoE) laid out as its published
   checkpoint (every projection and expert e4m3 with an f32
   `weight_scale_inv`, the rest bf16, `e_score_correction_bias` f32; 17
   GB; deepseek-mid-bench if the disk lacks room), where B6/B7 in e4m3
   blockwise mode and B8 on the merged e4m3 experts must launch and B9
   does not (a loaded fp8 `wkv_b` takes the dequant + einsum); and the
   AWQ engine's tree dumped with `save_preprocessed` and served again
   with `skip_preprocess=true`. Each checks that every loaded leaf equals
   the written one byte for byte (drawn again from its seed: QTensor
   data, scales, zeros and `in_perm`; the engine's merged MoE leaves part
   by part) and that the greedy tokens of three prompts equal those of an
   engine handed the same tree in memory (`Engine(cfg, params=...)`), and
   prints a `load` line: seconds to load, GB/s read, peak and resident
   device GiB, the host's peak resident set during bring-up. On the HF
   Llama engine, `evals.perplexity_from_tokens` over 1,024 tokens
   (windows of 512, stride 256) through the kernels and then through
   `infer.attn_type=ref infer.op_impl=xla` (no kernel of either may
   launch there): the two perplexities within 1e-3 relative (an `evals`
   line).
4. One `kernels` JSON line (B1-B13: the first case of each kernel, B3, B4
   and B9 with the launches of the DeepSeek-R1 bf16 burst, then one row
   for each variant with the launches of the phase that is its main path:
   latent B1/B5 from R1 bf16, e4m3 from the fp8-KV phases, d192 from R1
   dense, d64 from tiny-llama-debug, d32 from micro-llama-debug, B13 from
   the dense-kernel phase),
   then the card's name and power limit, then the device JSON as the last
   line.

It imports nothing of JAX or of `chitu_tpu`, exits non-zero without a
CUDA device, and fails when run outside a checkout of the repository.
"""

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib

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


def host_us(torch, fn, calls=200, reps=5):
    """Host time of one eager fn() call, in microseconds: `calls` calls
    enqueued back to back (fewer than the launch queue holds, so the host
    does not wait on the card), the card drained before each of `reps`
    runs; the median run."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2] / calls * 1e6


def cold_layers(torch, dev, nbytes: int, least: int) -> int:
    """Layers of a stack to cycle over so that between two calls on one
    layer the others read more than twice the card's L2 (`nbytes`: what
    one call reads of its layer)."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return max(least, 2 * l2 // nbytes + 2)


def device_ms_cold(torch, fns, reps=REPS):
    """Device time of one call with its weight cold in L2, as a decode step
    finds a layer's weight after the other layers' weights have passed:
    fns[i] calls on layer i of a stack sized by `cold_layers`; one CUDA
    graph holds whole cycles over the layers (at least GRAPH_CALLS calls,
    so a replay's first call follows the last layer's), no flush kernel
    inside; median of `reps` replays over the calls."""
    n = len(fns)

    def cycle():
        for f in fns:
            f()

    return device_ms(torch, cycle, calls=-(-GRAPH_CALLS // n), reps=reps) / n


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


def poison(torch, shape, dev):
    """Fill a bf16 block of an output's size with 7.0 and free it: the
    caching allocator hands it to the next launch's output, so a kernel
    that leaves part of its output unwritten shows stale 7.0s, not the
    previous launch's right answer."""
    junk = torch.full(shape, 7.0, dtype=torch.bfloat16, device=dev)
    del junk


# e4m3 encodings the appends must get right, all within e4m3's range:
# +-448, +-464 (a tie down to 448), the smallest subnormal and its half (a
# tie to zero), a subnormal tie, mantissa ties either way, signed zeros and
# underflows
E4M3_EDGES = [448.0, -448.0, 464.0, -464.0, 2.0 ** -9, -(2.0 ** -9),
              2.0 ** -10, -(2.0 ** -10), 3 * 2.0 ** -10, 1.0625, 1.1875,
              -0.0, 0.0, 1e-8, -1e-8, 0.01171875]
# beyond the range: NaN codes (sign | 0x7F), never a saturated 448
E4M3_OVERFLOW = [466.0, -466.0, 1000.0, -600.0, float("inf"),
                 float("-inf"), float("nan")]


def with_values(torch, x, vals):
    """x with its first len(vals) elements replaced by vals."""
    x = x.clone()
    x.view(-1)[: len(vals)] = torch.tensor(vals, dtype=x.dtype, device=x.device)
    return x


def overflow_append_check(torch, tk, name, pool0, kernel_fn, plain_fn, k, v):
    """An appending kernel fed values beyond e4m3's range (and the edge
    values) writes the plain append's bytes: NaN codes with the value's
    sign. Only the pools are compared (the rows holding NaN are not
    attended)."""
    kk = with_values(torch, k, E4M3_OVERFLOW + E4M3_EDGES)
    vv = None if v is None else with_values(torch, v, E4M3_EDGES + E4M3_OVERFLOW)
    pool_k, pool_p = pool0.clone(), pool0.clone()
    kernel_fn(pool_k, kk, vv)
    plain_fn(pool_p, kk, vv)
    torch.cuda.synchronize()
    if not torch.equal(pool_k, pool_p):
        n = int((pool_k != pool_p).sum().item())
        raise AssertionError(f"{name}: {n} pool bytes differ from the plain "
                             "append on out-of-range values")
    if not ((pool_k == 127).any() and (pool_k == -1).any()):
        raise AssertionError(f"{name}: no NaN codes written")
    del pool_k, pool_p


def e4m3_decode_exact(torch, tk, dev, latent=False):
    """B4 over an e4m3 pool where each row's context is one token whose
    value lanes cycle through the 254 finite e4m3 codes (subnormals and
    both signs): a softmax over one key is exactly 1, so the output must
    be the decoded values exactly (e4m3 is exact in bf16). -> the number
    of output values that differ from `kv_decode` of the codes."""
    from chitu_tpu_torch.models.common import kv_decode

    g = torch.Generator(device=dev)
    g.manual_seed(9)
    B, PAGE = 8, 64
    codes = torch.arange(-128, 128, device=dev)
    codes = codes[(codes != 127) & (codes != -1)].to(torch.int8)
    if latent:
        H, KV, D, M, n = 128, 1, tk.LATENT_QK, 640, tk.LATENT_DV
        lanes = slice(0, n)
        kw = dict(kv_heads=1, head_dim=D, split_kv=False, v_dim=n, scale=0.1)
    else:
        H, KV, D = 32, 8, 128
        M, n = 2 * KV * D, KV * D
        lanes = slice(n, 2 * n)
        kw = dict(kv_heads=KV, head_dim=D)
    vals = codes.repeat(B * n // codes.numel() + 1)[: B * n].view(B, n)
    vals = torch.roll(vals, shifts=37, dims=1)
    pool = torch.zeros((1, B, PAGE, M), dtype=torch.int8, device=dev)
    pool[0, :, 0, lanes] = vals
    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    out = tk.attend_decode(
        q, pool, 0, torch.arange(B, dtype=torch.int32, device=dev)[:, None],
        torch.zeros(B, dtype=torch.int32, device=dev), PAGE, **kw)
    want = kv_decode(vals).float()  # [B, n]
    if latent:
        want = want[:, None, :].expand(B, H, n)
    else:
        want = want.view(B, KV, 1, D).expand(B, KV, H // KV, D).reshape(B, H, D)
    return int((out.float() != want).sum().item())


def compare_rows(torch, name, out_k, out_p, rows, pool_kernel=None,
                 pool_plain=None):
    """-> (max abs err, max per-row relative err) over the live rows;
    raises unless every (token, head) row is within ROW_RTOL and the pools
    (where given) are equal."""
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


def bit_equal(torch, name, out, again):
    """Two launches on equal inputs give equal bits (the split decode
    merges its partials in a fixed order)."""
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two launches on equal inputs differ")


def replay_equal(torch, name, fn, eager):
    """One fn() call captured in a CUDA graph and replayed must give the
    bits of the eager call `eager` (the split-K tickets go back to zero in
    the launch that used them, so a replay finds them as capture did)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, eager):
        raise AssertionError(f"{name}: graph replay differs from an eager launch")
    del graph


def plan_fields(plan):
    """The GEMM mainloop's plan of a case, for its result line."""
    return dict(regime=plan.regime, tile_rows=plan.tn, k_splits=plan.splits,
                weight_load="tma" if plan.tma_w else "cp.async",
                x_load="tma" if plan.tma_x else "cp.async")


def kernel_cases(torch, tk, plain, dev, kv="bf16", geom=None):
    """Yields one result dict per case; the first case of each kernel is
    the one reported in the kernels line. kv="e4m3": the same cases on an
    int8 pool of e4m3 bits (no window/softcap variants), the new rows fed
    e4m3 edge values and, in a second launch, values beyond e4m3's range
    (the pool bytes must still equal the plain append's). geom = (H, KV,
    D, variant): the bf16 cases at another head geometry (no window /
    softcap variants), reported as that variant (micro-llama-debug: 4
    heads on 2 of size 32)."""
    import torch.nn.functional as F

    from chitu_tpu_torch.models.common import kv_encode

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    H, KV, D, PAGE, L, LAYER = 32, 8, 128, 64, 2, 1
    fp8 = kv == "e4m3"
    tag = "[e4m3]" if fp8 else ""
    esz = 1 if fp8 else 2  # bytes of a pool element
    variants = ((0, 0.0),) if fp8 else ((0, 0.0), (512, 30.0))
    if geom is not None:
        H, KV, D, kv = geom
        tag, variants = f"[{kv}]", ((0, 0.0),)
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
    if fp8:
        pool0 = kv_encode(pool0, torch.int8)
        bad = e4m3_decode_exact(torch, tk, dev)
        if bad:
            raise AssertionError(f"attend_decode[e4m3]: {bad} decoded values "
                                 "differ from the e4m3 codes' values")

    def edges(x):
        return with_values(torch, x, E4M3_EDGES) if fp8 else x

    def gathered_kv(bts):
        """[R, mp*page] rows of the kernel's layer -> K, V [R, KV, S, D]."""
        rows = plain._gather(pool_k, LAYER, bts)
        k, v = plain.unpack_pool(rows, KV, D)
        return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

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
    k = edges(randn(B, KV, D))
    v = edges(randn(B, KV, D))
    live = valid.clone()
    if fp8:
        overflow_append_check(
            torch, tk, "attend_decode_fused[e4m3]", pool0,
            lambda pk, kk, vv: tk.attend_decode_fused(
                q, pk, LAYER, kk, vv, bts, seq, valid, PAGE, KV, D),
            lambda pp, kk, vv: tk.attend_decode_fused_plain(
                q, pp, LAYER, kk, vv, bts, seq, valid, PAGE, KV, D),
            k, v)
    for window, softcap in variants:
        name = "attend_decode_fused" + (
            tag if not window else "[window,softcap]")
        kw = dict(scale=scale, window=window, softcap=softcap)
        pool_k = pool0.clone()
        pool_p = pool0.clone()
        args = (LAYER, k, v, bts, seq, valid, PAGE, KV, D)
        poison(torch, q.shape, dev)
        out_k = tk.attend_decode_fused(q, pool_k, *args, **kw)
        out_p = tk.attend_decode_fused_plain(q, pool_p, *args, **kw)
        err, rel = compare_rows(torch, name, out_k, out_p, live, pool_k, pool_p)
        bit_equal(torch, name, out_k,
                  tk.attend_decode_fused(q, pool0.clone(), *args, **kw))
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
        nbytes = (ctx * 2 * KV * D * esz + 2 * q.numel() * 2
                  + 2 * k.numel() * 2 + n_live * M * esz)
        flops = 4 * H * D * (ctx + B)
        bnd, by = bound_ms(nbytes, flops)
        yield dict(name=name, kernel="attend_decode_fused", variant=kv,
                   route="cuda",
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
    k = edges(randn(T, KV, D))
    v = edges(randn(T, KV, D))
    pargs = (LAYER, bts_p, block_seg, block_q, total, PAGE, KV, D)
    if fp8:
        overflow_append_check(
            torch, tk, "attend_prefill_packed_fused[e4m3]", pool0,
            lambda pk, kk, vv: tk.attend_prefill_packed_fused(
                q, pk, pargs[0], kk, vv, *pargs[1:]),
            lambda pp, kk, vv: tk.attend_prefill_packed_fused_plain(
                q, pp, pargs[0], kk, vv, *pargs[1:]),
            k, v)
    for window, softcap in (variants[:1] if fp8 or geom else ((0, 0.0), (128, 30.0))):
        name = "attend_prefill_packed_fused" + (
            tag if not window else "[window,softcap]"
        )
        kw = dict(scale=scale, window=window, softcap=softcap)
        pool_k = pool0.clone()
        pool_p = pool0.clone()
        args = (LAYER, k, v, bts_p, block_seg, block_q, total, PAGE, KV, D)
        poison(torch, q.shape, dev)
        out_k = tk.attend_prefill_packed_fused(q, pool_k, *args, **kw)
        out_p = tk.attend_prefill_packed_fused_plain(q, pool_p, *args, **kw)
        err, rel = compare_rows(torch, name, out_k, out_p, tok_live, pool_k, pool_p)
        bit_equal(torch, name, out_k,
                  tk.attend_prefill_packed_fused(q, pool0.clone(), *args, **kw))
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
        nbytes = (ctx * 2 * KV * D * esz + 2 * q.numel() * 2
                  + n_new * M * esz + n_new * 2 * KV * D * 2)
        bnd, by = bound_ms(nbytes, 4 * H * D * pairs)
        yield dict(name=name, kernel="attend_prefill_packed_fused",
                   variant=kv, route="cuda",
                   source="chitu_tpu_torch/csrc/attention.cu",
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
    for window, softcap in (variants[:1] if fp8 or geom else ((0, 0.0), (256, 30.0))):
        name = "attend_prefill" + (tag if not window else "[window,softcap]")
        kw = dict(scale=scale, window=window, softcap=softcap)
        args = (pool0, LAYER, bt, q_pos, totl, PAGE, KV, D)
        poison(torch, q.shape, dev)
        out_k = tk.attend_prefill(q, *args, **kw)
        out_p = plain.attend_prefill(q, *args, **kw)
        rows = torch.ones(T, dtype=torch.bool, device=dev)
        err, rel = compare_rows(torch, name, out_k, out_p, rows, None, None)
        bit_equal(torch, name, out_k, tk.attend_prefill(q, *args, **kw))
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
        nbytes = totl * 2 * KV * D * esz + 2 * q.numel() * 2
        bnd, by = bound_ms(nbytes, 4 * H * D * pairs)
        yield dict(name=name, kernel="attend_prefill", variant=kv,
                   route="cuda",
                   source="chitu_tpu_torch/csrc/attention.cu",
                   replaces="chitu_tpu/ops/pallas_attention.py:1137",
                   max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                   bound_by=by, library_ms=lib_ms,
                   shape=f"T={T} q_pos0={start} total={totl} H={H} KV={KV} D={D}")


# ---------------------------------------------------------------------------
# phase 2d: DeepSeek's MLA kernels: B9, the latent row of B1, B3, B4 and B5,
# and B3 / B4 on Llama-3-8B's split geometry
# ---------------------------------------------------------------------------

ATTN_SRC = "chitu_tpu_torch/csrc/attention.cu"
ABSORB_SRC = "chitu_tpu_torch/csrc/absorb.cu"
# DeepSeek-R1's softmax scale: 1/sqrt(192) times the YaRN mscale squared
# (factor 40, mscale_all_dim 1), as the model computes it
R1_SCALE = 192 ** -0.5 * (0.1 * 1.0 * math.log(40.0) + 1.0) ** 2


def absorb_cases(torch, ab, dev):
    """B9 at DeepSeek-R1's wkv_b [L, 512, 128*256] (layer 1) and
    deepseek-mid-bench's (32 heads): uk and uv at T 16, 1 and 128, each on
    output memory filled with 7.0, two launches bit-equal and a CUDA-graph
    replay bit-equal to an eager launch. Times warm (`ms`, `library_ms`:
    the graph's calls reread one layer, which stays in L2) and cold
    (`ms_cold`, `library_ms_cold`: the calls cycle over the stack's L
    layers, L sized so the others read more than twice the L2 in between).
    The first case (R1, uk, T 16) is the one reported in the kernels
    line."""
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    bf = torch.bfloat16
    C, dn, dv, dr = 512, 128, 128, 64

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    for label, H in (("R1", 128), ("mid", 32)):
        half_bytes = C * H * dn * 2  # what one call reads of its layer
        L = cold_layers(torch, dev, half_bytes, 8)
        w = torch.empty((L, C, H * (dn + dv)), dtype=bf, device=dev)
        for l in range(L):
            w[l] = randn(C, H * (dn + dv), s=0.02)
        wl = w[1].view(C, H, dn + dv)
        for T in (16, 1, 128):
            for kind in ("uk", "uv"):
                # uk reads q_nope as the model passes it: a view of the
                # [T, H, dn + rope] query rows
                x = randn(T, H, dn + dr)[..., :dn] if kind == "uk" else randn(T, H, C)
                name = f"absorb_matmul[{label},{kind},T={T}]"
                run = lambda: ab.absorb_matmul(x, w, 1, kind, dn, dv)
                poison(torch, (T, H, C if kind == "uk" else dv), dev)
                got = run()
                want = ab.absorb_matmul_plain(x, w, 1, kind, dn, dv)
                err, rel = compare_rows(torch, name, got, want, slice(None))
                bit_equal(torch, name, got, run())
                replay_equal(torch, name, run, got)
                eq = "thd,chd->thc" if kind == "uk" else "thc,chd->thd"
                halves = [w[l].view(C, H, dn + dv)[..., :dn] if kind == "uk"
                          else w[l].view(C, H, dn + dv)[..., dn:] for l in range(L)]
                half = halves[1]
                nbytes = half.numel() * 2 + x.numel() * 2 + got.numel() * 2
                bnd, by = bound_ms(nbytes, 2.0 * T * H * C * (dn if kind == "uk" else dv))
                res = dict(
                    name=name, kernel="absorb_matmul", route="cuda",
                    source=ABSORB_SRC,
                    replaces="chitu_tpu/ops/pallas_absorb.py:103",
                    max_abs_err=err, max_row_rel_err=rel,
                    ms=device_ms(torch, run),
                    ms_cold=device_ms_cold(torch, [
                        (lambda l=l: ab.absorb_matmul(x, w, l, kind, dn, dv))
                        for l in range(L)]),
                    plain_ms=call_ms(torch, lambda: ab.absorb_matmul_plain(
                        x, w, 1, kind, dn, dv)),
                    bound_ms=bnd, bound_by=by,
                    library_ms=device_ms(torch, lambda: torch.einsum(eq, x, half)),
                    host_us=host_us(torch, run),
                    library_host_us=host_us(torch, lambda: torch.einsum(eq, x, half)),
                    library_ms_cold=device_ms_cold(torch, [
                        (lambda hl=hl: torch.einsum(eq, x, hl)) for hl in halves]),
                    shape=f"T={T} H={H} C={C} dn={dn} dv={dv} kind={kind} "
                          f"leaf_half_bytes={half.numel() * 2} layers={L}")
                if hasattr(ab, "gemm_plan"):
                    p = ab.gemm_plan(x, w, kind, dn, dv)
                    res.update(regime=p.regime, tile_rows=p.tn, blocks=p.blocks,
                               items_per_block=p.per_block)
                yield res
        del w, wl
    torch.cuda.empty_cache()


def mla_attention_cases(torch, tk, plain, dev, kv="bf16", split=True):
    """The latent row (DeepSeek-R1: 128 heads on one KV head of 576 live
    lanes, 512 value lanes, pages of 64, rows of 640) through B4, B1, B3
    and B5, then the latent decode at long contexts and at a split's edge
    and deepseek-mid-bench's 32 heads, then (`split`) B4 and B3 at
    Llama-3-8B's split geometry. The first case of B3 and of B4 (latent)
    is the one reported in the kernels line: their main path is DeepSeek
    serving. Every latent output lands on memory filled with 7.0, and two
    launches and a CUDA-graph replay must give equal bits. The decode
    cases are timed warm (`ms`: the graph rereads one layer's rows) and
    cold (`ms_cold`: the calls cycle over the layers of a pool sized by
    `cold_layers`); SDPA on the gathered rows (25 ms a call at R1's decode)
    is timed warm only. kv="e4m3": the latent cases on an int8 pool of
    e4m3 bits (B1's new rows fed e4m3 edge values, and values beyond the
    range in a second launch), without the split ones."""
    import torch.nn.functional as F

    from chitu_tpu_torch.models.common import kv_decode, kv_encode

    g = torch.Generator(device=dev)
    g.manual_seed(4)
    bf = torch.bfloat16
    H, QK, DV, M, PAGE, L, LAYER = 128, 576, 512, 640, 64, 2, 1
    B, MP = 16, 33
    P = B * MP
    kw = dict(kv_heads=1, head_dim=QK, split_kv=False, v_dim=DV, scale=R1_SCALE)
    fp8 = kv == "e4m3"
    variant = "latent,e4m3" if fp8 else "latent"
    esz = 1 if fp8 else 2

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    def latent_pool(layers, pages):
        pool = randn(layers, pages, PAGE, M, s=0.5)
        pool[..., QK:] = 0  # the pad lanes of a latent row
        return kv_encode(pool, torch.int8) if fp8 else pool

    pool0 = latent_pool(L, P)
    if fp8:
        bad = e4m3_decode_exact(torch, tk, dev, latent=True)
        if bad:
            raise AssertionError(f"attend_decode[latent,e4m3]: {bad} decoded "
                                 "values differ from the e4m3 codes' values")

    def gathered(pool, bts, layer=LAYER):
        """[R, mp*page] latent rows -> K = V [R, 1, S, 576] (bf16)."""
        rows = kv_decode(plain._gather(pool, layer, bts))
        return rows[..., :QK][:, None].contiguous()

    def case(name, kernel, err, rel, ms, plain_ms, lib_ms, nbytes, flops, shape,
             src=ATTN_SRC, replaces="", variant=variant, **extra):
        bnd, by = bound_ms(nbytes, flops)
        return dict(name=name, kernel=kernel, variant=variant, route="cuda",
                    source=src, replaces=replaces, max_abs_err=err,
                    max_row_rel_err=rel, ms=ms, plain_ms=plain_ms,
                    bound_ms=bnd, bound_by=by, library_ms=lib_ms, shape=shape,
                    **extra)

    def held(name, run, want, rows, shape, pools=None):
        """The checked launch on memory that held 7.0s, within the limit of
        the plain output `want` (and the pools equal), then two launches
        and a graph replay bit-equal -> (max abs err, row rel err)."""
        poison(torch, shape, dev)
        got = run()
        err, rel = compare_rows(torch, name, got, want, rows,
                                *(pools or (None, None)))
        bit_equal(torch, name, got, run())
        replay_equal(torch, name, run, got)
        return err, rel

    def with_layers(pool, layers):
        """`pool` followed by fresh layers up to `layers` (the cold stack;
        the checked layer keeps its rows)."""
        if layers <= pool.shape[0]:
            return pool
        return torch.cat([pool, latent_pool(layers - pool.shape[0], pool.shape[1])])

    def decode_cases(label, Hq, q, knew, seq, bts, pool_in, valid_f, lib=True,
                     cold=True):
        """B4 over the pool the plain append wrote, then B1 (fused), for
        rows of context seq[b] + 1 -> two result dicts (`cold`: with
        `ms_cold`)."""
        Bn, mp = bts.shape
        valid = torch.ones(Bn, dtype=torch.bool, device=dev)
        ctx = int((seq + 1).sum().item())  # latent rows read, new token's included
        nbytes = ctx * QK * esz + q.numel() * 2 + Bn * Hq * DV * 2
        flops = 2.0 * Hq * (QK + DV) * ctx
        layers = cold_layers(torch, dev, ctx * QK * esz, 2) if cold else 2
        lt = f"[{variant},{label}]"
        shape = (f"B={Bn} H={Hq} live={QK} value={DV} page={PAGE} mp={mp} "
                 f"ctx_rows={ctx} layers={layers}")
        if hasattr(tk, "latent_split"):
            S, chunk = tk.latent_split(Bn, Hq, mp, PAGE, tk._sm_count(dev))
            shape += f" splits={S} chunk={chunk}"
        pool_a = pool_in.clone()
        plain.append_decode(pool_a, LAYER, knew, None, bts, seq, valid, PAGE)
        args = (pool_a, LAYER, bts, seq, PAGE)
        run = lambda: tk.attend_decode(q, *args, **kw)
        want = tk._vlanes(plain.attend_decode(
            q, *args, 1, QK, scale=R1_SCALE, split_kv=False), DV)
        err, rel = held("attend_decode" + lt, run, want, valid, (Bn, Hq, DV))
        lib_ms = None
        if lib:
            kg = gathered(pool_a, bts)
            cols = torch.arange(mp * PAGE, device=dev)[None, :]
            mask = (cols <= seq[:, None].long())[:, None, None, :]
            lib_ms = device_ms_sized(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kg, kg, attn_mask=mask, scale=R1_SCALE,
                enable_gqa=True))
            del kg, mask
        stack = with_layers(pool_a, layers)
        yield case(
            "attend_decode" + lt, "attend_decode", err, rel,
            device_ms(torch, run),
            call_ms(torch, lambda: plain.attend_decode(
                q, *args, 1, QK, scale=R1_SCALE, split_kv=False), reps=5),
            lib_ms, nbytes, flops, shape,
            replaces="chitu_tpu/ops/pallas_attention.py:327",
            ms_cold=device_ms_cold(torch, [
                (lambda l=l: tk.attend_decode(q, stack, l, bts, seq, PAGE, **kw))
                for l in range(layers)]) if cold else None)
        del stack, pool_a
        if fp8:
            overflow_append_check(
                torch, tk, "attend_decode_fused" + lt, pool_in,
                lambda pk, kk, vv: tk.attend_decode_fused(
                    q, pk, LAYER, kk, None, bts, seq, valid_f, PAGE, **kw),
                lambda pp, kk, vv: tk.attend_decode_fused_plain(
                    q, pp, LAYER, kk, None, bts, seq, valid_f, PAGE, **kw),
                knew, None)
        pool_k, pool_p = pool_in.clone(), pool_in.clone()
        fargs = (LAYER, knew, None, bts, seq, valid_f, PAGE)
        want = tk.attend_decode_fused_plain(q, pool_p, *fargs, **kw)
        run = lambda: tk.attend_decode_fused(q, pool_k, *fargs, **kw)
        err, rel = held("attend_decode_fused" + lt, run, want, valid_f,
                        (Bn, Hq, DV), (pool_k, pool_p))
        stack = with_layers(pool_k, layers)
        yield case(
            "attend_decode_fused" + lt, "attend_decode_fused", err, rel,
            device_ms(torch, run),
            call_ms(torch, lambda: tk.attend_decode_fused_plain(
                q, pool_p, *fargs, **kw), reps=5),
            lib_ms, nbytes + Bn * M * esz, flops, shape,
            replaces="chitu_tpu/ops/pallas_attention.py:727",
            ms_cold=device_ms_cold(torch, [
                (lambda l=l: tk.attend_decode_fused(
                    q, stack, l, knew, None, bts, seq, valid_f, PAGE, **kw))
                for l in range(layers)]) if cold else None)
        del stack, pool_k, pool_p

    # ---- decode rows of mixed context up to 2047 (B4, then B1) ----------
    bts = torch.arange(P, device=dev, dtype=torch.int32).reshape(B, MP)
    seq = torch.randint(1, MP * PAGE - PAGE, (B,), generator=g,
                        device=dev).to(torch.int32)
    seq[0] = 2047
    q = randn(B, H, QK)
    knew = randn(B, 1, QK)
    if fp8:
        knew = with_values(torch, knew, E4M3_EDGES)
    valid_f = torch.ones(B, dtype=torch.bool, device=dev)
    valid_f[3] = False  # a row that appends nothing
    yield from decode_cases("R1", H, q, knew, seq, bts, pool0, valid_f)

    # ---- B3: a 512-token slab of three prompts ---------------------------
    T = 512
    TQ = tk.packed_q_block(H, M, PAGE, M, kv_heads=H, split_kv=False)
    NB = T // TQ
    segs = [(0, 200), (256, 150), (0, 100)]  # (start, new tokens)
    mp_p = 8
    bts_p = torch.full((B, mp_p), -1, dtype=torch.int32, device=dev)
    block_seg = torch.full((NB,), -1, dtype=torch.int32, device=dev)
    block_q = torch.zeros((NB,), dtype=torch.int32, device=dev)
    total = torch.zeros((B,), dtype=torch.int32, device=dev)
    tok_live = torch.zeros((T,), dtype=torch.bool, device=dev)
    off = 0
    for r, (s0, n) in enumerate(segs):
        bts_p[r] = torch.arange(r * mp_p, (r + 1) * mp_p, device=dev)
        nb = (n + TQ - 1) // TQ
        block_seg[off // TQ : off // TQ + nb] = r
        block_q[off // TQ : off // TQ + nb] = s0 + torch.arange(nb, device=dev) * TQ
        total[r] = s0 + n
        tok_live[off : off + n] = True
        off += nb * TQ
    lt = f"[{variant},R1]"
    qp = randn(T, H, QK)
    pargs = (pool0, LAYER, bts_p, block_seg, block_q, total, PAGE)
    run = lambda: tk.attend_prefill_packed(qp, *pargs, **kw)
    err, rel = held("attend_prefill_packed" + lt, run,
                    tk.attend_prefill_packed_plain(qp, *pargs, **kw),
                    tok_live, (T, H, DV))
    dead = ~torch.repeat_interleave(block_seg >= 0, TQ)
    if run()[dead].abs().max().item() != 0.0:
        raise AssertionError("attend_prefill_packed[latent]: dead blocks not zero")
    # library: SDPA over each segment's gathered rows, padded to one batch
    kg = gathered(pool0, bts_p[: len(segs)])
    S = kg.shape[2]
    nmax = max(n for _, n in segs)
    qs = torch.zeros((len(segs), H, nmax, QK), dtype=bf, device=dev)
    mask = torch.zeros((len(segs), 1, nmax, S), dtype=torch.bool, device=dev)
    off, pairs = 0, 0
    for r, (s0, n) in enumerate(segs):
        qs[r, :, :n] = qp[off : off + n].transpose(0, 1)
        qpos = s0 + torch.arange(n, device=dev)[:, None]
        mr = torch.arange(S, device=dev)[None, :] <= qpos
        mask[r, 0, :n] = mr
        mask[r, 0, n:, 0] = True
        pairs += int(mr.sum().item())
        off += (n + TQ - 1) // TQ * TQ
    n_new = sum(n for _, n in segs)
    ctx_rows = sum(s0 + n for s0, n in segs)
    yield case(
        "attend_prefill_packed" + lt, "attend_prefill_packed", err, rel,
        device_ms(torch, run),
        call_ms(torch, lambda: tk.attend_prefill_packed_plain(qp, *pargs, **kw),
                reps=5),
        device_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kg, kg, attn_mask=mask, scale=R1_SCALE, enable_gqa=True)),
        ctx_rows * QK * esz + n_new * H * (QK + DV) * 2,
        2.0 * H * (QK + DV) * pairs,
        f"T={T} Tq={TQ} NB={NB} segs={segs} H={H} live={QK} value={DV}",
        replaces="chitu_tpu/ops/pallas_attention.py:1709")
    del kg, qs, mask

    # ---- B5: a 512-token chunk at q_pos 512 ------------------------------
    def chunk_case(label, Hq, qc):
        start = 512
        totl = start + T
        bt = torch.arange(16, device=dev, dtype=torch.int32) + 100
        q_pos = (start + torch.arange(T, device=dev)).to(torch.int32)
        sargs = (pool0, LAYER, bt, q_pos, totl, PAGE)
        run = lambda: tk.attend_prefill(qc, *sargs, **kw)
        err, rel = held(f"attend_prefill[{variant},{label}]", run,
                        tk._vlanes(plain.attend_prefill(
                            qc, *sargs, 1, QK, scale=R1_SCALE, split_kv=False), DV),
                        slice(None), (T, Hq, DV))
        kg = gathered(pool0, bt[None])
        cols = torch.arange(kg.shape[2], device=dev)[None, :]
        mask = (cols <= q_pos[:, None].long()) & (cols < totl)
        pairs = int(mask.sum().item())
        return case(
            f"attend_prefill[{variant},{label}]", "attend_prefill", err, rel,
            device_ms(torch, run),
            call_ms(torch, lambda: plain.attend_prefill(
                qc, *sargs, 1, QK, scale=R1_SCALE, split_kv=False), reps=5),
            device_ms(torch, lambda: F.scaled_dot_product_attention(
                qc.transpose(0, 1)[None], kg, kg, attn_mask=mask[None, None],
                scale=R1_SCALE, enable_gqa=True)),
            totl * QK * esz + T * Hq * (QK + DV) * 2, 2.0 * Hq * (QK + DV) * pairs,
            f"T={T} q_pos0={start} total={totl} H={Hq} live={QK} value={DV}",
            replaces="chitu_tpu/ops/pallas_attention.py:1137")

    yield chunk_case("R1", H, qp)

    # ---- the latent decode where the split matters -----------------------
    # one row of a 16,384-token context (the split fills the card); 16 rows
    # of 4,096-8,191 (113-151 MB of rows, past twice the L2); four rows
    # whose contexts end one key past a split boundary, on it and one
    # short of it (the new token alone in its split)
    mp1 = 16384 // PAGE + 1
    yield from decode_cases(
        "batch1_16k", H, randn(1, H, QK), randn(1, 1, QK),
        torch.full((1,), 16383, dtype=torch.int32, device=dev),
        torch.arange(mp1, device=dev, dtype=torch.int32)[None],
        latent_pool(2, mp1), torch.ones(1, dtype=torch.bool, device=dev))
    mpl = 8192 // PAGE + 1
    seq_l = torch.randint(4096, 8192, (B,), generator=g, device=dev).to(torch.int32)
    yield from decode_cases(
        "long16", H, randn(B, H, QK), randn(B, 1, QK), seq_l,
        torch.arange(B * mpl, device=dev, dtype=torch.int32).reshape(B, mpl),
        latent_pool(2, B * mpl), valid_f, lib=False)
    chunk = 64  # a tree without the split: any boundary of 64-key tiles
    if hasattr(tk, "latent_split"):
        chunk = tk.latent_split(4, H, MP, PAGE, tk._sm_count(dev))[1]
    seq_e = torch.tensor([chunk, chunk - 1, 2 * chunk, chunk + 1], dtype=torch.int32,
                         device=dev).clamp(max=MP * PAGE - 1)
    yield from decode_cases(
        "split_edge", H, randn(4, H, QK), randn(4, 1, QK), seq_e, bts[:4].contiguous(),
        pool0, valid_f[:4].contiguous(), lib=False, cold=False)

    # ---- deepseek-mid-bench: 32 heads (half of each decode tile dead) ----
    yield from decode_cases("mid", 32, randn(B, 32, QK), knew, seq, bts, pool0,
                            valid_f, lib=False)
    yield chunk_case("mid", 32, randn(T, 32, QK))
    qm = randn(T, 32, QK)
    pargs = (pool0, LAYER, bts_p, block_seg, block_q, total, PAGE)
    run = lambda: tk.attend_prefill_packed(qm, *pargs, **kw)
    err, rel = held(f"attend_prefill_packed[{variant},mid]", run,
                    tk.attend_prefill_packed_plain(qm, *pargs, **kw),
                    tok_live, (T, 32, DV))
    yield case(
        f"attend_prefill_packed[{variant},mid]", "attend_prefill_packed", err,
        rel, device_ms(torch, run), None, None,
        ctx_rows * QK * esz + n_new * 32 * (QK + DV) * 2,
        2.0 * 32 * (QK + DV) * pairs,
        f"T={T} Tq={TQ} NB={NB} segs={segs} H=32 live={QK} value={DV}",
        replaces="chitu_tpu/ops/pallas_attention.py:1709")
    del pool0
    torch.cuda.empty_cache()
    if fp8 or not split:
        return

    # ---- B4 and B3 at Llama-3-8B's split geometry ------------------------
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    cols = torch.arange(MP * PAGE, device=dev)[None, :]
    ctx = int((seq + 1).sum().item())
    H, KV, D = 32, 8, 128
    M = 2 * KV * D
    scale = D ** -0.5
    pool = randn(L, P, PAGE, M, s=0.5)
    q = randn(B, H, D)
    plain.append_decode(pool, LAYER, randn(B, KV, D), randn(B, KV, D), bts,
                        seq, valid, PAGE)
    dargs = (pool, LAYER, bts, seq, PAGE, KV, D)
    out_k = tk.attend_decode(q, *dargs, scale=scale)
    out_p = plain.attend_decode(q, *dargs, scale=scale)
    err, rel = compare_rows(torch, "attend_decode[split]", out_k, out_p, valid)
    bit_equal(torch, "attend_decode[split]", out_k,
              tk.attend_decode(q, *dargs, scale=scale))
    rows = plain._gather(pool, LAYER, bts)
    kg2, vg2 = (t.transpose(1, 2).contiguous()
                for t in plain.unpack_pool(rows, KV, D))
    mask = (cols <= seq[:, None].long())[:, None, None, :]
    yield case(
        "attend_decode[split,Llama-3-8B]", "attend_decode", err, rel,
        device_ms(torch, lambda: tk.attend_decode(q, *dargs, scale=scale)),
        call_ms(torch, lambda: plain.attend_decode(q, *dargs, scale=scale)),
        device_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kg2, vg2, attn_mask=mask, scale=scale,
            enable_gqa=True)),
        ctx * 2 * KV * D * 2 + 2 * q.numel() * 2, 4.0 * H * D * ctx,
        f"B={B} H={H} KV={KV} D={D} page={PAGE} mp={MP} ctx_rows={ctx}",
        replaces="chitu_tpu/ops/pallas_attention.py:327", variant="split")

    TQ = tk.packed_q_block(H, M, PAGE, D, kv_heads=KV)
    NB = T // TQ
    segs = [(0, 100), (256, 150), (0, 60)]  # B2's slab: 64-token q blocks
    block_seg = torch.full((NB,), -1, dtype=torch.int32, device=dev)
    block_q = torch.zeros((NB,), dtype=torch.int32, device=dev)
    total = torch.zeros((B,), dtype=torch.int32, device=dev)
    tok_live = torch.zeros((T,), dtype=torch.bool, device=dev)
    off = 0
    for r, (s0, n) in enumerate(segs):
        nb = (n + TQ - 1) // TQ
        block_seg[off // TQ : off // TQ + nb] = r
        block_q[off // TQ : off // TQ + nb] = s0 + torch.arange(nb, device=dev) * TQ
        total[r] = s0 + n
        tok_live[off : off + n] = True
        off += nb * TQ
    n_new = sum(n for _, n in segs)
    ctx_rows = sum(s0 + n for s0, n in segs)
    q = randn(T, H, D)
    pargs = (pool, LAYER, bts_p, block_seg, block_q, total, PAGE, KV, D)
    poison(torch, q.shape, dev)
    out_k = tk.attend_prefill_packed(q, *pargs, scale=scale)
    out_p = tk.attend_prefill_packed_plain(q, *pargs, scale=scale)
    err, rel = compare_rows(torch, "attend_prefill_packed[split]", out_k,
                            out_p, tok_live)
    bit_equal(torch, "attend_prefill_packed[split]", out_k,
              tk.attend_prefill_packed(q, *pargs, scale=scale))
    yield case(
        "attend_prefill_packed[split,Llama-3-8B]", "attend_prefill_packed",
        err, rel,
        device_ms(torch, lambda: tk.attend_prefill_packed(q, *pargs, scale=scale)),
        call_ms(torch, lambda: tk.attend_prefill_packed_plain(
            q, *pargs, scale=scale), reps=5),
        sdpa_segments_ms(torch, F, q, pool, LAYER, bts_p, segs, TQ, KV, D,
                         scale, plain),
        ctx_rows * 2 * KV * D * 2 + 2 * n_new * H * D * 2,
        4.0 * H * D * pairs_split(segs),
        f"T={T} Tq={TQ} NB={NB} segs={segs} H={H} KV={KV} D={D}",
        replaces="chitu_tpu/ops/pallas_attention.py:1709", variant="split")
    del pool
    torch.cuda.empty_cache()


def latent_cases(torch, tk, dev):
    """The latent row's cases alone (bf16 pool), for
    scripts/torch_kernel_compare.py: `mla_attention_cases` without the
    split geometry, the plain versions of the tree that `tk` comes from."""
    from chitu_tpu_torch.ops import attention as plain

    yield from mla_attention_cases(torch, tk, plain, dev, split=False)


def latent_e4m3_cases(torch, tk, dev):
    """The same on an e4m3 pool."""
    from chitu_tpu_torch.ops import attention as plain

    yield from mla_attention_cases(torch, tk, plain, dev, kv="e4m3")


def pairs_split(segs):
    """Causal (query, key) pairs of packed segments [(start, new tokens)]."""
    return sum(n * s0 + n * (n + 1) // 2 for s0, n in segs)


def sdpa_segments_ms(torch, F, q, pool, layer, bts, segs, tq, kv_heads, d,
                     scale, plain):
    """Device time of the library yardstick of a packed slab on the split
    layout: one `scaled_dot_product_attention` over each segment's
    gathered, decoded K/V, the segments padded to one batch with causal
    masks by absolute position (packed rows of `tq`-token blocks)."""
    dev = q.device
    R = len(segs)
    rows = plain._gather(pool, layer, bts[:R])
    kg, vg = (t.transpose(1, 2).contiguous()
              for t in plain.unpack_pool(rows, kv_heads, d))
    S, H = kg.shape[2], q.shape[1]
    nmax = max(n for _, n in segs)
    qs = torch.zeros((R, H, nmax, d), dtype=q.dtype, device=dev)
    mask = torch.zeros((R, 1, nmax, S), dtype=torch.bool, device=dev)
    off = 0
    for r, (s0, n) in enumerate(segs):
        qs[r, :, :n] = q[off : off + n].transpose(0, 1)
        qp = s0 + torch.arange(n, device=dev)[:, None]
        cols = torch.arange(S, device=dev)[None, :]
        mask[r, 0, :n] = (cols <= qp) & (cols < s0 + n)
        mask[r, 0, n:, 0] = True
        off += (n + tq - 1) // tq * tq
    return device_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True))


# ---------------------------------------------------------------------------
# phase 2e: the split layout at other head sizes (DeepSeek-R1's dense MLA at
# 192, tiny-llama-debug's 64) and B13, the dense stacked-layer GEMM
# ---------------------------------------------------------------------------


def split_head_cases(torch, tk, plain, dev, label, H, KV, D, kernels,
                     scale=None):
    """B1 (fused), B4, B5 and B3 (those named in `kernels`) on the split
    layout at head size D: 16 decode rows of context up to 2047 (pages of
    64), a 512-token chunk at q_pos 512, and a packed slab of three prompts
    (256 tokens: the plain version gathers K and V a token at a time, 13 GB
    in f32 at 128 heads of 192). At DeepSeek's dense MLA (D 192) V lives in
    the first 128 of 192 lanes and the rest are zero, as the model pads
    it. Limits and yardsticks as in phase 2."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    bf = torch.bfloat16
    PAGE, L, LAYER, B, MP = 64, 2, 1, 16, 33
    P = B * MP
    M = 2 * KV * D
    G = H // KV
    scale = scale or D ** -0.5
    dv = 128 if D == 192 else D  # live value lanes
    variant = f"d{D}"

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    def vpad(v):
        if dv < D:
            v[..., dv:] = 0
        return v

    pool0 = randn(L, P, PAGE, M, s=0.5)
    if dv < D:
        pool0.view(L, P, PAGE, 2, KV, D)[:, :, :, 1, :, dv:] = 0

    def gathered_kv(pool, bts):
        rows = plain._gather(pool, LAYER, bts)
        k, v = plain.unpack_pool(rows, KV, D)
        return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    def case(name, kernel, err, rel, ms, plain_ms, lib_ms, nbytes, flops, shape,
             replaces):
        bnd, by = bound_ms(nbytes, flops)
        return dict(name=f"{name}[{variant},{label}]", kernel=kernel,
                    variant=variant, route="cuda", source=ATTN_SRC,
                    replaces=replaces, max_abs_err=err, max_row_rel_err=rel,
                    ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                    library_ms=lib_ms, shape=shape)

    bts = torch.arange(P, device=dev, dtype=torch.int32).reshape(B, MP)
    seq = torch.randint(1, MP * PAGE - PAGE, (B,), generator=g,
                        device=dev).to(torch.int32)
    seq[0] = 2047
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    valid[3] = False
    q = randn(B, H, D)
    k, v = randn(B, KV, D), vpad(randn(B, KV, D))
    ctx = int((seq + 1).sum().item())
    cols = torch.arange(MP * PAGE, device=dev)[None, :]
    mask = (cols <= seq[:, None].long())[:, None, None, :]
    kv_bytes = 2 * KV * D * 2  # a context row's K and V
    shape = f"B={B} H={H} KV={KV} D={D} page={PAGE} mp={MP} ctx_rows={ctx}"
    if "attend_decode_fused" in kernels:
        pool_k, pool_p = pool0.clone(), pool0.clone()
        fargs = (LAYER, k, v, bts, seq, valid, PAGE, KV, D)
        poison(torch, q.shape, dev)
        out_k = tk.attend_decode_fused(q, pool_k, *fargs, scale=scale)
        out_p = tk.attend_decode_fused_plain(q, pool_p, *fargs, scale=scale)
        err, rel = compare_rows(torch, "attend_decode_fused", out_k, out_p,
                                valid, pool_k, pool_p)
        bit_equal(torch, "attend_decode_fused", out_k, tk.attend_decode_fused(
            q, pool0.clone(), *fargs, scale=scale))
        kg, vg = gathered_kv(pool_k, bts)
        yield case(
            "attend_decode_fused", "attend_decode_fused", err, rel,
            device_ms(torch, lambda: tk.attend_decode_fused(
                q, pool_k, *fargs, scale=scale)),
            call_ms(torch, lambda: tk.attend_decode_fused_plain(
                q, pool_p, *fargs, scale=scale), reps=5),
            device_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kg, vg, attn_mask=mask, scale=scale,
                enable_gqa=True)),
            (ctx - B) * kv_bytes + 2 * q.numel() * 2 + 2 * k.numel() * 2
            + int(valid.sum().item()) * M * 2,
            4.0 * H * D * ctx, shape, "chitu_tpu/ops/pallas_attention.py:727")
        del pool_k, pool_p, kg, vg
    if "attend_decode" in kernels:
        pool_a = pool0.clone()
        plain.append_decode(pool_a, LAYER, k, v, bts, seq, valid, PAGE)
        dargs = (pool_a, LAYER, bts, seq, PAGE, KV, D)
        poison(torch, q.shape, dev)
        out_k = tk.attend_decode(q, *dargs, scale=scale)
        out_p = tk.attend_decode_plain(q, *dargs, scale=scale)
        err, rel = compare_rows(torch, "attend_decode", out_k, out_p, valid)
        bit_equal(torch, "attend_decode", out_k,
                  tk.attend_decode(q, *dargs, scale=scale))
        kg, vg = gathered_kv(pool_a, bts)
        yield case(
            "attend_decode", "attend_decode", err, rel,
            device_ms(torch, lambda: tk.attend_decode(q, *dargs, scale=scale)),
            call_ms(torch, lambda: tk.attend_decode_plain(
                q, *dargs, scale=scale), reps=5),
            device_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kg, vg, attn_mask=mask, scale=scale,
                enable_gqa=True)),
            ctx * kv_bytes + 2 * q.numel() * 2, 4.0 * H * D * ctx, shape,
            "chitu_tpu/ops/pallas_attention.py:327")
        del pool_a, kg, vg
    if "attend_prefill" in kernels:
        T, start = 512, 512
        totl = start + T
        bt = torch.arange(16, device=dev, dtype=torch.int32) + 100
        q_pos = (start + torch.arange(T, device=dev)).to(torch.int32)
        qp = randn(T, H, D)
        sargs = (pool0, LAYER, bt, q_pos, totl, PAGE, KV, D)
        poison(torch, qp.shape, dev)
        out_k = tk.attend_prefill(qp, *sargs, scale=scale)
        out_p = tk.attend_prefill_plain(qp, *sargs, scale=scale)
        err, rel = compare_rows(torch, "attend_prefill", out_k, out_p,
                                slice(None))
        bit_equal(torch, "attend_prefill", out_k,
                  tk.attend_prefill(qp, *sargs, scale=scale))
        kg, vg = gathered_kv(pool0, bt[None])
        c = torch.arange(kg.shape[2], device=dev)[None, :]
        m5 = (c <= q_pos[:, None].long()) & (c < totl)
        yield case(
            "attend_prefill", "attend_prefill", err, rel,
            device_ms(torch, lambda: tk.attend_prefill(qp, *sargs, scale=scale)),
            call_ms(torch, lambda: tk.attend_prefill_plain(
                qp, *sargs, scale=scale), reps=5),
            device_ms(torch, lambda: F.scaled_dot_product_attention(
                qp.transpose(0, 1)[None], kg, vg, attn_mask=m5[None, None],
                scale=scale, enable_gqa=True)),
            totl * kv_bytes + 2 * qp.numel() * 2,
            4.0 * H * D * int(m5.sum().item()),
            f"T={T} q_pos0={start} total={totl} H={H} KV={KV} D={D}",
            "chitu_tpu/ops/pallas_attention.py:1137")
        del kg, vg
    if "attend_prefill_packed" in kernels:
        T = 256
        TQ = tk.packed_q_block(H, M, PAGE, D, kv_heads=KV)
        NB = T // TQ
        segs = [(0, 100), (128, 60), (0, 40)]
        mp_p = 4
        bts_p = torch.full((B, mp_p), -1, dtype=torch.int32, device=dev)
        block_seg = torch.full((NB,), -1, dtype=torch.int32, device=dev)
        block_q = torch.zeros((NB,), dtype=torch.int32, device=dev)
        total = torch.zeros((B,), dtype=torch.int32, device=dev)
        tok_live = torch.zeros((T,), dtype=torch.bool, device=dev)
        off = 0
        for r, (s0, n) in enumerate(segs):
            bts_p[r] = torch.arange(r * mp_p, (r + 1) * mp_p, device=dev)
            nb = (n + TQ - 1) // TQ
            block_seg[off // TQ : off // TQ + nb] = r
            block_q[off // TQ : off // TQ + nb] = (
                s0 + torch.arange(nb, device=dev) * TQ)
            total[r] = s0 + n
            tok_live[off : off + n] = True
            off += nb * TQ
        qs = randn(T, H, D)
        pargs = (pool0, LAYER, bts_p, block_seg, block_q, total, PAGE, KV, D)
        poison(torch, qs.shape, dev)
        out_k = tk.attend_prefill_packed(qs, *pargs, scale=scale)
        out_p = tk.attend_prefill_packed_plain(qs, *pargs, scale=scale)
        err, rel = compare_rows(torch, "attend_prefill_packed", out_k, out_p,
                                tok_live)
        bit_equal(torch, "attend_prefill_packed", out_k,
                  tk.attend_prefill_packed(qs, *pargs, scale=scale))
        dead = ~torch.repeat_interleave(block_seg >= 0, TQ)
        if dead.any() and out_k[dead].abs().max().item() != 0.0:
            raise AssertionError("attend_prefill_packed: dead blocks not zero")
        n_new = sum(n for _, n in segs)
        yield case(
            "attend_prefill_packed", "attend_prefill_packed", err, rel,
            device_ms(torch, lambda: tk.attend_prefill_packed(
                qs, *pargs, scale=scale)),
            call_ms(torch, lambda: tk.attend_prefill_packed_plain(
                qs, *pargs, scale=scale), reps=3),
            sdpa_segments_ms(torch, F, qs, pool0, LAYER, bts_p, segs, TQ, KV,
                             D, scale, plain),
            sum(s0 + n for s0, n in segs) * kv_bytes + 2 * n_new * H * D * 2,
            4.0 * H * D * pairs_split(segs),
            f"T={T} Tq={TQ} NB={NB} segs={segs} H={H} KV={KV} D={D}",
            "chitu_tpu/ops/pallas_attention.py:1709")
    del pool0
    gc.collect()
    torch.cuda.empty_cache()


DENSE_SRC = "chitu_tpu_torch/csrc/dense_gemm.cu"
# Llama-3-8B's four stacked projections: wqkv, wo, w_gate_up, w_down
DENSE_PROJ = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)]


def dense_gemm_cases(torch, dg, dev):
    """B13 at Llama-3-8B's four stacked shapes (layer 1 of the stack), T
    16, 512, 1, 64 and 65, against its plain version (every row within
    1e-2 of the plain row's norm, on output memory filled with 7.0), two
    launches bit-equal and a CUDA-graph replay bit-equal to an eager
    launch. Times warm and cold as B9's (`absorb_cases`): the stack holds
    L layers, at least 2, enough that the others read more than twice the
    L2 between two calls on one. Library yardstick: one `torch.mm(x,
    w[layer], out_dtype=float32)` on the layer's view. Bound: the layer's
    weight, x and the f32 output / 3.35 TB/s against 2TKN / 989 TFLOP/s."""
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    for K, N in DENSE_PROJ:
        L = cold_layers(torch, dev, K * N * 2, 2)
        w = torch.empty((L, K, N), dtype=torch.bfloat16, device=dev)
        for l in range(L):
            w[l] = (torch.randn((K, N), generator=g, device=dev) * 0.02).to(
                torch.bfloat16)
        for T in (16, 512, 1, 64, 65):
            x = torch.randn((T, K), generator=g, device=dev).to(torch.bfloat16)
            name = f"dense_matmul_stacked[{K}->{N},T={T}]"
            run = lambda: dg.dense_matmul_stacked(x, 1, w)
            poison(torch, (T, 2 * N), dev)  # the f32 output lands on 7.0s
            got = run()
            err, rel = _row_rel(torch, name, got,
                                dg.dense_matmul_stacked_plain(x, 1, w), ROW_RTOL)
            bit_equal(torch, name, got, run())
            replay_equal(torch, name, run, got)
            bnd, by = bound_ms(K * N * 2 + T * K * 2 + T * N * 4, 2.0 * T * K * N)
            res = dict(
                name=name, kernel="dense_matmul_stacked", variant="bf16",
                route="cuda", source=DENSE_SRC,
                replaces="chitu_tpu/ops/pallas_quant_gemm.py:588",
                max_abs_err=err, max_row_rel_err=rel,
                ms=device_ms(torch, run),
                ms_cold=device_ms_cold(torch, [
                    (lambda l=l: dg.dense_matmul_stacked(x, l, w)) for l in range(L)]),
                plain_ms=call_ms(torch, lambda: dg.dense_matmul_stacked_plain(
                    x, 1, w)),
                bound_ms=bnd, bound_by=by,
                library_ms=device_ms(torch, lambda: torch.mm(
                    x, w[1], out_dtype=torch.float32)),
                host_us=host_us(torch, run),
                library_host_us=host_us(torch, lambda: torch.mm(
                    x, w[1], out_dtype=torch.float32)),
                library_ms_cold=device_ms_cold(torch, [
                    (lambda l=l: torch.mm(x, w[l], out_dtype=torch.float32))
                    for l in range(L)]),
                shape=f"T={T} K={K} N={N} layers={L} layer=1")
            if hasattr(dg, "gemm_plan"):
                res.update(plan_fields(dg.gemm_plan(x, w)))
            yield res
        del w
    torch.cuda.empty_cache()


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


def int8_cases(torch, qg, dev):
    """B10 at Llama-3-8B's W8A8 projection shapes, T 16, 1, 512, 64 and 65
    (the first case, T 16 `[4096 -> 28672]`, is the one reported in the
    kernels line): the int32 sums equal the plain product's exactly, the
    scaled f32 output within 1e-5 of the plain row's norm (the same f32
    arithmetic), a bf16 output with a bias within 1e-2; each checked
    output on memory filled with 7.0, two launches and a CUDA-graph replay
    bit-equal. Times warm and cold as B9's (`absorb_cases`): the weights of
    a stack of W8A8 layers sized by `cold_layers`. Library yardstick:
    `torch._int_mm` (more than 16 rows only), warm and cold."""
    from chitu_tpu_torch.ops import norm_quant as nq
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    bf = torch.bfloat16

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    for K, N in PROJ:
        L = cold_layers(torch, dev, K * N, 2)
        ws = [qt.quantize_weight(randn(K, N, s=0.02), QuantKind.W8A8)
              for _ in range(L)]
        w8 = ws[1]
        for T in TS + [64, 65]:
            name = f"int8_gemm[T={T},{K}->{N}]"
            xa = nq.quant_acts_plain(randn(T, K))
            run_acc = lambda: qg.int8_matmul(xa.data, w8.data)
            acc, acc_p = run_acc(), qg.int8_matmul_plain(xa.data, w8.data)
            if not torch.equal(acc, acc_p):
                bad = (acc != acc_p).sum().item()
                raise AssertionError(f"{name}: {bad} int32 sums differ")
            bit_equal(torch, name + " sums", acc, run_acc())
            replay_equal(torch, name + " sums", run_acc, acc)
            run = lambda: qg.int8_gemm(xa.data, xa.scale, w8)
            poison(torch, (T, 2 * N), dev)  # the f32 output lands on 7.0s
            got = run()
            err, rel = _row_rel(torch, name, got,
                                qg.int8_gemm_plain(xa.data, xa.scale, w8), 1e-5)
            bit_equal(torch, name, got, run())
            replay_equal(torch, name, run, got)
            bias = randn(N)
            _row_rel(torch, name + "+bias", qg.int8_gemm(xa.data, xa.scale, w8, bias, bf),
                     qg.int8_gemm_plain(xa.data, xa.scale, w8, bias, bf), ROW_RTOL)
            nbytes = w8.nbytes() + T * K + T * 4 + T * N * 4
            bnd, by = bound_ms(nbytes, 2.0 * T * K * N, INT8_OP_PER_S)
            lib = lib_cold = None
            if T > 16:  # torch._int_mm takes more than 16 rows only
                lib = device_ms_sized(torch, lambda: torch._int_mm(xa.data, w8.data))
                lib_cold = device_ms_cold(torch, [
                    (lambda w=w: torch._int_mm(xa.data, w.data)) for w in ws])
            res = dict(
                name=name, kernel="int8_gemm", route="cuda", source=QGEMM_SRC,
                replaces="chitu_tpu/ops/pallas_quant_gemm.py:501",
                max_abs_err=err, max_row_rel_err=rel, int32_sums_equal=True,
                ms=device_ms_sized(torch, run),
                ms_cold=device_ms_cold(torch, [
                    (lambda w=w: qg.int8_gemm(xa.data, xa.scale, w)) for w in ws]),
                plain_ms=call_ms(
                    torch, lambda: qg.int8_gemm_plain(xa.data, xa.scale, w8),
                    reps=5),
                bound_ms=bnd, bound_by=by, library_ms=lib, library_ms_cold=lib_cold,
                shape=f"T={T} K={K} N={N} layers={L} layer=1")
            if hasattr(qg, "int8_gemm_plan"):
                res.update(plan_fields(qg.int8_gemm_plan(xa.data, w8.data)))
            yield res
        del ws, w8
    torch.cuda.empty_cache()


def quant_kernel_cases(torch, qg, qt, QuantKind, dev):
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
        poison(torch, (T, 2 * N), dev)  # the f32 output lands on 7.0s
        got = qg.quant_gemm(x, q)
        want = qg.quant_gemm_plain(x, q)
        err, rel = _row_rel(torch, name, got, want, ROW_RTOL)
        bit_equal(torch, name, got, qg.quant_gemm(x, q))
        replay_equal(torch, name, lambda: qg.quant_gemm(x, q), got)
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
                         f"weight_bytes={q.nbytes()}",
                   **plan_fields(qg.gemm_plan(x, q)))
        if timed:
            res["ms"] = device_ms_sized(torch, lambda: qg.quant_gemm(x, q))
            res["plain_ms"] = call_ms(
                torch, lambda: qg.quant_gemm_plain(x, q), reps=5)
            wd = q.dequantize(bf)
            res["library_ms"] = device_ms_sized(torch, lambda: torch.matmul(x, wd))
            del wd
        return res

    # the soft-fp8 engine's own shapes first, then every other mode; T 64
    # and 65 stand on the edge of the two regimes
    for K, N in PROJ:
        for T in TS + [64, 65, 128]:
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
    # shapes no tensor map describes (rows of 4100 bytes; x rows of 8002):
    # the cp.async path of the same kernel, both regimes
    for T in (16, 512):
        yield gemm_case("e4m3_blockwise", T, 4096, 4100, timed=False)
        yield gemm_case("int8_channel", T, 4001, 4096, timed=False)
    torch.cuda.empty_cache()

    yield from int8_cases(torch, qg, dev)


# ---------------------------------------------------------------------------
# phase 2b': the activation quantizers (B11, B12)
# ---------------------------------------------------------------------------

NQ_EPS = 1e-5
# (kernel, width, label): B11 at Llama-3-8B's hidden size, B12 mid-FFN and
# on wo's input
ACTS_WIDTHS = [("rms_norm_quant", 4096, "D"), ("quant_acts", 14336, "F"),
               ("quant_acts", 4096, "D")]
ACTS_TS = [16, 1, 64, 65, 512]  # decode first: the kernels line's case


def tie_rows(torch, T, D):
    """T rows of D bf16 values (on the CPU) on which a product with the
    reciprocal of the scale rounds otherwise than the division: row r
    holds every bf16 value v with A_r / 256 <= |v| <= A_r (so |v / s| >=
    0.5, s = A_r / 127) and fills the rest with smaller normal values; A_r
    is the row's amax, picked where the ladder holds such ties.
    -> (rows, count of values the product would round otherwise)."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    every = bits.view(torch.bfloat16).float()
    every = every[torch.isfinite(every)]
    recip = torch.tensor(1.0) / torch.tensor(127.0)
    g = torch.Generator()
    g.manual_seed(5)
    rows, flips, a = [], 0, 2.0
    while len(rows) < T:
        a = float(torch.tensor(a * 1.0137).bfloat16().float())
        amax = torch.tensor(a)
        lad = every[(every.abs() <= amax) & (every.abs() >= amax / 256)]
        s = amax * recip
        n = int((torch.round(lad / s) != torch.round(lad * (1.0 / s))).sum())
        if n == 0 or lad.numel() > D:
            continue
        fill = (torch.randn(D - lad.numel(), generator=g) * a / 8).clamp(-a, a)
        row = torch.cat([lad, fill])[torch.randperm(D, generator=g)]
        rows.append(row)
        flips += n
    return torch.stack(rows).to(torch.bfloat16), flips


def acts_equal(torch, name, got, want):
    """Scales and int8 values bit-equal."""
    torch.cuda.synchronize()
    if not (torch.equal(got.scale, want.scale) and torch.equal(got.data, want.data)):
        ns = int((got.scale != want.scale).sum())
        nd = int((got.data != want.data).sum())
        raise AssertionError(f"{name}: {ns} scales and {nd} int8 values differ")


def acts_close(torch, name, got, want):
    """B11's limits: scales within 1e-6 relative, int8 values at most 1
    apart, at most 0.1 % of them off (the sum of squares runs in another
    order than torch's mean, and a last-bit difference flips a tie).
    -> (scale rel err, share off, largest difference)."""
    torch.cuda.synchronize()
    rel = ((got.scale - want.scale).abs() / want.scale).max().item()
    d = (got.data.int() - want.data.int()).abs()
    off = (d != 0).float().mean().item()
    if not (rel <= 1e-6 and d.max().item() <= 1 and off <= 1e-3):
        raise AssertionError(
            f"{name}: scale rel err {rel}, max int8 diff {d.max().item()}, "
            f"share off by one {off}")
    return rel, off, float(d.max().item())


def acts_cases(torch, nq, dev):
    """B11 `rms_norm_quant` at D 4096 and B12 `quant_acts` at F 14336 and
    D 4096, at T 16, 1, 64, 65 and 512 (the first case of each, T 16, is
    the one reported in the kernels line), then B11 at D 8192 (a 70B-class
    hidden size), B12 at F 29568 (Qwen2-72B's FFN, whose rows split over
    a cluster at T 16 and 1), an odd width (D 4100), an x starting 2 bytes
    past a 16-byte boundary, and rows of rounding ties.
    Each output lands on memory filled with 7.0; B12 is bit-equal to
    `quant_acts_plain` (the max does not depend on order, and both divide
    in IEEE f32), B11 within `acts_close`'s limits; two launches and a
    CUDA-graph replay bit-equal. Times warm: on the main path the input
    was written by the kernel just before (the residual add, silu(gate) *
    up, the attention output) and sits in L2. Each case names its plan
    (from `nq.plan_for` where the tree has one) and the host time of a
    call. Last, `launch_floor`: the device time of a one-element in-place
    add, what no launch beats. A tree from before the redesign (no
    `nq.plan_for`; `scripts/torch_kernel_compare.py` runs earlier trees)
    is held to B11's limits for B12 too, and skips the unaligned x, which
    its wrapper refuses."""
    exact = hasattr(nq, "plan_for")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    bf = torch.bfloat16
    w = (1.0 + 0.1 * torch.randn(8192, generator=g, device=dev)).to(bf)

    def pack(a):
        return torch.cat([a.data.view(-1), a.scale.view(torch.int8)])

    def case(kernel, T, D, label, x=None, tag=""):
        if x is None:
            x = torch.randn((T, D), generator=g, device=dev).to(bf)
        nw = w[:D].contiguous() if kernel == "rms_norm_quant" else None
        if kernel == "rms_norm_quant":
            run = lambda: nq.rms_norm_quant(x, nw, NQ_EPS)
            plain = lambda: nq.rms_norm_quant_plain(x, nw, NQ_EPS)
        else:
            run = lambda: nq.quant_acts(x)
            plain = lambda: nq.quant_acts_plain(x)
        name = f"{kernel}[T={T},{label}={D}{tag}]"
        poison(torch, (-(-T * D // 2),), dev)  # the int8 output
        poison(torch, (2 * T,), dev)  # the scales
        got = run()
        want = plain()
        if kernel == "quant_acts" and exact:
            acts_equal(torch, name, got, want)
            rel, off, dmax = 0.0, 0.0, 0.0
        else:
            rel, off, dmax = acts_close(torch, name, got, want)
        bit_equal(torch, name, pack(got), pack(run()))
        replay_equal(torch, name, lambda: pack(run()), pack(got))
        nbytes = T * D * 3 + T * 4 + (D * 2 if nw is not None else 0)
        bnd, by = bound_ms(nbytes, 0.0)
        res = dict(
            name=name, kernel=kernel, route="cuda", source=NQ_SRC,
            replaces="chitu_tpu/ops/pallas_norm_quant.py:"
                     + ("79" if kernel == "rms_norm_quant" else "107"),
            max_abs_err=dmax, scale_rel_err=rel, int8_off_share=off,
            bit_equal_plain=kernel == "quant_acts" and exact,
            ms=device_ms(torch, run), plain_ms=call_ms(torch, plain),
            host_us=host_us(torch, run), bound_ms=bnd, bound_by=by,
            library_ms=None, shape=f"T={T} {label}={D}{tag}")
        if hasattr(nq, "plan_for"):
            p = nq.plan_for(x)
            res.update(regime=p.regime, cluster=p.cluster, threads=p.threads,
                       rows=p.rows, vecs=p.vecs, grid=p.grid)
        return res

    for kernel, D, label in ACTS_WIDTHS:
        for T in ACTS_TS:
            yield case(kernel, T, D, label)
    yield case("rms_norm_quant", 16, 8192, "D")  # a 70B-class hidden size
    for T in (16, 1):  # Qwen2-72B's FFN: a row split over a cluster
        yield case("quant_acts", T, 29568, "F")
    for kernel in ("rms_norm_quant", "quant_acts"):
        yield case(kernel, 16, 4100, "D")
        if exact:
            buf = torch.randn(16 * 4096 + 1, generator=g, device=dev).to(bf)
            yield case(kernel, 16, 4096, "D", buf[1:].view(16, 4096), ",x+2B")
    ties, flips = tie_rows(torch, 16, 14336)
    assert flips > 0
    yield case("quant_acts", 16, 14336, "F", ties.to(dev), f",ties={flips}")
    one = torch.zeros(1, device=dev)
    yield dict(name="launch_floor", kernel="launch_floor",
               ms=device_ms(torch, lambda: one.add_(1.0)),
               shape="one f32 element added in place")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2c: the grouped expert GEMM of the MoE path
# ---------------------------------------------------------------------------

MOE_SRC = "chitu_tpu_torch/csrc/moe_gemm.cu"
# (label, experts, K, N, e4m3?) of the expert stacks the engines hold:
# Mixtral-8x7B gate/up merged in e4m3 and split in bf16, down in both;
# moe-16x-bench likewise
MOE_STACKS = [
    ("mixtral", 8, 4096, 28672, True), ("mixtral", 8, 4096, 14336, False),
    ("mixtral", 8, 14336, 4096, True), ("mixtral", 8, 14336, 4096, False),
    ("moe16x", 16, 2048, 2816, True), ("moe16x", 16, 2048, 1408, False),
    ("moe16x", 16, 1408, 2048, True), ("moe16x", 16, 1408, 2048, False),
]
# DeepSeek-R1's experts (256, top-8): gate/up merged in e4m3, down in e4m3
# and bf16; one layer a stack (a bf16 layer of them is 15 GB)
R1_MOE_STACKS = [
    ("R1", 256, 7168, 4096, True), ("R1", 256, 2048, 7168, True),
    ("R1", 256, 2048, 7168, False),
]


def check_grouped(torch, name, got, again, want, live_rows):
    """The limits every grouped-GEMM result is held to: every row of a
    live block within ROW_RTOL of the plain row's norm, every other row
    exactly zero, and a second launch bit-equal. -> (max abs err, max row
    relative err)."""
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    dead = got[~live_rows]
    if dead.numel() and dead.abs().max().item() != 0.0:
        raise AssertionError(f"{name}: dead blocks not zero")
    return _row_rel(torch, name, got[live_rows], want[live_rows], ROW_RTOL)


def moe_kernel_cases(torch, np, mg, moe, qt, QuantKind, dev):
    """One result dict per case of `grouped_gemm`; the first (the merged
    e4m3 gate/up stack of Mixtral-8x7B at the 16-token decode geometry) is
    the one reported in the kernels line."""
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    rng = np.random.default_rng(2)
    bf = torch.bfloat16

    def stack(L, E, K, N, fp8, rowwise=False):
        """[L, E, K, N] experts, made one layer at a time."""
        w = torch.empty((L, E, K, N), dtype=bf, device=dev)
        for l in range(L):
            w[l].normal_(0.0, 0.02, generator=g)
        if not fp8:
            return w
        q = qt.quantize_stacked(
            w, lambda t: qt.quantize_weight(t, QuantKind.SOFT_FP8))
        if rowwise:
            q = qt.expand_fp8_scales_rowwise({"w": q})["w"]
            assert q.scale.shape == (L, E, K // 128, N)
        return q

    def routing(T, E, k, skewed=False):
        """sel [T, k]: k distinct experts a token from the numpy seed, or
        (skewed) the same two for every token."""
        if skewed:
            sel = np.tile(np.array([[0, 3]]), (T, 1))
        else:
            sel = np.stack([rng.permutation(E)[:k] for _ in range(T)])
        return torch.tensor(sel, dtype=torch.int32, device=dev)

    def case(label, w, T, layer=0, skewed=False, timed=True, tag="", k=2):
        data = w.data if hasattr(w, "kind") else w
        fp8 = hasattr(w, "kind")
        E, K, N = data.shape[-3:]
        bm, NB = moe.dispatch_geometry(T, k, E)
        sel = routing(T, E, k, skewed)
        row_assign, block_expert = moe.sorted_dispatch(sel, E, bm)
        x = (torch.randn((T, K), generator=g, device=dev)).to(bf)
        A = T * k
        tok = torch.where(row_assign < A, row_assign.clamp(max=A - 1) // k, 0)
        xs = x[tok.long()].contiguous()
        be = block_expert.tolist()
        live = [e for e in be if e >= 0]
        live_rows = torch.repeat_interleave(block_expert >= 0, bm)
        mode = ("e4m3_rowwise" if fp8 and w.scale.shape[-1] == N
                else "e4m3_blockwise" if fp8 else "bf16")
        name = (f"grouped_gemm[{label},{mode},T={T},{K}->{N}"
                f"{',layer1' if layer else ''}{tag}]")
        run = lambda: mg.grouped_matmul(xs, w, layer, block_expert, bm)
        junk = torch.full((NB * bm, N), 7.0, dtype=bf, device=dev)
        del junk  # the output lands on this memory: dead rows must be written
        got, again = run(), run()
        want = mg.grouped_matmul_plain(xs, w, layer, block_expert, bm)
        err, rel = check_grouped(torch, name, got, again, want, live_rows)
        replay_equal(torch, name, run, got)
        experts = sorted(set(live))
        wbytes = len(experts) * K * N * (1 if fp8 else 2)
        if fp8:
            wbytes += len(experts) * w.scale[0, 0].numel() * 4
        nbytes = wbytes + xs.numel() * 2 + NB * bm * N * 2
        bnd, by = bound_ms(nbytes, 2.0 * A * K * N)
        res = dict(name=name, kernel="grouped_gemm", route="cuda",
                   source=MOE_SRC,
                   replaces="chitu_tpu/ops/pallas_moe_gemm.py:287",
                   max_abs_err=err, max_row_rel_err=rel, bound_ms=bnd,
                   bound_by=by, ms=None, plain_ms=None, library_ms=None,
                   shape=f"T={T} k={k} E={E} bm={bm} NB={NB} live_blocks="
                         f"{len(live)} live_experts={len(experts)} K={K} N={N} "
                         f"mode={mode} weight_bytes_read={wbytes}",
                   **plan_fields(mg.gemm_plan(xs, w, block_expert, bm)))
        if timed:
            res["ms"] = device_ms_sized(torch, run)
            res["plain_ms"] = call_ms(
                torch,
                lambda: mg.grouped_matmul_plain(xs, w, layer, block_expert, bm),
                reps=3)
            # library: one matmul per live expert over its rows, on bf16
            # weights dequantized beforehand
            dense = {e: mg.expert_weight(w, layer, e) for e in experts}
            spans = [(e, be.index(e) * bm, (be.index(e) + be.count(e)) * bm)
                     for e in experts]
            out = torch.empty((NB * bm, N), dtype=bf, device=dev)

            def library():
                for e, lo, hi in spans:
                    torch.matmul(xs[lo:hi], dense[e], out=out[lo:hi])

            res["library_ms"] = device_ms_sized(torch, library)
            del dense
        return res

    for label, E, K, N, fp8 in MOE_STACKS:
        w = stack(2, E, K, N, fp8)
        # decode batch, prefill slab, one request; at Mixtral also the
        # other row tiles (T 64 and 65: bm 32, T 128: bm 64)
        more = (64, 65, 128) if label == "mixtral" else ()
        for T in (16, 512, 1) + more:
            yield case(label, w, T, layer=1 if T == 1 else 0)
        if (label, fp8) == ("mixtral", True):
            # the skewed routing that the capacity route would drop
            yield case(label, w, 16, skewed=True, timed=False, tag=",skewed")
            yield case(label, w, 512, skewed=True, timed=False, tag=",skewed")
        del w
        torch.cuda.empty_cache()
    w = stack(2, 8, 4096, 14336, True, rowwise=True)
    for T in (16, 512):
        yield case("mixtral", w, T, layer=1)
    del w
    w = stack(1, 8, 4096, 14336, False)[0]  # an unstacked [E, K, N] weight
    yield case("mixtral", w, 16, timed=False, tag=",unstacked")
    del w
    torch.cuda.empty_cache()
    # DeepSeek-R1's geometry: at T 16 and top-8 of 256, bm 16 and 136
    # blocks, up to 128 live experts with one row or two each
    for label, E, K, N, fp8 in R1_MOE_STACKS:
        w = stack(1, E, K, N, fp8)
        for T in (16, 512, 1):
            yield case(label, w, T, k=8)
        del w
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the engine at full width
# ---------------------------------------------------------------------------


ATTN_KERNELS = ("attend_decode_fused", "attend_prefill_packed_fused",
                "attend_prefill")


def _swap_targets():
    """(module, name) of every call the model makes into this slice's
    GEMM and quantizer kernels, each with its plain version."""
    from chitu_tpu_torch.models import deepseek_v3, llama, moe
    from chitu_tpu_torch.ops import (
        absorb_kernels, linear, moe_gemm_kernels, norm_quant,
        quant_gemm_kernels,
    )

    return [
        (deepseek_v3, "absorb_matmul", absorb_kernels.absorb_matmul_plain),
        (moe, "grouped_matmul", moe_gemm_kernels.grouped_matmul_plain),
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
    quantized, grouped and absorb GEMMs and activation quantizers on the
    card. Attention stays on its kernel (it is held against its own plain
    version in phase 2)."""
    return _swapped(lambda kernel_fn, plain_fn, name: plain_fn)


def shadowed(torch, errs):
    """Every call into one of this slice's kernels also runs the plain
    version on the same inputs and is held to the kernel cases' limits;
    the kernel's result goes on. `errs[name]` collects the largest error
    (GEMM: row relative; quantizers: share of int8 values off by one)."""

    def make(kernel_fn, plain_fn, name):
        def both(*args, **kw):
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            if name.endswith(("gemm", "matmul")):
                limit = 1e-5 if name == "int8_gemm" else ROW_RTOL
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


# the wrappers of the attention kernels the models call through
# `ops.attention_kernels`; B1 and B2 append into the pool they are given
ATTN_WRAPPERS = ("attend_decode_fused", "attend_prefill_packed_fused",
                 "attend_prefill", "attend_prefill_packed", "attend_decode")
APPENDING = ("attend_decode_fused", "attend_prefill_packed_fused")


@contextlib.contextmanager
def shadowed_attention(torch, tk, errs):
    """Every call of an attention wrapper, and of B13 through `linear`,
    also runs its plain version on equal inputs, held to the limits of
    phase 2: the appending kernels' plain versions write into a copy of
    the layer's pool slice, which must come out byte-equal to the layer
    the kernel wrote; outputs within ROW_RTOL on the rows both define
    (B1: the valid rows; B2, B3: the live tokens). The kernel's result
    goes on. `errs[variant]` collects the largest row error."""
    import inspect

    from chitu_tpu_torch.ops import dense_gemm_kernels as dg
    from chitu_tpu_torch.ops import linear

    def shim(name):
        real = getattr(tk, name)
        plain_fn = getattr(tk, name + "_plain")
        sig = inspect.signature(real)

        def both(*a, **kw):
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            args = dict(args.arguments)
            pool, layer, q = args["pool"], args["layer"], args["q"]
            key = tk.variant_name(name, pool, q.shape[-1],
                                  args.get("split_kv", True))
            if name in APPENDING:
                args["pool"], args["layer"] = pool[layer:layer + 1].clone(), 0
            out = real(*a, **kw)
            want = plain_fn(**args)
            if name in APPENDING and not torch.equal(pool[layer], args["pool"][0]):
                raise AssertionError(f"{key} in the model: pool bytes differ "
                                     "from the plain append")
            if name == "attend_decode_fused":
                rows = args["valid"]
            elif name.startswith("attend_prefill_packed"):
                rows = tk.packed_token_layout(
                    args["block_seg"], args["block_qstart"],
                    args["total_lens"], q.shape[0])[2]
            elif name == "attend_prefill":
                # the kernel places row t at q_pos[0] + t, the plain
                # version at q_pos[t]: they part on a chunk's padded rows
                qp = args["q_pos"]
                rows = qp == qp[0] + torch.arange(qp.shape[0], device=qp.device)
            else:
                rows = slice(None)
            if isinstance(rows, slice) or bool(rows.any()):
                _, e = compare_rows(torch, f"{key} in the model", out, want,
                                    rows)
                errs[key] = max(errs.get(key, 0.0), e)
            return out

        return both

    def dense_both(x, layer, w):
        got = real_dense(x, layer, w)
        _, e = _row_rel(torch, "dense_matmul_stacked in the model", got,
                        dg.dense_matmul_stacked_plain(x, layer, w), ROW_RTOL)
        errs["dense_matmul_stacked"] = max(
            errs.get("dense_matmul_stacked", 0.0), e)
        return got

    old = {n: getattr(tk, n) for n in ATTN_WRAPPERS}
    real_dense = linear.dense_matmul_stacked
    try:
        for n in ATTN_WRAPPERS:
            setattr(tk, n, shim(n))
        linear.dense_matmul_stacked = dense_both
        yield
    finally:
        for n, fn in old.items():
            setattr(tk, n, fn)
        linear.dense_matmul_stacked = real_dense


def shadow_serve(torch, np, tk, eng, label):
    """A short burst with every attention and B13 call shadowed: a lone
    prompt (B5, then decode: B1), two prompts in one packed slab (B2, or
    B3 for DeepSeek), and one more arriving while those decode (the hybrid
    step: B1 + B2, or B4 + B3). -> the largest row error of each kernel
    variant."""
    from chitu_tpu_torch import SampleParams

    rng = np.random.default_rng(11)
    V = eng.cfg.models.vocab_size
    short = SampleParams(temperature=0.0, max_new_tokens=4)
    long = SampleParams(temperature=0.0, max_new_tokens=12)

    def prompt(n):
        return [int(x) for x in rng.integers(1, V, size=n)]

    errs = {}
    with torch.no_grad(), shadowed_attention(torch, tk, errs):
        reqs = [eng.submit("", short, prompt_tokens=prompt(120))]
        eng.step()
        eng.step()
        reqs += [eng.submit("", long, prompt_tokens=prompt(n)) for n in (40, 70)]
        eng.step()
        reqs.append(eng.submit("", short, prompt_tokens=prompt(50)))
        eng.run_until_complete()
    torch.cuda.synchronize()
    for r, n in zip(reqs, (4, 12, 12, 4)):
        if len(r.async_stream.tokens) != n:
            raise AssertionError(f"[{label}] shadowed request incomplete")
    if not errs:
        raise AssertionError(f"[{label}] the shadowed burst reached no kernel")
    return errs


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
    cache = dict(eng.cache.arrays)
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
    limit = float("inf") if label.endswith(STEP_ACTS) else LOGITS_RTOL
    _, rel = _row_rel(torch, f"{label} prefill logits", got, want, limit)
    return errs, rel


# infer.attn_type=ref and infer.op_impl=xla: every attention call and
# every call op_impl governs take their plain versions on the card; under
# soft-fp8, so that the dequant GEMM would otherwise launch
PLAIN_ROUTE = ["models.n_layers=4", "infer.attn_type=ref",
               "infer.op_impl=xla", "quant.method=soft_fp8",
               "quant.quant_on_load=true"]
ROUTED_OFF = ATTN_WRAPPERS + ("quant_gemm", "int8_gemm", "rms_norm_quant",
                              "quant_acts", "dense_matmul_stacked",
                              "absorb_matmul")


def routed_off(tk, forbid):
    """The launches (variants included) of the kernels in `forbid`."""
    return {k: n for k, n in tk.LAUNCHES.items()
            if n and k.split("[")[0] in forbid}


def plain_route_logits(torch, np, tk, eng, forbid):
    """One 64-token prefill of the idle plain-route engine's model, then
    the same model switched back to the kernels (equal weights): no
    kernel in `forbid` may launch in the first, the attention and dequant
    GEMM kernels must in the second, and every logits row must lie within
    LOGITS_RTOL. -> the largest per-row relative error."""
    from chitu_tpu_torch.ops import linear

    cfg = eng.cfg
    dev = eng.device
    rng = np.random.default_rng(7)
    toks = torch.tensor(rng.integers(1, cfg.models.vocab_size, size=64),
                        dtype=torch.int32, device=dev)
    mp = cfg.infer.max_seq_len // cfg.infer.page_size + 1
    bt = torch.arange(mp, dtype=torch.int32, device=dev)  # free pages
    args = (dict(eng.cache.arrays), toks, bt, 0, 64, cfg.infer.page_size)
    with torch.no_grad():
        tk.reset_launch_counts()
        want, _ = eng.model.prefill(*args, return_all_logits=True)
        torch.cuda.synchronize()
        off = routed_off(tk, forbid)
        eng.model.attn_route, eng.model.attn = tk.attention_route("auto")
        linear.set_op_impl("auto")
        tk.reset_launch_counts()
        got, _ = eng.model.prefill(*args, return_all_logits=True)
        torch.cuda.synchronize()
    if off:
        raise AssertionError(f"plain route launched kernels: {off}")
    if not (tk.LAUNCHES["attend_prefill"] and tk.LAUNCHES["quant_gemm"]):
        raise AssertionError("the kernel route reached no kernel")
    _, rel = _row_rel(torch, "plain route prefill logits", got, want,
                      LOGITS_RTOL)
    return rel


def host_rss_gib() -> float:
    """The process's resident set now, GiB (/proc/self/statm; mapped file
    pages a load touched count while they stay mapped)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


@contextlib.contextmanager
def host_peak(out):
    """Sample the resident set every 5 ms while the body runs; the set at
    its start lands in out["host_start_gib"], the peak in
    out["host_peak_gib"], and the process's lifetime peak (getrusage) in
    out["host_maxrss_gib"]."""
    import resource
    import threading

    out["host_start_gib"] = host_rss_gib()
    peak = [out["host_start_gib"]]
    done = threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], host_rss_gib())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield
    finally:
        done.set()
        th.join()
        out["host_peak_gib"] = max(peak[0], host_rss_gib())
        out["host_maxrss_gib"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20


BRINGUP = {}  # phase label -> its bring-up stats


def engine_phase(torch, np, tk, card, label="bf16", overrides=(),
                 lens=(40, 100, 200, 130, 60, 700), new_tokens=32,
                 need=ATTN_KERNELS, check_plain=False,
                 model="Llama-3-8B-Instruct", shadow=False, forbid=(),
                 after=None):
    """Bring up an engine, serve one lone prompt and then a burst that
    arrives while it decodes, check everything came back, and return the
    kernel launch counts of that run (zeroed just before it). `shadow`:
    then a short burst with every attention and B13 call shadowed by its
    plain version (`shadow_serve`). `forbid`: kernels that must not launch
    in the burst (the plain route), then `plain_route_logits`. `after(eng)`:
    more checks on the idle engine before it goes; its dict joins the
    phase's stats."""
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine

    cfg = load_config(overrides=[
        f"models={model}", "infer.stop_with_eos=false", *overrides,
    ])
    torch.cuda.reset_peak_memory_stats()
    host = {}
    t0 = time.time()
    with host_peak(host):
        eng = Engine(cfg)
        torch.cuda.synchronize()
    bringup = time.time() - t0
    BRINGUP[label] = dict(
        bringup_s=bringup,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        resident_gib=torch.cuda.memory_allocated() / 2**30, **host,
    )
    source = (f"loaded from {cfg.models.ckpt_dir}" if cfg.infer.do_load
              else "random weights")
    print(f"engine[{label}] bring-up {bringup:.1f} s "
          f"({cfg.models.name}, {cfg.models.n_layers} layers, {source}, "
          f"quant {cfg.quant.method}, KV pool {eng.cache.bytes() / 2**30:.2f} GiB, "
          f"peak during bring-up "
          f"{BRINGUP[label]['peak_gib']:.1f} GiB, resident "
          f"after it {BRINGUP[label]['resident_gib']:.1f} GiB, host RSS "
          f"{BRINGUP[label]['host_start_gib']:.2f} GiB at its start, peak "
          f"{BRINGUP[label]['host_peak_gib']:.2f} GiB during it, "
          f"{BRINGUP[label]['host_maxrss_gib']:.2f} GiB since the process began)",
          flush=True)
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
    # the burst in two waves: the first prefills, the second arrives while
    # the first decodes, so a hybrid step carries both (DeepSeek: B4 + B3)
    half = len(lens) // 2
    for i, n in enumerate(lens):
        if i == half:
            eng.step()
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
    if routed_off(tk, forbid):
        raise AssertionError(f"[{label}] kernels launched under the plain "
                             f"route: {routed_off(tk, forbid)}")

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
    if shadow:
        stats["shadowed_call_err_vs_plain"] = shadow_serve(
            torch, np, tk, eng, label)
    if forbid:
        stats["route"] = eng.model.attn_route
        stats["logits_row_rel_err_plain_route_vs_kernels"] = (
            plain_route_logits(torch, np, tk, eng, forbid))
    stats["kv_pool_gib"] = eng.cache.bytes() / 2**30
    if after is not None:
        stats.update(after(eng))
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
    "quant_gemm", "int8_gemm", "rms_norm_quant", "quant_acts", "grouped_gemm",
    "attend_prefill_packed", "attend_decode", "absorb_matmul")
MIXTRAL = "Mixtral-8x7B-Instruct-v0.1"
MOE_PHASES = [
    # (label, model card, overrides, kernels beyond attention that must have
    # launched). Full width always; the depth is what 80 GB holds: a layer
    # of Mixtral-8x7B experts is 2.82 GB in bf16, and a quantized engine
    # draws the bf16 tree before it quantizes leaf by leaf.
    ("mixtral_bf16", MIXTRAL, ["models.n_layers=8"], ("grouped_gemm",)),
    ("mixtral_soft_fp8", MIXTRAL,
     ["models.n_layers=20", "quant.method=soft_fp8",
      "quant.quant_on_load=true"], ("grouped_gemm", "quant_gemm")),
    ("moe16x_bf16", "moe-16x-bench", [], ("grouped_gemm",)),
    ("moe16x_soft_fp8", "moe-16x-bench",
     ["quant.method=soft_fp8", "quant.quant_on_load=true"],
     ("grouped_gemm", "quant_gemm")),
]


# DeepSeek serving: the kernels each phase must launch. Full width always;
# the depth is what 80 GB holds: a layer of DeepSeek-R1's experts is
# 22.5 GB in bf16, and a quantized engine draws the bf16 tree first, so
# 5 layers (3 dense, 2 MoE: 53 GB) in bf16 and in soft-fp8; 6 would be 76.
MLA_KERNELS = ("attend_decode_fused", "attend_prefill_packed",
               "attend_decode", "attend_prefill", "absorb_matmul",
               "grouped_gemm")
R1 = "DeepSeek-R1"
SOFT = ["quant.method=soft_fp8", "quant.quant_on_load=true"]
MLA_PHASES = [
    # (label, model card, overrides, kernels beyond MLA_KERNELS)
    ("r1_bf16", R1, ["models.n_layers=5"], ()),
    ("r1_soft_fp8", R1, ["models.n_layers=5"] + SOFT, ("quant_gemm",)),
    ("mid_bf16", "deepseek-mid-bench", [], ()),
    ("mid_soft_fp8", "deepseek-mid-bench", SOFT, ("quant_gemm",)),
]


# Slice 5: the e4m3 KV pool, DeepSeek's dense MLA (head_dim 192), the debug
# cards' head sizes (64, 32) and B13. Full width; R1 at the depth 80 GB
# holds (the dense MLA pool is 96 KiB a token a layer: 13 GiB at 4 layers).
LLAMA = "Llama-3-8B-Instruct"
E4M3 = ("attend_decode_fused[e4m3]", "attend_prefill_packed_fused[e4m3]",
        "attend_prefill[e4m3]")
LATENT_E4M3 = tuple(f"{k}[latent,e4m3]" for k in (
    "attend_decode_fused", "attend_prefill_packed", "attend_decode",
    "attend_prefill"))
D192 = tuple(f"{k}[d192]" for k in (
    "attend_decode_fused", "attend_prefill_packed", "attend_decode",
    "attend_prefill"))
SLICE5_PHASES = [
    # (label, model card, overrides, kernels that must have launched)
    ("llama_fp8_kv", LLAMA, ["infer.kv_dtype=fp8"], ATTN_KERNELS + E4M3),
    ("r1_fp8_kv", R1, ["models.n_layers=5", "infer.kv_dtype=fp8"],
     MLA_KERNELS + LATENT_E4M3),
    ("r1_dense", R1, ["models.n_layers=4", "infer.mla_absorb=none"],
     D192 + ("grouped_gemm",)),
    ("llama_dense_kernel", LLAMA, ["models.n_layers=4"],
     ATTN_KERNELS + ("dense_matmul_stacked",)),
    ("tiny_llama_d64", "tiny-llama-debug", [],
     tuple(f"{k}[d64]" for k in ATTN_KERNELS)),
    ("micro_llama_d32", "micro-llama-debug", [],
     tuple(f"{k}[d32]" for k in ATTN_KERNELS)),
]
# the kernels line's rows beyond the first case of each kernel: a variant
# and the phase whose launches it reports (its main path)
VARIANT_ROWS = [
    ("attend_decode_fused[latent]", "r1_bf16"),
    ("attend_prefill[latent]", "r1_bf16"),
    *((k, "llama_fp8_kv") for k in E4M3),
    *((k, "r1_fp8_kv") for k in LATENT_E4M3),
    *((k, "r1_dense") for k in D192),
    ("attend_decode_fused[d64]", "tiny_llama_d64"),
    ("attend_prefill[d64]", "tiny_llama_d64"),
    *((f"{k}[d32]", "micro_llama_d32") for k in ATTN_KERNELS),
    ("dense_matmul_stacked", "llama_dense_kernel"),
]


# ---------------------------------------------------------------------------
# Slice 11: checkpoints read from disk
# ---------------------------------------------------------------------------

GROUP = 128  # AWQ / GPTQ group of the int4 checkpoints
FILE_BYTES = 4 << 30  # a checkpoint file holds tensors up to about this


def draw(torch, dev, name, shape, kind):
    """One tensor of a checkpoint, from a generator seeded by its name, on
    the card: the same name gives the same bytes every time, so a leaf
    that was written can be drawn again to check what was read."""
    g = torch.Generator(device=dev)
    g.manual_seed(zlib.crc32(name.encode()))
    r = lambda: torch.randn(shape, generator=g, device=dev)
    if kind == "w":
        return (r() * 0.02).to(torch.bfloat16)
    if kind == "norm":
        return (1.0 + 0.1 * r()).to(torch.bfloat16)
    if kind == "f32":  # DeepSeek's e_score_correction_bias
        return 0.1 * r()
    if kind == "e4m3":  # spread over the e4m3 range, as a published weight
        return (r() * 64).clamp(-448, 448).to(torch.float8_e4m3fn)
    if kind == "scale_inv":  # weight ~ e4m3 * scale_inv ~ 0.02
        return 2e-4 * (0.5 + torch.rand(shape, generator=g, device=dev))
    if kind == "nibble":
        return torch.randint(0, 16, shape, generator=g, device=dev, dtype=torch.int8)
    if kind == "zero":  # 1..15: GPTQ stores zero - 1 in a nibble
        return torch.randint(1, 16, shape, generator=g, device=dev).float()
    if kind == "wscale":  # f16 values, so the f16 file holds them exactly
        s = 0.001 + 0.004 * torch.rand(shape, generator=g, device=dev)
        return s.to(torch.float16).float()
    if kind == "gidx":  # a group of GROUP rows each, rows shuffled
        K = shape[0]
        return (torch.arange(K, device=dev) // GROUP)[
            torch.randperm(K, generator=g, device=dev)]
    raise ValueError(kind)


def proj_tensors(torch, dev, name, out, inp, fmt, g_key=None):
    """The checkpoint tensors of one projection `name` ([out, in] in the
    HF layout) in format `fmt`: bf16, e4m3 + weight_scale_inv, AWQ or GPTQ
    (g_key: the draw of a g_idx the projection shares; None: identity)."""
    from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind
    from chitu_tpu_torch.quantize import packed

    if fmt == "bf16":
        return {f"{name}.weight": draw(torch, dev, f"{name}.weight", (out, inp), "w")}
    if fmt == "fp8":
        return {
            f"{name}.weight": draw(torch, dev, f"{name}.weight", (out, inp), "e4m3"),
            f"{name}.weight_scale_inv": draw(
                torch, dev, f"{name}.weight_scale_inv",
                (-(-out // 128), -(-inp // 128)), "scale_inv"),
        }
    data = draw(torch, dev, f"{name}.data", (inp, out), "nibble")
    zeros = draw(torch, dev, f"{name}.zeros", (inp // GROUP, out), "zero")
    scales = draw(torch, dev, f"{name}.scales", (inp // GROUP, out), "wscale")
    if fmt == "awq":
        parts = packed.pack_awq(QTensor(data=data, scale=scales, zeros=zeros,
                                        kind=QuantKind.W4A16, block=GROUP))
    else:
        g = (draw(torch, dev, g_key, (inp,), "gidx") if g_key
             else torch.arange(inp, device=dev) // GROUP)
        parts = packed.pack_gptq(data, zeros, scales, g_idx=g)
    return {f"{name}.{k}": v for k, v in parts.items()}


def proj_leaf(torch, dev, name, out, inp, fmt, g_key=None):
    """What the loader should make of `proj_tensors(...)`: [in, out] bf16,
    or a QTensor with the e4m3 bytes transposed and their scales, or the
    int4 values one a byte (rows sorted by group under an act-order
    g_idx, the sort as `in_perm`)."""
    from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind

    if fmt == "bf16":
        return draw(torch, dev, f"{name}.weight", (out, inp), "w").T.contiguous()
    if fmt == "fp8":
        w = draw(torch, dev, f"{name}.weight", (out, inp), "e4m3")
        s = draw(torch, dev, f"{name}.weight_scale_inv",
                 (-(-out // 128), -(-inp // 128)), "scale_inv")
        return QTensor(data=w.view(torch.uint8).T.contiguous().view(w.dtype),
                       scale=s.T.contiguous(), kind=QuantKind.SOFT_FP8, block=128)
    data = draw(torch, dev, f"{name}.data", (inp, out), "nibble")
    q = QTensor(data=data,
                scale=draw(torch, dev, f"{name}.scales", (inp // GROUP, out), "wscale"),
                zeros=draw(torch, dev, f"{name}.zeros", (inp // GROUP, out), "zero"),
                kind=QuantKind.W4A16, block=GROUP)
    if fmt == "gptq" and g_key:
        perm = torch.argsort(draw(torch, dev, g_key, (inp,), "gidx"), stable=True)
        q.data, q.in_perm = data[perm], perm.to(torch.int32)
    return q


def _cat(torch, parts):
    """Projection leaves side by side along the out dim (the merged
    wqkv / w_gate_up of the llama family)."""
    from chitu_tpu_torch.ops.qtensor import QTensor

    if not isinstance(parts[0], QTensor):
        return torch.cat(parts, dim=-1)
    c = lambda n: torch.cat([getattr(p, n) for p in parts], dim=-1)
    return QTensor(data=c("data"), scale=c("scale"), zeros=c("zeros"),
                   kind=parts[0].kind, block=parts[0].block, in_perm=parts[0].in_perm)


def _stack(torch, items):
    from chitu_tpu_torch.ops.qtensor import TENSOR_FIELDS, QTensor

    if not isinstance(items[0], QTensor):
        return torch.stack(items)
    kw = {n: (None if getattr(items[0], n) is None
              else torch.stack([getattr(q, n) for q in items])) for n in TENSOR_FIELDS}
    return QTensor(kind=items[0].kind, block=items[0].block, **kw)


def llama_ckpt(torch, dev, m, fmt):
    """A Llama checkpoint in HF naming as (name, make) groups in file
    order (make() -> its tensors), and the tree the loader should build
    from it (merged q/k/v and gate/up)."""
    V, D, H, KV, F = m.vocab_size, m.dim, m.n_heads, m.n_kv_heads, m.inter_dim
    Dh = m.head_dim or D // H
    groups = [("model.embed_tokens.weight", lambda: {
        "model.embed_tokens.weight": draw(torch, dev, "model.embed_tokens.weight", (V, D), "w")})]
    attn = (("q", H * Dh, D), ("k", KV * Dh, D), ("v", KV * Dh, D), ("o", D, H * Dh))
    ffn = (("gate", F, D), ("up", F, D), ("down", D, F))
    for i in range(m.n_layers):
        p = f"model.layers.{i}"
        for n in ("input_layernorm", "post_attention_layernorm"):
            groups.append((f"{p}.{n}", lambda k=f"{p}.{n}.weight": {
                k: draw(torch, dev, k, (D,), "norm")}))
        for blk, projs in (("self_attn", attn), ("mlp", ffn)):
            for x, out, inp in projs:
                # act-order GPTQ: q/k/v share one g_idx, gate/up another
                g_key = (f"{p}.{blk}.g_idx" if fmt == "gptq" and x not in ("o", "down")
                         else None)
                groups.append((f"{p}.{blk}.{x}_proj", lambda a=(
                    f"{p}.{blk}.{x}_proj", out, inp, fmt, g_key):
                    proj_tensors(torch, dev, *a)))
    groups += [("model.norm.weight", lambda: {
        "model.norm.weight": draw(torch, dev, "model.norm.weight", (D,), "norm")}),
               ("lm_head.weight", lambda: {
                   "lm_head.weight": draw(torch, dev, "lm_head.weight", (V, D), "w")})]

    def tree():
        def leaf(i, blk, x):
            out, inp = {"q": (H * Dh, D), "k": (KV * Dh, D), "v": (KV * Dh, D),
                        "o": (D, H * Dh), "gate": (F, D), "up": (F, D),
                        "down": (D, F)}[x]
            p = f"model.layers.{i}.{blk}"
            g_key = f"{p}.g_idx" if fmt == "gptq" and x not in ("o", "down") else None
            return proj_leaf(torch, dev, f"{p}.{x}_proj", out, inp, fmt, g_key)

        L = range(m.n_layers)
        norm = lambda n: torch.stack([draw(torch, dev, f"model.layers.{i}.{n}.weight",
                                           (D,), "norm") for i in L])
        return {
            "embed": draw(torch, dev, "model.embed_tokens.weight", (V, D), "w"),
            "norm": draw(torch, dev, "model.norm.weight", (D,), "norm"),
            "lm_head": draw(torch, dev, "lm_head.weight", (V, D), "w").T.contiguous(),
            "layers": {
                "attn_norm": norm("input_layernorm"),
                "ffn_norm": norm("post_attention_layernorm"),
                "wqkv": _stack(torch, [_cat(torch, [leaf(i, "self_attn", x) for x in "qkv"])
                                       for i in L]),
                "wo": _stack(torch, [leaf(i, "self_attn", "o") for i in L]),
                "w_gate_up": _stack(torch, [_cat(torch, [leaf(i, "mlp", x)
                                                         for x in ("gate", "up")]) for i in L]),
                "w_down": _stack(torch, [leaf(i, "mlp", "down") for i in L]),
            },
        }

    return groups, tree


def r1_ckpt(torch, dev, m):
    """DeepSeek-R1 laid out as its published checkpoint is: every
    projection and expert in e4m3 with an f32 weight_scale_inv; embed,
    head, norms and router in bf16; e_score_correction_bias in f32. ->
    (name, make) groups and the tree the loader should build."""
    mo, ml = m.moe, m.mla
    V, D, H, E, Fm, Fd = (m.vocab_size, m.dim, m.n_heads, mo.n_routed_experts,
                          mo.moe_inter_dim, m.inter_dim)
    Fs = Fm * max(mo.n_shared_experts, 1)
    qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
    attn = [("q_a_proj", "wq_a", ml.q_lora_rank, D),
            ("q_b_proj", "wq_b", H * qk, ml.q_lora_rank),
            ("kv_a_proj_with_mqa", "wkv_a", ml.kv_lora_rank + ml.qk_rope_head_dim, D),
            ("kv_b_proj", "wkv_b", H * (ml.qk_nope_head_dim + ml.v_head_dim),
             ml.kv_lora_rank),
            ("o_proj", "wo", D, H * ml.v_head_dim)]
    norms = [("input_layernorm", "attn_norm", D), ("post_attention_layernorm", "ffn_norm", D),
             ("self_attn.q_a_layernorm", "q_norm", ml.q_lora_rank),
             ("self_attn.kv_a_layernorm", "kv_norm", ml.kv_lora_rank)]
    dense_mlp = [("gate_proj", "w_gate", Fd, D), ("up_proj", "w_up", Fd, D),
                 ("down_proj", "w_down", D, Fd)]
    moe_mlp = [("gate_proj", "gate", Fm, D), ("up_proj", "up", Fm, D),
               ("down_proj", "down", D, Fm)]
    one = lambda k, shape, kind: (k, lambda: {k: draw(torch, dev, k, shape, kind)})
    fp8 = lambda n, out, inp: (n, lambda: proj_tensors(torch, dev, n, out, inp, "fp8"))
    groups = [one("model.embed_tokens.weight", (V, D), "w")]
    for i in range(m.n_layers):
        p = f"model.layers.{i}"
        groups += [one(f"{p}.{hf}.weight", (n,), "norm") for hf, _, n in norms]
        groups += [fp8(f"{p}.self_attn.{hf}", o, n) for hf, _, o, n in attn]
        if i < mo.n_dense_layers:
            groups += [fp8(f"{p}.mlp.{hf}", o, n) for hf, _, o, n in dense_mlp]
            continue
        groups += [one(f"{p}.mlp.gate.weight", (E, D), "w"),
                   one(f"{p}.mlp.gate.e_score_correction_bias", (E,), "f32")]
        groups += [fp8(f"{p}.mlp.shared_experts.{hf}", o if o != Fm else Fs,
                       n if n != Fm else Fs) for hf, _, o, n in moe_mlp]
        groups += [fp8(f"{p}.mlp.experts.{e}.{hf}", o, n)
                   for e in range(E) for hf, _, o, n in moe_mlp]
    groups += [one("model.norm.weight", (D,), "norm"), one("lm_head.weight", (V, D), "w")]

    def tree():
        leaf = lambda n, o, i: proj_leaf(torch, dev, n, o, i, "fp8")

        def stack(layers):
            out = {ours: torch.stack([draw(torch, dev, f"model.layers.{i}.{hf}.weight",
                                           (n,), "norm") for i in layers])
                   for hf, ours, n in norms}
            for hf, ours, o, n in attn:
                out[ours] = _stack(torch, [leaf(f"model.layers.{i}.self_attn.{hf}", o, n)
                                           for i in layers])
            return out

        dense_l = list(range(mo.n_dense_layers))
        moe_l = list(range(mo.n_dense_layers, m.n_layers))
        dense = stack(dense_l)
        for hf, ours, o, n in dense_mlp:
            dense[ours] = _stack(torch, [leaf(f"model.layers.{i}.mlp.{hf}", o, n)
                                         for i in dense_l])
        moe_p = stack(moe_l)
        moe_p["moe_gate"] = torch.stack([
            draw(torch, dev, f"model.layers.{i}.mlp.gate.weight", (E, D), "w").T
            for i in moe_l])
        moe_p["gate_bias"] = torch.stack([
            draw(torch, dev, f"model.layers.{i}.mlp.gate.e_score_correction_bias",
                 (E,), "f32") for i in moe_l])
        for hf, x, o, n in moe_mlp:
            so, sn = (Fs if o == Fm else o), (Fs if n == Fm else n)
            moe_p[f"shared_{x}"] = _stack(torch, [
                leaf(f"model.layers.{i}.mlp.shared_experts.{hf}", so, sn) for i in moe_l])
            moe_p[f"exp_{x}"] = _stack(torch, [_stack(torch, [
                leaf(f"model.layers.{i}.mlp.experts.{e}.{hf}", o, n) for e in range(E)])
                for i in moe_l])
        return {
            "embed": draw(torch, dev, "model.embed_tokens.weight", (V, D), "w"),
            "norm": draw(torch, dev, "model.norm.weight", (D,), "norm"),
            "lm_head": draw(torch, dev, "lm_head.weight", (V, D), "w").T.contiguous(),
            "dense_layers": dense,
            "moe_layers": moe_p,
        }

    return groups, tree


def write_checkpoint(torch, groups, d, files=None):
    """Write the groups' tensors with the port's own writer into `d`, file
    by file (HF sharded naming and a model.safetensors.index.json): a
    file's tensors are drawn on the card, written and dropped before the
    next; `files` fixes the file count, else a file holds about
    FILE_BYTES. Each file is synced and dropped from the page cache, so
    the load reads the disk. -> bytes written."""
    from chitu_tpu_torch.utils.safetensors import save_file

    os.makedirs(d, exist_ok=True)
    chunks, cur, size = [], [], 0
    for name, make in groups:
        cur.append(make)
        if files is None:
            t = make()
            size += sum(v.numel() * v.element_size() for v in t.values())
            del t
            if size >= FILE_BYTES:
                chunks.append(cur)
                cur, size = [], 0
    if cur:
        chunks.append(cur)
    if files is not None:
        per = -(-len(groups) // files)
        chunks = [[mk for _, mk in groups[i:i + per]] for i in range(0, len(groups), per)]
    weight_map, total = {}, 0
    for j, makes in enumerate(chunks):
        fname = f"model-{j + 1:05d}-of-{len(chunks):05d}.safetensors"
        tensors = {}
        for mk in makes:
            tensors.update(mk())
        path = os.path.join(d, fname)
        save_file(tensors, path)
        weight_map.update({k: fname for k in tensors})
        total += sum(v.numel() * v.element_size() for v in tensors.values())
        del tensors
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return total


MERGED = {"wq_kv_a": ("wq_a", "wkv_a"), "shared_gu": ("shared_gate", "shared_up"),
          "exp_gu": ("exp_gate", "exp_up")}


def _leaf_equal(torch, got, want):
    """Byte equality of two leaves; QTensors field by field, packed int4
    compared one nibble a byte."""
    from chitu_tpu_torch.ops.qtensor import TENSOR_FIELDS, QTensor, unpack_int4

    if isinstance(want, QTensor):
        if not isinstance(got, QTensor) or (got.kind, got.block) != (want.kind, want.block):
            return False
        got = unpack_int4(got) if got.packed else got
        return all(
            (getattr(got, n) is None) == (getattr(want, n) is None)
            and (getattr(want, n) is None
                 or _leaf_equal(torch, getattr(got, n), getattr(want, n)))
            for n in TENSOR_FIELDS)
    raw = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    return (not isinstance(got, QTensor) and got.dtype == want.dtype
            and tuple(got.shape) == tuple(want.shape)
            and torch.equal(raw(got), raw(want)))


def _split(got, widths, scale_widths):
    """A merged leaf's parts along the out dim (data, and scale at the
    scales' widths)."""
    from chitu_tpu_torch.ops.qtensor import QTensor

    out, o, so = [], 0, 0
    for w, sw in zip(widths, scale_widths):
        out.append(QTensor(data=got.data[..., o:o + w], scale=got.scale[..., so:so + sw],
                           kind=got.kind, block=got.block))
        o, so = o + w, so + sw
    return out


def loaded_leaves_equal(torch, got, want, path=""):
    """-> the paths of the engine's leaves (`got`: its params tree, MoE
    gate/up merged by the engine) that differ from what was written
    (`want`: the tree the loader should build)."""
    bad = []
    for k, g in got.items():
        if isinstance(g, dict):
            bad += loaded_leaves_equal(torch, g, want[k], f"{path}{k}/")
        elif k in MERGED and k not in want:
            parts = [want[p] for p in MERGED[k]]
            for p, w, name in zip(_split(g, [w.data.shape[-1] for w in parts],
                                         [w.scale.shape[-1] for w in parts]), parts, MERGED[k]):
                if not _leaf_equal(torch, p, w):
                    bad.append(f"{path}{k}[{name}]")
        elif k not in want or not _leaf_equal(torch, g, want[k]):
            bad.append(f"{path}{k}")
    return bad


def greedy_tokens(np, eng, vocab):
    """Greedy tokens of three prompts (16 new each) submitted together."""
    from chitu_tpu_torch import SampleParams

    rng = np.random.default_rng(23)
    reqs = [eng.submit("", SampleParams(temperature=0.0, max_new_tokens=16),
                       prompt_tokens=[int(x) for x in rng.integers(1, vocab, size=n)])
            for n in (30, 90, 200)]
    eng.run_until_complete()
    return [list(r.async_stream.tokens) for r in reqs]


def ppl_kernels_vs_plain(torch, np, tk, eng):
    """`evals.perplexity_from_tokens` over 1,024 tokens (windows of 512,
    stride 256), first through the kernels, then the same model through
    `infer.attn_type=ref infer.op_impl=xla`; the attention kernel must
    launch in the first and none in the second."""
    from chitu_tpu_torch import evals
    from chitu_tpu_torch.ops import linear

    rng = np.random.default_rng(31)
    toks = [int(x) for x in rng.integers(1, eng.cfg.models.vocab_size, size=1024)]
    tk.reset_launch_counts()
    t0 = time.time()
    got = evals.perplexity_from_tokens(eng, toks, window=512, stride=256)
    torch.cuda.synchronize()
    t_k = time.time() - t0
    launched = dict(tk.LAUNCHES)
    route = eng.model.attn_route, eng.model.attn
    eng.model.attn_route, eng.model.attn = tk.attention_route("ref")
    linear.set_op_impl("xla")
    try:
        tk.reset_launch_counts()
        t0 = time.time()
        want = evals.perplexity_from_tokens(eng, toks, window=512, stride=256)
        torch.cuda.synchronize()
        t_p = time.time() - t0
        off = routed_off(tk, ROUTED_OFF)
    finally:
        eng.model.attn_route, eng.model.attn = route
        linear.set_op_impl("auto")
    if off:
        raise AssertionError(f"evals: the plain route launched kernels: {off}")
    if launched.get("attend_prefill", 0) <= 0:
        raise AssertionError("evals: the kernel route launched no attend_prefill")
    rel = abs(got - want) / want
    if not (math.isfinite(got) and rel < PPL_RTOL):
        raise AssertionError(f"evals: perplexity {got} through the kernels, {want} "
                             f"plain (relative {rel:.2e}, limit {PPL_RTOL})")
    return dict(ppl_kernels=got, ppl_plain=want, ppl_rel_diff=rel, ppl_kernels_s=t_k,
                ppl_plain_s=t_p, ppl_launches=launched)


# the two perplexities of one model through the kernels and their plain
# versions: each window's logits differ by the rounding of two sound bf16
# forwards (LOGITS_RTOL per row at most), which moves a mean
# log-probability by far less
PPL_RTOL = 1e-3
R1_FP8_NEED = tuple(k for k in MLA_KERNELS if k != "absorb_matmul") + ("quant_gemm",)
LOAD_PHASES = [
    # (label, model card, overrides, checkpoint format, kernels that must
    # have launched). Full width; depth cut to what the checkpoint's disk
    # and the card hold.
    ("load_llama_hf", LLAMA, ["models.n_layers=8"], "bf16", ATTN_KERNELS),
    ("load_llama_awq", LLAMA, ["models.n_layers=4", "quant.method=w4a16"], "awq",
     ATTN_KERNELS + ("quant_gemm",)),
    ("load_llama_gptq", LLAMA, ["models.n_layers=4", "quant.method=w4a16"], "gptq",
     ATTN_KERNELS + ("quant_gemm",)),
    ("load_r1_fp8", R1, ["models.n_layers=4"], "fp8", R1_FP8_NEED),
]


def load_phases(torch, np, tk, card, root):
    """Slice 11's phases: each writes a checkpoint from seeded draws with
    the port's writer into `root`, serves it through `engine_phase` with
    `infer.do_load=true models.ckpt_dir=<dir>` and checks that every
    loaded leaf equals what was written, byte for byte, and that its
    greedy tokens equal those of an engine handed the same tree in memory
    (`Engine(cfg, params=...)`); then the AWQ engine's tree is dumped with
    `save_preprocessed` and served again with `skip_preprocess=true`, and
    the evals phase runs on the HF Llama engine. -> launches by phase."""
    import shutil

    from chitu_tpu_torch import load_config
    from chitu_tpu_torch.engine import Engine
    from chitu_tpu_torch.loader import save_preprocessed

    dev = torch.device("cuda", 0)
    out, tokens = {}, {}
    for label, model, ovr, fmt, need in LOAD_PHASES:
        m = load_config(overrides=[f"models={model}", *ovr]).models
        if fmt == "fp8":
            groups, tree = r1_ckpt(torch, dev, m)
            nbytes = sum(sum(v.numel() * v.element_size() for v in mk().values())
                         for _, mk in groups)
            free = shutil.disk_usage(root).free
            if free < nbytes * 1.1:
                # the checkpoint's disk decides the depth: deepseek-mid-bench
                # keeps R1's layer kinds at a quarter of the bytes
                print(f"[{label}] {nbytes / 1e9:.1f} GB of checkpoint do not fit "
                      f"{free / 1e9:.1f} GB free: deepseek-mid-bench instead", flush=True)
                model, ovr = "deepseek-mid-bench", []
                m = load_config(overrides=[f"models={model}"]).models
                groups, tree = r1_ckpt(torch, dev, m)
        else:
            groups, tree = llama_ckpt(torch, dev, m, fmt)
        d = os.path.join(root, label)
        t0 = time.time()
        nbytes = write_checkpoint(torch, groups, d, files=2 if fmt == "bf16" else None)
        write_s = time.time() - t0
        print(f"[{label}] wrote {nbytes / 1e9:.2f} GB in {write_s:.1f} s "
              f"({len(os.listdir(d)) - 1} files, {d})", flush=True)
        load = ["infer.do_load=true", f"models.ckpt_dir={d}"]

        def after(eng, label=label, nbytes=nbytes, tree=tree):
            b = BRINGUP[label]
            stats = dict(ckpt_gb=nbytes / 1e9, write_s=write_s, load_s=b["bringup_s"],
                         read_gbps=nbytes / 1e9 / b["bringup_s"],
                         load_peak_gib=b["peak_gib"], resident_gib=b["resident_gib"],
                         host_start_gib=b["host_start_gib"],
                         host_peak_gib=b["host_peak_gib"],
                         host_maxrss_gib=b["host_maxrss_gib"])
            want = tree()
            bad = loaded_leaves_equal(torch, eng.model.params_tree(), want)
            del want
            torch.cuda.empty_cache()
            if bad:
                raise AssertionError(f"[{label}] loaded leaves differ from what was "
                                     f"written: {bad}")
            tokens[label] = greedy_tokens(np, eng, eng.cfg.models.vocab_size)
            if label == "load_llama_hf":
                ev = ppl_kernels_vs_plain(torch, np, tk, eng)
                print("evals " + json.dumps(dict(phase="evals", card=card, **ev)),
                      flush=True)
                stats.update(ev)
            if label == "load_llama_awq":
                t0 = time.time()
                save_preprocessed(eng.model.params_tree(),
                                  os.path.join(d, "chitu_tpu_preprocessed"),
                                  layout={"merge_tp": 1})
                stats["preprocessed_save_s"] = time.time() - t0
            if label == "load_r1_fp8":
                on_load = BRINGUP.get("r1_soft_fp8", {})
                stats["model"] = eng.cfg.models.name
                stats["r1_soft_fp8_on_load_peak_gib"] = on_load.get("peak_gib")
            print("load " + json.dumps(dict(phase=label, card=card, **stats)), flush=True)
            return stats

        out[label] = engine_phase(torch, np, tk, card, label, ovr + load, need=need,
                                  model=model, after=after)
        # the same tree handed over in memory
        cfg = load_config(overrides=[f"models={model}", "infer.stop_with_eos=false", *ovr])
        eng = Engine(cfg, params=tree())
        same = greedy_tokens(np, eng, cfg.models.vocab_size)
        eng.terminate()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        if same != tokens[label]:
            raise AssertionError(f"[{label}] greedy tokens of the loaded engine "
                                 f"{tokens[label]} differ from the in-memory tree's {same}")
        print(f"[{label}] loaded leaves byte-equal to the written ones; greedy tokens "
              f"equal to the in-memory tree's", flush=True)
        if label == "load_llama_awq":
            pre = ovr + load + ["skip_preprocess=true"]

            def after_pre(eng, tree=tree):
                bad = loaded_leaves_equal(torch, eng.model.params_tree(), tree())
                torch.cuda.empty_cache()
                if bad:
                    raise AssertionError(f"[load_preprocessed] leaves differ: {bad}")
                toks = greedy_tokens(np, eng, eng.cfg.models.vocab_size)
                if toks != tokens["load_llama_awq"]:
                    raise AssertionError("[load_preprocessed] greedy tokens differ "
                                         "from the AWQ checkpoint's")
                b = BRINGUP["load_preprocessed"]
                dump = os.path.join(d, "chitu_tpu_preprocessed")
                gb = sum(os.path.getsize(os.path.join(dump, f)) for f in os.listdir(dump)) / 1e9
                stats = dict(ckpt_gb=gb, load_s=b["bringup_s"],
                             read_gbps=gb / b["bringup_s"], load_peak_gib=b["peak_gib"],
                             resident_gib=b["resident_gib"],
                             host_start_gib=b["host_start_gib"],
                             host_peak_gib=b["host_peak_gib"],
                             host_maxrss_gib=b["host_maxrss_gib"])
                print("load " + json.dumps(dict(phase="load_preprocessed", card=card,
                                                **stats)), flush=True)
                return stats

            out["load_preprocessed"] = engine_phase(
                torch, np, tk, card, "load_preprocessed", pre, need=need, model=model,
                after=after_pre)
        shutil.rmtree(d, ignore_errors=True)
    return out


def row_key(res):
    v = res.get("variant")
    return res["kernel"] if v in (None, "bf16", "split") else f"{res['kernel']}[{v}]"


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    from chitu_tpu_torch.models import moe
    from chitu_tpu_torch.ops import absorb_kernels as ab
    from chitu_tpu_torch.ops import attention as plain
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chitu_tpu_torch.ops import dense_gemm_kernels as dg
    from chitu_tpu_torch.ops import linear
    from chitu_tpu_torch.ops import moe_gemm_kernels as mg
    from chitu_tpu_torch.ops import norm_quant as nq
    from chitu_tpu_torch.ops import quant_gemm_kernels as qg
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

    t_main = time.time()
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
    first, by_row = {}, {}
    t0 = time.time()
    with torch.no_grad():
        for cases in (kernel_cases(torch, tk, plain, dev),
                      quant_kernel_cases(torch, qg, qt, QuantKind, dev),
                      acts_cases(torch, nq, dev),
                      moe_kernel_cases(torch, np, mg, moe, qt, QuantKind, dev),
                      absorb_cases(torch, ab, dev),
                      mla_attention_cases(torch, tk, plain, dev),
                      kernel_cases(torch, tk, plain, dev, kv="e4m3"),
                      mla_attention_cases(torch, tk, plain, dev, kv="e4m3"),
                      split_head_cases(torch, tk, plain, dev, "R1", 128, 128,
                                       192, ATTN_WRAPPERS, scale=R1_SCALE),
                      split_head_cases(torch, tk, plain, dev,
                                       "tiny-llama-debug", 32, 4, 64,
                                       ("attend_decode_fused", "attend_prefill")),
                      kernel_cases(torch, tk, plain, dev,
                                   geom=(4, 2, 32, "d32")),
                      dense_gemm_cases(torch, dg, dev)):
            for res in cases:
                res["card"] = card
                if res.get("bound_by") == "bytes" and any(
                        res.get(k) is not None and res[k] < res["bound_ms"]
                        for k in ("ms", "library_ms")):
                    res["l2_resident"] = True
                print("case " + json.dumps(res), flush=True)
                first.setdefault(res["kernel"], res)
                by_row.setdefault(row_key(res), res)
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
    # infer.attn_type=ref infer.op_impl=xla: no kernel of either launches
    engine_phase(torch, np, tk, card, "plain_route", PLAIN_ROUTE,
                 lens=(40, 100, 200), new_tokens=8, need=(),
                 forbid=ROUTED_OFF)
    # MoE serving: the grouped GEMM's launches are those of the soft-fp8
    # Mixtral-8x7B burst
    for label, model, ovr, need in MOE_PHASES:
        got = engine_phase(torch, np, tk, card, label, ovr,
                           need=ATTN_KERNELS + need, model=model)
        if label == "mixtral_soft_fp8":
            launches["grouped_gemm"] = got["grouped_gemm"]
    engine_phase(
        torch, np, tk, card, "mixtral_fp8_e4m3",
        ["quant.method=fp8", "quant.fp8_act=e4m3"] + quant + ["models.n_layers=4"],
        lens=(40, 100, 200), new_tokens=8,
        need=ATTN_KERNELS + ("grouped_gemm", "quant_gemm"), check_plain=True,
        model=MIXTRAL,
    )
    # DeepSeek serving: B3, B4 and B9 report the launches of the bf16
    # DeepSeek-R1 burst
    for label, model, ovr, need in MLA_PHASES:
        got = engine_phase(torch, np, tk, card, label, ovr,
                           need=MLA_KERNELS + need, model=model)
        if label == "r1_bf16":
            r1_launches = got
            for k in ("attend_prefill_packed", "attend_decode", "absorb_matmul"):
                launches[k] = got[k]
    engine_phase(
        torch, np, tk, card, "r1_fp8_e4m3",
        ["quant.method=fp8", "quant.fp8_act=e4m3"] + quant + ["models.n_layers=4"],
        lens=(40, 100, 200), new_tokens=8,
        need=MLA_KERNELS + ("quant_gemm",), check_plain=True, model=R1,
    )
    # slice 5: each phase's burst, then a shadowed one
    phase = {"r1_bf16": r1_launches}
    for label, model, ovr, need in SLICE5_PHASES:
        linear.set_dense_kernel(label == "llama_dense_kernel")
        try:
            phase[label] = engine_phase(torch, np, tk, card, label, ovr,
                                        need=need, model=model, shadow=True)
        finally:
            linear.set_dense_kernel(False)

    # slice 11: checkpoints read from disk, in a directory deleted after
    root = tempfile.mkdtemp(prefix="chitu_ckpt_")
    try:
        phase.update(load_phases(torch, np, tk, card, root))
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)

    print(f"chip_smoke total {time.time() - t_main:.1f} s", flush=True)
    rows = []

    def row(name, r, n):
        if n <= 0:
            raise AssertionError(f"kernel {name} has no launches to report")
        rows.append(dict(
            name=name, route=r["route"], source=r["source"],
            replaces=r["replaces"], launches=n,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("ms_cold", "library_ms_cold") if r.get(k) is not None},
        ))

    for kname in KERNEL_ORDER:
        row(kname, first[kname], launches.get(kname, 0))
    for key, label in VARIANT_ROWS:
        row(key, by_row[key], phase[label].get(key, 0))
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
