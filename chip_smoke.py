#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`chitu_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each fatal on failure:
1. Card: name and power limit; TF32 off; build the CUDA kernels from
   `chitu_tpu_torch/csrc/` (nvcc, sm_90a) and the native page allocator
   (`csrc/hostops.cpp`, g++), and report both build times.
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
   Slice 12's geometries at Llama-3-8B's shapes, held the same way (two
   launches and a graph replay bit-equal too): B3 as `verify_draft` packs
   a spec verify round (16 rows of K1 = 5 tokens, one block a row at
   `block_qstart` = the row's context of 300-2,000 tokens, one dead row)
   and B2 with three prefix-cache hit tails of 40, 150 and 300 tokens
   whose blocks start at 1,024 on a 16-page prefix the rows share.
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
   Then slice 12, each phase printing its page allocator (every engine
   without the prefix cache must run `NativeBackedPageAllocator`):
   `prefix_cache`, Llama-3-8B-Instruct at 32 layers, bf16, random
   weights, `infer.prefix_cache=true`: a cold burst of six prompts (one
   1,024-token prefix, tails of 40-300 tokens; no page hit, the chunked
   prefill), the same burst warm (each hits the 16 shared pages, B2 runs
   the tails from `block_qstart` 1,024 and `_prefill_one` is never
   called), a lone warm prompt (`_prefill_one` from 1,024: B5), the
   prefill device ms of the cold and the warm burst (torch.profiler over
   the step that prefills them), pages and slots back with the LRU
   counted; then the same weights at `infer.kv_pool_frac=0.01` (33
   pages): two stale prompts fill the LRU, a shared 128-token prefix is
   published, and eight requests of 200 new tokens outgrow the pool, so
   LRU eviction and preemption both fire (each counted, each > 0),
   against an uncached engine's tokens. `spec_decode`: the same weights
   with `infer.spec_decode=ngram infer.spec_k=4`: a greedy burst of six
   against the same burst with `executor.spec_enabled = False`, one
   sampled request that leaves `_spec_stats` as it was, tokens a verify
   round and B3's launches printed, one verify round with every attention
   call shadowed by its plain version; micro-llama-debug the same
   without the shadow (its two layers of random weights loop, so drafts
   must be accepted: more than one token a round); Mixtral-8x7B-Instruct-
   v0.1 bf16 at 4 layers the same (B3 and B8 must launch; the round with every GEMM
   call shadowed); DeepSeek-R1 bf16 at 4 layers (3 dense, 1 MoE) with the
   prefix cache and spec decode: a warm burst hits, the latent B3 runs its
   tails and spec decode falls back to windows (`_spec_stats` stays zero).
   Every token comparison of slice 12 follows the near-tie rule: a stream
   equal in full passes; otherwise, at its first divergent token, one
   teacher-forced prefill of prompt + reference through the kernels gives
   that position's logits row, and the two tokens' logits must lie within
   1e-2 of the row's spread (largest minus smallest logit) or within 3
   sigma, sigma being sqrt(2) x the rms difference between that row and
   the same row through the plain versions of every kernel (the Mixtral
   phase, where a router flip moves whole rows, takes 0.15 of the spread
   alone); every divergence is printed with its gap, and later tokens are
   not compared.
   Then slice 13. Tensor parallelism of Llama-3-8B-Instruct at full width:
   `tp2` (bf16, 4 layers), `tp2_soft_fp8` (`quant.method=soft_fp8
   quant.quant_on_load=true`, 4 layers: B6 runs on the shards) and `tp4`
   (2 layers, 2 KV heads a rank). Each phase first serves a burst of eight
   greedy requests (prompts of 128-1,024 tokens, `TP_NEW` new tokens
   each: seven through `Engine.submit`, one chat message) on a tp=1
   engine from the
   same seed, then starts N ranks of this script (`--tp-rank`) through the
   port's launcher (`parallel.distributed.spawn_ranks`), all on the one
   card over gloo (the backend is printed); every rank draws each leaf
   whole and keeps its slice, so the weights are the tp=1 engine's. Rank 0
   serves the same burst, the chat message over HTTP to a server on its
   engine, then one prefill and one decode step with every kernel call
   shadowed by its plain version (held to phase 2's limits); the other
   ranks follow it. Held: rank r's weight bytes are (total - replicated) /
   N + replicated (the norms, and per-channel scales of row-parallel
   weights) and its pool bytes total / N; the attention kernels (and B6 in
   soft-fp8) launched on rank 0; rank 0's streams equal the tp=1 streams
   or part at a near tie (the rule above, on the tp=1 engine's rows; the
   two engines batch the HTTP request differently and sum the row-parallel
   products in another order). A world is killed, every rank, when one
   fails or after 900 s. Every multi-rank phase's ranks start while the
   phase before it runs (`start_world`): they import and wait, touching
   nothing on the card, until that phase has ended. `awq`:
   Llama-3-8B-Instruct at 32 layers, random bf16 weights with 5 % of the
   embedding columns x 8 (the JAX test's planted outliers),
   `awq_quantize_llama_params` on 512 calibration tokens (wall seconds
   printed), the AWQ tree and RTN W4A16 of the same weights served
   through the engine (B7's int4 mode must launch), and against the bf16
   model's teacher-forced logits over 256 held-out tokens AWQ MSE <= 1.2
   x RTN MSE.
   Then slice 14. Pipeline parallelism, ranks sharing the card over gloo
   (`PP_PHASES`): `pp2` (Llama-3-8B-Instruct bf16, 8 layers), `pp2_tp2`
   (2 layers, four ranks), `pp2_mixtral` (Mixtral-8x7B bf16, 4 layers)
   and `pp2_r1` (DeepSeek-R1 bf16, 5 layers: 3 dense, 2 MoE). Each phase
   starts its world first (the ranks come up one after another, each
   drawing every leaf whole and keeping its stage's layers), serves the
   TP phases' burst from rank 0 and a lone request, then builds the
   one-rank engine from the same seed, fed the HTTP request's prompt
   tokens as the world saw them. Held: each rank's weight and pool bytes
   are its stage's share exactly (`stage_bytes`); the phase's kernels
   launched on every rank in the burst (rank 0 marks the burst's start
   and end in its step stream, which every rank applies in lockstep); the
   burst ran pipelined decode windows; at tp 1 the lone request (the
   sequential path at the one-rank shapes) gives the one-rank engine's
   tokens exactly, and the largest difference of its teacher-forced
   logits is printed; the burst's streams part from the one-rank streams
   only at near ties and hold at every position. An MoE card's decode
   routes some tokens to other experts than its teacher-forced prefill
   does, so its tokens are held to the largest share of the spread by
   which the one-rank engine's own streams lie below the top of its own
   teacher-forced rows, or 0.15 if larger.
   Then slice 15. Expert parallelism, ranks sharing the card over gloo
   (`EP_PHASES`, through `pp_phase`): `tp2_mixtral` (Mixtral-8x7B-Instruct
   bf16, 8 layers: 4 experts a rank), `tp2_r1` (DeepSeek-R1 bf16, 4
   layers, 3 dense and 1 MoE: 64 heads and 128 experts a rank),
   `tp4_r1_soft_fp8` (the same in soft-fp8 on four ranks: 32 heads and 64
   e4m3 experts a rank), `pp2_tp2_mixtral` (4 layers) and `pp2_tp2_r1` (5
   layers, 3 dense and 2 MoE), each held as the PP phases are (bytes
   from `stage_bytes`: experts and every other cut leaf / tp, the router,
   norms and latent down-projections whole, DeepSeek's latent pools whole
   over tp; B8 on every rank, and B9 and the latent B1 / B3 / B4 / B5 on
   the R1 phases; the streams to the MoE limit), and besides: every
   rank of a stage chose the same experts in every router call of the
   shadowed steps (a crc32 of the selections a call), and at every
   position the world's row lies within 3 sigma of the one-rank row
   unless the world and the one-rank engine chose other experts for its
   own token, or within NEIGHBOUR_SIGMAS when they did for one of the
   FLIP_REACH tokens before it (a router near tie that the all-reduce's
   summing order tips moves a row by a whole expert; every MoE layer's
   choices for every teacher-forced token are recorded on both sides),
   and the median row lies within 3 sigma. Phase
   2 holds the ranks' geometries too: B8 on rank 0's E / 2 and E / 4
   experts of DeepSeek-R1 (bf16 down, merged e4m3 gate / up) and
   Mixtral-8x7B (bf16 gate, merged e4m3) at T 16 and 512, about
   (tp - 1) / tp of the assignments on the dead expert; B9 at R1's 64
   heads a rank (its 32 at tp 4 are deepseek-mid-bench's geometry); the
   latent B4 / B1 and B5 at 64 heads.
   Then slice 16. Data parallelism, ranks sharing the card over gloo
   (`RING_PHASES`, through `pp_phase` with dp 2): `dp2_ring_kv`
   (Llama-3-8B-Instruct bf16, 32 layers, the ring KV pool),
   `dp2_ring_prefill` (32 layers, whole prompts of 2,048 and 4,096 tokens
   prefilled sequence-parallel over the two replicas), `dp2_tp2_ring_kv`
   and `dp2_pp2_ring_kv` (8 layers, four ranks) and `dp2_ring_kv_r1`
   (DeepSeek-R1 bf16, 4 layers: 3 dense, 1 MoE, whose tokens split over
   the replicas). Held as the PP phases are, and besides: each rank's
   weight bytes are those of its (stage, TP index) in one replica and,
   under the ring KV pool, its pool bytes that share over 2; no pipelined
   window ran; B1's partials mode and the decode merge launched on every
   rank of the Llama ring KV phases (their shadowed steps hold the
   partials against the plain partials mode, the appends byte-equal, and
   the merge of both ranks' splits against its plain version). Phase 2
   holds B1's partials mode and the merge of both ranks' splits on a ring
   rank's pages (`ring_kernel_cases`: the B1 batch, its pages striped
   over two ranks).
   Then slice 17 (`SLICE17_PHASES`: R1's dense MLA and Llama-3-8B W8A8
   at tp2, Llama-3-8B at pp3) and slice 18, the last layouts the port
   refused (`SLICE18_PHASES`, `SLICE18_RING`, through `pp_phase`):
   `tp2_qwen72_fp8` (Qwen2-72B-Instruct soft-fp8, 4 layers: each rank's
   `w_down`, gate and up cut inside block 115 of 128 rows, held to the
   whole blocks' bytes, `block_cut_bytes`), then on the same world rank
   0's server answers `/stop`, an `/init` of twice the world's ranks
   (400) and an `/init` of 2 bf16 layers that every rank builds
   (`world_reinit`), its streams held to the one-rank engine's on those
   overrides; `tp3_mixtral` and `tp3_r1` (Mixtral-8x7B and DeepSeek-R1,
   4 layers, three ranks: attention and its pool whole on every rank,
   experts 3 / 3 / 2 and 86 / 85 / 85); `dp2_pp2_ring_prefill`
   (Llama-3-8B, 4 layers, ring prefill of 2,048 and 4,096-token prompts
   on two replicas of two stages). Phase 2 holds B6 on a tp2 rank's
   whole-block slice of Qwen2-72B's `w_down` (`straddle_cases`: `[14848
   -> 8192]`, 64 zero rows of padding, T 16 and 512, both ranks' partials
   summed against one rank's product) and B8 on rank 0's uneven range
   (`EP3_MOE_STACKS`: 86 of 256 and 3 of 8 experts). Since slice 18 the
   multi-rank bursts decode `TP_NEW` = 32 tokens a stream and the earlier
   worlds run shallower (the phase tables say which), to hold the smoke
   within its limit.
4. One `kernels` JSON line (B1-B13: the first case of each kernel, B3, B4
   and B9 with the launches of the DeepSeek-R1 bf16 burst, then one row
   for each variant with the launches of the phase that is its main path:
   latent B1/B5 from R1 bf16, e4m3 from the fp8-KV phases, d192 from R1
   dense, d64 from tiny-llama-debug, d32 from micro-llama-debug, B13 from
   the dense-kernel phase; slice 12's B3 verify geometry with B3's
   launches in the `spec_decode` phase, and its B2 from 1,024 with B2's
   launches in the warm `prefix_cache` burst; slice 15's B8 at E / 2 and
   E / 4 experts, B9 and the latent B1 / B5 at 64 heads, with rank 0's
   launches in `tp2_r1` and `tp4_r1_soft_fp8`; slice 16's B1 partials
   mode on a ring rank's pages and the merge of both ranks' splits, with
   rank 0's launches in `dp2_ring_kv`; slice 17's and slice 18's
   geometries with rank 0's launches in the phase that runs them),
   then the card's name and power limit, then the device JSON as the last
   line.

It imports nothing of JAX or of `chitu_tpu`, exits non-zero without a
CUDA device, and fails when run outside a checkout of the repository.
"""

import contextlib
import functools
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
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

    # R1 at tp 2 holds 64 heads a rank; at tp 4, 32: mid's geometry
    for label, H, Ts in (("R1", 128, (16, 1, 128)), ("mid", 32, (16, 1, 128)),
                         ("R1_tp2", 64, (16, 128))):
        half_bytes = C * H * dn * 2  # what one call reads of its layer
        L = cold_layers(torch, dev, half_bytes, 8)
        w = torch.empty((L, C, H * (dn + dv)), dtype=bf, device=dev)
        for l in range(L):
            w[l] = randn(C, H * (dn + dv), s=0.02)
        wl = w[1].view(C, H, dn + dv)
        for T in Ts:
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
                if label == "R1_tp2":
                    res["variant"] = "h64"
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
                     cold=True, variant=variant):
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
            lib_ms, nbytes, flops, shape, variant=variant,
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
            lib_ms, nbytes + Bn * M * esz, flops, shape, variant=variant,
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
    def chunk_case(label, Hq, qc, variant=variant):
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
            replaces="chitu_tpu/ops/pallas_attention.py:1137", variant=variant)

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
    if not fp8:
        # ---- DeepSeek-R1 at tp 2: a rank's 64 heads (its latent pool whole;
        # at tp 4 its 32 heads are mid's geometry above) -------------------
        yield from decode_cases("R1_tp2", 64, randn(B, 64, QK), knew, seq, bts,
                                pool0, valid_f, cold=False, variant="latent,h64")
        yield chunk_case("R1_tp2", 64, randn(T, 64, QK), variant="latent,h64")
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
                     scale=None, variant=None):
    """B1 (fused), B4, B5 and B3 (those named in `kernels`) on the split
    layout at head size D: 16 decode rows of context up to 2047 (pages of
    64), a 512-token chunk at q_pos 512, and a packed slab of three prompts
    (256 tokens: the plain version gathers K and V a token at a time, 13 GB
    in f32 at 128 heads of 192). At DeepSeek's dense MLA (D 192) V lives in
    the first 128 of 192 lanes and the rest are zero, as the model pads
    it. Limits and yardsticks as in phase 2. `variant` names the rows
    (default `d<D>`)."""
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
    variant = variant or f"d{D}"

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


# B10 on a tp2 rank's slices of Llama-3-8B's row-parallel W8A8 inputs:
# wo [2048 -> 4096], w_down [7168 -> 4096]
PROJ_TP2 = [(2048, 4096), (7168, 4096)]


def int8_cases(torch, qg, dev, proj=None, ts=None, variant=None):
    """B10 at Llama-3-8B's W8A8 projection shapes (`proj`, default PROJ),
    T 16, 1, 512, 64 and 65 (`ts`; the first case, T 16 `[4096 -> 28672]`,
    is the one reported in the kernels line; `variant` names the rows of
    another set of shapes): the int32 sums equal the plain product's
    exactly, the scaled f32 output within 1e-5 of the plain row's norm
    (the same f32 arithmetic), a bf16 output with a bias within 1e-2; each
    checked output on memory filled with 7.0, two launches and a
    CUDA-graph replay bit-equal. Times warm and cold as B9's
    (`absorb_cases`): the weights of a stack of W8A8 layers sized by
    `cold_layers`. Library yardstick: `torch._int_mm`, warm and cold; it
    takes more than 16 rows only, so at T <= 16 it runs on the rows
    padded with zeros to 32 (`library_padded_to`)."""
    from chitu_tpu_torch.ops import norm_quant as nq
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    bf = torch.bfloat16

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    for K, N in proj or PROJ:
        L = cold_layers(torch, dev, K * N, 2)
        ws = [qt.quantize_weight(randn(K, N, s=0.02), QuantKind.W8A8)
              for _ in range(L)]
        w8 = ws[1]
        for T in ts or TS + [64, 65]:
            name = f"int8_gemm[T={T},{K}->{N}{',' + variant if variant else ''}]"
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
            # torch._int_mm takes more than 16 rows only
            xl = xa.data if T > 16 else torch.cat([xa.data, torch.zeros(
                (32 - T, K), dtype=torch.int8, device=dev)])
            lib = device_ms_sized(torch, lambda: torch._int_mm(xl, w8.data))
            lib_cold = device_ms_cold(torch, [
                (lambda w=w: torch._int_mm(xl, w.data)) for w in ws])
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
                library_padded_to=None if T > 16 else 32, variant=variant,
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
    yield from int8_cases(torch, qg, dev, PROJ_TP2, [16, 512], "tp2")


QWEN72_DOWN = (29568, 8192)  # Qwen2-72B's w_down, [inter -> dim]


def straddle_cases(torch, qg, qt, QuantKind, dev):
    """Slice 18: B6 on a tp2 rank's slice of Qwen2-72B's soft-fp8 `w_down`
    [29568 -> 8192], whose cut at row 14,784 falls inside block 115 of
    128 rows: each rank holds the 116 whole blocks over its rows,
    [14848 -> 8192], and its input is padded with 64 zeros over the rows
    it does not own (`ops.linear`; rank 1's zeros in front, rank 0's at
    the back). At T 16 and 512, the wrapper on rank 1's padded input and
    stored blocks against its plain version (ROW_RTOL a row, two launches
    and a graph replay bit-equal), and both ranks' partial products
    through `linear`, summed, against the one-rank product through B6
    (ROW_RTOL a row: the products' sums run in another order). Bound:
    the stored slice's bytes, x's and y's, against 2 T x 14848 x 8192
    operations (the kernel multiplies the padded rows too). Library:
    `torch.matmul` on the stored slice dequantized beforehand."""
    from chitu_tpu_torch.ops import linear
    from chitu_tpu_torch.parallel.sharding import shard_qtensor

    g = torch.Generator(device=dev)
    g.manual_seed(18)
    bf = torch.bfloat16
    K, N = QWEN72_DOWN
    w = (torch.randn((K, N), generator=g, device=dev) * 0.02).to(bf)
    q = qt.quantize_weight(w, QuantKind.SOFT_FP8)
    del w
    ranks = [shard_qtensor(q, ("tp", None), r, 2).contiguous() for r in range(2)]
    k = K // 2
    for T in (16, 512):
        x = torch.randn((T, K), generator=g, device=dev).to(bf)
        name = f"quant_gemm[e4m3_straddled,T={T},{k}+64->{N}]"
        parts = [linear.linear(x[:, r * k:(r + 1) * k], ranks[r],
                               out_dtype=torch.float32) for r in range(2)]
        whole = qg.quant_gemm(x, q)
        _row_rel(torch, name + " ranks summed", parts[0] + parts[1], whole,
                 ROW_RTOL)
        s = ranks[1]
        if s.rows != (64, 64 + k) or s.data.shape[-2] != k + 64:
            raise AssertionError(f"{name}: rank 1 holds rows {s.rows} of "
                                 f"{s.data.shape[-2]}")
        xp = torch.nn.functional.pad(x[:, k:], (64, 0)).contiguous()
        st = s.stored()
        poison(torch, (T, 2 * N), dev)
        got = qg.quant_gemm(xp, st)
        want = qg.quant_gemm_plain(xp, st)
        err, rel = _row_rel(torch, name, got, want, ROW_RTOL)
        bit_equal(torch, name, got, qg.quant_gemm(xp, st))
        replay_equal(torch, name, lambda: qg.quant_gemm(xp, st), got)
        Ks = st.data.shape[-2]
        nbytes = st.nbytes() + xp.numel() * 2 + T * N * 4
        bnd, by = bound_ms(nbytes, 2.0 * T * Ks * N)
        res = dict(name=name, kernel="quant_gemm", variant=f"straddled,T{T}",
                   route="cuda", source=QGEMM_SRC,
                   replaces="chitu_tpu/ops/pallas_quant_gemm.py:282",
                   max_abs_err=err, max_row_rel_err=rel, bound_ms=bnd,
                   bound_by=by,
                   shape=f"T={T} K={Ks} (rows {s.rows[0]}:{s.rows[1]} the "
                         f"rank's) N={N} mode=e4m3_blockwise "
                         f"weight_bytes={st.nbytes()}",
                   **plan_fields(qg.gemm_plan(xp, st)))
        res["ms"] = device_ms_sized(torch, lambda: qg.quant_gemm(xp, st))
        res["plain_ms"] = call_ms(torch, lambda: qg.quant_gemm_plain(xp, st),
                                  reps=5)
        wd = st.dequantize(bf)
        res["library_ms"] = device_ms_sized(torch, lambda: torch.matmul(xp, wd))
        del wd, parts, whole
        yield res
    del q, ranks
    torch.cuda.empty_cache()


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
    if hasattr(nq, "quant_acts_given"):
        for K, label in ((2048, "D"), (7168, "F")):  # wo's, w_down's at tp2
            for T in ACTS_TS[:2] + ACTS_TS[-1:]:
                yield from row_parallel_acts_cases(torch, nq, dev, g, T, K, label)
        # rows of ties, split over the two ranks
        yield from row_parallel_acts_cases(torch, nq, dev, g, 16, 7168, "F",
                                           whole=ties.to(dev),
                                           tag=f",ties={flips}")
    one = torch.zeros(1, device=dev)
    yield dict(name="launch_floor", kernel="launch_floor",
               ms=device_ms(torch, lambda: one.add_(1.0)),
               shape="one f32 element added in place")
    torch.cuda.empty_cache()


def row_parallel_acts_cases(torch, nq, dev, g, T, K, label, whole=None,
                            tag=""):
    """B12's row-parallel modes at one of the tp2 slices of Llama-3-8B's
    W8A8 row-parallel inputs (K of a [T, 2K] row: wo's 2048 of 4096,
    w_down's 7168 of 14336): `acts_absmax` on each half equals its plain
    version (a max, exact), and the max of the halves' is the whole row's;
    `quant_acts_given` on rank 0's half under that absmax is bit-equal to
    its plain version and to `quant_acts` (the one-rank B12) on the whole
    row, cut to the half: int8 values and scales, on memory filled with
    7.0; two launches and a CUDA-graph replay bit-equal. Times warm (the
    input was written just before on the main path)."""
    bf = torch.bfloat16
    if whole is None:
        whole = torch.randn((T, 2 * K), generator=g, device=dev).to(bf)
    halves = [whole[:, :K].contiguous(), whole[:, K:].contiguous()]
    x = halves[0]
    shape = f"T={T} {label}={K} of {2 * K}{tag}"
    poison(torch, (2 * T,), dev)
    parts = [nq.acts_absmax(h) for h in halves]
    for h, a in zip(halves, parts):
        if not torch.equal(a, nq.acts_absmax_plain(h)):
            raise AssertionError(f"acts_absmax[{shape}]: differs from plain")
    amax = torch.maximum(*parts)
    if not torch.equal(amax, nq.acts_absmax_plain(whole)):
        raise AssertionError(f"acts_absmax[{shape}]: the halves' max is not "
                             "the whole row's")
    run_a = lambda: nq.acts_absmax(x)  # noqa: E731
    bit_equal(torch, f"acts_absmax[{shape}]", parts[0], run_a())
    replay_equal(torch, f"acts_absmax[{shape}]", run_a, parts[0])
    bnd, by = bound_ms(T * K * 2 + T * 4, 0.0)
    yield dict(
        name=f"acts_absmax[{shape}]", kernel="acts_absmax", route="cuda",
        source=NQ_SRC, replaces="chitu_tpu/ops/pallas_norm_quant.py:107",
        max_abs_err=0.0, bit_equal_plain=True,
        ms=device_ms(torch, run_a),
        plain_ms=call_ms(torch, lambda: nq.acts_absmax_plain(x)),
        host_us=host_us(torch, run_a), bound_ms=bnd, bound_by=by,
        library_ms=device_ms(torch, lambda: torch.linalg.vector_norm(
            x, float("inf"), dim=-1, dtype=torch.float32)),
        shape=shape)

    def pack(a):
        return torch.cat([a.data.view(-1), a.scale.view(torch.int8)])

    run = lambda: nq.quant_acts_given(x, amax)  # noqa: E731
    poison(torch, (-(-T * K // 2),), dev)
    poison(torch, (2 * T,), dev)
    got = run()
    acts_equal(torch, f"quant_acts_given[{shape}]", got,
               nq.quant_acts_given_plain(x, amax))
    one = nq.quant_acts(whole)
    acts_equal(torch, f"quant_acts_given[{shape}] against the whole row", got,
               nq.QuantizedActs(data=one.data[:, :K].contiguous(),
                                scale=one.scale))
    bit_equal(torch, f"quant_acts_given[{shape}]", pack(got), pack(run()))
    replay_equal(torch, f"quant_acts_given[{shape}]", lambda: pack(run()),
                 pack(got))
    bnd, by = bound_ms(T * K * 3 + T * 8, 0.0)
    res = dict(
        name=f"quant_acts_given[{shape}]", kernel="quant_acts_given",
        route="cuda", source=NQ_SRC,
        replaces="chitu_tpu/ops/pallas_norm_quant.py:107",
        max_abs_err=0.0, bit_equal_plain=True, bit_equal_whole_row=True,
        ms=device_ms(torch, run),
        plain_ms=call_ms(torch, lambda: nq.quant_acts_given_plain(x, amax)),
        host_us=host_us(torch, run), bound_ms=bnd, bound_by=by,
        library_ms=None, shape=shape)
    p = nq.plan_for(x)
    res.update(regime=p.regime, cluster=p.cluster, threads=p.threads,
               rows=p.rows, vecs=p.vecs, grid=p.grid)
    yield res


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


# expert parallelism, rank 0's share: (label, experts of the whole model,
# K, N, e4m3?, top-k, tp)
EP_MOE_STACKS = [
    ("R1", 256, 2048, 7168, False, 8, 2), ("R1", 256, 7168, 4096, True, 8, 4),
    ("R1", 256, 7168, 4096, True, 8, 2),
    ("mixtral", 8, 4096, 14336, False, 2, 2),
    ("mixtral", 8, 4096, 28672, True, 2, 2),
    ("mixtral", 8, 4096, 28672, True, 2, 4),
]


# tp3: rank 0's uneven expert range (86 of 256, 3 of 8)
EP3_MOE_STACKS = [
    ("R1", 256, 2048, 7168, False, 8, 3),
    ("mixtral", 8, 4096, 14336, False, 2, 3),
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
    from chitu_tpu_torch.parallel.sharding import even_range

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

    def case(label, w, T, layer=0, skewed=False, timed=True, tag="", k=2,
             tp=1, e_all=None):
        """`tp` > 1: the stack is rank 0's experts (expert parallelism),
        E / tp of them, or, when tp does not divide the model's `e_all`,
        its range of the first E % tp ranks' (3 of 8 at tp3, 86 of 256);
        the tokens route over all of them, and the assignments of other
        ranks' experts go to the dead expert, the stack's E, whose blocks
        are dead (`models.moe.moe_ffn_ep`)."""
        data = w.data if hasattr(w, "kind") else w
        fp8 = hasattr(w, "kind")
        E, K, N = data.shape[-3:]
        Ed = E + 1 if tp > 1 else E
        bm, NB = moe.dispatch_geometry(T, k, Ed)
        e_all = e_all or E * tp
        sel = routing(T, e_all, k, skewed)
        foreign = None
        if tp > 1:
            sel = moe.local_ids(sel, 0, E)
            foreign = (sel == E).float().mean().item()
            tag += f",ep{tp}"
        row_assign, block_expert = moe.sorted_dispatch(sel, Ed, bm)
        block_expert = torch.where(block_expert >= E, -1, block_expert)
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
        # the products this run needs: the rank's own assignments
        mine = int((sel < E).sum().item()) if tp > 1 else A
        bnd, by = bound_ms(nbytes, 2.0 * mine * K * N)
        res = dict(name=name, kernel="grouped_gemm", route="cuda",
                   source=MOE_SRC,
                   replaces="chitu_tpu/ops/pallas_moe_gemm.py:287",
                   max_abs_err=err, max_row_rel_err=rel, bound_ms=bnd,
                   bound_by=by, ms=None, plain_ms=None, library_ms=None,
                   shape=f"T={T} k={k} E={E} bm={bm} NB={NB} live_blocks="
                         f"{len(live)} live_experts={len(experts)} K={K} N={N} "
                         f"mode={mode} weight_bytes_read={wbytes}"
                         + (f" tp={tp} experts_of_all={e_all} foreign_share="
                            f"{foreign:.3f}" if tp > 1 else ""),
                   **plan_fields(mg.gemm_plan(xs, w, block_expert, bm)))
        if tp > 1:
            res["variant"] = f"ep{tp}" + (
                "" if e_all == E * tp else f",{E}of{e_all}")
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
    # expert parallelism: rank 0's E / tp experts, about (tp - 1) / tp of
    # the assignments another rank's (dead blocks); the first ep2 case is
    # the tp2_r1 phase's bf16 down projection, the first ep4 one the
    # tp4_r1_soft_fp8 phase's merged e4m3 gate / up
    for label, E, K, N, fp8, k, tp in EP_MOE_STACKS:
        w = stack(1, E // tp, K, N, fp8)
        for T in (16, 512):
            yield case(label, w, T, k=k, tp=tp)
        del w
        torch.cuda.empty_cache()
    # slice 18: rank 0's uneven range at tp3, the tp3_r1 phase's bf16 down
    # projection (86 of 256) and the tp3_mixtral phase's bf16 gate (3 of 8)
    for label, E, K, N, fp8, k, tp in EP3_MOE_STACKS:
        w = stack(1, len(range(*even_range(E, 0, tp))), K, N, fp8)
        for T in (16, 512):
            yield case(label, w, T, k=k, tp=tp, e_all=E)
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
        (linear, "acts_absmax", norm_quant.acts_absmax_plain),
        (linear, "quant_acts_given", norm_quant.quant_acts_given_plain),
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


TIE_EPS = 1e-4  # a quotient this close to k + 0.5 is a rounding tie


def off_at_ties(torch, name, args, want, off):
    """The largest distance from a rounding tie (k + 0.5) of the plain
    version's quotient |y / s| over the values `off` marks (0 if none):
    y is the plain version's f32 row (B11: RMSNorm times w; B12: x), s its
    scale."""
    if not off.any():
        return 0.0
    x = args[0].float()
    if name == "rms_norm_quant":
        w, eps = args[1], args[2]
        x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()
    q = (x / want.scale[:, None]).abs()
    return ((q - q.floor() - 0.5).abs()[off]).max().item()


def shadowed(torch, errs):
    """Every call into one of this slice's kernels also runs the plain
    version on the same inputs and is held to the kernel cases' limits;
    the kernel's result goes on. `errs[name]` collects the largest error
    (GEMM: row relative; quantizers: share of int8 values off by one).
    B11 / B12 (whole rows): scales within 1e-6, int8 values at most one
    step apart, and a value one step off only where the plain version's
    quotient y / s lies within TIE_EPS of a rounding tie (`off_at_ties`):
    the kernel cases' cap of 0.1 % of the values is a share over random
    rows of 16, and one row of a decode call may hold more values at a
    tie than that (a row of 4096 in `tp2_w8a8`'s shadowed decode had 6
    values one step off, 0.146 %)."""

    def make(kernel_fn, plain_fn, name):
        def both(*args, **kw):
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            if name in ("acts_absmax", "quant_acts_given"):
                # B12's row-parallel modes: bit-equal to their plain versions
                same = torch.equal(got, want) if name == "acts_absmax" else (
                    torch.equal(got.data, want.data)
                    and torch.equal(got.scale, want.scale))
                if not same:
                    raise AssertionError(f"{name} in the model differs from "
                                         "its plain version")
                e = 0.0
            elif name.endswith(("gemm", "matmul")):
                limit = 1e-5 if name == "int8_gemm" else ROW_RTOL
                _, e = _row_rel(torch, f"{name} in the model", got, want, limit)
            else:
                rel = ((got.scale - want.scale).abs() / want.scale).max().item()
                d = (got.data.int() - want.data.int()).abs()
                e = (d != 0).float().mean().item()
                far = off_at_ties(torch, name, args, want, d != 0)
                if not (rel <= 1e-6 and d.max().item() <= 1 and far <= TIE_EPS):
                    raise AssertionError(
                        f"{name} in the model: scale rel err {rel}, max int8 "
                        f"diff {d.max().item()}, share off by one {e}, a value "
                        f"off by one {far} from a rounding tie (limit {TIE_EPS})"
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

    def partials_both(q, pool, layer, k, v, block_tables, seq_lens, valid,
                      page_size, kv_heads, head_dim, scale=None, window=0,
                      softcap=0.0, fused=True):
        # the ring KV decode's B1 partials on a rank's local table: the
        # plain partials at the kernel's split, on a copy of the layer
        copy = pool[layer:layer + 1].clone()
        o, ml = real_partials(q, pool, layer, k, v, block_tables, seq_lens,
                              valid, page_size, kv_heads, head_dim, scale,
                              window, softcap, fused)
        _, chunk = tk.decode_split(q.shape[0], kv_heads, block_tables.shape[1],
                                   page_size, tk._sm_count(q.device))
        op, mlp = tk.attend_decode_partials_plain(
            q, copy, 0, k, v, block_tables, seq_lens, valid, page_size,
            kv_heads, head_dim, scale, window, softcap, fused, S=o.shape[2],
            chunk=chunk)
        if fused and not torch.equal(pool[layer], copy[0]):
            raise AssertionError("attend_decode_partials in the model: pool "
                                 "bytes differ from the plain append")
        rows = (valid if fused else torch.ones_like(valid))[:, None, None, None]
        live = ((mlp[..., 1] > 0) & rows).flatten()
        if bool(live.any()):
            D = o.shape[-1]
            _, e = compare_rows(
                torch, "attend_decode_partials in the model",
                (o / ml[..., 1:].clamp_min(1e-30)).reshape(-1, D),
                (op / mlp[..., 1:].clamp_min(1e-30)).reshape(-1, D), live)
            errs["attend_decode_partials"] = max(
                errs.get("attend_decode_partials", 0.0), e)
        return o, ml

    def merge_both(part_o, part_ml, out_dtype=torch.bfloat16):
        # the ring KV decode's merge of every rank's splits, at the shape
        # the model gives it, against its plain version
        out = real_merge(part_o, part_ml, out_dtype)
        want = tk.decode_merge_plain(part_o, part_ml, out_dtype).reshape(
            out.shape)
        live = (part_ml[..., 1] > 0).any(2).reshape(out.shape[:2])
        if bool(live.any()):
            _, e = compare_rows(torch, "decode_merge in the model", out, want,
                                live)
            errs["decode_merge"] = max(errs.get("decode_merge", 0.0), e)
        return out

    old = {n: getattr(tk, n) for n in ATTN_WRAPPERS}
    real_dense = linear.dense_matmul_stacked
    real_partials = tk.attend_decode_partials
    real_merge = tk.decode_merge
    try:
        tk.attend_decode_partials = partials_both
        tk.decode_merge = merge_both
        for n in ATTN_WRAPPERS:
            setattr(tk, n, shim(n))
        linear.dense_matmul_stacked = dense_both
        yield
    finally:
        for n, fn in old.items():
            setattr(tk, n, fn)
        linear.dense_matmul_stacked = real_dense
        tk.attend_decode_partials = real_partials
        tk.decode_merge = real_merge


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
    allocator = check_allocator(eng, label)
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
    idle_engine_checks(eng, label)
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
        allocator=allocator,
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
    # slice 12: a case's geometry, with the launches of the kernel in the
    # phase that runs it (spec verify rounds; prefix-hit tails)
    ("attend_prefill_packed[verify]", "spec_decode", "attend_prefill_packed"),
    ("attend_prefill_packed_fused[qstart1024]", "prefix_cache",
     "attend_prefill_packed_fused"),
    # slice 15: the geometries of a rank under expert parallelism, with the
    # launches of rank 0 of the phase that runs them
    ("grouped_gemm[ep2]", "tp2_r1", "grouped_gemm"),
    ("grouped_gemm[ep4]", "tp4_r1_soft_fp8", "grouped_gemm"),
    ("absorb_matmul[h64]", "tp2_r1", "absorb_matmul"),
    ("attend_decode_fused[latent,h64]", "tp2_r1", "attend_decode_fused[latent]"),
    ("attend_prefill[latent,h64]", "tp2_r1", "attend_prefill[latent]"),
    # slice 16: B1's partials mode on a ring rank's pages, with the
    # launches of rank 0 of the dp 2 ring KV phase
    ("attend_decode_partials[ring]", "dp2_ring_kv", "attend_decode_partials"),
    ("decode_merge[ring]", "dp2_ring_kv", "decode_merge"),
    # slice 17: a rank's geometries under the layouts it serves, with the
    # launches of rank 0 of the phase that runs them: the dense MLA's
    # split kernels at 64 heads, B10 on the tp2 slices of wo's and
    # w_down's inputs, B12's row-parallel modes
    *((f"{k}[d192,h64]", "tp2_r1_dense", f"{k}[d192]") for k in (
        "attend_decode_fused", "attend_prefill_packed", "attend_decode",
        "attend_prefill")),
    ("int8_gemm[tp2]", "tp2_w8a8", "int8_gemm"),
    ("acts_absmax", "tp2_w8a8"),
    ("quant_acts_given", "tp2_w8a8"),
    # slice 18: B6 on a rank's whole-block slice of Qwen2-72B's w_down, B8
    # on rank 0's uneven expert range at tp3, with the launches of rank 0
    # of the phase that runs them
    ("quant_gemm[straddled,T16]", "tp2_qwen72_fp8", "quant_gemm"),
    ("quant_gemm[straddled,T512]", "tp2_qwen72_fp8", "quant_gemm"),
    ("grouped_gemm[ep3,86of256]", "tp3_r1", "grouped_gemm"),
    ("grouped_gemm[ep3,3of8]", "tp3_mixtral", "grouped_gemm"),
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


# ---------------------------------------------------------------------------
# Slice 12: the prefix cache, n-gram speculative decoding, the native page
# allocator
# ---------------------------------------------------------------------------

# A greedy stream may part from its reference only at a near tie. At the
# first differing position the logits row that predicts it comes from one
# teacher-forced prefill through the kernels (k) and one through the plain
# versions of every kernel (p), on the same weights and context. The gap
# |k[b] - k[a]| between the reference's token b and the stream's token a
# must lie within NEAR_TIE of k's spread (largest minus smallest logit), or
# else within NOISE_SIGMAS standard deviations of the difference two sound
# computations make to a pair of logits: sigma = sqrt(2) x the rms over the
# vocabulary of k - p, the typical per-entry disagreement (the largest one
# sits near 4.4 x the rms on every row read). On an H100 the Llama-3-8B
# streams part at up to 2.7 sigma (ROADMAP C). A MoE layer routes each
# token to its top experts, so a last-bit difference can flip a router
# choice and move a whole row (the Mixtral row's rms is 1.03 logits, 10 %
# of its spread): the Mixtral phase, where every layer routes, takes only
# a share of the spread, NEAR_TIE_MOE, set from its reading (0.103).
# DeepSeek-R1 at 4 layers routes in one and keeps both dense arms.
NEAR_TIE = 1e-2
NOISE_SIGMAS = 3.0
NEAR_TIE_MOE = 0.15
# Under expert parallelism a router flip moves its own token's row by a
# whole expert's output, and the rows of the tokens after it, less,
# through attention. A teacher-forced row beyond NOISE_SIGMAS sigma of the
# one-rank row passes only when its own token chose other experts in some
# layer, or when one of the FLIP_REACH tokens before it did and the row is
# within NEIGHBOUR_SIGMAS. Set from the readings (on an H100, of 211 such
# rows in the five EP phases 209 had their own token flipped; 2 sat 1 and
# 4 tokens after a flip, at 4.96 and 3.39 sigma): twice the farthest
# reach, twice NOISE_SIGMAS.
FLIP_REACH = 8
NEIGHBOUR_SIGMAS = 6.0


def slice12_kernel_cases(torch, tk, plain, dev):
    """The two geometries slice 12 gives the split attention kernels at
    Llama-3-8B's shapes (32 heads on 8 of 128, pages of 64), each held
    against its plain version as phase 2 holds its cases (output rows
    within ROW_RTOL on memory that held 7.0, dead blocks zero, two
    launches and a graph replay bit-equal; the appending B2 with the pool
    bytes equal): B3 at the spec verify geometry (16 rows of K1 = 5
    tokens, one block a row at block_qstart = the row's context of
    300-2,000 tokens, row 7 dead) and B2 with three prefix-cache hit
    tails (40, 150 and 300 tokens) whose blocks start at 1,024, on a
    16-page prefix the three rows share. Yardstick: SDPA on each row's
    gathered K/V."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(12)
    bf = torch.bfloat16
    H, KV, D, PAGE, L, LAYER = 32, 8, 128, 64, 2, 1
    M, scale = 2 * KV * D, D ** -0.5

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    def held(name, run, want, rows, block_seg, pools=None):
        poison(torch, want.shape, dev)
        got = run()
        err, rel = compare_rows(torch, name, got, want, rows,
                                *(pools or (None, None)))
        dead = ~torch.repeat_interleave(block_seg >= 0,
                                        got.shape[0] // block_seg.shape[0])
        if got[dead].abs().max().item() != 0.0:
            raise AssertionError(f"{name}: dead blocks not zero")
        return got, err, rel

    def case(name, kernel, variant, replaces, err, rel, ms, plain_ms, lib_ms,
             nbytes, flops, shape):
        bnd, by = bound_ms(nbytes, flops)
        return dict(name=name, kernel=kernel, variant=variant, route="cuda",
                    source=ATTN_SRC, replaces=replaces, max_abs_err=err,
                    max_row_rel_err=rel, ms=ms, plain_ms=plain_ms,
                    bound_ms=bnd, bound_by=by, library_ms=lib_ms, shape=shape)

    # ---- B3: one K1-token block a row, as verify_draft packs it --------
    B, K1, MP = 16, 5, 33
    P = B * MP
    pool = randn(L, P, PAGE, M, s=0.5)
    bts = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, MP)
    seq = torch.randint(300, 2001, (B,), generator=g, device=dev).to(torch.int32)
    seq[0] = 2000
    block_seg = torch.arange(B, dtype=torch.int32, device=dev)
    block_seg[7] = -1
    total = seq + K1
    q = randn(B * K1, H, D)
    rows = torch.repeat_interleave(block_seg >= 0, K1)
    pargs = (pool, LAYER, bts, block_seg, seq, total, PAGE, KV, D)
    run = lambda: tk.attend_prefill_packed(q, *pargs, scale=scale)  # noqa: E731
    name = "attend_prefill_packed[verify,Llama-3-8B]"
    got, err, rel = held(name, run,
                         tk.attend_prefill_packed_plain(q, *pargs, scale=scale),
                         rows, block_seg)
    bit_equal(torch, name, got, run())
    replay_equal(torch, name, run, got)
    live = block_seg >= 0
    segs = [(int(s), K1) for s in seq[live].tolist()]
    yield case(
        name, "attend_prefill_packed", "verify",
        "chitu_tpu/ops/pallas_attention.py:1709", err, rel,
        device_ms(torch, run),
        call_ms(torch, lambda: tk.attend_prefill_packed_plain(
            q, *pargs, scale=scale), reps=5),
        sdpa_segments_ms(torch, F, q[rows], pool, LAYER, bts[live], segs, K1,
                         KV, D, scale, plain),
        sum(s + n for s, n in segs) * 2 * KV * D * 2
        + 2 * len(segs) * K1 * H * D * 2,
        4.0 * H * D * pairs_split(segs),
        f"B={B} K1={K1} (one block a row, {tk._rows_block(H // KV, K1)} "
        f"token a CUDA block) ctx={seq.tolist()} dead_row=7 H={H} KV={KV} "
        f"D={D} page={PAGE}")
    del pool

    # ---- B2: prefix-hit tails from block_qstart 1,024 ------------------
    segs = [(1024, 40), (1024, 150), (1024, 300)]
    TQ = tk.packed_q_block(H, M, PAGE, D, kv_heads=KV)
    padded = sum((n + TQ - 1) // TQ * TQ for _, n in segs)
    NB = padded // TQ + 1  # and one dead block
    T, R, mp = NB * TQ, 16, 32
    pool0 = randn(L, 64, PAGE, M, s=0.5)
    bts_p = torch.full((R, mp), -1, dtype=torch.int32, device=dev)
    block_seg = torch.full((NB,), -1, dtype=torch.int32, device=dev)
    block_q = torch.zeros((NB,), dtype=torch.int32, device=dev)
    total = torch.zeros((R,), dtype=torch.int32, device=dev)
    rows = torch.zeros((T,), dtype=torch.bool, device=dev)
    off = 0
    for r, (s0, n) in enumerate(segs):
        bts_p[r, :16] = torch.arange(16, device=dev)  # the shared prefix
        bts_p[r, 16:21] = 16 + 5 * r + torch.arange(5, device=dev)
        nb = (n + TQ - 1) // TQ
        block_seg[off // TQ : off // TQ + nb] = r
        block_q[off // TQ : off // TQ + nb] = s0 + torch.arange(nb, device=dev) * TQ
        total[r] = s0 + n
        rows[off : off + n] = True
        off += nb * TQ
    q, k, v = randn(T, H, D), randn(T, KV, D), randn(T, KV, D)
    args = (LAYER, k, v, bts_p, block_seg, block_q, total, PAGE, KV, D)
    pool_k, pool_p = pool0.clone(), pool0.clone()
    name = "attend_prefill_packed_fused[qstart1024,Llama-3-8B]"
    want = tk.attend_prefill_packed_fused_plain(q, pool_p, *args, scale=scale)
    got, err, rel = held(
        name, lambda: tk.attend_prefill_packed_fused(q, pool_k, *args, scale=scale),
        want, rows, block_seg, (pool_k, pool_p))
    run = lambda: tk.attend_prefill_packed_fused(  # noqa: E731
        q, pool0.clone(), *args, scale=scale)
    bit_equal(torch, name, got, run())
    pool_g = pool0.clone()
    replay_equal(torch, name, lambda: tk.attend_prefill_packed_fused(
        q, pool_g, *args, scale=scale), got)
    n_new = sum(n for _, n in segs)
    yield case(
        name, "attend_prefill_packed_fused", "qstart1024",
        "chitu_tpu/ops/pallas_attention.py:1424", err, rel,
        device_ms(torch, lambda: tk.attend_prefill_packed_fused(
            q, pool_k, *args, scale=scale)),
        call_ms(torch, lambda: tk.attend_prefill_packed_fused_plain(
            q, pool_p, *args, scale=scale), reps=5),
        sdpa_segments_ms(torch, F, q, pool_k, LAYER, bts_p, segs, TQ, KV, D,
                         scale, plain),
        sum(s + n for s, n in segs) * 2 * KV * D * 2 + 2 * n_new * H * D * 2
        + n_new * 2 * KV * D * 2 + n_new * M * 2,
        4.0 * H * D * pairs_split(segs),
        f"T={T} Tq={TQ} NB={NB} segs={segs} (pages 0-15 shared) H={H} KV={KV} "
        f"D={D} page={PAGE}")
    del pool0, pool_k, pool_p, pool_g
    torch.cuda.empty_cache()


def check_allocator(eng, label, prefix_cache=False):
    """Print the engine's page allocator; without the prefix cache it must
    be the native one (the JAX engine's default)."""
    name = type(eng.cache.allocator).__name__
    want = "PrefixCachingAllocator" if prefix_cache else "NativeBackedPageAllocator"
    print(f"[{label}] page allocator {name}", flush=True)
    if name != want:
        raise AssertionError(f"[{label}] page allocator {name}, expected {want}")
    return name


def stream_rows(torch, tk, eng, prompt, stream, plain=False):
    """The logits rows [len(stream), V] that predict each token of
    `stream` after `prompt`: teacher-forced prefill chunks through the idle
    engine's model (the prompt, whose last row predicts the first token;
    then the stream but its last token, all rows), each of the executor's
    bucketed length, in pages taken from its allocator and given back; `plain`: through the plain versions of every kernel (attention
    and op_impl's), on the same weights. Under tensor or pipeline
    parallelism every rank runs the same call; a stage before the last
    gets None."""
    from chitu_tpu_torch.executor import _bucket
    from chitu_tpu_torch.ops import linear

    ex, alloc, page = eng.executor, eng.cache.allocator, eng.cfg.infer.page_size
    n = len(prompt) + len(stream)
    rid = "teacher-forced"
    if not alloc.ensure(rid, n + 1):
        raise AssertionError("no pages for the teacher-forced prefill")
    route = (eng.model.attn_route, eng.model.attn)
    try:
        if plain:
            eng.model.attn_route, eng.model.attn = tk.attention_route("ref")
            linear.set_op_impl("xla")
        bt = torch.as_tensor(alloc.block_table([rid], ex.mp_full)[0],
                             device=ex.device)
        rows = []
        for start, chunk in ((0, prompt), (len(prompt), stream[:-1])):
            if not chunk:
                continue
            T = _bucket(len(chunk), ex.prefill_buckets)
            toks = torch.zeros(T, dtype=torch.int32, device=ex.device)
            toks[:len(chunk)] = torch.tensor(chunk, dtype=torch.int32,
                                             device=ex.device)
            with torch.no_grad():
                logits, _ = eng.model.prefill(
                    dict(eng.cache.arrays), toks, bt, start, len(chunk), page,
                    return_all_logits=start > 0)
            rows.append(None if logits is None
                        else logits[:len(chunk)] if start else logits[None])
        # a pipeline stage before the last has no logits
        return None if rows[0] is None else torch.cat(rows).float()
    finally:
        eng.model.attn_route, eng.model.attn = route
        linear.set_op_impl(eng.cfg.infer.op_impl)
        alloc.free(rid)


def routed_rows(torch, tk, eng, prompt, stream):
    """`stream_rows` with the kernels, and the experts that the MoE
    layers the rank holds chose for each token of it: [layers, tokens
    (the prompt, then the stream but its last token), k], each token's
    experts in ascending order (no layers on a dense model)."""
    from chitu_tpu_torch.models import deepseek_v3, mixtral

    calls = []
    held = {m: m.route for m in (mixtral, deepseek_v3)}

    def recording(f):
        def rec(*a, **k):
            w, sel = f(*a, **k)
            calls.append(sel.to("cpu", torch.int64))
            return w, sel
        return rec

    for m, f in held.items():
        m.route = recording(f)
    try:
        rows = stream_rows(torch, tk, eng, prompt, stream)
    finally:
        for m, f in held.items():
            m.route = f
    # one call a layer a chunk; a chunk's bucket pads it past its tokens
    chunks = [len(prompt)] + ([len(stream) - 1] if len(stream) > 1 else [])
    per = len(calls) // len(chunks)
    sel = torch.stack([torch.cat([calls[c * per + j][:n]
                                  for c, n in enumerate(chunks)])
                       for j in range(per)]) if per else torch.zeros(
        0, sum(chunks), 0, dtype=torch.int64)
    return rows, sel.sort(-1).values


def teacher_forced_row(torch, tk, eng, tokens, plain=False):
    """The logits row that predicts the token after `tokens` (`stream_rows`)."""
    return stream_rows(torch, tk, eng, list(tokens), [0], plain)[0]


def near_tie(torch, tk, eng, label, prompts, got, want, moe=False,
             moe_limit=NEAR_TIE_MOE):
    """Each greedy stream in `got` equals its reference in `want`, or
    parts from it at a near tie (NEAR_TIE above; `moe`: `moe_limit` of the
    spread alone, NEAR_TIE_MOE unless the caller measured the reference's
    own); tokens after the first divergence are not compared. Prints
    every divergence with its gap. -> the divergences [(stream, position,
    gap / spread, gap / sigma)]."""
    out = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            raise AssertionError(f"[{label}] stream {i}: {len(a)} tokens against "
                                 f"{len(b)}, equal where both have them")
        ctx = list(p) + list(b[:j])
        row = teacher_forced_row(torch, tk, eng, ctx)
        ref = teacher_forced_row(torch, tk, eng, ctx, plain=True)
        margin = (row[b[j]] - row[a[j]]).item()
        plain_margin = (ref[b[j]] - ref[a[j]]).item()
        gap = abs(margin)
        rel = gap / (row.max() - row.min()).item()
        sigma = math.sqrt(2.0) * (row - ref).pow(2).mean().sqrt().item()
        sigmas = gap / sigma if sigma else math.inf
        print(f"[{label}] divergence: stream {i} at token {j} of {len(b)}: "
              f"{a[j]} against the reference's {b[j]}, logit gap {gap:.5g} = "
              f"{rel:.3e} of the row's spread (limit "
              f"{moe_limit if moe else NEAR_TIE}) = {sigmas:.3f} sigma "
              f"(sigma {sigma:.5g}, limit {'none' if moe else NOISE_SIGMAS}); "
              f"the pair's kernels-vs-plain shift {abs(margin - plain_margin):.5g}, "
              f"plain margin {plain_margin:.5g}, the stream's token ranks "
              f"{int((row > row[a[j]]).sum().item())} in the kernels' row",
              flush=True)
        ok = (rel <= moe_limit if moe
              else rel <= NEAR_TIE or sigmas <= NOISE_SIGMAS)
        if not ok:
            raise AssertionError(f"[{label}] stream {i} parts from its reference "
                                 f"at token {j} beyond a near tie")
        out.append((i, j, rel, sigmas))
    return out


def step_device_ms(torch, eng):
    """One engine step under torch.profiler -> (device ms: the sum of its
    kernels' device time, span ms: CUDA events around the step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        eng.step()
        b.record()
        b.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                 or getattr(e, "self_cuda_time_total", 0.0)
                 for e in prof.key_averages())
    return dev_us / 1e3, a.elapsed_time(b)


def serve_burst(eng, prompts, params, profile_first=None):
    """Submit `prompts` together and serve them to the end -> (token
    streams, the first step's (device ms, span ms) when `profile_first` is
    the torch module)."""
    reqs = [eng.submit("", params, prompt_tokens=p) for p in prompts]
    first = step_device_ms(profile_first, eng) if profile_first else None
    eng.run_until_complete()
    for r in reqs:
        if r.finish_reason is None:
            raise AssertionError(f"request {r.request_id} unfinished")
    return [list(r.async_stream.tokens) for r in reqs], first


def idle_engine_checks(eng, label):
    """Pages (the LRU's counted as free) and slots all back."""
    if eng.cache.allocator.num_free() != eng.cache.num_pages:
        raise AssertionError(f"[{label}] KV pages not all returned: "
                             f"{eng.cache.allocator.num_free()} of {eng.cache.num_pages}")
    if len(eng.pool) or len(eng.executor.slots.free) != eng.cfg.infer.max_reqs:
        raise AssertionError(f"[{label}] tasks or slots left behind")


def free_memory(torch):
    """Give the device memory of engines no longer referenced back."""
    gc.collect()
    torch.cuda.empty_cache()


SHARED = 1024  # the shared prefix: 16 pages of 64
TAILS = (40, 300, 90, 260, 150, 200)  # the first tail ends inside page 16


def prefix_phases(torch, np, tk, card):
    """Llama-3-8B-Instruct at full width and depth, bf16, random weights,
    `infer.prefix_cache=true`: a cold burst of six prompts (a shared
    1,024-token prefix and tails of 40-300 tokens), the same burst warm,
    and a lone warm prompt; then the same weights in an engine whose pool
    `kv_pool_frac` cuts to 33 pages, where LRU eviction and preemption
    must both fire. -> (launches of the warm burst, the weights)."""
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine

    label = "prefix_cache"
    base = [f"models={LLAMA}", "infer.stop_with_eos=false",
            "infer.prefix_cache=true"]
    t0 = time.time()
    eng = Engine(load_config(overrides=base))
    torch.cuda.synchronize()
    print(f"engine[{label}] bring-up {time.time() - t0:.1f} s ({LLAMA}, "
          f"{eng.cfg.models.n_layers} layers, random weights, KV pool "
          f"{eng.cache.bytes() / 2**30:.2f} GiB, {eng.cache.num_pages} pages)",
          flush=True)
    check_allocator(eng, label, prefix_cache=True)
    alloc = eng.cache.allocator
    rng = np.random.default_rng(12)
    V = eng.cfg.models.vocab_size

    def toks(n):
        return [int(x) for x in rng.integers(1, V, size=n)]

    greedy = SampleParams(temperature=0.0, max_new_tokens=32)
    shared = toks(SHARED)
    prompts = [shared + toks(n) for n in TAILS]
    chains = [(len(p) - 1) // 64 for p in prompts]
    # cold: every prompt is admitted in one step, so no lookup finds a
    # page; the chunked prefill (prompts over the 512-token chunk)
    cold, cold_ms = serve_burst(eng, prompts, greedy, torch)
    if alloc.hits != 0 or alloc.misses != sum(chains):
        raise AssertionError(f"[{label}] cold burst: {alloc.hits} hits, "
                             f"{alloc.misses} misses, expected 0 and {sum(chains)}")
    idle_engine_checks(eng, label)
    # warm: each attaches the 16 shared pages (the first prompt published
    # them; a later prompt's own tail pages hang off its cold page 15, so
    # their parent check stops the walk there)
    calls = []
    real_one = eng.executor._prefill_one

    def spy(t, tokens=None):
        calls.append((t.task_id, t.prefilled_len))
        return real_one(t, tokens)

    eng.executor._prefill_one = spy
    tk.reset_launch_counts()
    try:
        warm, warm_ms = serve_burst(eng, prompts, greedy, torch)
        torch.cuda.synchronize()
        warm_launches = dict(tk.LAUNCHES)
        want_hits = 16 * len(prompts) + max(0, chains[0] - 16)
        if alloc.hits != want_hits:
            raise AssertionError(f"[{label}] warm burst: {alloc.hits} hits, "
                                 f"expected {want_hits}")
        if calls:
            raise AssertionError(f"[{label}] hit tails left the packed slab: {calls}")
        if warm_launches.get("attend_prefill_packed_fused", 0) <= 0:
            raise AssertionError(f"[{label}] B2 did not launch on the hit tails")
        div = near_tie(torch, tk, eng, label + " warm", prompts, warm, cold)
        # a lone warm prompt: the chunked path from q_pos 1,024 (B5)
        tk.reset_launch_counts()
        lone, _ = serve_burst(eng, prompts[2:3], greedy)
        lone_b5 = tk.LAUNCHES.get("attend_prefill", 0)
        if [s for _, s in calls] != [SHARED] or lone_b5 <= 0:
            raise AssertionError(f"[{label}] lone hit: prefill_one calls {calls}, "
                                 f"B5 launches {lone_b5}")
        div += near_tie(torch, tk, eng, label + " lone", prompts[2:3], lone, cold[2:3])
    finally:
        del eng.executor._prefill_one
        real_one = None  # the executor goes with the engine below
    hits = alloc.hits
    idle_engine_checks(eng, label)
    params = eng.model.params_tree()
    stats = dict(
        phase=label, card=card, layers=eng.cfg.models.n_layers,
        allocator=type(alloc).__name__, prompts=[len(p) for p in prompts],
        hits=hits, misses=alloc.misses, warm_hits_expected=want_hits,
        cold_prefill_device_ms=cold_ms[0], cold_prefill_span_ms=cold_ms[1],
        warm_prefill_device_ms=warm_ms[0], warm_prefill_span_ms=warm_ms[1],
        warm_launches={k: v for k, v in warm_launches.items() if v},
        lone_b5_launches=lone_b5, divergences=div)
    eng.terminate()
    del eng
    free_memory(torch)

    # the same weights in a pool of 33 pages (kv_pool_frac's floor: one
    # max_seq_len request): stale entries fill the LRU, the shared prefix
    # is published, then eight requests outgrow the pool as they decode
    label = "prefix_cache_tight"
    shared2 = toks(128)
    burst = [shared2 + toks(8 + 7 * i) for i in range(8)]
    stale = [toks(600), toks(600)]
    long = SampleParams(temperature=0.0, max_new_tokens=200)
    roomy = Engine(load_config(overrides=base[:2]), params=params)
    check_allocator(roomy, label + " reference")
    want, _ = serve_burst(roomy, burst, long)
    roomy.terminate()
    del roomy
    free_memory(torch)
    tight = Engine(load_config(overrides=base + ["infer.kv_pool_frac=0.01"]),
                   params=params)
    check_allocator(tight, label, prefix_cache=True)
    alloc = tight.cache.allocator
    counts = {"preempt": 0, "evict": 0}
    real_preempt, real_evict = tight.executor.preempt, alloc._evict_one

    def preempt(t):
        counts["preempt"] += 1
        real_preempt(t)

    def evict():
        ok = real_evict()
        counts["evict"] += ok
        return ok

    tight.executor.preempt, alloc._evict_one = preempt, evict
    short = SampleParams(temperature=0.0, max_new_tokens=2)
    serve_burst(tight, stale, short)
    serve_burst(tight, burst[:1], short)
    tk.reset_launch_counts()
    t0 = time.time()
    got, _ = serve_burst(tight, burst, long)
    wall = time.time() - t0
    if not (counts["preempt"] > 0 and counts["evict"] > 0):
        raise AssertionError(f"[{label}] preemptions {counts['preempt']}, "
                             f"evictions {counts['evict']}: both must fire")
    if any(len(s) != 200 for s in got):
        raise AssertionError(f"[{label}] a request came back short")
    tdiv = near_tie(torch, tk, tight, label, burst, got, want)
    idle_engine_checks(tight, label)
    stats.update(tight_pages=tight.cache.num_pages, tight_preemptions=counts["preempt"],
                 tight_evictions=counts["evict"], tight_hits=alloc.hits,
                 tight_burst_wall_s=wall, tight_divergences=tdiv)
    print("engine " + json.dumps(stats), flush=True)
    tight.terminate()
    del tight
    free_memory(torch)
    return warm_launches, params


SPEC = ["infer.spec_decode=ngram", "infer.spec_k=4"]


def spec_burst(torch, np, tk, eng, label, new_tokens=32, n=6, moe=False):
    """A greedy burst of `n` prompts with spec decode, the same burst with
    `spec_enabled = False` on the same engine as the reference (near-tie
    rule; `moe`: its MoE limit), then one sampled request, which must leave
    `_spec_stats` as it was. -> stats."""
    from chitu_tpu_torch import SampleParams

    ex = eng.executor
    rng = np.random.default_rng(21)
    V = eng.cfg.models.vocab_size
    prompts = [[int(x) for x in rng.integers(1, V, size=m)]
               for m in (40, 100, 200, 130, 60, 300)[:n]]
    greedy = SampleParams(temperature=0.0, max_new_tokens=new_tokens)
    s0 = list(ex._spec_stats)
    tk.reset_launch_counts()
    got, _ = serve_burst(eng, prompts, greedy)
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    emitted, rounds = ex._spec_stats[0] - s0[0], ex._spec_stats[1] - s0[1]
    if rounds <= 0 or launches.get("attend_prefill_packed", 0) <= 0:
        raise AssertionError(f"[{label}] no verify round ({rounds}) or no B3 "
                             f"launch ({launches.get('attend_prefill_packed')})")
    ex.spec_enabled = False
    try:
        want, _ = serve_burst(eng, prompts, greedy)
    finally:
        ex.spec_enabled = True
    div = near_tie(torch, tk, eng, label, prompts, got, want, moe)
    s1 = list(ex._spec_stats)
    sampled = SampleParams(temperature=0.8, top_k=16, top_p=0.9,
                           max_new_tokens=8)
    out, _ = serve_burst(eng, prompts[:1], sampled)
    if ex._spec_stats != s1 or len(out[0]) != 8:
        raise AssertionError(f"[{label}] a sampled request took the spec path")
    idle_engine_checks(eng, label)
    print(f"[{label}] {emitted} tokens in {rounds} verify rounds "
          f"({emitted / rounds:.2f} a round), B3 launches "
          f"{launches['attend_prefill_packed']}", flush=True)
    return dict(spec_tokens=emitted, verify_rounds=rounds,
                tokens_per_round=emitted / rounds, launches=launches,
                divergences=div)


def one_verify_round(torch, np, eng, label, ctx):
    """One request of two tokens: its prefill, then one verify round, with
    the calls of the `ctx` context shadowed. -> the round count."""
    from chitu_tpu_torch import SampleParams

    rng = np.random.default_rng(5)
    p = [int(x) for x in rng.integers(1, eng.cfg.models.vocab_size, size=90)]
    r0 = eng.executor._spec_stats[1]
    with torch.no_grad(), ctx:
        out, _ = serve_burst(eng, [p], SampleParams(temperature=0.0,
                                                    max_new_tokens=2))
    torch.cuda.synchronize()
    rounds = eng.executor._spec_stats[1] - r0
    if rounds != 1 or len(out[0]) != 2:
        raise AssertionError(f"[{label}] shadowed request: {rounds} rounds, "
                             f"{len(out[0])} tokens")
    return rounds


def spec_phases(torch, np, tk, card, params):
    """`infer.spec_decode=ngram infer.spec_k=4`: Llama-3-8B-Instruct at 32
    layers on the prefix phase's weights (a burst, its reference, a
    sampled request, one verify round with every attention call shadowed);
    micro-llama-debug, whose streams loop, so drafts are accepted;
    Mixtral-8x7B-Instruct-v0.1 bf16 at 4 layers (a burst; one round with
    every GEMM call shadowed: B8 at T = B x K1 rows); DeepSeek-R1 bf16 at 4
    layers (3 dense, 1 MoE) with the prefix cache too: a cold and a warm
    burst on a shared 512-token prefix, where the latent B3 runs the hit
    tails and spec decode falls back to windows (no verify_draft).
    -> launches by phase."""
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine

    out = {}
    label = "spec_decode"
    eng = Engine(load_config(overrides=[f"models={LLAMA}", "infer.stop_with_eos=false",
                                        *SPEC]), params=params)
    check_allocator(eng, label)
    stats = spec_burst(torch, np, tk, eng, label)
    errs = {}
    stats["shadowed_rounds"] = one_verify_round(
        torch, np, eng, label, shadowed_attention(torch, tk, errs))
    if "attend_prefill_packed" not in errs:
        raise AssertionError(f"[{label}] the shadowed round reached no B3 call")
    stats["shadowed_call_err_vs_plain"] = errs
    out[label] = stats["launches"]
    print("engine " + json.dumps(dict(phase=label, card=card,
                                     layers=eng.cfg.models.n_layers, **stats)),
          flush=True)
    eng.terminate()
    del eng
    free_memory(torch)

    # a small vocabulary and two layers of random weights loop within a
    # few tokens, so drafts hit: acceptance beyond one token a round runs
    # through the kernels (B3 at head size 32)
    label = "spec_micro"
    eng = Engine(load_config(overrides=["models=micro-llama-debug",
                                        "infer.stop_with_eos=false", *SPEC]))
    check_allocator(eng, label)
    stats = spec_burst(torch, np, tk, eng, label)
    if not stats["tokens_per_round"] > 1.0:
        raise AssertionError(f"[{label}] no draft accepted on looping streams")
    if stats["launches"].get("attend_prefill_packed[d32]", 0) <= 0:
        raise AssertionError(f"[{label}] B3 at head size 32 did not launch")
    out[label] = stats["launches"]
    print("engine " + json.dumps(dict(phase=label, card=card, layers=2, **stats)),
          flush=True)
    eng.terminate()
    del eng
    free_memory(torch)

    label = "spec_mixtral"
    eng = Engine(load_config(overrides=[f"models={MIXTRAL}", "models.n_layers=4",
                                        "infer.stop_with_eos=false", *SPEC]))
    check_allocator(eng, label)
    stats = spec_burst(torch, np, tk, eng, label, moe=True)
    if stats["launches"].get("grouped_gemm", 0) <= 0:
        raise AssertionError(f"[{label}] B8 did not launch")
    errs = {}
    stats["shadowed_rounds"] = one_verify_round(torch, np, eng, label,
                                                shadowed(torch, errs))
    if "grouped_matmul" not in errs:
        raise AssertionError(f"[{label}] the shadowed round reached no B8 call")
    stats["shadowed_call_err_vs_plain"] = errs
    out[label] = stats["launches"]
    print("engine " + json.dumps(dict(phase=label, card=card, layers=4, **stats)),
          flush=True)
    eng.terminate()
    del eng
    free_memory(torch)

    label = "r1_prefix_spec"
    eng = Engine(load_config(overrides=[f"models={R1}", "models.n_layers=4",
                                        "infer.stop_with_eos=false",
                                        "infer.prefix_cache=true", *SPEC]))
    check_allocator(eng, label, prefix_cache=True)
    rng = np.random.default_rng(31)
    V = eng.cfg.models.vocab_size
    shared = [int(x) for x in rng.integers(1, V, size=512)]
    prompts = [shared + [int(x) for x in rng.integers(1, V, size=n)]
               for n in (40, 120, 200)]
    greedy = SampleParams(temperature=0.0, max_new_tokens=16)
    cold, _ = serve_burst(eng, prompts, greedy)
    tk.reset_launch_counts()
    warm, _ = serve_burst(eng, prompts, greedy)
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    hits = eng.cache.allocator.hits
    if hits != 8 * len(prompts):  # the 8 shared pages each (see prefix_phases)
        raise AssertionError(f"[{label}] warm burst hit {hits} pages, expected "
                             f"{8 * len(prompts)}")
    if launches.get("attend_prefill_packed[latent]", 0) <= 0:
        raise AssertionError(f"[{label}] the latent B3 did not run the hit tails")
    if eng.executor._spec_stats != [0, 0]:
        raise AssertionError(f"[{label}] spec decode ran without verify_draft")
    div = near_tie(torch, tk, eng, label, prompts, warm, cold)
    idle_engine_checks(eng, label)
    out[label] = launches
    print("engine " + json.dumps(dict(
        phase=label, card=card, layers=4, hits=hits,
        misses=eng.cache.allocator.misses, spec_stats=eng.executor._spec_stats,
        launches={k: v for k, v in launches.items() if v}, divergences=div)),
        flush=True)
    eng.terminate()
    del eng
    free_memory(torch)
    return out


def row_key(res):
    v = res.get("variant")
    return res["kernel"] if v in (None, "bf16", "split") else f"{res['kernel']}[{v}]"


# ---------------------------------------------------------------------------
# Slice 13: tensor parallelism (ranks sharing the card over gloo) and AWQ
# ---------------------------------------------------------------------------

TP_LENS = (128, 256, 384, 512, 640, 768, 1024)  # the burst's API prompts
TP_NEW = 32  # new tokens a stream of the multi-rank phases' bursts (64
# until slice 18 brought its phases: the earlier worlds' bursts decode half
# as long since)
TP_MSG = "Tensor parallel serving over HTTP to rank 0. " * 5  # ~250 bytes
TP_TIMEOUT = 900  # a world's whole run, killed past it
TP_BASE = [f"models={LLAMA}", "infer.stop_with_eos=false",
           "infer.max_seq_len=2048", "infer.max_reqs=8"]


def tp_prompts(np, V):
    rng = np.random.default_rng(21)
    return [[int(x) for x in rng.integers(1, V, size=n)] for n in TP_LENS]


def tp_reference(torch, np, label, overrides, base=TP_BASE,
                 http_prompt=None, prompts=None):
    """The tp=1 engine of a TP or PP phase (same seed, same weights): the
    streams of the burst's API prompts (`prompts`, else the seven of
    `tp_prompts`) and its chat message, with the message's prompt tokens
    (`http_prompt`: those tokens, as the world recorded them), and of a
    lone request; its weight, pool and norm bytes. -> (engine, result)."""
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine
    from chitu_tpu_torch.ops.qtensor import QTensor

    eng = Engine(load_config(overrides=base + list(overrides)))
    prompts = prompts or tp_prompts(np, eng.cfg.models.vocab_size)
    greedy = SampleParams(temperature=0.0, max_new_tokens=TP_NEW)
    torch.cuda.synchronize()
    t0 = time.time()
    reqs = [eng.submit("", greedy, prompt_tokens=p) for p in prompts]
    if http_prompt is None:
        msg = eng.submit([{"role": "user", "content": TP_MSG}], greedy)
        http_prompt = list(eng.pool[f"task-{msg.request_id}"].tokens)
    else:
        msg = eng.submit("", greedy, prompt_tokens=http_prompt)
    eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.time() - t0
    lone, lone_tokens = lone_decode_rate(eng, prompts[0][:64])
    m = eng.model
    # what every rank holds whole: the norms, and the per-out-channel
    # scales of the row-parallel projections
    norms = sum(getattr(m, n).numel() * getattr(m, n).element_size()
                for n in ("norm", "attn_norm", "ffn_norm") if hasattr(m, n))
    for n in ("wo", "w_down"):
        w = getattr(m, n, None)
        if isinstance(w, QTensor) and w.scale.dim() < w.data.dim():
            norms += w.scale.numel() * w.scale.element_size()
    res = dict(api=[list(r.async_stream.tokens) for r in reqs],
               http=list(msg.async_stream.tokens), http_prompt=http_prompt,
               prompts=prompts, weight_bytes=eng.weight_bytes(),
               pool_bytes=eng.cache.bytes(), norm_bytes=norms,
               layers=eng.cfg.models.n_layers, burst_wall_s=wall,
               decode_tokens_per_s_batch1=lone, lone=lone_tokens)
    print(f"[{label}] tp=1 reference: weights {res['weight_bytes'] / 2**30:.3f} "
          f"GiB, pool {res['pool_bytes'] / 2**30:.3f} GiB", flush=True)
    return eng, res


def lone_decode_rate(eng, prompt):
    """A lone greedy request of TP_NEW + 1 new tokens -> its decode rate at
    batch 1 (TP_NEW tokens over the time from its first token to its
    last), and its tokens."""
    from chitu_tpu_torch import SampleParams

    r = eng.submit("", SampleParams(temperature=0.0, max_new_tokens=TP_NEW + 1),
                   prompt_tokens=prompt)
    eng.run_until_complete()
    return (TP_NEW / (r.finish_time - r.prefill_end_time),
            list(r.async_stream.tokens))


def batch_decode_rate(eng, prompts, n):
    """n greedy requests of 65 new tokens on 128-token prompts, submitted
    together -> their decode rate at batch n (64 tokens a row over the
    time from the last first token to the last finish)."""
    from chitu_tpu_torch import SampleParams

    reqs = [eng.submit("", SampleParams(temperature=0.0, max_new_tokens=65),
                       prompt_tokens=prompts[i % len(prompts)][:128])
            for i in range(n)]
    eng.run_until_complete()
    span = max(r.finish_time for r in reqs) - max(r.prefill_end_time for r in reqs)
    return n * 64 / span


def seeded_params(model, seed=0):
    """Random weights of a Llama-family model whose whole leaves do not
    fit a card: each layer of each leaf drawn on its own (normal * 0.02,
    norms 1, biases 0, bf16) from a generator seeded by (seed, leaf,
    layer), then cut to the rank's stage and TP slice as `TPLayout.place`
    cuts it; the rank holds its share and one layer beside it. Every
    layout of one card gets slices of the same weights (not those of
    `init_params`, which draws each leaf whole)."""
    import dataclasses

    import torch

    from chitu_tpu_torch.parallel.sharding import StageSlice

    lay = model.layout
    one = dataclasses.replace(lay, stage=StageSlice())
    out = {}
    for name, shape in model._shapes(local=False, merged=True).items():
        if not lay.stage.holds(name):
            continue
        top = name in ("embed", "norm", "lm_head")
        layers = [0] if top else range(*lay.stage.ranges.get("layers", (0, shape[0])))
        for i, layer in enumerate(layers):
            g = torch.Generator(device=model.device)
            g.manual_seed(zlib.crc32(f"{seed}/{name}/{layer}".encode()))
            t = torch.empty(shape if top else (1, *shape[1:]), dtype=torch.bfloat16,
                            device=model.device)
            if "norm" in name:
                t.fill_(1.0)
            elif name == "b_qkv":
                t.zero_()
            else:
                t.normal_(0.0, 0.02, generator=g)
            for k, v in one.place(name, t).items():
                if top:
                    out[k] = v
                    continue
                if k not in out:
                    out[k] = v.new_empty((len(layers), *v.shape[1:]))
                out[k][i:i + 1].copy_(v)
            del t
    return out


GO = "go"  # the file that lets a started world's ranks go


def start_world(label, n, overrides, prompts, base=TP_BASE, grid=None,
                **extra):
    """Start n ranks of this script (`--tp-rank`) through the port's
    launcher (`parallel.distributed.spawn_ranks`, the one
    `python -m chitu_tpu_torch infer.tp_size=N` uses), rank 0 included,
    on the grid's overrides (`infer.tp_size=n` by default); ranks that
    share the card do so over gloo. They import and then wait, touching
    nothing on the card, until `join_world` lets them go: the phase before
    runs meanwhile (`run_worlds`). `extra` goes to the ranks (`seeded`:
    weights from `seeded_params`; `batch`: also time a decode batch of
    that many rows). -> the world."""
    from chitu_tpu_torch.parallel import distributed

    d = tempfile.mkdtemp(prefix=f"chitu_{label}_")
    spec = os.path.join(d, "spec.json")
    grid = grid or [f"infer.tp_size={n}"]
    with open(spec, "w") as f:
        json.dump(dict(label=label, overrides=base + list(overrides)
                       + grid + ["serve.port=0"],
                       prompts=prompts, out=d, **extra), f)
    procs = distributed.spawn_ranks(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", spec], n,
        distributed.local_coordinator(), first=0)
    return dict(label=label, n=n, out=d, procs=procs, started=time.time())


def stop_world(world):
    """Kill a world's ranks that are still running and remove its
    directory."""
    import shutil

    for p in world["procs"]:
        if p.poll() is None:
            p.kill()
        p.wait()
    shutil.rmtree(world["out"], ignore_errors=True)


def join_world(world):
    """Let a started world's ranks go, with a rendezvous picked now, and
    wait for them. Killed, all of them, when one fails or TP_TIMEOUT
    passes. -> (each rank's result, the sampling rank's teacher-forced
    rows of rank 0's streams and its lone request)."""
    from chitu_tpu_torch.parallel import distributed

    label, n, d, procs = world["label"], world["n"], world["out"], world["procs"]
    t0 = time.time()
    with open(os.path.join(d, GO + ".tmp"), "w") as f:
        f.write(distributed.local_coordinator())
    os.replace(os.path.join(d, GO + ".tmp"), os.path.join(d, GO))
    try:
        while any(p.poll() is None for p in procs):
            if time.time() - t0 > TP_TIMEOUT or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        stop_world(world)
        raise AssertionError(f"[{label}] ranks exited with {rcs}")
    import torch

    out = []
    for r in range(n):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out.append(json.load(f))
        for key, name in (("tf_routes", f"tf_routes{r}.pt"),
                          ("acts", f"acts{r}.pt")):
            path = os.path.join(d, name)
            if os.path.exists(path):
                out[r][key] = torch.load(path)
    if os.path.exists(os.path.join(d, "decode_routes.pt")):
        out[0]["decode_routes"] = torch.load(os.path.join(d, "decode_routes.pt"))
    rows = torch.load(os.path.join(d, "tp_rows.pt"))
    stop_world(world)
    print(f"[{label}] world of {n} ranks: {time.time() - t0:.1f} s (started "
          f"{t0 - world['started']:.1f} s before)", flush=True)
    return out, rows


def tp_world(label, n, overrides, prompts, base=TP_BASE, grid=None, **extra):
    """`start_world`, then `join_world` at once."""
    return join_world(start_world(label, n, overrides, prompts, base=base,
                                  grid=grid, **extra))


def run_worlds(phases):
    """The multi-rank phases in order: (slice, label, start, run), where
    start() starts the phase's world (`start_world`; None for a phase of
    this process alone) and run(world=world) runs the phase on it. Each
    world's ranks start while the phase before it runs, so their start-up
    (about 10 s a process: the interpreter, torch, the port) overlaps that
    phase's work; they wait at their gate until it has ended. Prints each
    slice's time. -> {label: run's result}."""
    out, world, pending, t0 = {}, None, None, time.time()
    try:
        for i, (sl, label, start, run) in enumerate(phases):
            world = pending or (start() if start is not None else None)
            nxt = phases[i + 1] if i + 1 < len(phases) else None
            pending = nxt[2]() if nxt is not None and nxt[2] is not None else None
            out[label] = run(world=world)
            if nxt is None or nxt[0] != sl:
                print(f"slice {sl} phases {time.time() - t0:.1f} s", flush=True)
                t0 = time.time()
    finally:
        for w in (world, pending):
            if w is not None:
                stop_world(w)
    return out


def record_decode_routes(torch, eng, seen, route_watchers):
    """On rank 0 of a world of one stage: the experts that every MoE layer
    of the burst's decode steps (windows and the decode rows of hybrid
    steps) chose for each live row, kept by request id and the position
    of the token fed ({rid: {pos: [layers, k] ascending}}). A row's
    request is found by its block table's first page after the step,
    while the request still holds it."""
    model, ex = eng.model, eng.executor
    cur, pending, out = [], [], {}

    def watching(fn, rows):
        def call(*a, **k):
            live = "burst" in seen and "burst_end" not in seen
            if live:
                route_watchers.append(cur.append)
            try:
                return fn(*a, **k)
            finally:
                if live:
                    route_watchers.remove(cur.append)
                    tables, seq, valid = rows(*a)
                    B = tables.shape[0]
                    if cur:
                        pending.append((tables[:, 0].clone(), seq.clone(),
                                        valid.clone(),
                                        torch.stack([c[:B] for c in cur])))
                    cur.clear()
        return call

    # decode(cache, tokens, seq_lens, tables, valid); step_hybrid(cache,
    # tokens, seq_lens, tables, valid, <the prefill rows>)
    model.decode = watching(model.decode, lambda *a: (a[3], a[2], a[4]))
    model.step_hybrid = watching(model.step_hybrid, lambda *a: (a[3], a[2], a[4]))
    step = ex.step

    def stepping(tasks):
        got = step(tasks)
        if pending:
            page0 = {}
            for t in tasks:
                first = int(eng.cache.allocator.block_table([t.task_id], 1)[0, 0])
                if first >= 0:
                    page0[first] = t.req.request_id
            for first, seq, valid, sel in pending:
                sel = sel.sort(-1).values.to("cpu", torch.int64)
                for i, (f, q, v) in enumerate(zip(first.tolist(), seq.tolist(),
                                                  valid.tolist())):
                    if v and f in page0:
                        out.setdefault(page0[f], {})[q] = sel[:, i]
            pending.clear()
        return got

    ex.step = stepping
    return out


def record_sliced_acts(eng, seen):
    """Every W8A8 quantization of a row-parallel input slice (`linear`'s
    `quant_acts_rows` with the group's `row_max`) in the shadowed steps:
    [(the slice, its int8 values, its scales)] on the host."""
    from chitu_tpu_torch.models import llama
    from chitu_tpu_torch.ops import linear

    kept = []
    rows = linear.quant_acts_rows

    def keeping(x, row_max=None):
        q = rows(x, row_max)
        if row_max is not None and "routes" in seen and "routes_end" not in seen:
            kept.append((x.cpu(), q.data.cpu(), q.scale.cpu()))
        return q

    linear.quant_acts_rows = llama.quant_acts_rows = keeping
    return kept


PPL_WINDOW = 512  # a perplexity window; the stride is the window


def ppl_tokens(V):
    """The fixed token sequence a world's and the one-rank engine's
    perplexities are measured on: 1,200 tokens, three windows."""
    import numpy as np

    rng = np.random.default_rng(17)
    return [int(x) for x in rng.integers(1, V, size=1200)]


def tp_rank_main(spec_path):
    """One rank of a TP or PP phase. Ranks that share the card come up one
    after another (each draws every leaf whole before it keeps its part).
    Rank 0 serves the burst: its chat message over HTTP to the server on
    its engine and the seven prompts through `Engine.submit`, all at once;
    then a lone request, and a prefill, a hybrid and a decode step with
    every kernel call shadowed by its plain version (and, where the spec
    asks, a perplexity through the lockstep). The other ranks follow it
    (`Engine.follow`). Every rank counts its kernel launches and its
    pipelined decode windows in the burst: rank 0 marks the burst's start
    and end in its step stream, which every rank applies in lockstep.
    Then every rank runs the teacher-forced prefills of rank 0's streams
    (`stream_rows`), and the sampling rank (rank 0 under TP alone, the
    last stage's first rank under PP, of replica 0 under DP) keeps the
    rows."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import urllib.request

    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chitu_tpu_torch.parallel import distributed, pipeline
    from chitu_tpu_torch.serve import BackgroundServer

    with open(spec_path) as f:
        spec = json.load(f)
    # wait, touching nothing on the card, until the phase before has
    # ended (`join_world`), or this script has
    go, parent = os.path.join(spec["out"], GO), os.getppid()
    while not os.path.exists(go):
        if os.getppid() != parent:
            sys.exit(3)
        time.sleep(0.05)
    with open(go) as f:
        os.environ["CHITU_TPU_COORDINATOR"] = f.read()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(overrides=spec["overrides"])
    t0 = time.time()
    distributed.maybe_initialize(cfg)
    world = dist.get_world_size()
    shared = torch.cuda.device_count() < world
    for r in range(world if shared else 1):
        if not shared or r == dist.get_rank():
            eng = Engine(cfg, params=seeded_params if spec.get("seeded") else None)
            torch.cuda.synchronize()
            res = dict(bringup_s=time.time() - t0)
            # the whole leaves' blocks go back to the card for the next rank
            free_memory(torch)
        if shared:
            dist.barrier()
    rank = eng.rank
    res.update(rank=rank, stage=eng.group.stage, replica=eng.group.replica,
               backend=eng.group.backend,
               device=str(eng.device), weight_bytes=eng.weight_bytes(),
               pool_bytes=eng.cache.bytes(),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[{spec['label']}] rank {rank} (stage {res['stage']}): backend "
          f"{res['backend']} on {res['device']}, weights "
          f"{res['weight_bytes'] / 2**30:.3f} GiB, pool "
          f"{res['pool_bytes'] / 2**30:.3f} GiB, bring-up "
          f"{res['bringup_s']:.1f} s", flush=True)
    # the burst's launches and pipelined windows on every rank, between
    # rank 0's marks; a checksum of every router call's selections in the
    # shadowed steps, between two more marks
    windows, seen, routes, rings, route_watchers = [0], set(), [], [0], []
    decode_pipelined = pipeline.decode_pipelined

    def counted(*a, **k):
        windows[0] += 1
        return decode_pipelined(*a, **k)

    pipeline.decode_pipelined = counted
    prefill_ring = getattr(eng.model, "_prefill_ring", None)
    if prefill_ring is not None:
        def ringed(*a, **k):
            rings[0] += 1
            return prefill_ring(*a, **k)

        eng.model._prefill_ring = ringed
    from chitu_tpu_torch.models import deepseek_v3, mixtral, moe

    def routing(*a, **k):
        w, sel = moe.route(*a, **k)
        if "routes" in seen and "routes_end" not in seen:
            routes.append(zlib.crc32(sel.cpu().numpy().tobytes()))
        for keep in route_watchers:
            keep(sel)
        return w, sel

    mixtral.route = deepseek_v3.route = routing
    if spec.get("decode_routes") and rank == 0:
        decode_routes = record_decode_routes(torch, eng, seen, route_watchers)
    if spec.get("acts"):
        acts = record_sliced_acts(eng, seen)
    apply = eng._apply

    def marking(msg):
        for op, arg in msg["ops"]:
            if op != "mark":
                continue
            if arg == "burst":
                tk.reset_launch_counts()
                windows[0] = rings[0] = 0
            elif arg == "burst_end":
                res["launches"] = {k: v for k, v in tk.LAUNCHES.items() if v}
                res["pipelined_windows"] = windows[0]
                res["ring_prefills"] = rings[0]
            seen.add(arg)
        apply(msg)

    eng._apply = marking
    if rank != 0:
        eng.follow()
    else:
        greedy = SampleParams(temperature=0.0, max_new_tokens=TP_NEW)
        reqs, submit, prompt_of = [], eng.submit, {}

        def recording(*a, **k):
            r = submit(*a, **k)
            reqs.append(r)
            prompt_of[r.request_id] = list(eng._staged[r.request_id].tokens)
            return r

        eng.submit = recording
        srv = BackgroundServer(cfg, engine=eng)
        port = srv.start()
        http = {}

        def mark(name):
            # the server's worker thread steps it into the stream
            with eng._lock:
                eng._outbox.append(("mark", name))
            srv.ctx.wake.set()
            while name not in seen:
                time.sleep(0.005)

        def post():
            body = json.dumps({"messages": [{"role": "user", "content": TP_MSG}],
                               "max_tokens": TP_NEW, "temperature": 0.0}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/chat/completions", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TP_TIMEOUT) as r:
                http["resp"] = json.loads(r.read())

        mark("burst")
        torch.cuda.synchronize()
        t1 = time.time()
        th = threading.Thread(target=post)
        th.start()
        api = [eng.submit("", greedy, prompt_tokens=p) for p in spec["prompts"]]
        srv.ctx.wake.set()
        th.join()
        while any(r.finish_reason is None for r in api):
            time.sleep(0.01)
        torch.cuda.synchronize()
        res["burst_wall_s"] = time.time() - t1
        mark("burst_end")
        srv.ctx.stop_flag.set()
        srv.ctx.worker.join()
        srv._loop.call_soon_threadsafe(srv._loop.stop)
        srv._thread.join(timeout=5)
        eng.submit = submit
        res["decode_tokens_per_s_batch1"], res["lone"] = lone_decode_rate(
            eng, spec["prompts"][0][:64])
        if spec.get("batch"):
            res[f"decode_tokens_per_s_batch{spec['batch']}"] = batch_decode_rate(
                eng, spec["prompts"], spec["batch"])
        msg = [r for r in reqs if r not in api]
        reqs_all = api + msg[:1]
        res["api"] = [list(r.async_stream.tokens) for r in api]
        res["http"] = list(msg[0].async_stream.tokens) if len(msg) == 1 else None
        res["http_prompt"] = prompt_of[msg[0].request_id] if len(msg) == 1 else None
        res["http_usage"] = http["resp"]["usage"]
        # a prefill step, a hybrid step (the first request's decode row
        # beside a second request's prefill: B4 and B3 where the family
        # takes them) and a decode step, every kernel call of rank 0
        # shadowed by its plain version on equal inputs
        errs = {}
        rng = np.random.default_rng(5)
        p = [int(x) for x in rng.integers(1, cfg.models.vocab_size, 300)]
        q = [int(x) for x in rng.integers(1, cfg.models.vocab_size, 200)]
        with eng._lock:  # every rank applies it before the first step
            eng._outbox.append(("mark", "routes"))
        with torch.no_grad(), shadowed_attention(torch, tk, errs), \
                shadowed(torch, errs):
            two = SampleParams(temperature=0.0, max_new_tokens=2)
            eng.submit("", two, prompt_tokens=p)
            eng.step()
            eng.submit("", two, prompt_tokens=q)
            eng.step()
            eng.step()
        with eng._lock:  # ... and this one before the next
            eng._outbox.append(("mark", "routes_end"))
        eng.run_until_complete()
        res["shadowed_call_err_vs_plain"] = errs
        if spec.get("ppl"):
            # through the world's lockstep: every rank runs its part
            from chitu_tpu_torch import evals

            t1 = time.time()
            res["ppl"] = evals.perplexity_from_tokens(
                eng, ppl_tokens(cfg.models.vocab_size), window=PPL_WINDOW)
            res["ppl_s"] = time.time() - t1
        eng.terminate()
    pipeline.decode_pipelined = decode_pipelined
    # every decoded position of rank 0's streams and its lone request,
    # through the world
    pairs = eng.group.decide(
        list(zip(spec["prompts"] + [res["http_prompt"], spec["prompts"][0][:64]],
                 res["api"] + [res["http"], res["lone"]])) if rank == 0 else None)
    rows, tf_routes = [], []
    for p, a in pairs:
        if a:
            row, sel = routed_rows(torch, tk, eng, p, a)
            rows.append(row)
            tf_routes.append(sel)
    res["routes"] = routes
    if spec.get("decode_routes") and rank == 0:
        # each stream's experts in the world's decode, by the position of
        # the token fed (the streams as `pairs` orders them)
        streams = []
        for r in reqs_all:
            got = decode_routes.get(r.request_id, {})
            n = len(prompt_of[r.request_id])
            toks = list(r.async_stream.tokens)
            streams.append([got.get(n + m) for m in range(len(toks) - 1)])
        torch.save(streams, os.path.join(spec["out"], "decode_routes.pt"))
    if spec.get("acts"):
        torch.save(acts, os.path.join(spec["out"], f"acts{rank}.pt"))
    if eng.group.world_rank == eng.group.sampler:
        torch.save([r.cpu() for r in rows],
                   os.path.join(spec["out"], "tp_rows.pt"))
    if spec.get("reinit"):
        res["reinit"] = world_reinit(eng, cfg, spec["reinit"])
    if (eng.group.rank == 0 and eng.group.replica == 0
            and any(s.numel() for s in tf_routes)):
        # the stage's first TP rank: its layers' selections
        torch.save(tf_routes, os.path.join(spec["out"],
                                           f"tf_routes{eng.group.world_rank}.pt"))
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    from chitu_tpu_torch.parallel import distributed

    distributed.shutdown()


def tp_phase(torch, np, tk, card, label, n, overrides, need, backend="gloo",
             world=None):
    """A TP phase: the tp=1 reference engine, then the world of n ranks on
    the same seed. Held: every rank's backend is `backend` (gloo: the ranks
    share one card; nccl: a card each, `scripts/torch_tp_cards.py`); rank r's weight bytes are (total - norms) / n + norms and
    its pool bytes total / n; rank 0's streams, the HTTP one included,
    equal the tp=1 streams or part from them at a near tie (judged on the
    tp=1 engine's rows), and at every position of them the world's
    teacher-forced row stays within the noise of the tp=1 engine's and the
    decoded token is a near tie (`every_position`); the kernels
    in `need` launched on rank 0 in the burst; every shadowed call within
    its limit. `world`: the phase's world, started (`start_world`)."""
    ref_eng, ref = tp_reference(torch, np, label, overrides)
    ranks, tp_rows = join_world(
        world or start_world(label, n, overrides, ref["prompts"]))
    r0 = ranks[0]
    for res in ranks:
        if res["backend"] != backend:
            raise AssertionError(f"[{label}] rank {res['rank']} on {res['backend']}")
        norms = ref["norm_bytes"]
        if (res["weight_bytes"] - norms) * n != ref["weight_bytes"] - norms:
            raise AssertionError(f"[{label}] rank {res['rank']} holds "
                                 f"{res['weight_bytes']} weight bytes of "
                                 f"{ref['weight_bytes']}")
        if res["pool_bytes"] * n != ref["pool_bytes"]:
            raise AssertionError(f"[{label}] rank {res['rank']} pool "
                                 f"{res['pool_bytes']} of {ref['pool_bytes']}")
    for k in need:
        if r0["launches"].get(k, 0) <= 0:
            raise AssertionError(f"[{label}] kernel {k} did not launch on rank 0")
    if r0["http"] is None or r0["http_usage"]["completion_tokens"] != TP_NEW:
        raise AssertionError(f"[{label}] the HTTP request: {r0['http_usage']}")
    got = r0["api"] + [r0["http"]]
    want = ref["api"] + [ref["http"]]
    prompts = ref["prompts"] + [ref["http_prompt"]]
    div = near_tie(torch, tk, ref_eng, label, prompts, got, want)
    rows = every_position(torch, tk, ref_eng, label, prompts, got, tp_rows)
    same = sum(a == b for a, b in zip(got, want))
    ref_eng.terminate()
    del ref_eng
    free_memory(torch)
    stats = dict(
        phase=label, card=card, tp=n, layers=ref["layers"], backend=r0["backend"],
        streams_equal=same, streams=len(got), divergences=div,
        every_position=rows,
        rank_weight_bytes=[r["weight_bytes"] for r in ranks],
        rank_pool_bytes=[r["pool_bytes"] for r in ranks],
        tp1_weight_bytes=ref["weight_bytes"], tp1_pool_bytes=ref["pool_bytes"],
        replicated_bytes=ref["norm_bytes"],
        rank_bringup_s=[r["bringup_s"] for r in ranks],
        rank_peak_gib=[r["peak_gib"] for r in ranks],
        burst_wall_s=r0["burst_wall_s"], tp1_burst_wall_s=ref["burst_wall_s"],
        decode_tokens_per_s_batch1=r0["decode_tokens_per_s_batch1"],
        tp1_decode_tokens_per_s_batch1=ref["decode_tokens_per_s_batch1"],
        rank_devices=[r["device"] for r in ranks],
        launches_rank0=r0["launches"],
        shadowed_call_err_vs_plain=r0["shadowed_call_err_vs_plain"])
    print("tp " + json.dumps(stats), flush=True)
    return stats


def every_position(torch, tk, eng, label, prompts, streams, tp_rows,
                   tie=NEAR_TIE, world_routes=None, own_routes=None):
    """Every decoded position of the TP world's streams against the tp=1
    engine, on teacher-forced rows of the same context (`stream_rows`: the
    tp=1 engine's with the kernels and plain, the world's own in
    `tp_rows`), with sigma = sqrt(2) x the rms of the tp=1 row's
    kernels-vs-plain difference (near_tie's). Held at each position: the
    world's row differs from the tp=1 row by an rms within NOISE_SIGMAS
    sigma; the decoded token is the top of the world's row or of the tp=1
    row, or a near tie on one of them (within NEAR_TIE of the row's spread
    or NOISE_SIGMAS sigma below its top). Prints the rows checked, the
    rms in sigma, and how many tokens sit below the top of which row and
    by how much. `world_routes` (an MoE card under tensor parallelism,
    where a router near tie that the all-reduce's other summing order
    tips moves a row by a whole expert's output): the world's experts of
    each stream's teacher-forced tokens, every MoE layer (`routed_rows`),
    against the tp=1 engine's; a row beyond NOISE_SIGMAS sigma passes
    only when its own token's experts flipped, or within NEIGHBOUR_SIGMAS
    sigma when a flip came at most FLIP_REACH tokens before it, and the
    median shift is held within NOISE_SIGMAS sigma. `own_routes` (a world
    of one stage): each stream's experts in the world's own decode, by
    the token fed (`record_decode_routes`), against the world's own
    teacher-forced prefill (`world_routes`): a decoded token that is no
    near tie of either row passes only when the world's decode routed the
    token it was predicted from to other experts than the world's
    prefill did (its teacher-forced row is then not what the decode saw),
    or, within NEIGHBOUR_SIGMAS sigma of the top of the world's row, when
    such a flip came at most FLIP_REACH tokens before it: the world held
    to its own decode-against-prefill deviation, as the one-rank engine
    is (`own_deviation`). Each such token is printed with the routes on
    both sides.
    -> those numbers."""
    out = dict(rows=0, below_top={}, worst_spread={}, worst_sigma={})
    if world_routes is not None:
        out.update(rows_beyond=0, rows_own_flip=0, rows_after_a_neighbour=0,
                   beyond_after_a_neighbour=[])
    if own_routes is not None:
        out.update(decode_positions=0, decode_flips=0, tokens_by_own_flip=[])
    shifts = []
    for i, (p, a, tp) in enumerate(zip(prompts, streams, tp_rows)):
        if world_routes is None:
            k = stream_rows(torch, tk, eng, p, a)
        else:
            k, sel = routed_rows(torch, tk, eng, p, a)
            theirs = world_routes[i]
            if sel.shape != theirs.shape or not sel.numel():
                raise AssertionError(
                    f"[{label}] stream {i}: the world's router selections "
                    f"{tuple(theirs.shape)}, the tp=1 engine's {tuple(sel.shape)}")
            # tokens from the last flip to each row's own token (row j
            # predicts from token len(p) - 1 + j)
            differs = (sel != theirs).any(-1).any(0)
            at = torch.arange(len(differs))
            last = torch.where(differs, at, torch.full_like(
                at, -len(at) - FLIP_REACH - 1)).cummax(0).values
            since = (at - last)[len(p) - 1:].to(k.device)
        pl = stream_rows(torch, tk, eng, p, a, plain=True)
        tp = tp.to(k.device)
        sigma = math.sqrt(2.0) * (k - pl).pow(2).mean(-1).sqrt()
        shift = (tp - k).pow(2).mean(-1).sqrt() / sigma
        shifts.append(shift)
        at = torch.arange(len(a), device=k.device)
        dec = torch.tensor(a, device=k.device)
        near = {}
        for what, row, tok in (("decoded_on_tp1", k, dec),
                               ("decoded_on_world", tp, dec),
                               ("world_argmax_on_tp1", k, tp.argmax(-1))):
            top = row.max(-1).values
            gap = top - row[at, tok]
            spread = top - row.min(-1).values
            near[what] = (gap <= tie * spread) | (gap <= NOISE_SIGMAS * sigma)
            below = gap > 0
            out["below_top"][what] = out["below_top"].get(what, 0) + int(below.sum())
            if below.any():
                out["worst_spread"][what] = max(out["worst_spread"].get(what, 0.0),
                                                (gap / spread)[below].max().item())
                out["worst_sigma"][what] = max(out["worst_sigma"].get(what, 0.0),
                                               (gap / sigma)[below].max().item())
        far = shift > NOISE_SIGMAS
        if world_routes is not None:
            own = since == 0
            after = (since > 0) & (since <= FLIP_REACH)
            out["rows_beyond"] += int(far.sum())
            out["rows_own_flip"] += int(own.sum())
            out["rows_after_a_neighbour"] += int(after.sum())
            for j in (far & ~own).nonzero().flatten().tolist():
                out["beyond_after_a_neighbour"].append(
                    [i, j, int(since[j]), shift[j].item()])
            far = far & ~own & ~(after & (shift <= NEIGHBOUR_SIGMAS))
        if far.any():
            j = int(far.nonzero()[0])
            raise AssertionError(
                f"[{label}] stream {i}, token {j}: the world's row differs from "
                f"the tp=1 row by an rms of {shift[j].item():.3f} sigma (limit "
                f"{NOISE_SIGMAS}){'' if world_routes is None else ' and no router flip that allows it'}")
        off = ~(near["decoded_on_tp1"] | near["decoded_on_world"])
        if own_routes is not None and own_routes[i] is not None:
            # the world's decode against its own prefill, by row: row j
            # was predicted from stream token j - 1 (fed at len(p) + j - 1)
            prefill = world_routes[i][:, len(p):]
            flip = torch.zeros(len(a), dtype=torch.bool)
            flipped = {}
            for m, sel_m in enumerate(own_routes[i]):
                if sel_m is None:
                    continue
                out["decode_positions"] += 1
                if not torch.equal(sel_m, prefill[:, m]):
                    flip[m + 1] = True
                    layers = (sel_m != prefill[:, m]).any(-1).nonzero().flatten()
                    flipped[m + 1] = [[int(ly), sel_m[ly].tolist(),
                                       prefill[ly, m].tolist()] for ly in layers]
            out["decode_flips"] += int(flip.sum())
            at_c = torch.arange(len(a))
            last = torch.where(flip, at_c, torch.full_like(
                at_c, -len(at_c) - FLIP_REACH - 1)).cummax(0).values
            since_w = (at_c - last).to(k.device)
            top_w = tp.max(-1).values
            gap_w = top_w - tp[at, dec]
            spread_w = top_w - tp.min(-1).values
            gap_k = k.max(-1).values - k[at, dec]
            spread_k = k.max(-1).values - k.min(-1).values
            ok = off & ((since_w == 0) | (
                (since_w <= FLIP_REACH) & (gap_w <= NEIGHBOUR_SIGMAS * sigma)))
            for j in ok.nonzero().flatten().tolist():
                f = j - int(since_w[j])
                out["tokens_by_own_flip"].append(dict(
                    stream=i, token=j, tokens_since_the_flip=int(since_w[j]),
                    share_of_spread_world=(gap_w[j] / spread_w[j]).item(),
                    share_of_spread_tp1=(gap_k[j] / spread_k[j]).item(),
                    sigma_world=(gap_w[j] / sigma[j]).item(),
                    flip_at_token=f,
                    routes_decode_vs_prefill=flipped.get(f)))
            off = off & ~ok
        if off.any():
            j = int(off.nonzero()[0])
            raise AssertionError(
                f"[{label}] stream {i}, token {j}: the decoded token {a[j]} is "
                "no near tie of the tp=1 row nor of the world's row")
        out["rows"] += len(a)
    shifts = torch.cat(shifts)
    out["tp_vs_tp1_rms_sigma"] = dict(median=shifts.median().item(),
                                      max=shifts.max().item())
    if world_routes is not None:
        if out["tp_vs_tp1_rms_sigma"]["median"] > NOISE_SIGMAS:
            raise AssertionError(
                f"[{label}] the world's rows differ from the tp=1 rows by a "
                f"median rms of {out['tp_vs_tp1_rms_sigma']['median']:.3f} "
                f"sigma (limit {NOISE_SIGMAS})")
        print(f"[{label}] {out['rows_beyond']} of {out['rows']} rows beyond "
              f"{NOISE_SIGMAS} sigma of the tp=1 rows; {out['rows_own_flip']} rows "
              f"whose own token's experts flipped (not held), "
              f"{out['rows_after_a_neighbour']} within {FLIP_REACH} tokens after "
              f"a flip (held within {NEIGHBOUR_SIGMAS} sigma), the rest within "
              f"{NOISE_SIGMAS}; beyond without a flip of their own [stream, row, "
              f"tokens since the flip, sigma]: {out['beyond_after_a_neighbour']}",
              flush=True)
    if own_routes is not None:
        print(f"[{label}] the world's own decode against its own prefill: "
              f"{out['decode_flips']} of {out['decode_positions']} decoded "
              "positions routed to other experts; decoded tokens no near tie "
              "of either row, passed by such a flip [stream, token, tokens "
              "since the flip, share of the world row's spread, of the tp=1 "
              "row's, sigma on the world row, [layer, decode's experts, "
              f"prefill's experts]]: {[[t['stream'], t['token'], t['tokens_since_the_flip'], round(t['share_of_spread_world'], 4), round(t['share_of_spread_tp1'], 4), round(t['sigma_world'], 2), t['routes_decode_vs_prefill']] for t in out['tokens_by_own_flip']]}",
              flush=True)
    print(f"[{label}] every position: {out['rows']} rows; the world's rows "
          f"against tp=1's: rms {out['tp_vs_tp1_rms_sigma']} sigma (limit "
          f"{NOISE_SIGMAS}); tokens below the top {out['below_top']}, at most "
          f"{out['worst_spread']} of the spread and {out['worst_sigma']} sigma "
          f"(a decoded token passes within {tie} or {NOISE_SIGMAS} sigma "
          "on either row)", flush=True)
    return out


TP_PHASES = [
    # (label, ranks, overrides, kernels that must launch on rank 0)
    # 2 of 32 layers (4 until the slice 18 phases came, 8 before slice 16),
    # tp4 2: a
    # 32-layer burst takes about two minutes through gloo, the bytes and
    # streams hold at any depth, and scripts/torch_tp_cards.py runs all 32
    # on a card a rank
    ("tp2", 2, ["models.n_layers=2"], ATTN_KERNELS),
    ("tp2_soft_fp8", 2, ["models.n_layers=2", "quant.method=soft_fp8",
                         "quant.quant_on_load=true"],
     ATTN_KERNELS + ("quant_gemm",)),
    ("tp4", 4, ["models.n_layers=2"], ATTN_KERNELS),
]
# ---------------------------------------------------------------------------
# Slice 14: pipeline parallelism (ranks sharing the card over gloo)
# ---------------------------------------------------------------------------

PP_PHASES = [
    # (label, model card, pp, tp, overrides, kernels that must launch on
    # every rank in the burst: each stage runs them on its own layers).
    # pp2 at 2 of 32 layers (4 until slice 18, 8 in PR 16), pp2_mixtral at
    # 2 (4 until slice 18) and pp2_tp2 at 2 since the later slices' phases
    # came (32 and 4 before; scripts/torch_pp_cards.py runs all 32 on a
    # card a rank)
    ("pp2", LLAMA, 2, 1, ["models.n_layers=2"], ATTN_KERNELS),
    ("pp2_tp2", LLAMA, 2, 2, ["models.n_layers=2"], ATTN_KERNELS),
    ("pp2_mixtral", MIXTRAL, 2, 1, ["models.n_layers=2"],
     ATTN_KERNELS + ("grouped_gemm",)),
    ("pp2_r1", R1, 2, 1, ["models.n_layers=5"],
     ("attend_decode_fused[latent]", "attend_prefill_packed[latent]",
      "absorb_matmul", "grouped_gemm")),
]


def held_whole(layout, name):
    """Does every TP rank of a stage hold the full leaf `name` whole (the
    norms, the MoE router, the latent down-projections)? Read from the
    model's layout (`TPLayout`, `MLALayout`): a spec with every entry None;
    a merged leaf by its parts'."""
    from chitu_tpu_torch.models import deepseek_v3, llama

    parts = {**llama.MERGES, **deepseek_v3.MERGES}.get(name, (name,))
    return all(e is None for n in parts for e in layout.part_spec(n, 4))


def stage_bytes(eng, pp, tp):
    """Each rank's (weight bytes, pool bytes) in a pp x tp world, from the
    one-rank engine's leaves: rank (p, t) holds of each stacked leaf its
    stage's layers (`StageSlice`: L // pp, the first L % pp stages one
    more), of those 1 / tp (the whole of the leaves every rank holds,
    `held_whole`), plus embed / tp on stage 0 and head / tp + norm on the
    last, and its layers' pool / tp; DeepSeek: the dense-first stack and
    its pool on stage 0, the stage's MoE layers and their pool on each
    stage, the latent pools whole over tp (the dense MLA's per-head pools
    / tp)."""
    from chitu_tpu_torch.models import deepseek_v3, llama
    from chitu_tpu_torch.ops.qtensor import QTensor
    from chitu_tpu_torch.parallel.sharding import StageSlice, safe_spec

    def size(t):
        if isinstance(t, dict):
            return sum(size(v) for v in t.values())
        return t.nbytes() if isinstance(t, QTensor) else t.numel() * t.element_size()

    # the one-rank engine's layout at the world's tp: which leaves cut
    import dataclasses

    lay = dataclasses.replace(eng.model.layout, tp=tp)

    def part(k, v, t):
        # a row-parallel weight's per-out-channel scale stays whole
        # (`sharding.narrow_rows`): W8A16 and W8A8 `wo`, `w_down`
        if held_whole(lay, k):
            return size(v)
        nd = v.data.dim() if isinstance(v, QTensor) else v.dim()
        parts = {**llama.MERGES, **deepseek_v3.MERGES}.get(k, (k,))
        widths = getattr(lay, "widths", {}).get(k)
        shape = list(v.shape)
        if widths:
            shape[-1] = widths[0]
        # a dim tp does not divide stays whole (`sharding.safe_spec`)
        spec = safe_spec(lay.part_spec(parts[0], nd), shape, tp)
        if all(e is None for e in spec):
            return size(v)
        if "ep" in spec:
            # experts in contiguous ranges, the first E % tp ranks one more
            E = v.shape[spec.index("ep")]
            return size(v) // E * (E // tp + (t < E % tp))
        if isinstance(v, QTensor) and v.scale.dim() < v.data.dim():
            if spec[-2] is not None and spec[-1] is None:
                sc = v.scale.numel() * v.scale.element_size()
                return (size(v) - sc) // tp + sc
        if isinstance(v, QTensor) and v.scale.dim() == v.data.dim():
            cut = block_cut_bytes(v, spec, t, tp, widths)
            if cut is not None:
                return cut
        return size(v) // tp

    def share(leaves, t):
        return sum(part(k, v, t) for k, v in leaves.items())

    tree = eng.model.params_tree()
    top = {k: size(tree.get(k, {})) for k in ("embed", "norm", "lm_head")}
    pools = {k: size(v) for k, v in eng.cache.arrays.items()}
    m = eng.model
    out = []
    # heads that tp does not divide: attention and its pool replicate
    htp = tp if lay.heads_split else 1
    V = m.args.vocab_size
    vtp = tp if V % tp == 0 else 1
    for r in range(pp * tp):
        p, t = r // tp, r % tp
        if "moe_layers" in tree:
            n = m.n_moe
            held = StageSlice.of(p, pp, {"moe_layers": n}).count("moe_layers", n)
            # the latent pools are whole on every TP rank, the dense
            # MLA's per-head pools cut by heads
            ptp = 1 if m.absorb else htp
            w = share(tree["moe_layers"], t) // n * held
            pool = pools["kv_moe"] // n * held // ptp
            if p == 0:
                w += share(tree.get("dense_layers", {}), t) + top["embed"] // vtp
                pool += pools["kv_dense"] // ptp
        else:
            n = m.args.n_layers
            held = StageSlice.of(p, pp, {"layers": n}).count("layers", n)
            w = share(tree["layers"], t) // n * held
            w += top["embed"] // vtp if p == 0 else 0
            pool = pools["kv"] // n * held // htp
        if p == pp - 1:
            w += top["lm_head"] // vtp + top["norm"]
        out.append((w, pool))
    return out


def block_cut_bytes(v, spec, t, tp, widths=None):
    """Bytes of TP rank t's cut of a quantized [L, K, N] leaf with
    blockwise or groupwise scales along the cut dim (e4m3 [K/B, N/B] or
    [K/B, N], int4 [K/G, N] with zeros), when a cut falls inside a block:
    the whole blocks over the rank's equal slice of each part (`widths`:
    a merged leaf's parts along the columns, each cut on its own), which
    are its share plus the overlap, and those blocks' scales (and zeros).
    The plain arithmetic of the sharding rule; None when every cut falls
    on a block edge (then the rank holds 1 / tp)."""
    if v.data.dim() != 3 or (spec[-2] is None) == (spec[-1] is None):
        return None
    L, K, N = v.data.shape
    b, item = v.block, v.data.element_size()
    aux = [a for a in (v.scale, v.zeros) if a is not None]
    per_col = aux[0].shape[-1] == N  # rowwise / groupwise: a scale a column

    def cover(n):
        per = n // tp
        a, e = t * per // b * b, (t + 1) * per
        return min(-(-e // b) * b, n) - a

    if spec[-2] is not None:  # rows
        if K % (tp * b) == 0:
            return None
        rows = cover(K)
        return (L * rows * N * item
                + len(aux) * L * -(-rows // b) * aux[0].shape[-1] * 4)
    ws = widths or (N,)
    if per_col or all(w % (tp * b) == 0 for w in ws):
        return None  # a scale a column cuts exactly; so do block edges
    cols = [cover(w) for w in ws]
    return (L * K * sum(cols) * item
            + len(aux) * L * aux[0].shape[-2] * sum(-(-c // b) for c in cols) * 4)


def sliced_acts_check(torch, label, ranks, tp):
    """W8A8 under TP: every row-parallel input slice that rank r quantized
    in the shadowed steps (B12's PARTIAL and GIVEN modes around the
    group's MAX all-reduce) equals, bit for bit, the one-rank B12 kernel
    (`quant_acts`) on the whole row, the ranks' slices joined in rank
    order, cut to rank r's columns: int8 values and scales. -> counts."""
    from chitu_tpu_torch.ops import norm_quant as nq

    calls = [res.get("acts") for res in ranks]
    if not calls[0] or any(len(c or ()) != len(calls[0]) for c in calls):
        raise AssertionError(f"[{label}] row-parallel W8A8 inputs a rank: "
                             f"{[len(c) for c in calls]}")
    widths, rows = set(), 0
    for parts in zip(*calls):
        whole = torch.cat([x for x, _, _ in parts], dim=-1).cuda()
        want = nq.quant_acts(whole)
        k0 = 0
        for r, (x, q, sc) in enumerate(parts):
            k = x.shape[-1]
            if not (torch.equal(q.cuda(), want.data[:, k0:k0 + k])
                    and torch.equal(sc.cuda(), want.scale)):
                raise AssertionError(
                    f"[{label}] rank {r}'s int8 slice of a [{whole.shape[0]}, "
                    f"{whole.shape[1]}] row-parallel input differs from the "
                    "one-rank B12 on the whole row")
            k0 += k
        widths.add(whole.shape[1])
        rows += whole.shape[0]
    out = dict(calls=len(calls[0]), rows=rows, widths=sorted(widths),
               bit_equal=True)
    print(f"[{label}] W8A8 row-parallel inputs: {out['calls']} calls a rank "
          f"({rows} rows, widths {out['widths']}), every rank's slice bit-equal "
          "to the one-rank B12 on the whole row", flush=True)
    return out


def own_deviation(torch, tk, eng, prompts, streams):
    """The largest share of the row's spread by which a decoded token of
    the engine's own `streams` lies below the top of its teacher-forced
    row (`stream_rows`)."""
    worst = 0.0
    for p, a in zip(prompts, streams):
        row = stream_rows(torch, tk, eng, p, a)
        top = row.max(-1).values
        at = torch.arange(len(a), device=row.device)
        gap = top - row[at, torch.tensor(a, device=row.device)]
        worst = max(worst, (gap / (top - row.min(-1).values)).max().item())
    return worst


def pp_world_args(np, model, pp, tp, overrides, dp=1, lens=None):
    """A PP, EP or ring phase's world: -> (the ranks' base overrides, the
    burst's API prompts, the grid's overrides)."""
    from chitu_tpu_torch import load_config

    base = [f"models={model}"] + TP_BASE[1:]
    V = load_config(overrides=base + list(overrides)).models.vocab_size
    prompts = tp_prompts(np, V)
    if lens:
        rng = np.random.default_rng(16)
        prompts = [[int(x) for x in rng.integers(1, V, size=n)] for n in lens]
    grid = [f"infer.dp_size={dp}", f"infer.pp_size={pp}", f"infer.tp_size={tp}"]
    return base, prompts, grid


def world_extras(label, model, pp, tp, overrides, dp=1):
    """What a `pp_phase` world's ranks record beyond the burst: an MoE
    card's decode routes in a world of one stage under TP
    (`record_decode_routes`), W8A8 row-parallel slices under TP
    (`record_sliced_acts`), a perplexity (`PPL_PHASES`)."""
    return dict(
        decode_routes=model in (MIXTRAL, R1) and pp == 1 and dp == 1 and tp > 1,
        acts="quant.method=w8a8" in overrides and tp > 1,
        ppl=label in PPL_PHASES)


def start_pp_world(np, label, model, pp, tp, overrides, dp=1, lens=None):
    """`start_world` for `pp_phase`."""
    base, prompts, grid = pp_world_args(np, model, pp, tp, overrides, dp, lens)
    extra = world_extras(label, model, pp, tp, overrides, dp)
    if label in REINIT:
        # after the phase, rank 0 serves /stop and /init on the same world
        # (`world_reinit`): one of another world size, then REINIT's
        ovr = base + REINIT[label] + grid + ["serve.port=0"]
        extra["reinit"] = dict(
            overrides=ovr, bad=ovr + [f"infer.tp_size={2 * tp}"],
            prompts=[p[:REINIT_LEN] for p in prompts[:REINIT_STREAMS]])
    return start_world(label, dp * pp * tp, overrides, prompts, base=base,
                       grid=grid, **extra)


# /init's overrides after a phase, on the same world (bf16, 2 layers)
REINIT = {"tp2_qwen72_fp8": ["models.n_layers=2"]}
REINIT_STREAMS, REINIT_LEN = 3, 256


def world_reinit(eng, cfg, spec):
    """Slice 18, on every rank of a world whose engine has stopped: rank 0
    serves `/stop`, an `/init` whose layout has another world size (it
    must answer 400), then `/init` with `spec["overrides"]` through the
    port's own HTTP handlers (`serve.ServerContext.rebuild`: every rank
    builds the new engine), greedy streams of `spec["prompts"]` through
    the new engine, `/stop` and the end of the world's served life
    (`end_world`); the other ranks wait in `serve.follow_world`, the
    served world's follower loop. -> rank 0's answers, streams and bytes,
    or the other ranks' bytes."""
    import urllib.error
    import urllib.request

    from chitu_tpu_torch import SampleParams
    from chitu_tpu_torch.serve import (
        BackgroundServer,
        ServerContext,
        follow_world,
    )

    t0 = time.time()
    if eng.rank != 0:
        ctx = ServerContext(cfg)
        ctx.engine = eng
        follow_world(ctx)
        new = ctx.engine
        return dict(weight_bytes=new.weight_bytes(),
                    pool_bytes=new.cache.bytes())
    srv = BackgroundServer(cfg, engine=eng)
    port = srv.start()

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=TP_TIMEOUT) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    out = dict(stop=post("/stop", {})[0])
    out["bad"] = post("/init", {"overrides": spec["bad"]})
    t1 = time.time()
    out["init"] = post("/init", {"overrides": spec["overrides"]})[0]
    out["init_s"] = time.time() - t1
    new = srv.ctx.engine
    greedy = SampleParams(temperature=0.0, max_new_tokens=TP_NEW)
    reqs = [new.submit("", greedy, prompt_tokens=p) for p in spec["prompts"]]
    srv.ctx.wake.set()
    while any(r.finish_reason is None for r in reqs):
        time.sleep(0.01)
    out.update(tokens=[list(r.async_stream.tokens) for r in reqs],
               weight_bytes=new.weight_bytes(), pool_bytes=new.cache.bytes(),
               layers=new.cfg.models.n_layers, quant=new.cfg.quant.method)
    out["stop2"] = post("/stop", {})[0]
    srv._loop.call_soon_threadsafe(srv._loop.stop)
    srv._thread.join(timeout=5)
    srv.ctx.end_world()
    out["wall_s"] = time.time() - t0
    return out


def reinit_check(torch, np, tk, label, ranks, spec_overrides, prompts, tp):
    """The /init part of a phase: the world-size change answered 400 and
    named both sizes; the rebuilt world's per-rank bytes are the one-rank
    engine's share (`stage_bytes`), and rank 0's streams equal the
    one-rank engine's on the same overrides (same seed, same weights) or
    part at a near tie. -> the record."""
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine

    r0 = ranks[0]["reinit"]
    status, body = r0["bad"]
    detail = body.get("detail", "")
    print(f"[{label}] /stop {r0['stop']}; /init of {2 * tp} ranks on {tp}: "
          f"{status} {detail!r}; /init {r0['init']} in {r0['init_s']:.1f} s "
          f"({r0['layers']} layers, quant {r0['quant']}); /stop {r0['stop2']}",
          flush=True)
    if (r0["stop"], r0["init"], r0["stop2"]) != (200, 200, 200):
        raise AssertionError(f"[{label}] /stop, /init, /stop answered "
                             f"{r0['stop']}, {r0['init']}, {r0['stop2']}")
    if status != 400 or f"{2 * tp} ranks" not in detail or (
            f"{tp} process" not in detail):
        raise AssertionError(f"[{label}] the world-size change: {status} "
                             f"{detail!r}")
    ovr = [o for o in spec_overrides if not o.startswith(
        ("infer.tp_size", "infer.pp_size", "infer.dp_size"))]
    ref = Engine(load_config(overrides=ovr))
    greedy = SampleParams(temperature=0.0, max_new_tokens=TP_NEW)
    reqs = [ref.submit("", greedy, prompt_tokens=p) for p in prompts]
    ref.run_until_complete()
    want = [list(r.async_stream.tokens) for r in reqs]
    wb = stage_bytes(ref, 1, tp)
    got_b = [(r0["weight_bytes"], r0["pool_bytes"])] + [
        (res["reinit"]["weight_bytes"], res["reinit"]["pool_bytes"])
        for res in ranks[1:]]
    print(f"[{label}] rebuilt world: rank bytes {got_b}, predicted {wb}",
          flush=True)
    if got_b != wb:
        raise AssertionError(f"[{label}] the rebuilt world's rank bytes "
                             f"{got_b}, not {wb}")
    div = near_tie(torch, tk, ref, label + " /init", prompts, r0["tokens"],
                   want)
    same = sum(a == b for a, b in zip(r0["tokens"], want))
    ref.terminate()
    del ref
    free_memory(torch)
    return dict(status_world_size_change=status, detail=detail,
                init_s=r0["init_s"], wall_s=r0["wall_s"],
                layers=r0["layers"], streams_equal=same,
                streams=len(want), divergences=div, rank_bytes=got_b)


def pp_phase(torch, np, tk, card, label, model, pp, tp, overrides, need,
             backend="gloo", dp=1, lens=None, world=None):
    """A PP or EP phase: the world of pp x tp ranks first (they share the
    card with nothing else), then the one-rank reference engine on the
    same seed, fed the HTTP request's prompt tokens as the world saw them.
    Held: every rank's backend is `backend`; rank r's weight and pool
    bytes are its stage's share (`stage_bytes`); the kernels in `need`
    launched on every rank in the burst, on the stage's own layers; the
    ranks of a stage chose the same experts in every router call of the
    shadowed steps (a checksum a call); under pp rank 0 ran pipelined
    decode windows in the burst; its lone request (the
    sequential path, the one-rank engine's shapes) gives the reference's
    tokens exactly, and its teacher-forced logits' largest difference from
    the reference's is printed; its burst streams, the HTTP one included,
    equal the reference's or part at a near tie, and hold at every
    position (`every_position`; an MoE card under TP holds the median
    row there); every shadowed call of rank 0 within its limit. Under dp
    (the slice 16 phases: `lens`, the burst's prompt lengths, else
    TP_LENS): dp x pp x tp ranks, each replica's rank holding the bytes
    of its (stage, TP index), its pool over dp under the ring KV pool; no
    pipelined window (the JAX package runs dp x pp in sequence); the
    ranks of a (replica, stage) routed alike; the lone request's tokens
    equal the reference's unless tp > 1 or the ring pool merges the
    attention partials in another order. `world`: the phase's world,
    started (`start_pp_world`). -> rank 0's launches in the burst."""
    base, prompts, _ = pp_world_args(np, model, pp, tp, overrides, dp, lens)
    ring_kv = dp > 1 and "infer.ring_kv=true" in overrides
    ring_prefill = dp > 1 and "infer.ring_prefill=true" in overrides
    ranks, rows = join_world(world or start_pp_world(
        np, label, model, pp, tp, overrides, dp, lens))
    free_memory(torch)
    r0 = ranks[0]
    ref_eng, ref = tp_reference(torch, np, label, overrides, base=base,
                                http_prompt=r0["http_prompt"], prompts=prompts)
    want = stage_bytes(ref_eng, pp, tp) * dp
    if ring_kv:
        if any(pb % dp for _, pb in want):
            raise AssertionError(f"[{label}] a pool does not stripe over {dp}")
        want = [(wb, pb // dp) for wb, pb in want]
    for res, (wb, pb) in zip(ranks, want):
        print(f"[{label}] rank {res['rank']} stage {res['stage']}: weights "
              f"{res['weight_bytes']} bytes ({res['weight_bytes'] / 2**30:.3f} "
              f"GiB; predicted {wb}), pool {res['pool_bytes']} bytes "
              f"({res['pool_bytes'] / 2**30:.3f} GiB; predicted {pb}), peak "
              f"{res['peak_gib']:.2f} GiB, pipelined windows in the burst "
              f"{res['pipelined_windows']}, launches {res['launches']}",
              flush=True)
        if res["backend"] != backend:
            raise AssertionError(f"[{label}] rank {res['rank']} on {res['backend']}")
        if (res["weight_bytes"], res["pool_bytes"]) != (wb, pb):
            raise AssertionError(f"[{label}] rank {res['rank']} holds "
                                 f"{res['weight_bytes']} weight and "
                                 f"{res['pool_bytes']} pool bytes, not {wb}, {pb}")
        for k in need:
            if res["launches"].get(k, 0) <= 0:
                raise AssertionError(f"[{label}] kernel {k} did not launch on "
                                     f"rank {res['rank']} in the burst")
    if pp > 1 and dp == 1 and r0["pipelined_windows"] <= 0:
        raise AssertionError(f"[{label}] the burst ran no pipelined window")
    if dp > 1 and any(res["pipelined_windows"] for res in ranks):
        raise AssertionError(f"[{label}] a pipelined window ran under dp")
    if ring_prefill and not all(res["ring_prefills"] for res in ranks):
        raise AssertionError(f"[{label}] a rank ran no ring prefill in the "
                             f"burst: {[r['ring_prefills'] for r in ranks]}")
    # every rank of a stage routed the shadowed steps' tokens to the same
    # experts (the all-reduces hand each rank the same hidden state)
    moe = model in (MIXTRAL, R1)
    for d in range(dp):
        for p in range(pp):
            stage = [res["routes"] for res in ranks
                     if (res["replica"], res["stage"]) == (d, p)]
            if moe and not all(stage):
                raise AssertionError(f"[{label}] stage {p}: a rank recorded no "
                                     f"router call: {[len(r) for r in stage]}")
            if any(r != stage[0] for r in stage):
                raise AssertionError(f"[{label}] stage {p}: the ranks' router "
                                     f"checksums differ: {stage}")
    routes = [len(res["routes"]) for res in ranks]
    if moe:
        print(f"[{label}] router checksums of the shadowed steps: {routes} "
              "calls a rank, equal on every rank of a stage", flush=True)
    if r0["http"] is None or r0["http_usage"]["completion_tokens"] != TP_NEW:
        raise AssertionError(f"[{label}] the HTTP request: {r0['http_usage']}")
    # the lone request: the sequential path at the one-rank shapes, equal
    # in full at tp 1 (under TP the row-parallel sums take another order)
    lone_prompt = prompts[0][:64]
    lone_ref = stream_rows(torch, tk, ref_eng, lone_prompt, r0["lone"])
    lone_diff = (rows[-1].to(lone_ref.device) - lone_ref).abs().max().item()
    # the sequential path at the one-rank shapes runs the same arithmetic
    # only without a ring: the ring pool merges the partials in another
    # order, ring prefill attends in plain PyTorch
    exact = tp == 1 and not ring_kv and not ring_prefill
    print(f"[{label}] lone request: {len(r0['lone'])} tokens, equal to the "
          f"one-rank engine's: {r0['lone'] == ref['lone']}; teacher-forced "
          f"logits' largest difference {lone_diff} (predicted "
          f"{0 if exact else 'the TP sums or ring merge noise'})", flush=True)
    if exact and r0["lone"] != ref["lone"]:
        raise AssertionError(f"[{label}] the lone request's tokens differ from "
                             "the one-rank engine's")
    got = r0["api"] + [r0["http"]]
    want_streams = ref["api"] + [ref["http"]]
    all_prompts = prompts + [r0["http_prompt"]]
    if not exact:
        got, want_streams = got + [r0["lone"]], want_streams + [ref["lone"]]
        all_prompts = all_prompts + [lone_prompt]
    # an MoE card's decode routes some tokens to other experts than its
    # teacher-forced prefill does (last-bit noise at a router near tie moves
    # a whole expert's output): its tokens are held to the largest share of
    # the spread by which the one-rank engine's own streams lie below the
    # top of its own teacher-forced rows, or NEAR_TIE_MOE if larger
    own = own_deviation(torch, tk, ref_eng, all_prompts, want_streams) if moe else 0.0
    tie = max(NEAR_TIE_MOE, own) if moe else NEAR_TIE
    if moe:
        print(f"[{label}] the one-rank engine's own streams lie at most {own:.4g} "
              f"of the spread below the top of its teacher-forced rows: the "
              f"MoE limit is {tie:.4g}", flush=True)
    div = near_tie(torch, tk, ref_eng, label, all_prompts, got, want_streams,
                   moe=moe, moe_limit=tie)
    world_routes = own_routes = None
    if moe and (tp > 1 or dp > 1):
        # the stage-first ranks' selections, layers in stage order
        firsts = sorted((res for res in ranks if "tf_routes" in res),
                        key=lambda res: res["stage"])
        if [res["stage"] for res in firsts] != list(range(pp)):
            raise AssertionError(f"[{label}] router selections came from stages "
                                 f"{[res['stage'] for res in firsts]}")
        world_routes = [torch.cat(s) for s in zip(*(res["tf_routes"]
                                                     for res in firsts))]
    extras = world_extras(label, model, pp, tp, overrides, dp)
    if extras["decode_routes"]:
        own_routes = r0["decode_routes"] + [None] * (len(got) - len(
            r0["decode_routes"]))
    pos = every_position(torch, tk, ref_eng, label, all_prompts, got, rows,
                         tie=tie, world_routes=world_routes,
                         own_routes=own_routes)
    acts = sliced_acts_check(torch, label, ranks, tp) if extras["acts"] else None
    ppl = None
    if extras["ppl"]:
        from chitu_tpu_torch import evals

        want_ppl = evals.perplexity_from_tokens(
            ref_eng, ppl_tokens(ref_eng.cfg.models.vocab_size), window=PPL_WINDOW)
        ppl = dict(world=r0["ppl"], one_rank=want_ppl, world_s=r0["ppl_s"],
                   rel=abs(r0["ppl"] - want_ppl) / want_ppl)
        print(f"[{label}] perplexity of {len(ppl_tokens(2))} tokens "
              f"(windows of {PPL_WINDOW}): the world's {r0['ppl']} in "
              f"{r0['ppl_s']:.2f} s, the one-rank engine's {want_ppl}, "
              f"relative {ppl['rel']:.3g} (limit {PPL_RTOL})", flush=True)
        if not ppl["rel"] <= PPL_RTOL:
            raise AssertionError(f"[{label}] the world's perplexity "
                                 f"{r0['ppl']} against {want_ppl}")
    same = sum(a == b for a, b in zip(got, want_streams))
    ref_eng.terminate()
    del ref_eng
    free_memory(torch)
    reinit = None
    if label in REINIT:
        ovr = base + REINIT[label] + ["serve.port=0"]
        reinit = reinit_check(torch, np, tk, label, ranks, ovr,
                              [p[:REINIT_LEN] for p in prompts[:REINIT_STREAMS]],
                              tp)
    stats = dict(
        phase=label, card=card, model=model, dp=dp, pp=pp, tp=tp, reinit=reinit,
        ring_kv=ring_kv, ring_prefill=ring_prefill,
        rank_ring_prefills=[r.get("ring_prefills") for r in ranks],
        prompt_lens=[len(p) for p in prompts],
        layers=ref["layers"], backend=r0["backend"], streams_equal=same,
        streams=len(got), divergences=div, every_position=pos,
        moe_limit=tie if moe else None, one_rank_own_deviation=own,
        lone_tokens_equal=r0["lone"] == ref["lone"],
        lone_logits_max_abs_diff=lone_diff,
        rank_stage=[r["stage"] for r in ranks],
        rank_replica=[r["replica"] for r in ranks],
        rank_weight_bytes=[r["weight_bytes"] for r in ranks],
        rank_pool_bytes=[r["pool_bytes"] for r in ranks],
        predicted_rank_bytes=want,
        one_rank_weight_bytes=ref["weight_bytes"],
        one_rank_pool_bytes=ref["pool_bytes"],
        rank_bringup_s=[r["bringup_s"] for r in ranks],
        rank_peak_gib=[r["peak_gib"] for r in ranks],
        rank_launches=[r["launches"] for r in ranks],
        pipelined_windows=r0["pipelined_windows"],
        burst_wall_s=r0["burst_wall_s"], one_rank_burst_wall_s=ref["burst_wall_s"],
        decode_tokens_per_s_batch1=r0["decode_tokens_per_s_batch1"],
        one_rank_decode_tokens_per_s_batch1=ref["decode_tokens_per_s_batch1"],
        rank_devices=[r["device"] for r in ranks],
        router_calls_checked=routes, sliced_acts=acts, perplexity=ppl,
        shadowed_call_err_vs_plain=r0["shadowed_call_err_vs_plain"])
    print("pp " + json.dumps(stats), flush=True)
    return r0["launches"]


# ---------------------------------------------------------------------------
# Slice 15: expert parallelism (ranks sharing the card over gloo)
# ---------------------------------------------------------------------------

R1_EP_KERNELS = ("attend_decode_fused[latent]", "attend_prefill_packed[latent]",
                 "attend_decode[latent]", "attend_prefill[latent]",
                 "absorb_matmul", "grouped_gemm")
EP_PHASES = [
    # (label, model card, pp, tp, overrides, kernels that must launch on
    # every rank in the burst). R1 at 4 layers is 3 dense and 1 MoE, at 5
    # 3 and 2; each rank of tp2_r1 holds 64 heads and 128 experts, of
    # tp4_r1_soft_fp8 32 heads and 64 experts in e4m3. tp2_mixtral and
    # pp2_tp2_mixtral at 2 layers (4 until slice 18, whose tp3_mixtral runs
    # expert parallelism at 4; 8 in PR 15 and 16, ROADMAP C.3): its tokens
    # are held to the world's own decode-against-prefill routes too
    # (`every_position`).
    ("tp2_mixtral", MIXTRAL, 1, 2, ["models.n_layers=2"],
     ATTN_KERNELS + ("grouped_gemm",)),
    ("tp2_r1", R1, 1, 2, ["models.n_layers=4"], R1_EP_KERNELS),
    ("tp4_r1_soft_fp8", R1, 1, 4, ["models.n_layers=4"] + SOFT,
     R1_EP_KERNELS + ("quant_gemm",)),
    ("pp2_tp2_mixtral", MIXTRAL, 2, 2, ["models.n_layers=2"],
     ATTN_KERNELS + ("grouped_gemm",)),
    ("pp2_tp2_r1", R1, 2, 2, ["models.n_layers=5"], R1_EP_KERNELS),
]


# ---------------------------------------------------------------------------
# Slice 16: data parallelism, the ring KV pool and ring prefill (ranks
# sharing the card over gloo)
# ---------------------------------------------------------------------------

RING_DP = 2


def ring_kernel_cases(torch, tk, dev):
    """B1 in its partials mode on the ring KV pool: the Llama-3-8B decode
    batch of the B1 case (16 rows, 32 query heads on 8 KV heads, pages of
    64, contexts up to 2,047, a row that is not valid and a padded bucket
    row), its 528 pages shuffled and striped over 2 ranks (global page g
    on rank g // 264). Each rank's launch on its local table (the other
    rank's pages masked) appends the new rows it owns and writes its split
    partials; the two ranks' partials joined on the split axis and merged
    by `decode_merge` are held against the same in plain PyTorch (row
    limit ROW_RTOL; each rank's pool bytes equal) and against the
    whole-pool plain decode; two runs give equal bits. Times: one rank's
    partials launch (`ms`), the plain partials of one rank, and SDPA over
    that rank's gathered owned K/V; the bound counts the pool rows one
    rank owns in the rows' contexts. A second row: the merge of both
    ranks' 2 x S splits (the ring KV decode's shape: rank r's split s as
    split r * S + s) against its plain version on the same partials, its
    bound the partials read and the output written."""
    import torch.nn.functional as F

    from chitu_tpu_torch.ops import attention as plain
    from chitu_tpu_torch.ops.attention_ring import ring_local_block_table

    g = torch.Generator(device=dev)
    g.manual_seed(16)
    H, KV, D, PAGE, L, LAYER, B, MP = 32, 8, 128, 64, 2, 1, 16, 33
    M, G, P = 2 * KV * D, H // KV, B * MP
    PL = P // RING_DP
    scale = D ** -0.5
    bf = torch.bfloat16

    def randn(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)

    pool0 = randn(L, P, PAGE, M, s=0.5)
    bts = torch.randperm(P, generator=g, device=dev).to(torch.int32).reshape(B, MP)
    seq = torch.randint(1, MP * PAGE - PAGE, (B,), generator=g,
                        device=dev).to(torch.int32)
    seq[0] = 2047
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    valid[3] = False
    valid[B - 1] = False
    bts[B - 1] = -1
    seq[B - 1] = 0
    q, k, v = randn(B, H, D), randn(B, KV, D), randn(B, KV, D)
    ranks = [(pool0[:, r * PL:(r + 1) * PL].contiguous(),
              ring_local_block_table(bts, PL, r)) for r in range(RING_DP)]

    def kernel(pools):
        parts = [tk.attend_decode_partials(q, p, LAYER, k, v, lbt, seq, valid,
                                           PAGE, KV, D, scale=scale)
                 for p, (_, lbt) in zip(pools, ranks)]
        return parts, tk.decode_merge(torch.cat([o for o, _ in parts], 2),
                                      torch.cat([m for _, m in parts], 2))

    name = "attend_decode_partials"
    pools_k = [lp.clone() for lp, _ in ranks]
    parts, out_k = kernel(pools_k)
    S = parts[0][0].shape[2]
    _, chunk = tk.decode_split(B, KV, MP, PAGE, tk._sm_count(dev))
    pools_p = [lp.clone() for lp, _ in ranks]
    parts_p = [tk.attend_decode_partials_plain(
        q, pp, LAYER, k, v, lbt, seq, valid, PAGE, KV, D, scale=scale, S=S,
        chunk=chunk) for pp, (_, lbt) in zip(pools_p, ranks)]
    out_p = tk.decode_merge_plain(torch.cat([o for o, _ in parts_p], 2),
                                  torch.cat([m for _, m in parts_p], 2)
                                  ).reshape(B, H, D)
    for r in range(RING_DP):
        if not torch.equal(pools_k[r], pools_p[r]):
            raise AssertionError(f"{name}: rank {r}'s pool bytes differ from "
                                 "the plain owner-write append")
    err, rel = compare_rows(torch, name, out_k, out_p, valid)
    whole = tk.attend_decode_fused_plain(q, pool0.clone(), LAYER, k, v, bts,
                                         seq, valid, PAGE, KV, D, scale=scale)
    _, rel_whole = compare_rows(torch, f"{name} (whole pool)", out_k, whole,
                                valid)
    bit_equal(torch, name, out_k, kernel([lp.clone() for lp, _ in ranks])[1])
    p0, lbt0 = pools_k[0], ranks[0][1]
    args = (LAYER, k, v, lbt0, seq, valid, PAGE, KV, D)
    ms = device_ms(torch, lambda: tk.attend_decode_partials(q, p0, *args,
                                                            scale=scale))
    o_all = torch.cat([o for o, _ in parts], 2)
    ml_all = torch.cat([m for _, m in parts], 2)
    plain_ms = call_ms(torch, lambda: tk.attend_decode_partials_plain(
        q, pools_p[0], *args, scale=scale, S=S, chunk=chunk))
    # library: SDPA over rank 0's gathered owned K/V (its context rows)
    kg, vg = plain.unpack_pool(plain._gather(p0, LAYER, lbt0), KV, D)
    kg, vg = kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()
    cols = torch.arange(kg.shape[2], device=dev)[None, :]
    owned = (lbt0 >= 0).repeat_interleave(PAGE, dim=1)
    mask = (cols <= seq[:, None].long()) & owned
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kg, vg, attn_mask=mask[:, None, None, :],
        scale=scale, enable_gqa=True))
    ctx = int(mask[:B - 1].sum().item())  # rank 0's pool rows read
    n_live = int(valid.sum().item())
    nbytes = (ctx * 2 * KV * D * 2 + q.numel() * 2 + 2 * k.numel() * 2
              + n_live * M * 2 + o_all.numel() * 4 // RING_DP
              + ml_all.numel() * 4 // RING_DP)
    bnd, by = bound_ms(nbytes, 4 * H * D * (ctx + B))
    yield dict(name=name, kernel=name, variant="ring", route="cuda",
               source=ATTN_SRC, replaces="chitu_tpu/ops/pallas_attention.py:727",
               max_abs_err=err, max_row_rel_err=rel,
               max_row_rel_err_vs_whole_pool=rel_whole, ms=ms,
               plain_ms=plain_ms, bound_ms=bnd,
               bound_by=by, library_ms=lib_ms,
               shape=f"B={B} H={H} KV={KV} D={D} page={PAGE} mp={MP} "
                     f"ranks={RING_DP} pages_a_rank={PL} splits={S} "
                     f"rank0_ctx_rows={ctx}")

    name = "decode_merge"
    merged = tk.decode_merge(o_all, ml_all)
    live = (ml_all[..., 1] > 0).any(2).reshape(B, H)
    m_err, m_rel = compare_rows(
        torch, name, merged,
        tk.decode_merge_plain(o_all, ml_all).reshape(B, H, D), live)
    bit_equal(torch, name, merged, tk.decode_merge(o_all, ml_all))
    m_ms = device_ms(torch, lambda: tk.decode_merge(o_all, ml_all))
    m_plain = call_ms(torch, lambda: tk.decode_merge_plain(o_all, ml_all))
    m_bytes = o_all.numel() * 4 + ml_all.numel() * 4 + merged.numel() * 2
    m_bnd, m_by = bound_ms(m_bytes, 3 * o_all.numel(), F32_FLOP_PER_S)
    yield dict(name=name, kernel=name, variant="ring", route="cuda",
               source=ATTN_SRC, replaces="chitu_tpu/ops/pallas_attention.py:727",
               max_abs_err=m_err, max_row_rel_err=m_rel, ms=m_ms,
               plain_ms=m_plain, bound_ms=m_bnd, bound_by=m_by,
               library_ms=None,
               shape=f"B={B} KV={KV} splits={RING_DP}x{S} G={G} D={D}")


RING_KERNELS = ("attend_decode_partials", "decode_merge")
RING_PHASES = [
    # (label, model card, dp, pp, tp, overrides, kernels that must launch on
    # every rank in the burst, the burst's prompt lengths (None: TP_LENS)).
    # Llama-3-8B at 4 of its 32 layers (8 until slice 18, 32 in PR 16; the
    # later slices' phases took the time: ranks
    # sharing the card wait about 1.3 ms a gloo all-reduce, one a layer a
    # decode step; scripts/torch_gloo_exchange.py).
    # R1 ring KV: the latent row's ring decode and every ring prefill are
    # plain PyTorch in this slice; its MoE layers split their tokens over
    # the two replicas
    ("dp2_ring_kv", LLAMA, RING_DP, 1, 1,
     ["models.n_layers=4", "infer.ring_kv=true"], RING_KERNELS, None),
    ("dp2_ring_prefill", LLAMA, RING_DP, 1, 1,
     ["models.n_layers=4", "infer.ring_prefill=true",
      "infer.max_seq_len=4224", "infer.prefill_chunk=4096"],
     ("attend_decode_fused",), (2048, 4096)),
    ("dp2_tp2_ring_kv", LLAMA, RING_DP, 1, 2,
     ["models.n_layers=4", "infer.ring_kv=true"], RING_KERNELS, None),
    ("dp2_pp2_ring_kv", LLAMA, RING_DP, 2, 1,
     ["models.n_layers=4", "infer.ring_kv=true"], RING_KERNELS, None),
    ("dp2_ring_kv_r1", R1, RING_DP, 1, 1,
     ["models.n_layers=4", "infer.ring_kv=true"],
     ("absorb_matmul", "grouped_gemm"), None),
]


# ---------------------------------------------------------------------------
# Slice 17: the layouts the port refused (ranks sharing the card over gloo)
# ---------------------------------------------------------------------------

ROW_ACTS = ("acts_absmax", "quant_acts_given")
SLICE17_PHASES = [
    # (label, model card, pp, tp, overrides, kernels that must launch on
    # every rank in the burst). Full width, depth cut: R1 at 4 layers is 3
    # dense and 1 MoE, each rank 64 heads of the per-head pool; Llama-3-8B
    # W8A8 (wo's and w_down's inputs row-parallel: B12's PARTIAL and GIVEN
    # modes); Llama-3-8B at 5 layers over 3 stages (2 / 2 / 1; 8 until
    # slice 18), with a
    # perplexity measured through the world's lockstep
    ("tp2_r1_dense", R1, 1, 2, ["models.n_layers=4", "infer.mla_absorb=none"],
     D192 + ("grouped_gemm",)),
    ("tp2_w8a8", LLAMA, 1, 2, ["models.n_layers=4", "quant.method=w8a8",
                               "quant.quant_on_load=true"],
     ATTN_KERNELS + ("int8_gemm", "rms_norm_quant") + ROW_ACTS),
    ("pp3", LLAMA, 3, 1, ["models.n_layers=5"], ATTN_KERNELS),
]
PPL_PHASES = ("pp3",)


# ---------------------------------------------------------------------------
# Slice 18: the last layouts the port refused (ranks sharing the card over
# gloo)
# ---------------------------------------------------------------------------

QWEN72 = "Qwen2-72B-Instruct"
SLICE18_PHASES = [
    # (label, model card, pp, tp, overrides, kernels that must launch on
    # every rank in the burst). Full width, depth cut. Qwen2-72B in
    # soft-fp8 at tp2: each rank's w_down (and gate, up) cut inside block
    # 115 of 128 rows, then /stop and /init on the same world (REINIT);
    # Mixtral-8x7B at tp3: 8 heads of KV replicate (32 query heads a
    # rank), experts 3 / 3 / 2; R1 at tp3 (3 dense, 1 MoE layer): 128
    # MLA heads a rank, experts 86 / 85 / 85
    ("tp2_qwen72_fp8", QWEN72, 1, 2, ["models.n_layers=4"] + SOFT,
     ATTN_KERNELS + ("quant_gemm",)),
    ("tp3_mixtral", MIXTRAL, 1, 3, ["models.n_layers=4"],
     ATTN_KERNELS + ("grouped_gemm",)),
    ("tp3_r1", R1, 1, 3, ["models.n_layers=4"], R1_EP_KERNELS),
]
# ring prefill under pp: Llama-3-8B on two replicas of two stages, the
# prompts of dp2_ring_prefill (dp, pp, tp, overrides, need, lens)
SLICE18_RING = [
    ("dp2_pp2_ring_prefill", LLAMA, RING_DP, 2, 1,
     ["models.n_layers=4", "infer.ring_prefill=true",
      "infer.max_seq_len=4224", "infer.prefill_chunk=4096"],
     ("attend_decode_fused",), (2048, 4096)),
]


AWQ_CALIB = 512
AWQ_HOLD = 256


def teacher_forced_logits(torch, eng, tokens):
    """All logits rows [n, V] of one prefill of `tokens` through the idle
    engine's model, in pages taken from its allocator and given back."""
    from chitu_tpu_torch.executor import _bucket

    ex, alloc, page = eng.executor, eng.cache.allocator, eng.cfg.infer.page_size
    n, rid = len(tokens), "teacher-forced"
    if not alloc.ensure(rid, n + 1):
        raise AssertionError("no pages for the teacher-forced prefill")
    try:
        T = _bucket(n, ex.prefill_buckets)
        toks = torch.zeros(T, dtype=torch.int32, device=ex.device)
        toks[:n] = torch.tensor(tokens, dtype=torch.int32, device=ex.device)
        bt = torch.as_tensor(alloc.block_table([rid], ex.mp_full)[0],
                             device=ex.device)
        with torch.no_grad():
            logits, _ = eng.model.prefill(dict(eng.cache.arrays), toks, bt, 0,
                                          n, page, return_all_logits=True)
        return logits[:n].float()
    finally:
        alloc.free(rid)


def awq_phase(torch, np, tk, card, layers=32):
    """AWQ at Llama-3-8B-Instruct's width: random bf16 weights with the
    JAX test's planted activation outliers (5 % of the embedding columns
    x 8), `awq_quantize_llama_params` on 512 calibration tokens on the
    card, then the AWQ tree and RTN W4A16 of the same weights served
    through the engine (B7's int4 mode must launch). Held: against the
    bf16 model's teacher-forced logits over 256 held-out tokens, AWQ MSE
    <= 1.2 x RTN MSE (the JAX test's criterion)."""
    from chitu_tpu_torch import SampleParams, load_config
    from chitu_tpu_torch.engine import Engine
    from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind
    from chitu_tpu_torch.quantize import awq

    label = "awq"
    base = [f"models={LLAMA}", f"models.n_layers={layers}",
            "infer.stop_with_eos=false", "infer.max_seq_len=1024",
            "infer.max_reqs=4"]
    eng = Engine(load_config(overrides=base))
    V, D = eng.cfg.models.vocab_size, eng.cfg.models.dim
    rng = np.random.default_rng(7)
    boost = torch.from_numpy(np.where(rng.random(D) < 0.05, 8.0, 1.0)).to(
        eng.device, torch.bfloat16)
    eng.model.embed.data.mul_(boost)
    calib = rng.integers(5, V, AWQ_CALIB)
    hold = [int(x) for x in rng.integers(5, V, AWQ_HOLD)]
    tree = eng.model.params_tree()
    ref = teacher_forced_logits(torch, eng, hold)
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        q = awq.awq_quantize_llama_params(eng.model, tree, calib)
    torch.cuda.synchronize()
    calib_s = time.time() - t0
    if not (isinstance(q["layers"]["wqkv"], QTensor)
            and q["layers"]["wqkv"].kind == QuantKind.W4A16):
        raise AssertionError(f"[{label}] the AWQ tree holds no W4A16 leaves")
    cfg = load_config(overrides=base)
    out = {}
    for name, params, extra in (
            ("awq", q, []),
            ("rtn", tree, ["quant.method=w4a16", "quant.quant_on_load=true"])):
        e = Engine(load_config(overrides=base + extra), params=params)
        tk.reset_launch_counts()
        toks = e.generate("", SampleParams(temperature=0.0, max_new_tokens=8),
                          prompt_tokens=hold[:64])
        torch.cuda.synchronize()
        launches = tk.LAUNCHES.get("quant_gemm", 0)
        if len(toks) != 8 or launches <= 0 or not e.model.wqkv.packed:
            raise AssertionError(f"[{label}] the {name} engine: {len(toks)} "
                                 f"tokens, {launches} int4 GEMM launches")
        got = teacher_forced_logits(torch, e, hold)
        out[name] = dict(mse=float(((got - ref) ** 2).mean()),
                         quant_gemm_launches=launches)
        e.terminate()
        del e
        free_memory(torch)
    del q, tree
    eng.terminate()
    del eng
    free_memory(torch)
    ratio = out["awq"]["mse"] / out["rtn"]["mse"]
    stats = dict(phase=label, card=card, layers=layers, calib_tokens=AWQ_CALIB,
                 held_out_tokens=AWQ_HOLD, calibration_s=calib_s,
                 awq_mse=out["awq"]["mse"], rtn_mse=out["rtn"]["mse"],
                 awq_over_rtn=ratio,
                 quant_gemm_launches={k: v["quant_gemm_launches"]
                                      for k, v in out.items()})
    print("awq " + json.dumps(stats), flush=True)
    if not ratio <= 1.2:
        raise AssertionError(f"[{label}] AWQ MSE {out['awq']['mse']} > 1.2 x "
                             f"RTN MSE {out['rtn']['mse']}")
    return stats


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(sys.argv[2])
        return
    from chitu_tpu_torch.models import moe
    from chitu_tpu_torch.ops import absorb_kernels as ab
    from chitu_tpu_torch.ops import attention as plain
    from chitu_tpu_torch.ops import attention_kernels as tk
    from chitu_tpu_torch.ops import cuda_build
    from chitu_tpu_torch.ops import dense_gemm_kernels as dg
    from chitu_tpu_torch.ops import linear
    from chitu_tpu_torch.ops import moe_gemm_kernels as mg
    from chitu_tpu_torch.ops import norm_quant as nq
    from chitu_tpu_torch.ops import quant_gemm_kernels as qg
    from chitu_tpu_torch.ops.qtensor import QuantKind
    from chitu_tpu_torch.quantize import transforms as qt

    from chitu_tpu_torch import load_config

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
    t0 = time.time()
    cuda_build.build_host("hostops")
    print(f"hostops build {time.time() - t0:.1f} s (g++, the native page "
          "allocator)", flush=True)

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
                      # slice 17: a tp2 rank's 64 heads of R1's dense MLA
                      split_head_cases(torch, tk, plain, dev, "R1 tp2", 64, 64,
                                       192, ATTN_WRAPPERS, scale=R1_SCALE,
                                       variant="d192,h64"),
                      split_head_cases(torch, tk, plain, dev,
                                       "tiny-llama-debug", 32, 4, 64,
                                       ("attend_decode_fused", "attend_prefill")),
                      kernel_cases(torch, tk, plain, dev,
                                   geom=(4, 2, 32, "d32")),
                      dense_gemm_cases(torch, dg, dev),
                      slice12_kernel_cases(torch, tk, plain, dev),
                      ring_kernel_cases(torch, tk, dev),
                      straddle_cases(torch, qg, qt, QuantKind, dev)):
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
    t0 = time.time()
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
    print(f"slices 1-10 phases {time.time() - t0:.1f} s", flush=True)

    # slice 11: checkpoints read from disk, in a directory deleted after
    t0 = time.time()
    root = tempfile.mkdtemp(prefix="chitu_ckpt_")
    try:
        phase.update(load_phases(torch, np, tk, card, root))
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    print(f"slice 11 phases {time.time() - t0:.1f} s", flush=True)

    # slice 12: the prefix cache, then spec decode on the same weights
    t0 = time.time()
    phase["prefix_cache"], params = prefix_phases(torch, np, tk, card)
    phase.update(spec_phases(torch, np, tk, card, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"slice 12 phases {time.time() - t0:.1f} s", flush=True)

    # slices 13-16: tensor parallelism (then AWQ), pipeline parallelism,
    # expert parallelism, data parallelism with the ring KV pool and ring
    # prefill, over ranks sharing the card
    worlds = []
    for label, n, ovr, need in TP_PHASES:
        worlds.append((13, label, functools.partial(
            start_world, label, n, ovr,
            tp_prompts(np, load_config(overrides=TP_BASE + ovr).models.vocab_size)),
            functools.partial(tp_phase, torch, np, tk, card, label, n, ovr, need)))
    worlds.append((13, "awq", None,
                   lambda world: awq_phase(torch, np, tk, card)))
    for sl, table in ((14, PP_PHASES), (15, EP_PHASES), (16, RING_PHASES),
                      (17, SLICE17_PHASES), (18, SLICE18_PHASES),
                      (18, SLICE18_RING)):
        for label, model, *rest in table:
            dp, pp, tp, ovr, need, lens = (
                rest if table in (RING_PHASES, SLICE18_RING)
                else (1, *rest, None))
            worlds.append((sl, label, functools.partial(
                start_pp_world, np, label, model, pp, tp, ovr, dp, lens),
                functools.partial(pp_phase, torch, np, tk, card, label, model,
                                  pp, tp, ovr, need, dp=dp, lens=lens)))
    got = run_worlds(worlds)
    phase.update({label: got[label] for table in
                  (EP_PHASES, RING_PHASES, SLICE17_PHASES, SLICE18_PHASES,
                   SLICE18_RING)
                  for label, *_ in table})

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
    for key, label, *launch_key in VARIANT_ROWS:
        row(key, by_row[key], phase[label].get((launch_key or [key])[0], 0))
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
