"""Microbatch pipeline-parallel decode.

Counterpart of `chitu_tpu/parallel/pipeline.py` (reference:
chitu/scheduler.py:139-186 SkewPipelineScheduler, chitu/executor.py:179-299
PipeTensorExecutor stage relay). The JAX package runs one program under
`shard_map` over ('pp', 'tp'); here each rank is a process that runs the
same phase loop over its own stage (`decode_pipelined`):

- each stage holds its layer range of the stacked weights and of the KV
  pool (`parallel.sharding.StageSlice`): L // pp layers, the first
  L % pp stages one more, so a stage may hold none and relays the
  hidden state as it came;
- S = pp microbatch groups stream through the stages: in phase q, stage s
  works on group (q - s) mod pp at decode step (q - s) // pp, so in steady
  state every stage holds a different group;
- the hidden state and the group's done flags go from stage to stage,
  and the last stage's sampled tokens and done flags go back to stage 0,
  which embeds them for the group's next step
  (`parallel.distributed.StageRelay`);
- only the last stage applies the head, the frequency penalty, sampling,
  the count update and the done latch (stop token or spent budget); the
  other stages pass the done flags on unchanged, and the window's tokens
  [window, S, Bg] go from the last stage to every rank once, at its end.

The port's tensor parallelism is always what the JAX package calls
"manual" (each rank holds its shard and calls its collectives), so its
"auto" mode (GSPMD inside the shard_map) has no counterpart. A stack
that pp does not divide, which the JAX package replicates and runs in
sequence, is cut into uneven ranges here and pipelined. Every family runs
it at pp x tp: Mixtral and DeepSeek with their experts over the stage's
TP group (the JAX package's manual-TP dual stack,
chitu_tpu/parallel/pipeline.py:138-194,447-481; DeepSeek's dense-first
layers on stage 0, cut over its group), the hidden state relayed whole
(every TP rank holds it after the layer's all-reduces). Attention is B1
on the stage's pool with the group's block tables at `seq0 + k`, the
kernel a one-stage engine runs.
"""

from __future__ import annotations

import torch

from chitu_tpu_torch import sampling


def supports_pipeline(model) -> bool:
    """The pipelined decode applies: the model runs as one stage of pp > 1
    (any family, at any tp) and dp is 1 (the JAX package refuses dp > 1,
    chitu_tpu/parallel/pipeline.py:200: dp x pp runs the layers in
    sequence). The JAX package's other conditions hold by construction or
    do not apply: a stack that pp does not divide is cut into uneven stage
    ranges (where the JAX package runs in sequence), and a leaf that tp
    does not divide is held whole and never summed (where `_manual_tp_ok`
    falls back to GSPMD)."""
    return (getattr(model, "stage", None) is not None
            and getattr(model, "dp_group", None) is None)


def decode_pipelined(
    model,
    cache,  # the stage's pools, updated IN PLACE
    counts: torch.Tensor,  # [max_reqs, V] i32 frequency-penalty counts
    generator,  # the sampling stage's torch.Generator
    tokens0: torch.Tensor,  # [S, Bg] i32 first fed token of each row
    seq0: torch.Tensor,  # [S, Bg] i32 context length BEFORE the fed token
    bts: torch.Tensor,  # [S, Bg, mp] i32 block tables
    valid: torch.Tensor,  # [S, Bg] bool
    temps: torch.Tensor,  # [S, Bg] f32
    top_ks: torch.Tensor,  # [S, Bg] i32
    top_ps: torch.Tensor,  # [S, Bg] f32
    slots: torch.Tensor,  # [S, Bg] i32 count row of each request
    pens: torch.Tensor,  # [S, Bg] f32 frequency penalties
    remaining: torch.Tensor,  # [S, Bg] i32 new-token budget left
    stop_ids: torch.Tensor,  # [S, Bg, 8] i32 stop tokens (-2 pad)
    check_stop: torch.Tensor,  # [S, Bg] bool
    window: int,
    page_size: int,
    greedy: bool = False,  # host-known: every row greedy
    nopen: bool = False,  # host-known: no row penalized
) -> torch.Tensor:
    """Run `window` decode steps of S = pp groups through the stages, on
    every rank of the world at once. -> tokens [window, S, Bg] on every
    rank (-1 where a row was invalid or already done)."""
    st = model.stage
    P, s = st.pp, st.stage
    S, Bg = tokens0.shape
    assert S == P, "one microbatch group per stage"
    dev = tokens0.device
    hdt = model.hidden_dtype
    D = model.args.dim
    span = P * window
    outs = (torch.full((window, S, Bg), -1, dtype=torch.int32, device=dev)
            if st.last else None)
    h_in = tok_in = done_in = None
    for q in range(span + P - 1):
        rel = q - s
        live = 0 <= rel < span
        if live:
            m, k = rel % P, rel // P
            if st.first:
                if k == 0:
                    tok_in = tokens0[m]
                    done_in = torch.zeros((Bg,), dtype=torch.bool, device=dev)
                h_in = model._embed(tok_in)
            validm = valid[m] & ~done_in
            h = model.decode_local(cache, h_in, seq0[m] + k, bts[m], validm,
                                   page_size)
            done = done_in
            if st.last:
                logits = model.final_logits(h)
                if not nopen:
                    logits = sampling.apply_frequency_penalty(
                        logits, counts, slots[m], pens[m])
                new = sampling.sample_tokens(
                    logits, generator, temps[m], top_ks[m], top_ps[m],
                    greedy_all=greedy)
                if not nopen:
                    sampling.update_counts(counts, slots[m], new, validm)
                outs[k, m] = torch.where(validm, new, torch.full_like(new, -1))
                # the done latch: only the last stage holds the token
                is_stop = check_stop[m] & torch.any(
                    new[:, None] == stop_ids[m], dim=-1)
                done = done_in | (validm & (is_stop | (k + 1 >= remaining[m])))
        # the links, in their global order: (s - 1, s) before (s, s + 1);
        # stage 0 takes (0, 1) before the ring's closing (pp - 1, 0). What
        # a stage sends in phase q its neighbour uses in phase q + 1.
        if not st.first and 0 <= rel + 1 < span:  # stage s - 1 was live
            buf = st.recv_prev(torch.empty((Bg, D + 1), dtype=hdt, device=dev))
            h_in, done_in = buf[:, :D], buf[:, D] > 0
        if not st.last and live:
            st.send_next(torch.cat([h.to(hdt), done[:, None].to(hdt)], dim=1))
        if st.first and P <= q + 1 < span:  # stage 0 feeds the next step
            buf = st.recv_last(torch.empty((2, Bg), dtype=torch.int32,
                                           device=dev))
            tok_in, done_in = buf[0], buf[1] > 0
        if st.last and live and rel + P < span:
            st.send_first(torch.stack([new, done.to(torch.int32)]))
    return st.world.from_sampler(outs, (window, S, Bg), torch.int32, dev)
