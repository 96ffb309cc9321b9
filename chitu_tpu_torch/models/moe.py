"""Mixture-of-experts: routing + token-sorted ragged expert dispatch.

Counterpart of `chitu_tpu/models/moe.py` (reference:
chitu/models/model_deepseek_v3.py:774-1061 gate + fused experts,
chitu/fused_moe.py token-sorted kernels, chitu/models/model_hf_mixtral.py:51-96
dense expert loop):

- `route` covers both gate flavours: softmax top-k with renormalization
  (Mixtral) and sigmoid + bias-corrected, group-limited top-k with
  route_scale (DeepSeek-V3).
- The primary dispatch is sorted and exact (`sorted_dispatch`): (token,
  choice) assignments are stably sorted by expert and laid out in bm-row
  blocks padded per expert, the static-shape equivalent of the reference's
  `moe_align_block_size` contract (chitu/fused_moe.py:314-610). The expert
  GEMMs run through the grouped kernel (`ops/moe_gemm_kernels.py`), which
  indexes the (layer, expert) weight stack itself: quantized experts stay
  packed in device memory and dequantize inside the GEMM. No token is ever
  dropped on this path.
- `moe_ffn` (capacity/einsum formulation) is the route of expert stacks
  the grouped kernel does not take (int8 / int4 experts, widths that are no
  multiple of 128), as in the JAX package; decode-sized batches get exact
  capacity there.

Everything between the router and the combine keeps static shapes and
never reads a device value on the host (no `.item()`, `nonzero`, boolean
mask indexing, `bincount` or `unique`), so a step can be captured in a CUDA
graph. The sort is one formulation for every size, a counting sort over a
one-hot cumsum (stable by construction: the JAX package's two
formulations give this same result). The combine gathers each token's k
rows through the inverse of `row_assign` and sums them in choice order:
`index_add_` on CUDA adds in an order that changes from run to run, and
greedy decoding must repeat bit for bit.

Expert parallelism (`moe_ffn_ep`, the counterpart of `moe_ffn_manual_ep`
and of `_moe_ffn_ep` under a mesh) is the JAX package's all-to-all-free
formulation: the tokens are replicated over the tensor-parallel group and
expert e lives on rank e // (E / tp); every rank routes its own copy of
the hidden state with the replicated router (global ids), maps the ids
outside its range to a dead expert El = E / tp, dispatches its experts
through the grouped kernel with `e_dispatch = El + 1` (the dead expert's
blocks read no weight and write zeros) and returns its partial combine,
which the caller sums over the group in one f32 all-reduce (with the
shared expert's partial, for DeepSeek). The JAX package's `_pp_composable`
and its stage gate (non-owning stages mark every assignment dead) have no
counterpart: a pipeline stage of the port holds only its own layers
(`parallel.sharding.StageSlice`), so every layer it runs is its own.
Stacks the grouped kernel does not take run the capacity route on the
local experts, the foreign assignments in a dead one-hot column.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from chitu_tpu_torch.ops.linear import linear, maybe_fp8_act
from chitu_tpu_torch.ops.moe_gemm_kernels import grouped_matmul, kernel_eligible
from chitu_tpu_torch.ops.qtensor import QTensor
from chitu_tpu_torch.parallel.sharding import even_range
from chitu_tpu_torch.utils import get_logger


def route(
    x: torch.Tensor,  # [T, D]
    gate_w: torch.Tensor,  # [D, E]
    moe,  # MoEArgs
    gate_bias: Optional[torch.Tensor] = None,  # [E] score correction bias
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weights [T, k] f32, selected experts [T, k] int32). The
    logits and scores are f32."""
    logits = linear(x, gate_w, out_dtype=torch.float32)  # [T, E]
    E = logits.shape[-1]
    k = moe.n_activated_experts

    if moe.score_func == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)

    # selection scores may carry a correction bias (DeepSeek; reference:
    # model_deepseek_v3.py:800-812); the weights use the raw scores
    sel_scores = scores + gate_bias[None, :].float() if gate_bias is not None else scores

    if moe.n_expert_groups > 1:
        # group-limited routing (reference: model_deepseek_v3.py:813-831):
        # keep only the top `n_limited_groups` groups, a group scored by
        # the sum of its top-2 experts
        G = moe.n_expert_groups
        per = E // G
        grouped = sel_scores.reshape(-1, G, per)
        top2 = grouped.topk(min(2, per), dim=-1).values.sum(dim=-1)  # [T, G]
        top_groups = top2.topk(moe.n_limited_groups, dim=-1).indices
        group_mask = torch.zeros_like(top2, dtype=torch.bool)
        group_mask.scatter_(1, top_groups, True)
        sel_scores = torch.where(
            group_mask.repeat_interleave(per, dim=-1), sel_scores,
            torch.full_like(sel_scores, float("-inf")),
        )

    sel = sel_scores.topk(k, dim=-1).indices  # [T, k]
    weights = scores.gather(-1, sel)  # [T, k]

    if moe.norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    weights = weights * moe.route_scale
    return weights.float(), sel.to(torch.int32)


def expert_capacity(T: int, E: int, k: int, factor: float = 2.0) -> int:
    """Static per-expert slot count of the capacity route; decode-sized
    batches get exact capacity, so no routed token is dropped in the
    serving hot loop. `factor` comes from MoEArgs.capacity_factor: raise it
    for prefill batches with skewed expert load (tokens beyond capacity
    drop that expert's contribution there; the sorted path is exact)."""
    if T <= 64:
        return T
    cap = int(math.ceil(T * k / E * factor))
    return max(min(cap, T), 4)


# ---------------------------------------------------------------------------
# Token-sorted ragged dispatch (the moe_align_block_size equivalent;
# reference: chitu/fused_moe.py:314-610): exact, static shapes.
# ---------------------------------------------------------------------------


def dispatch_geometry(T: int, k: int, E: int) -> Tuple[int, int]:
    """(bm, NB): block row count and static block-count bound.

    bm tracks the expected per-expert row count (~2*A/E, clamped to
    [16, 256] powers of two) so that most active experts fit one block:
    each live block streams its expert's whole weight, so blocks per expert
    multiply the weight traffic. NB covers the worst case: ceil(A/bm) full
    blocks plus one partial block per active expert."""
    A = T * k
    per = max(1, (2 * A) // max(E, 1))
    bm = 16
    while bm < per and bm < 256:
        bm *= 2
    NB = -(-A // bm) + min(E, A)
    return bm, NB


_CONSTS = {}


def _arange(n: int, device, div: int = 1) -> torch.Tensor:
    """arange(n) // div, int64 on `device`, made once."""
    key = (n, div, device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.arange(n, dtype=torch.int64, device=device) // div
    return _CONSTS[key]


def _dispatch(sel: torch.Tensor, E: int, bm: int):
    """-> (dest [A] int64, block_expert [NB] int64): the padded row of
    every assignment, and the expert of every block (-1 = dead). A counting
    sort: the rank of an assignment within its expert is a one-hot cumsum,
    so equal experts keep their assignment order."""
    T, k = sel.shape
    A = T * k
    dev = sel.device
    _, NB = dispatch_geometry(T, k, E)
    e_flat = sel.reshape(A).long()
    onehot = e_flat[:, None] == _arange(E, dev)[None, :]  # [A, E]
    csum = onehot.cumsum(dim=0)  # inclusive, int64
    pos = csum.gather(1, e_flat[:, None]).squeeze(1) - 1
    blocks_e = (csum[-1] + (bm - 1)) // bm  # blocks of each expert
    block_end = blocks_e.cumsum(dim=0)
    dest = ((block_end - blocks_e) * bm)[e_flat] + pos
    # block b belongs to the first expert whose blocks end beyond b
    b = _arange(NB, dev)
    block_expert = torch.where(
        b < block_end[-1], torch.searchsorted(block_end, b, right=True), -1
    )
    return dest, block_expert


def sorted_dispatch(
    sel: torch.Tensor,  # [T, k] int32 expert ids in [0, E)
    E: int,
    bm: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (token, choice) assignments by expert into bm-row blocks.

    Returns (row_assign [NB*bm] int32, block_expert [NB] int32):
    - row_assign[r] = flat assignment index (token*k + choice) occupying
      padded row r, or A (sentinel) for padding rows;
    - block_expert[b] = expert owning block b, or -1 for dead blocks
      (beyond the live blocks; the grouped kernel reads no weight for them
      and writes zeros).
    Experts appear in ascending order; each expert's rows are contiguous,
    in assignment order, and padded to a block multiple, so every live
    block holds exactly one expert's rows: the `moe_align_block_size`
    contract."""
    A = sel.numel()
    dest, block_expert = _dispatch(sel, E, bm)
    row_assign = torch.full(
        (block_expert.shape[0] * bm,), A, dtype=torch.int32, device=sel.device
    )
    row_assign[dest] = _arange(A, sel.device).to(torch.int32)
    return row_assign, block_expert.to(torch.int32)


def _combine(out_rows, dest, weights) -> torch.Tensor:
    """Token t's output is the weighted sum of its k rows
    `out_rows[dest[t*k + j]]`, taken in choice order: the same bits on
    every run."""
    T, k = weights.shape
    rows = out_rows[dest].float().view(T, k, out_rows.shape[-1])
    return (rows * weights.float()[:, :, None]).sum(dim=1)


def sorted_combine(
    out_rows: torch.Tensor,  # [NB*bm, D]
    row_assign: torch.Tensor,  # [NB*bm]
    weights: torch.Tensor,  # [T, k] f32 routing weights
) -> torch.Tensor:
    """Expert outputs back to tokens, weighted. Returns [T, D] f32. Each
    token owns exactly k rows: they are gathered through the inverse of
    `row_assign` and summed in a fixed order."""
    A = weights.numel()
    # padding rows all write slot A, which is dropped
    inv = torch.empty((A + 1,), dtype=torch.int64, device=out_rows.device)
    inv[row_assign.long()] = _arange(row_assign.shape[0], out_rows.device)
    return _combine(out_rows, inv[:A], weights)


def moe_ffn_sorted(
    x: torch.Tensor,  # [T, D]
    w_gate,  # [(L,) E, D, F] dense or QTensor; or merged [.., D, 2F]
    w_up,  # None when w_gate holds the merged [gate | up] stack
    w_down,  # [(L,) E, F, D]
    weights: torch.Tensor,  # [T, k]
    sel: torch.Tensor,  # [T, k] ids in [0, E_dispatch)
    n_experts: int,  # real experts indexable in the stacks
    layer=None,
    e_dispatch: Optional[int] = None,  # ids >= n_experts mark invalid
) -> torch.Tensor:
    """Exact token-sorted MoE SwiGLU through the grouped GEMM. The rows
    are bf16; SiLU and the product run in f32 and round to bf16."""
    T, D = x.shape
    k = sel.shape[-1]
    A = T * k
    Ed = e_dispatch or n_experts
    bm, NB = dispatch_geometry(T, k, Ed)
    dest, block_expert = _dispatch(sel, Ed, bm)
    if Ed > n_experts:
        # blocks of out-of-range experts (expert parallelism: owned by
        # another shard) are dead
        block_expert = torch.where(block_expert >= n_experts, -1, block_expert)
    block_expert = block_expert.to(torch.int32)

    # token of every padded row; padding rows carry token 0's activations
    # and nothing reads their output
    tok = torch.zeros((NB * bm,), dtype=torch.int64, device=x.device)
    tok[dest] = _arange(A, x.device, div=k)
    xs = x[tok].to(torch.bfloat16)  # [NB*bm, D]

    # quant.fp8_act='e4m3': the expert GEMMs bypass linear(), so the
    # activation rounding applies here too (reference act_quant feeds
    # fused_moe the same way, chitu/fused_moe.py:613-793)
    xs = maybe_fp8_act(xs, w_gate)
    layer = 0 if layer is None else layer
    if w_up is None:
        # merged [gate | up] stack: one grouped GEMM, split halves
        gu = grouped_matmul(xs, w_gate, layer, block_expert, bm)
        Fd = gu.shape[-1] // 2
        g, u = gu[:, :Fd], gu[:, Fd:]
    else:
        g = grouped_matmul(xs, w_gate, layer, block_expert, bm)
        u = grouped_matmul(xs, w_up, layer, block_expert, bm)
    h = (F.silu(g.float()) * u.float()).to(torch.bfloat16)
    h = maybe_fp8_act(h, w_down)
    d = grouped_matmul(h, w_down, layer, block_expert, bm)
    return _combine(d, dest, weights).to(x.dtype)


def _sorted_eligible(ws) -> bool:
    return all(kernel_eligible(w) for w in ws if w is not None)


_capacity_warned = set()


def _warn_capacity_fallback(T: int, E: int, cap: int):
    """One-time visibility when the capacity-einsum route runs: tokens
    routed beyond an expert's static capacity are dropped there under
    skewed loads; the sorted path is exact."""
    key = (T, E, cap)
    if key in _capacity_warned or cap >= T:
        return  # cap == T can never drop (each token appears once/expert)
    _capacity_warned.add(key)
    get_logger().warning(
        "MoE capacity-einsum fallback (experts not eligible for the grouped "
        "kernel): tokens beyond capacity=%d/expert DROP under skewed load at "
        "T=%d, E=%d; raise models.moe.capacity_factor for long prefill",
        cap, T, E,
    )


def local_ids(sel: torch.Tensor, start: int, n_local: int) -> torch.Tensor:
    """Global expert ids -> this rank's local ids: the rank holds experts
    [start, start + n_local); ids of other ranks' experts map to the dead
    id `n_local`."""
    sl = sel - start
    return torch.where((sl < 0) | (sl >= n_local),
                       torch.full_like(sl, n_local), sl)


def _n_experts(w) -> int:
    """Experts of a stack [(L,) E, K, N], dense or quantized."""
    return (w.data if isinstance(w, QTensor) else w).shape[-3]


def moe_ffn_ep(
    x: torch.Tensor,  # [T, D], the same on every rank of the group
    w_gate,  # the rank's [(L,) E / tp, K, N] stack, or merged [gate | up]
    w_up,  # None when w_gate holds the merged stack
    w_down,
    weights: torch.Tensor,  # [T, k]
    sel: torch.Tensor,  # [T, k] GLOBAL expert ids
    rank: int,
    tp: int,
    layer=None,
    moe=None,  # MoEArgs: the capacity route's slot count
) -> torch.Tensor:
    """This rank's partial combine of an expert-parallel MoE layer (the
    JAX package's `moe_ffn_manual_ep`; the rank's experts are its
    contiguous range, `sharding.even_range`, uneven where tp does not
    divide E, which the JAX package leaves to GSPMD's capacity einsum
    instead): its experts' contributions, in
    x's dtype; the caller sums it over the group. Stacks the grouped
    kernel takes dispatch through it with one dead expert for the
    assignments of other ranks; the others take the capacity route on
    the local experts."""
    El = _n_experts(w_down)
    E = moe.n_routed_experts if moe is not None else El * tp
    start, stop = even_range(E, rank, tp)
    if stop - start != El:
        raise ValueError(f"{El} local experts on rank {rank} are not its "
                         f"range [{start}, {stop}) of {E} over {tp} ranks")
    sl = local_ids(sel, start, El)
    if _sorted_eligible((w_gate, w_up, w_down)):
        return moe_ffn_sorted(
            x, w_gate, w_up, w_down, weights, sl, El, layer=layer,
            e_dispatch=El + 1,
        )
    return _capacity_route(x, w_gate, w_up, w_down, weights, sl, moe, layer,
                           E)


def moe_ffn_auto(
    x: torch.Tensor,
    w_gate,
    w_up,
    w_down,
    weights: torch.Tensor,
    sel: torch.Tensor,
    moe,  # MoEArgs
    layer=None,
    rank: int = 0,
    tp: int = 1,
    dp=None,
) -> torch.Tensor:
    """Pick the MoE execution path: under tensor parallelism (tp > 1, the
    stacks the rank's E / tp experts) the rank's partial of the expert-
    parallel layer (`moe_ffn_ep`, summed by the caller); on one device
    the exact sorted dispatch + grouped kernel when every stack is
    eligible for it, else the capacity-einsum route (quantized experts
    dequantize there). `dp` (the replicas' `DPGroup`, while every replica
    holds the same tokens): the JAX package's token split over 'dp'
    (chitu_tpu/models/moe.py:492-495) where the grouped kernel serves and
    the token count divides: each replica runs its T / dp tokens, and
    the rows are gathered over the group."""
    if (dp is not None and x.shape[0] % dp.size == 0
            and _sorted_eligible((w_gate, w_up, w_down))):
        n = x.shape[0] // dp.size
        rows = slice(dp.rank * n, (dp.rank + 1) * n)
        y = moe_ffn_auto(x[rows], w_gate, w_up, w_down, weights[rows],
                         sel[rows], moe, layer=layer, rank=rank, tp=tp)
        return dp.gather(y).reshape(x.shape[0], -1).to(y.dtype)
    if tp > 1:
        return moe_ffn_ep(x, w_gate, w_up, w_down, weights, sel, rank, tp,
                          layer=layer, moe=moe)
    E = moe.n_routed_experts
    if _sorted_eligible((w_gate, w_up, w_down)):
        return moe_ffn_sorted(
            x, w_gate, w_up, w_down, weights, sel, E, layer=layer
        )
    return _capacity_route(x, w_gate, w_up, w_down, weights, sel, moe, layer, E)


def _capacity_route(x, w_gate, w_up, w_down, weights, sel, moe, layer, E):
    """The capacity-einsum route on the stacks' experts; `E` the model's
    expert count (the capacity is per expert of the whole model; without
    `moe`, every token's slot: exact). Ids at or beyond the stacks' expert
    count (other ranks' experts) take no slot."""
    cap = x.shape[0] if moe is None else expert_capacity(
        x.shape[0], E, moe.n_activated_experts, moe.capacity_factor
    )
    _warn_capacity_fallback(x.shape[0], E, cap)

    def slice_layer(w):
        # the capacity einsums need this layer's [E, ...] stack
        if layer is None:
            return w
        nd = w.data.dim() if isinstance(w, QTensor) else w.dim()
        return w[layer] if nd == 4 else w

    if w_up is None:
        # merged stacks on the capacity route: split the halves
        gu = slice_layer(w_gate)
        if isinstance(gu, QTensor):
            gu = gu.dequantize(x.dtype)
        Fd = gu.shape[-1] // 2
        return moe_ffn(
            x, gu[..., :Fd], gu[..., Fd:], slice_layer(w_down),
            weights, sel, cap,
        )
    return moe_ffn(
        x, slice_layer(w_gate), slice_layer(w_up), slice_layer(w_down),
        weights, sel, cap,
    )


def moe_ffn(
    x: torch.Tensor,  # [T, D]
    w_gate,  # [E, D, F] (dense or QTensor with leading E)
    w_up,  # [E, D, F]
    w_down,  # [E, F, D]
    weights: torch.Tensor,  # [T, k]
    sel: torch.Tensor,  # [T, k] ids; >= E marks an assignment dropped
    capacity: int,
) -> torch.Tensor:
    """Capacity-dispatch MoE SwiGLU. Returns [T, D]."""
    T, D = x.shape
    E = w_gate.shape[0]
    k = sel.shape[-1]

    # [T, k, E] int64; an id >= E (another rank's expert) has no column
    onehot = F.one_hot(sel.long(), E + 1)[..., :E]
    flat = onehot.reshape(T * k, E)
    # slot index = rank of this (token, choice) among the expert's tokens
    pos = flat.cumsum(dim=0) - flat  # exclusive cumsum [T*k, E]
    pos = (pos * flat).sum(dim=-1).reshape(T, k)
    in_cap = pos < capacity

    # [T, k, cap]; an overflowing assignment gets an all-zero row
    slot = torch.where(in_cap, pos, torch.full_like(pos, capacity))
    slot_oh = F.one_hot(slot, capacity + 1)[..., :capacity].to(x.dtype)
    disp = torch.einsum("tke,tkc->tec", onehot.to(x.dtype), slot_oh)

    expert_in = torch.einsum("tec,td->ecd", disp, x)  # [E, cap, D]
    gate = _expert_matmul(expert_in, w_gate)  # [E, cap, F]
    up = _expert_matmul(expert_in, w_up)
    hidden = F.silu(gate) * up
    out_e = _expert_matmul(hidden, w_down)  # [E, cap, D]

    comb = torch.einsum(
        "tke,tkc,tk->tec", onehot.float(), slot_oh.float(), weights.float()
    ).to(x.dtype)
    return torch.einsum("tec,ecd->td", comb, out_e)


def _expert_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """[E, cap, D] x [E, D, F] -> [E, cap, F]; handles QTensor experts."""
    wd = w.dequantize(x.dtype) if isinstance(w, QTensor) else w.to(x.dtype)
    return torch.bmm(x, wd)


def moe_ffn_ref(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    weights: torch.Tensor,
    sel: torch.Tensor,
) -> torch.Tensor:
    """Dense per-expert oracle (the reference Mixtral loop semantics,
    model_hf_mixtral.py:51-96): every expert processes every token, masked
    combine. Exact; used by tests."""
    E = w_gate.shape[0]
    gate = torch.einsum("td,edf->etf", x, w_gate.to(x.dtype))
    up = torch.einsum("td,edf->etf", x, w_up.to(x.dtype))
    hid = F.silu(gate) * up
    out_e = torch.einsum("etf,efd->etd", hid, w_down.to(x.dtype))
    onehot = F.one_hot(sel.long(), E).float()  # [T, k, E]
    w_e = torch.einsum("tke,tk->te", onehot, weights.float())  # [T, E]
    return torch.einsum("te,etd->td", w_e.to(x.dtype), out_e)
