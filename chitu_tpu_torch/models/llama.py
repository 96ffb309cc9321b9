"""Llama-family model (HF Llama-3 / Qwen2 / GLM-4 / R1-Distill / Meta-Llama).

Counterpart of `chitu_tpu/models/llama.py` (reference:
chitu/models/model_hf_llama.py, chitu/models/model_llama.py). The weights
are the JAX package's stacked [L, ...] leaves under the same names, held
as frozen parameters of an `nn.Module`, in one of two layouts
(`infer.merge_qkv_gate_up`, decided as in the JAX package): merged
(`wqkv`, `w_gate_up`, optional `b_qkv`) or unmerged (`wq`/`wk`/`wv`,
`w_gate`/`w_up`, optional `bq`/`bk`/`bv`); besides them `wo`, `w_down`,
`attn_norm`, `ffn_norm`, `embed`, `norm`, `lm_head`. The layer loop is a
Python loop; each layer's projections are `torch.matmul` on views of the
stacked weights, and attention goes through the kernel wrappers of
`ops/attention_kernels.py` (CUDA kernels on the card, their plain
versions on the CPU). A projection weight may be a `QTensor` (on-load
quantization, or a quantized JAX tree carried across): `ops.linear`
sends it to the dequant GEMM, and W8A8 projections take per-token int8
activations from the fused norm+quant kernel. The KV pool in
`cache["kv"]` is updated IN PLACE and returned for symmetry with the JAX
functions.

Tensor parallelism (`infer.tp_size`, reference: chitu/tensor_parallel.py):
each rank is a process that holds its shard (`TPLayout`): q/k/v, gate/up
and the head column-parallel, wo and w_down row-parallel (their partial
products summed in f32 over the group), the embedding vocab-parallel (a
masked lookup, summed). The merged leaves of a rank are its own
(q_r | k_r | v_r) and (g_r | u_r): the shard of the JAX package's
rank-major layout. Attention runs the same kernels on the rank's heads,
and the pool holds the rank's KV heads (all of them replicated by
tp / KV ranks each when there are fewer KV heads than ranks); heads that
tp does not divide (Qwen2-7B's 28 at tp8, any card at tp3) leave
attention whole on every rank (`TPLayout.heads_split`, as the JAX
package's `safe_named_sharding` replicates them): all heads, the whole
pool, nothing summed after wo. A quantized leaf cut inside its blocks
(an FFN of 29,568 at tp2) holds the whole blocks over its slice
(`parallel.sharding`, `ops.linear`). The logits
are gathered to the full vocabulary on every rank of the group, so
sampling sees the same row everywhere.

Pipeline parallelism (`infer.pp_size`, the reference's PP stages): stage
p holds layers [p * L / pp, (p + 1) * L / pp) of every stacked leaf
(`TPLayout.stage`), its pool those layers, stage 0 the embedding, the
last stage the final norm and the head. Each forward keeps its
signature: stage 0 embeds, every stage runs its layers, and the hidden
state crosses each stage boundary once (`_run_layers`, over
`parallel.distributed.StageRelay`); only the last stage returns logits
(None elsewhere: the executor samples there and relays the tokens), and
`verify_draft` relays its greedy tokens to every rank. The pipelined
decode (`parallel/pipeline.py`) calls the stage's pieces itself:
`_embed`, `decode_local` and `final_logits`.

Data parallelism (`infer.dp_size`): each replica holds the same weights
and runs the same batch. With `infer.ring_kv` its pool holds 1 / dp of
the pages (`ops/attention_ring.py`): `prefill` appends a chunk's rows to
the pages the rank owns and attends them with the other ranks' partials
combined over the dp group, and `decode` runs B1 in its partials mode on
the rank's own pages, the dp ranks' partials merged by the decode merge.
With `infer.ring_prefill` a whole prompt's tokens split over the
replicas (`prefill(..., ring=True)`): each rank carries its slice through
every layer, ring attention (`parallel/ring.py`) passes the K/V slices
around, each rank appends every slice into its pool as it passes, and
the rank that holds the last valid token sends its hidden row to the
others for the logits; under pp each stage does so on its layers, the
relay passing the replica's slice from stage to stage.

Checkpoints load through `loader.load_checkpoint`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from chitu_tpu_torch.models import register_model
from chitu_tpu_torch.models.common import apply_rope, rms_norm, rope_tables
from chitu_tpu_torch.ops import attention as attn_ops
from chitu_tpu_torch.ops import attention_kernels as kernels
from chitu_tpu_torch.ops import attention_ring as ring_ops
from chitu_tpu_torch.ops.linear import (
    linear,
    matmul_out_dtype,
    op_kernels,
    quant_acts_rows,
)
from chitu_tpu_torch.ops.norm_quant import (
    quant_acts,
    quant_acts_plain,
    rms_norm_quant,
    rms_norm_quant_plain,
)
from chitu_tpu_torch.ops.qtensor import (
    TENSOR_FIELDS,
    QTensor,
    QuantKind,
    unpack_int4,
)
from chitu_tpu_torch.parallel.sharding import (
    StageSlice,
    narrow_out,
    owned,
    shard_leaf,
)
from chitu_tpu_torch.utils import get_logger, resolve_device


def _ffn_dim(args) -> int:
    """FFN hidden size (reference: model_llama.py:131-158)."""
    if args.inter_dim:
        return args.inter_dim
    hidden = int(2 * (4 * args.dim) / 3)
    if args.ffn_dim_multiplier:
        hidden = int(args.ffn_dim_multiplier * hidden)
    m = args.multiple_of
    return m * ((hidden + m - 1) // m)


def _to_torch(a) -> torch.Tensor:
    """numpy array -> tensor; bf16 `ml_dtypes` arrays go through a uint16
    view because `torch.from_numpy` rejects them."""
    a = np.ascontiguousarray(a)
    a = a if a.flags.writeable else a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _is_q(leaf) -> bool:
    """A quantized leaf of the JAX tree: a mapping or an object carrying
    the QTensor fields as numpy arrays."""
    if isinstance(leaf, dict):
        return "data" in leaf and "scale" in leaf
    return not isinstance(leaf, np.ndarray) and all(
        hasattr(leaf, n) for n in ("data", "scale", "kind")
    )


def qtensor_from_numpy(leaf) -> QTensor:
    """One quantized leaf of the JAX tree (see `params_from_numpy`) -> a
    `QTensor`, field by field and byte for byte."""
    get = leaf.get if isinstance(leaf, dict) else lambda k, d=None: getattr(leaf, k, d)
    kind = get("kind", QuantKind.SOFT_FP8)
    kind = QuantKind(getattr(kind, "value", kind))
    kw = {}
    for name in TENSOR_FIELDS:
        a = get(name)
        if a is None:
            kw[name] = None
            continue
        a = np.asarray(a)
        fp8 = a.dtype.name == "float8_e4m3fn" or (
            name == "data" and a.dtype == np.uint8
            and kind in (QuantKind.SOFT_FP8, QuantKind.FP8)
        )
        if fp8:  # e4m3 crosses as its bytes
            a = np.ascontiguousarray(a).view(np.uint8)
            kw[name] = _to_torch(a).view(torch.float8_e4m3fn)
        else:
            kw[name] = _to_torch(a)
    return QTensor(kind=kind, block=int(get("block", 128)), **kw)


def _leaf(a):
    return qtensor_from_numpy(a) if _is_q(a) else _to_torch(a)


def _cat_out(parts):
    """Concatenate projection weights along the out dim: dense tensors, or
    QTensors of one kind whose scales concatenate exactly."""
    if not any(isinstance(p, QTensor) for p in parts):
        return torch.cat(parts, dim=-1)
    q0 = parts[0]
    # outlier rows concatenate only as the column slices of one leaf's
    # (a merged llmint8 leaf split for its shards): one channel set
    if not all(
        isinstance(p, QTensor) and p.kind == q0.kind and p.block == q0.block
        and (p.oc_idx is None if q0.oc_idx is None else (
            p.oc_idx is not None and torch.equal(p.oc_idx, q0.oc_idx)))
        for p in parts
    ):
        raise NotImplementedError(
            "an unmerged quantized tree with mixed kinds or outlier rows "
            "cannot be merged into wqkv / w_gate_up; serve it unmerged "
            "(infer.merge_qkv_gate_up=off)"
        )
    # act-order GPTQ: the parts see one input, so their row orders are
    # usually one permutation, which the merged leaf keeps
    if q0.in_perm is not None or any(p.in_perm is not None for p in parts):
        if not all(
            p.in_perm is not None and torch.equal(p.in_perm, q0.in_perm)
            for p in parts
        ):
            raise NotImplementedError(
                "act-order parts with differing input permutations cannot "
                "be merged into wqkv / w_gate_up; serve them unmerged "
                "(infer.merge_qkv_gate_up=off)"
            )
    repack = all(p.packed for p in parts)
    parts = [unpack_int4(p) if p.packed else p for p in parts]
    cols, at = [], 0
    for p in parts:  # each part's kept stored columns, in the merged leaf
        w = p.data.shape[-1]
        for a, b in p.cols or ((0, w),):
            if cols and cols[-1][1] == at + a:
                cols[-1] = (cols[-1][0], at + b)
            else:
                cols.append((at + a, at + b))
        at += w
    blockwise = (
        q0.kind in (QuantKind.SOFT_FP8, QuantKind.FP8)
        and q0.scale.shape[-1] != q0.data.shape[-1]
    )
    if blockwise and any(p.data.shape[-1] % p.block for p in parts[:-1]):
        raise NotImplementedError(
            "blockwise fp8 scales merge exactly only when each part's out "
            "dim fills its last block"
        )
    cat = lambda name: torch.cat([getattr(p, name) for p in parts], dim=-1)
    q = QTensor(
        data=cat("data").view(torch.uint8).contiguous().view(q0.data.dtype)
        if q0.data.dtype == torch.float8_e4m3fn
        else cat("data"),
        scale=cat("scale"),
        zeros=cat("zeros") if q0.zeros is not None else None,
        kind=q0.kind, block=q0.block, in_perm=q0.in_perm,
        oc_idx=q0.oc_idx,
        oc_w=cat("oc_w") if q0.oc_w is not None else None,
        rows=q0.rows, cols=None if cols == [(0, at)] else tuple(cols),
    )
    if repack:
        from chitu_tpu_torch.quantize.transforms import pack_int4_storage

        q = pack_int4_storage({"w": q})["w"]
    return q


# the expert stacks of the MoE families, [L, E, in, out]: expert
# parallelism cuts them by experts
EXPERT_STACKS = ("w_gate", "w_up", "w_gu", "w_down",
                 "exp_gate", "exp_up", "exp_gu", "exp_down")

# the parts of each merged leaf, in their order along the out dim
MERGES = {
    "wqkv": ("wq", "wk", "wv"),
    "b_qkv": ("bq", "bk", "bv"),
    "w_gate_up": ("w_gate", "w_up"),
}
ROW_PARALLEL = ("wo", "w_down")


def split_rank_major(leaf, widths, merge_tp: int = 1):
    """A merged leaf -> its parts (the inverse of the JAX package's
    `rank_major_merge`): with merge_tp 1 the out dim is the plain
    concatenation of the parts; with merge_tp m it is m chunks, chunk c
    the concatenation of every part's c-th slice."""
    total = sum(widths)
    chunk = total // merge_tp
    parts = [[] for _ in widths]
    for c in range(merge_tp):
        o = c * chunk
        for i, w in enumerate(widths):
            wl = w // merge_tp
            parts[i].append(narrow_out(leaf, o, o + wl))
            o += wl
    return [p[0] if len(p) == 1 else _cat_out(p) for p in parts]


@dataclass(frozen=True)
class TPLayout:
    """One rank's view of the weights: which slice of every full leaf it
    holds, and whether its q/k/v and gate/up leaves are merged.

    Specs (`parallel.sharding`) are those of the JAX package's
    `param_partition_specs` on the unmerged parts: wq and bq split by
    query heads, wk/wv/bk/bv by KV heads (held by tp / KV ranks each when
    the KV heads are fewer than the ranks), w_gate/w_up by columns and
    wo/w_down by rows (whole when the FFN does not divide: then the FFN
    replicates and nothing is summed), embed by vocab rows and lm_head by
    vocab columns (whole when the vocabulary does not divide). A MoE
    layout (`moe`: Mixtral) cuts its expert stacks [L, E, in, out] by
    experts, rank r holding a contiguous range of E // tp of them (the
    first E % tp ranks one more, `sharding.even_range`), and keeps
    the router whole (expert parallelism, `models.moe.moe_ffn_ep`).
    Query or KV heads that tp does not divide (`heads_split` false)
    leave q, k, v and wo whole on every rank. Under
    pipeline parallelism `stage` says which layers and which ends of the
    model the rank's stage holds; a leaf is cut to those layers first."""

    rank: int = 0
    tp: int = 1
    # the full model's geometry (zeros: one device, merged leaves kept
    # as they are, no widths needed)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    inter_dim: int = 0
    vocab_size: int = 0
    merged: bool = True
    moe: bool = False
    stage: StageSlice = StageSlice()

    @property
    def widths(self) -> Dict[str, tuple]:
        H, KV, Dh, Fd = self.n_heads, self.n_kv_heads, self.head_dim, self.inter_dim
        qkv = (H * Dh, KV * Dh, KV * Dh)
        return {"wqkv": qkv, "b_qkv": qkv, "w_gate_up": (Fd, Fd)}

    @property
    def heads_split(self) -> bool:
        """Does attention split over the group? Each rank must hold whole
        query heads of one KV group: tp divides the query heads, and the
        KV heads divide or are divided by tp. Else every rank holds the
        attention leaves whole and runs every head (the JAX package's
        `safe_named_sharding` replicates what does not divide)."""
        H, KV, tp = self.n_heads, self.n_kv_heads, self.tp
        return H % tp == 0 and (KV % tp == 0 or tp % KV == 0)

    def part_spec(self, name: str, ndim: int) -> tuple:
        spec = [None] * ndim
        if self.moe and name in EXPERT_STACKS:
            # expert parallelism: [L, E, in, out] by contiguous expert
            # ranges (uneven where tp does not divide E)
            spec[-3] = "ep"
        elif name in ("wq", "bq", "wk", "wv", "bk", "bv", "wo") and (
                not self.heads_split):
            pass  # attention whole on every rank
        elif name in ("wq", "bq"):
            spec[-1] = ("tp", self.n_heads)
        elif name in ("wk", "wv", "bk", "bv"):
            spec[-1] = ("tp", self.n_kv_heads)
        elif name == "wo":
            spec[-2] = ("tp", self.n_heads)
        elif name in ("w_gate", "w_up"):
            spec[-1] = "tp"
        elif name == "w_down":
            spec[-2] = "tp"
        elif name == "embed":
            spec[0] = "tp"
        elif name == "lm_head":
            spec[-1] = "tp"
        return tuple(spec)

    def local(self, name: str, part):
        """Rank's shard of one full unmerged leaf."""
        if self.tp <= 1:
            return part
        nd = part.data.dim() if isinstance(part, QTensor) else part.dim()
        return shard_leaf(part, self.part_spec(name, nd), self.rank, self.tp)

    def place(self, name: str, leaf, merge_tp: int = 1,
              transform=None) -> Dict[str, Any]:
        """One full leaf (a merged one in plain or rank-major order, or an
        unmerged part) -> the rank's leaves by name, in this layout.
        `transform(name, leaf)` sees each full leaf of this layout before
        it is cut to the rank's TP slice (the on-load quantization, which
        must see whole rows; it quantizes each layer on its own, so the
        stage's layers are cut first). A leaf the stage does not hold
        gives nothing."""
        transform = transform or (lambda n, t: t)
        if not self.stage.holds(name):
            return {}
        whole = leaf
        if name not in ("embed", "norm", "lm_head"):
            # a view: the TP cut or `owned` copies the rank's part
            leaf = self.stage.cut("layers", leaf)
        out = self._place(name, leaf, merge_tp, transform)
        return {k: owned(v, whole) for k, v in out.items()}

    def _place(self, name, leaf, merge_tp, transform):
        if name in MERGES and not (self.moe and name == "w_gate_up"):
            names = MERGES[name]
            if self.merged:
                if self.tp <= 1 and merge_tp <= 1:
                    return {name: transform(name, leaf)}
                if merge_tp <= 1:
                    leaf = transform(name, leaf)
                parts = split_rank_major(leaf, self.widths[name], merge_tp)
                return {name: _cat_out([
                    self.local(n, p) for n, p in zip(names, parts)])}
            parts = split_rank_major(leaf, self.widths[name], merge_tp)
            return {n: self.local(n, transform(n, p))
                    for n, p in zip(names, parts)}
        if self.moe and name in EXPERT_STACKS:
            # each (layer, expert) matrix quantizes on its own: the rank's
            # experts are cut first
            return {name: transform(name, self.local(name, leaf))}
        # an unmerged part (a merged layout joins it to its siblings in
        # `assemble`), or a leaf of its own
        return {name: self.local(name, transform(name, leaf))}

    def assemble(self, leaves: Dict[str, Any]) -> Dict[str, Any]:
        """Local unmerged parts -> the merged leaves, in place, when this
        layout merges (a plain concatenation of the rank's parts; MoE
        expert stacks stay split). Parts that cannot merge (act-order GPTQ
        whose q/k/v permutations differ) all stay unmerged, and the model
        serves the tree unmerged (`load_params` follows the tree), as the
        JAX loader does (chitu_tpu/loader.py:685-708)."""
        moe = self.moe or "moe_gate" in leaves
        todo = [
            (m, ps) for m, ps in MERGES.items()
            if all(p in leaves for p in ps) and not (moe and m == "w_gate_up")
        ]
        if not self.merged or not todo:
            return leaves
        try:
            merged = {m: _cat_out([leaves[p] for p in ps]) for m, ps in todo}
        except NotImplementedError as e:
            get_logger().warning("serving the projections unmerged: %s", e)
            return leaves
        for m, ps in todo:
            for p in ps:
                del leaves[p]
            leaves[m] = merged[m]
        return leaves


def params_from_numpy(tree: Dict[str, Any], layout: Optional[TPLayout] = None,
                      merge_tp: int = 1) -> Dict[str, Any]:
    """The JAX package's llama, Mixtral or DeepSeek parameter tree, as
    numpy arrays ({"embed", "norm", "layers": {...}, "lm_head"}, or
    DeepSeek's "dense_layers" and "moe_layers" stacks), -> the tensors of
    this package's module by name. A quantized leaf (the JAX `QTensor`
    with numpy fields, or a mapping of its fields; e4m3 data as
    `ml_dtypes` arrays or a uint8 view) becomes a `QTensor`, byte for
    byte: blockwise or rowwise scales, packed or unpacked int4. The
    family shows in the tree: a Mixtral tree has a router (`moe_gate`),
    and its expert stacks `[L, E, in, out]` cross as they are, dense or
    quantized, split (`w_gate`, `w_up`) or merged (`w_gu`). A DeepSeek
    tree crosses leaf for leaf into the same nested form, `gate_bias` in
    f32, split or merged leaves (`wq_kv_a`, `shared_gu`, `exp_gu`) as
    they are; its layout (`deepseek_v3.MLALayout`) keeps the stage's
    layers and cuts the rank's slices.

    Without a `layout`, unmerged attention and dense-FFN leaves (wq/wk/wv,
    w_gate/w_up) are merged into the wqkv / w_gate_up leaves. With one
    (`model.layout`), the tree becomes that rank's leaves in that layout:
    merged leaves in plain order (`merge_tp` 1) or the JAX package's
    rank-major order (`merge_tp`, its model's `merge_tp`) are split into
    their parts, each part is cut to the rank's slice, and the parts are
    merged again when the layout merges. Under pipeline parallelism the
    layout's `stage` keeps the stage's layers of every stack, and the
    embedding, final norm and head where the stage holds them."""
    if "dense_layers" in tree:
        stacks = ("dense_layers", "moe_layers")
        out = {k: _leaf(tree[k]) for k in ("embed", "norm", "lm_head")}
        for stack in stacks:
            out[stack] = {k: _leaf(v) for k, v in tree[stack].items()}
        # the model's `MLALayout`: the stage's layers, the rank's slices
        return out if layout is None else layout.tree(out)
    layers = tree["layers"]
    flat = {k: tree[k] for k in ("embed", "norm", "lm_head") if k in tree}
    flat.update(layers)
    if layout is None:
        layout = TPLayout(moe="moe_gate" in layers)
        if any(k in layers for k in ("wqkv", "b_qkv", "w_gate_up")):
            # merged leaves cross as they are (no widths to split by)
            out = {k: _leaf(v) for k, v in flat.items()}
            return layout.assemble(out)
    out: Dict[str, Any] = {}
    for k in list(flat):
        out.update(layout.place(k, _leaf(flat.pop(k)), merge_tp))
    return layout.assemble(out)


_LAYER_LEAVES = (
    "attn_norm", "ffn_norm", "wqkv", "wo", "w_gate_up", "w_down", "b_qkv",
    "wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv",
)  # the leaves that live under "layers" in the nested tree


@register_model("hf-llama")
class LlamaForCausalLM(nn.Module):
    """Llama-family module: frozen stacked weights + the five forwards
    (prefill, prefill_packed, step_hybrid, decode, verify_draft). A family with another
    FFN (MoE) subclasses it: it extends `_shapes` and `LAYER_LEAVES` and
    overrides `_ffn`."""

    LAYER_LEAVES = _LAYER_LEAVES
    supports_ring_kv = True  # infer.ring_kv (ops/attention_ring.py)
    supports_ring_prefill = True  # infer.ring_prefill (`_prefill_ring`)

    def __init__(self, args, cfg, device=None):
        super().__init__()
        infer = cfg.infer
        self.args = args
        self.cfg = cfg
        # infer.attn_type: the CUDA kernels, or their plain versions
        self.attn_route, self.attn = kernels.attention_route(infer.attn_type)
        self.device = resolve_device(device)
        self.head_dim = args.head_dim_()
        self.inter_dim = _ffn_dim(args)
        self.rot_dim = int(self.head_dim * args.partial_rotary_factor)
        self.attn_scale = 1.0 / math.sqrt(self.head_dim)
        self.rotary_layout = args.rotary_type
        self._init_tp(infer)
        cos, sin = rope_tables(
            self.rot_dim, infer.max_seq_len, args.rope_theta,
            args.rope_scaling, device=self.device,
        )
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def _init_tp(self, infer):
        """The tensor-parallel geometry, the pipeline stage and the weight
        layout (the JAX package's `merged` / `merge_tp` / `kv_tp_shard`
        decisions)."""
        a = self.args
        H, KV, Fd, V = a.n_heads, a.n_kv_heads, self.inter_dim, a.vocab_size
        tp = infer.tp_size
        self.tp = tp
        stage = join_world(self, infer, {"layers": a.n_layers},
                           tied=a.tie_word_embeddings)
        self.n_local = stage.count("layers", a.n_layers)
        self.layout = TPLayout(
            self.rank, tp, H, KV, self.head_dim, Fd, V,
            moe=getattr(a, "moe", None) is not None, stage=stage,
        )
        # heads that tp does not divide: attention replicates, every rank
        # runs all heads on the whole pool and nothing is summed after wo
        self.attn_tp = tp if self.layout.heads_split else 1
        div = H % tp == 0 and KV % tp == 0 and Fd % tp == 0
        mq = infer.merge_qkv_gate_up
        if mq not in ("auto", "on", "off"):
            raise ValueError(f"merge_qkv_gate_up={mq!r}: expected auto, on or off")
        self.merged = mq == "on" or (mq == "auto" and (tp <= 1 or div))
        # tp chunk count of the JAX package's merged layout (1 = plain
        # [q|k|v] concatenation); the port always holds its own chunk
        self.merge_tp = tp if (self.merged and tp > 1 and div) else 1
        # the pool shards whenever the KV heads divide (the JAX package
        # also asks for 128-lane shards, a TPU layout matter: ROADMAP C);
        # fewer KV heads than ranks: each rank holds the one its queries
        # read
        at = self.attn_tp
        self.kv_tp_shard = at > 1 and KV % at == 0
        self.h_local = H // at
        self.kv_local = KV // at if self.kv_tp_shard else (1 if at > 1 else KV)
        self.ffn_tp = tp if Fd % tp == 0 else 1
        self.vocab_tp = tp if V % tp == 0 else 1
        self.layout = dataclasses.replace(self.layout, merged=self.merged)

    # -- cache geometry -----------------------------------------------------

    def kv_cache_spec(self) -> Dict[str, Any]:
        return dict(
            n_layers=self.n_local,
            kv_heads=self.kv_local,
            head_dim=self.head_dim,
            kv_dim=0,
        )

    # -- parameters ---------------------------------------------------------

    def _shapes(self, local: bool = True, merged: Optional[bool] = None
                ) -> Dict[str, tuple]:
        """Leaf shapes of this rank's layout (its stage's leaves), or
        (`local=False`) of the full tree at tp 1 and pp 1; `merged`
        overrides the layout's choice."""
        a = self.args
        merged = self.merged if merged is None else merged
        L, D, Dh = self.n_local if local else a.n_layers, a.dim, self.head_dim
        if local:
            H, KV, Fd = self.h_local, self.kv_local, self.inter_dim // self.ffn_tp
            V = a.vocab_size // self.vocab_tp
        else:
            H, KV, Fd, V = a.n_heads, a.n_kv_heads, self.inter_dim, a.vocab_size
        shapes = {
            "embed": (V, D),
            "norm": (D,),
            "attn_norm": (L, D),
            "ffn_norm": (L, D),
        }
        if merged:
            shapes["wqkv"] = (L, D, (H + 2 * KV) * Dh)
        else:
            shapes.update(wq=(L, D, H * Dh), wk=(L, D, KV * Dh),
                          wv=(L, D, KV * Dh))
        shapes["wo"] = (L, H * Dh, D)
        if merged:
            shapes["w_gate_up"] = (L, D, 2 * Fd)
        else:
            shapes.update(w_gate=(L, D, Fd), w_up=(L, D, Fd))
        shapes["w_down"] = (L, Fd, D)
        if a.attn_bias:
            if merged:
                shapes["b_qkv"] = (L, (H + 2 * KV) * Dh)
            else:
                shapes.update(bq=(L, H * Dh), bk=(L, KV * Dh), bv=(L, KV * Dh))
        if not a.tie_word_embeddings:
            shapes["lm_head"] = (D, V)
        if local:
            shapes = {k: v for k, v in shapes.items()
                      if self.layout.stage.holds(k)}
        return shapes

    def init_params(
        self, generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.bfloat16, transform=None,
    ):
        """Random weights on the module's device (normal * 0.02, norms 1,
        biases 0), drawn from `generator`; the JAX package's
        `init_params` layout and scales. Every leaf is drawn whole, in the
        merged tp-1 shapes and order, and the rank keeps its slice: the
        weights are those of the tp-1 merged draw from the same seed,
        whatever the layout and the rank, and no rank holds more than one
        full leaf at a time. `transform(name, leaf)` sees each full leaf
        of this layout first (`TPLayout.place`)."""
        for name, shape in self._shapes(local=False, merged=True).items():
            t = torch.empty(shape, dtype=dtype, device=self.device)
            if name in ("norm", "attn_norm", "ffn_norm"):
                t.fill_(1.0)
            elif name == "b_qkv":
                t.zero_()
            else:
                t.normal_(0.0, 0.02, generator=generator)
            for k, v in self.layout.place(name, t, transform=transform).items():
                self._install(k, v)
            del t
        return self

    def _install(self, name: str, t):
        self._drop(name)
        if isinstance(t, QTensor):
            setattr(self, name, t.to(self.device).contiguous())
        else:
            self.register_parameter(
                name,
                nn.Parameter(
                    t.detach().to(self.device).contiguous(),
                    requires_grad=False,
                ),
            )

    def load_params(self, tensors: Dict[str, Any]):
        """Install named weights (from `params_from_numpy`, or the nested
        tree `params_tree` returns) on this module's device, checking
        every logical shape. Dense tensors become frozen parameters,
        `QTensor`s plain attributes."""
        if "layers" in tensors:
            tensors = {
                **{k: v for k, v in tensors.items() if k != "layers"},
                **tensors["layers"],
            }
        # the layout follows the tree (the JAX package derives it from
        # the actual params too): a loader keeps parts unmerged that
        # cannot merge (act-order GPTQ with differing permutations)
        merged = "wqkv" in tensors
        if merged != self.merged and ("wq" in tensors or merged):
            for name in self._shapes():
                self._drop(name)
            self.merged = merged
            self.layout = dataclasses.replace(self.layout, merged=merged)
        shapes = self._shapes()
        missing = set(shapes) - set(tensors)
        if missing:
            raise KeyError(f"missing parameters: {sorted(missing)}")
        for name, shape in shapes.items():
            t = tensors[name]
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
            self._install(name, t)
        return self

    def _drop(self, name: str):
        if name in self._parameters:
            del self._parameters[name]
        elif name in self.__dict__:
            del self.__dict__[name]

    def params_tree(self, pop: bool = False) -> Dict[str, Any]:
        """The weights as the nested tree the quantization transforms walk
        ({"embed", "norm", "lm_head", "layers": {...}}). With `pop` the
        module gives them up, so a transform can free each dense leaf as
        it replaces it; `load_params` installs the result."""
        tree: Dict[str, Any] = {"layers": {}}
        for name in self._shapes():
            t = getattr(self, name)
            t = t.data if isinstance(t, nn.Parameter) else t
            if pop:
                self._drop(name)
            (tree["layers"] if name in self.LAYER_LEAVES else tree)[name] = t
        return tree

    # -- forward ------------------------------------------------------------

    def _layer(self, h: torch.Tensor, layer: int, cos, sin, attend,
               token_split: bool = True):
        """One decoder layer; `attend(q, k, v, layer)` appends the fresh
        K/V and returns the attention output [T, H, Dh] (this rank's
        heads). `token_split`: the MoE FFN may split the tokens over the
        replicas (not inside a sequence-parallel prefill, whose hidden
        state differs from replica to replica)."""
        T = h.shape[0]
        H, KV, Dh = self.h_local, self.kv_local, self.head_dim
        if self.merged:
            x = self._norm_acts(h, self.attn_norm[layer], self.wqkv)
            qkv = linear(
                x, self.wqkv, getattr(self, "b_qkv", None), layer=layer
            )
            q = qkv[:, : H * Dh]
            k = qkv[:, H * Dh : (H + KV) * Dh]
            v = qkv[:, (H + KV) * Dh :]
        else:
            x = self._norm_acts(h, self.attn_norm[layer], self.wq)
            q, k, v = (
                linear(x, getattr(self, w), getattr(self, b, None), layer=layer)
                for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))
            )
        q = q.reshape(T, H, Dh)
        k = k.reshape(T, KV, Dh)
        v = v.reshape(T, KV, Dh).contiguous()
        q = apply_rope(q, cos, sin, self.rotary_layout)
        k = apply_rope(k, cos, sin, self.rotary_layout)
        o = attend(q, k, v, layer)
        h = h + self._row_linear(o.reshape(T, -1), self.wo, layer,
                                 self.attn_tp > 1)
        return self._ffn(h, layer, token_split)

    def _row_linear(self, x, w, layer: int, sharded: bool = True):
        """A row-parallel projection: this rank's partial product, summed
        over the group in f32 (reference RowParallelLinear,
        tensor_parallel.py:157-169). An act-order weight's rows index the
        whole input, so its input is gathered first; a W8A8 weight's
        per-token scale is the whole row's (`linear`'s `row_max`)."""
        if self.group is None or not sharded:
            return linear(x, w, layer=layer)
        if isinstance(w, QTensor) and w.in_perm is not None:
            k = w.in_features
            k0 = self.rank * k
            full = self.group.gather_last(x, k0, w.in_perm.shape[-1])
            x = full.to(x.dtype)[..., w.in_perm[layer, k0:k0 + k].long()]
            w = w.without("in_perm")
        return self.group.all_reduce_f32(
            linear(x, w, layer=layer, row_max=self.group.max_))

    def _ffn(self, h: torch.Tensor, layer: int,
             token_split: bool = True) -> torch.Tensor:
        """The FFN half of a layer, norm and residual included: SwiGLU
        here; the MoE families override it."""
        if self.merged:
            x = self._norm_acts(h, self.ffn_norm[layer], self.w_gate_up)
            gu = linear(x, self.w_gate_up, layer=layer)
            Fd = gu.shape[-1] // 2
            gate, up = gu[:, :Fd], gu[:, Fd:]
        else:
            x = self._norm_acts(h, self.ffn_norm[layer], self.w_gate)
            gate = linear(x, self.w_gate, layer=layer)
            up = linear(x, self.w_up, layer=layer)
        hid = (F.silu(gate) * up).to(h.dtype)
        sharded = self.ffn_tp > 1
        hid = self._maybe_quant_acts(hid, self.w_down, sharded)
        return h + self._row_linear(hid, self.w_down, layer, sharded)

    @staticmethod
    def _w8a8(proj_w) -> bool:
        return isinstance(proj_w, QTensor) and proj_w.kind == QuantKind.W8A8

    def _norm_acts(self, h, norm_w, proj_w):
        """RMSNorm, fused with per-token int8 activation quantization when
        the consuming projection is W8A8."""
        if self._w8a8(proj_w):
            fused = rms_norm_quant if op_kernels() else rms_norm_quant_plain
            return fused(h, norm_w, self.args.norm_eps)
        return rms_norm(h, norm_w, self.args.norm_eps)

    def _maybe_quant_acts(self, x, proj_w, sharded: bool = False):
        """Mid-FFN activation quantization feeding a W8A8 down-projection;
        `sharded`: x is the rank's slice of the FFN's columns, quantized
        under the whole row's absmax."""
        if not self._w8a8(proj_w):
            return x
        if sharded and self.group is not None:
            return quant_acts_rows(x.contiguous(), self.group.max_)
        return (quant_acts if op_kernels() else quant_acts_plain)(x.contiguous())

    def _local_layers(self, h, cos, sin, attend, token_split=True):
        for layer in range(self.n_local):
            h = self._layer(h, layer, cos, sin, attend, token_split)
        return h

    def _run_layers(self, h, cos, sin, attend, token_split=True):
        """The stage's layers between the relay's links -> the normed
        hidden state on the last stage, None on the others (the reference
        PP stage loop, executor.py:179-299)."""
        st = self.stage
        if st is not None and not st.first:
            h = st.recv_prev(h)
        h = self._local_layers(h, cos, sin, attend, token_split)
        if st is not None and not st.last:
            st.send_next(h.to(self.hidden_dtype))
            return None
        return rms_norm(h, self.norm, self.args.norm_eps)

    @property
    def hidden_dtype(self) -> torch.dtype:
        """The dtype of the hidden state that crosses a stage boundary
        (the weights', which every stage holds a layer of)."""
        return self.attn_norm.dtype

    def final_logits(self, h: torch.Tensor) -> torch.Tensor:
        """The last stage's head on a hidden state [T, D]: norm, logits."""
        return self._logits(rms_norm(h, self.norm, self.args.norm_eps))

    def _head(self, h, idx=None):
        """Logits of the rows `idx` of the normed hidden state, or None on
        a stage that has none (not the last)."""
        if h is None:
            return None
        return self._logits(h if idx is None else h[idx])

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_rows(self, tokens)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.args.tie_word_embeddings else self.lm_head
        return head_logits(self, h, head)

    def _rope_rows(self, pos: torch.Tensor):
        idx = torch.clamp(pos, 0, self.cos.shape[0] - 1).long()
        return self.cos[idx], self.sin[idx]

    def _attn_kw(self):
        a = self.args
        return dict(
            kv_heads=self.kv_local, head_dim=self.head_dim,
            scale=self.attn_scale, window=a.sliding_window,
            softcap=a.attn_softcap,
        )

    def prefill(
        self,
        cache: Dict[str, torch.Tensor],  # {"kv": [L, P, page, M] pool}
        tokens: torch.Tensor,  # [T] int32 (padded)
        block_table: torch.Tensor,  # [mp] int32
        start_pos: int,  # chunk offset (chunked prefill)
        valid_len: int,  # valid tokens in this chunk
        page_size: int,
        return_all_logits: bool = False,
        ring: bool = False,
    ):
        """One request's prefill chunk -> (last-token logits [V], cache):
        a plain indexed append of the chunk's K/V, then the B5 kernel
        (reference: Transformer.prefill_single_device,
        models/model.py:450-465). On the ring KV pool: the owner-write
        append and the ring attention of `ops/attention_ring.py`. `ring`:
        the sequence-parallel prefill of a whole prompt (`_prefill_ring`)."""
        if ring:
            return self._prefill_ring(cache, tokens, block_table, valid_len,
                                      page_size)
        T = tokens.shape[0]
        dev = tokens.device
        ar = torch.arange(T, dtype=torch.int32, device=dev)
        pos = ar + start_pos
        total_len = start_pos + valid_len
        q_pos = torch.where(ar < valid_len, pos, torch.zeros_like(pos))
        pool = cache["kv"]
        h = self._embed(tokens)
        cos, sin = self._rope_rows(pos)
        kw = self._attn_kw()

        def attend(q, k, v, layer):
            attn_ops.append_prefill(
                pool, layer, k, v, block_table, pos, valid_len, page_size
            )
            return self.attn.attend_prefill(
                q, pool, layer, block_table, q_pos, total_len, page_size, **kw
            )

        def attend_ring_kv(q, k, v, layer):
            group = self.dp_group
            ring_ops.append_prefill_ring(pool, layer, k, v, block_table, pos,
                                         valid_len, page_size, group)
            if start_pos == 0:
                return ring_ops.attend_prefill_fresh(
                    q, k, v, q_pos, valid_len, pool.dtype, kw["scale"],
                    kw["window"], kw["softcap"])
            return ring_ops.attend_prefill_ring(
                q, pool, layer, block_table, q_pos, total_len, page_size,
                group=group, **kw)

        h = self._run_layers(h, cos, sin,
                             attend_ring_kv if self.ring_kv else attend)
        if return_all_logits:
            return self._head(h), cache
        return self._head(h, max(valid_len - 1, 0)), cache

    def _prefill_ring(self, cache, tokens, block_table, valid_len: int,
                      page_size: int):
        """Sequence-parallel prefill of a whole prompt (start 0) over the
        dp group -> (its last valid token's logits [V], cache). Replica d
        carries tokens [d T / dp, (d + 1) T / dp) through every layer;
        attention is `parallel.ring.ring_attention`, and every slice of
        K/V that passes a rank lands in its pool (replicated: each rank
        appends all T rows). The MoE layers take no token split here
        (each rank's rows are its own). The last valid token's hidden row
        goes from the rank that holds it to the others, which all take
        the logits of it. Under pp each stage runs its layers over the
        replica's slice, which the relay passes from stage to stage of the
        same replica (`_run_layers`); ring attention runs over the stage's
        dp group, each stage's pool takes its own layers' rows, and the
        logits are the last stage's (None on the others: the executor's
        sampler of record, replica 0's last stage, relays the token)."""
        from chitu_tpu_torch.parallel.ring import ring_attention

        group = self.dp_group
        T = tokens.shape[0]
        n = T // group.size
        d = group.rank
        dev = tokens.device
        pos = torch.arange(d * n, (d + 1) * n, dtype=torch.int32, device=dev)
        ring_pos = torch.where(pos < valid_len, pos, torch.full_like(pos, -1))
        pool = cache["kv"]
        bts = block_table[None, :]
        seg = torch.zeros((n,), dtype=torch.int32, device=dev)
        h = self._embed(tokens[d * n:(d + 1) * n])
        cos, sin = self._rope_rows(pos)

        def attend(q, k, v, layer):
            def append(kb, vb, pb):
                attn_ops.append_prefill_packed(pool, layer, kb, vb, bts, seg,
                                               pb, page_size)

            return ring_attention(q, k, v, ring_pos, group,
                                  scale=self.attn_scale, on_block=append)

        h = self._run_layers(h, cos, sin, attend, token_split=False)
        if h is None:  # a stage before the last: the logits are not here
            return None, cache
        owner, row = divmod(max(valid_len - 1, 0), n)
        last = h[row:row + 1].contiguous() if d == owner else torch.empty(
            (1, h.shape[1]), dtype=h.dtype, device=dev)
        last = group.broadcast_from(last, owner)
        return self._logits(last)[0], cache

    def prefill_packed(
        self,
        cache: Dict[str, torch.Tensor],
        tokens: torch.Tensor,  # [T] int32 packed (per-segment padded)
        seg_ids: torch.Tensor,  # [T] int32 segment per token (-1 = pad)
        pos: torch.Tensor,  # [T] int32 position within its sequence (-1 pad)
        block_tables: torch.Tensor,  # [R, mp] int32
        total_lens: torch.Tensor,  # [R] int32
        last_idx: torch.Tensor,  # [R] int32 packed row of each seg's last tok
        block_seg: torch.Tensor,  # [NB] int32
        block_qstart: torch.Tensor,  # [NB] int32
        page_size: int,
    ):
        """R ragged prompts in one forward -> (logits [R, V], cache). The
        B2 kernel appends each block's rows and attends (reference:
        chitu/utils.py:84-100 VarLens, executor.py:118-131); `seg_ids`
        feeds nothing but the contract (the kernel reads the block
        geometry), `pos` places the rotary tables."""
        pool = cache["kv"]
        h = self._embed(tokens)
        cos, sin = self._rope_rows(pos)
        kw = self._attn_kw()

        def attend(q, k, v, layer):
            return self.attn.attend_prefill_packed_fused(
                q, pool, layer, k, v, block_tables, block_seg, block_qstart,
                total_lens, page_size, **kw,
            )

        h = self._run_layers(h, cos, sin, attend)
        return self._head(h, last_idx.long()), cache

    def step_hybrid(
        self,
        cache: Dict[str, torch.Tensor],
        dec_tokens: torch.Tensor,  # [B] int32
        dec_seq_lens: torch.Tensor,  # [B] context length (fed token's pos)
        dec_block_tables: torch.Tensor,  # [B, mp_d] int32
        dec_valid: torch.Tensor,  # [B] bool
        pf_tokens: torch.Tensor,  # [T] int32 packed (per-segment padded)
        pf_seg_ids: torch.Tensor,  # [T] int32 (-1 = pad)
        pf_pos: torch.Tensor,  # [T] int32 (-1 = pad)
        pf_block_tables: torch.Tensor,  # [R, mp_p] int32
        pf_total_lens: torch.Tensor,  # [R] int32
        pf_last_idx: torch.Tensor,  # [R] int32
        pf_block_seg: torch.Tensor,  # [NB] int32
        pf_block_qstart: torch.Tensor,  # [NB] int32
        page_size: int,
    ):
        """Fused prefill+decode step -> (dec_logits [B, V], pf_logits
        [R, V], cache): the B decode tokens and the packed prefill tokens
        share every projection and FFN GEMM; attention splits into the B1
        kernel for the decode rows and the B2 kernel for the prefill rows
        (disjoint pages, so their order does not matter)."""
        B = dec_tokens.shape[0]
        pool = cache["kv"]
        h = self._embed(torch.cat([dec_tokens, pf_tokens]))
        cos, sin = self._rope_rows(torch.cat([dec_seq_lens, pf_pos]))
        kw = self._attn_kw()

        def attend(q, k, v, layer):
            od = self.attn.attend_decode_fused(
                q[:B], pool, layer, k[:B], v[:B], dec_block_tables,
                dec_seq_lens, dec_valid, page_size, **kw,
            )
            op = self.attn.attend_prefill_packed_fused(
                q[B:], pool, layer, k[B:], v[B:], pf_block_tables,
                pf_block_seg, pf_block_qstart, pf_total_lens, page_size, **kw,
            )
            return torch.cat([od, op], dim=0)

        h = self._run_layers(h, cos, sin, attend)
        dec_logits = self._head(h, slice(None, B))
        pf_logits = self._head(h, B + pf_last_idx.long())
        return dec_logits, pf_logits, cache

    def verify_draft(
        self,
        cache: Dict[str, torch.Tensor],
        tokens: torch.Tensor,  # [B, K1] int32: last accepted token + K drafts
        seq_lens: torch.Tensor,  # [B] int32 context BEFORE tokens[:, 0]
        block_tables: torch.Tensor,  # [B, mp] int32
        valid: torch.Tensor,  # [B] bool
        page_size: int,
    ):
        """Speculative-decode verification -> (greedy tokens [B, K1],
        cache): the B rows' K+1 tokens run through one forward at their
        absolute positions, and the greedy continuation of every position
        lets the caller accept the longest matching draft prefix plus one
        token of the model's own. The drafts' K/V land in the pool by the
        plain packed append (invalid rows write nothing); rows a later
        round rejects are overwritten by its inputs and never read (the
        attention is causal by position). Attention is the packed B3
        kernel with one K1-token block per row (`block_qstart` = seq_lens,
        dead blocks where not valid), as the JAX package's Pallas route
        packs it. The reference has no speculative decoding."""
        B, K1 = tokens.shape
        dev = tokens.device
        pool = cache["kv"]
        pos = (
            seq_lens[:, None]
            + torch.arange(K1, dtype=torch.int32, device=dev)[None, :]
        ).reshape(-1)
        rows = torch.arange(B, dtype=torch.int32, device=dev)
        block_seg = torch.where(valid, rows, torch.full_like(rows, -1))
        seg_ids = block_seg.repeat_interleave(K1)
        total_lens = seq_lens + K1
        h = self._embed(tokens.reshape(-1))
        cos, sin = self._rope_rows(pos)
        kw = self._attn_kw()

        def attend(q, k, v, layer):
            attn_ops.append_prefill_packed(
                pool, layer, k, v, block_tables, seg_ids, pos, page_size
            )
            return self.attn.attend_prefill_packed(
                q, pool, layer, block_tables, block_seg, seq_lens,
                total_lens, page_size, **kw,
            )

        h = self._run_layers(h, cos, sin, attend)
        logits = self._head(h)
        greedy = None if logits is None else torch.argmax(
            logits, dim=-1).to(torch.int32)
        if self.world is not None and self.world.needs_relay:
            # the drafts' acceptance runs on every rank, on the sampler's
            greedy = self.world.from_sampler(greedy, (B * K1,), torch.int32,
                                             dev)
        return greedy.reshape(B, K1), cache

    def decode(
        self,
        cache: Dict[str, torch.Tensor],
        tokens: torch.Tensor,  # [B] int32
        seq_lens: torch.Tensor,  # [B] context length (new token's position)
        block_tables: torch.Tensor,  # [B, mp] int32
        valid: torch.Tensor,  # [B] bool
        page_size: int,
    ):
        """Batched one-token decode -> (logits [B, V], cache) through the
        B1 kernel (reference: Transformer.decode, models/model.py:537-622)."""
        h = self._embed(tokens)
        cos, sin = self._rope_rows(seq_lens)
        attend = self._decode_attend(cache, seq_lens, block_tables, valid,
                                     page_size)
        return self._head(self._run_layers(h, cos, sin, attend)), cache

    def _decode_attend(self, cache, seq_lens, block_tables, valid, page_size):
        pool = cache["kv"]
        kw = self._attn_kw()

        def attend(q, k, v, layer):
            return self.attn.attend_decode_fused(
                q, pool, layer, k, v, block_tables, seq_lens, valid,
                page_size, **kw,
            )

        def attend_ring_kv(q, k, v, layer):
            return ring_ops.attend_decode_fused_ring(
                self.attn, q, pool, layer, k, v, block_tables, seq_lens,
                valid, page_size, group=self.dp_group, **kw)

        return attend_ring_kv if self.ring_kv else attend

    def decode_local(self, cache, h, seq_lens, block_tables, valid,
                     page_size):
        """The stage's layers of one decode step on a hidden state [B, D]
        (the pipelined decode's: no relay, no final norm), B1 on the
        stage's pool."""
        cos, sin = self._rope_rows(seq_lens)
        attend = self._decode_attend(cache, seq_lens, block_tables, valid,
                                     page_size)
        return self._local_layers(h, cos, sin, attend)


def embed_rows(model, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of `tokens`; vocab-parallel (`model.vocab_tp` > 1):
    each rank looks up the tokens in its vocab slice, zeros the rest, and
    the rows are summed over the group (exact: one nonzero term). A stage
    after the first gets an empty buffer of the rows' shape, which the
    relay fills."""
    if model.stage is not None and not model.stage.first:
        return torch.empty((tokens.shape[0], model.args.dim),
                           dtype=model.hidden_dtype, device=tokens.device)
    if model.vocab_tp == 1:
        return model.embed[tokens.long()]
    n = model.embed.shape[0]
    t = tokens.long() - model.rank * n
    held = (t >= 0) & (t < n)
    rows = model.embed[t.clamp(0, n - 1)] * held[:, None].to(model.embed.dtype)
    return model.group.all_reduce_f32(rows)


def head_logits(model, h: torch.Tensor, head) -> torch.Tensor:
    """f32 logits of a normed hidden state through `head` [D, V / vocab_tp]
    (dense, or quantized under quant.quantize_head); vocab-parallel: every
    rank gets the whole row, so sampling, penalties, stop checks and draft
    acceptance see the same logits everywhere."""
    if isinstance(head, QTensor):
        y = linear(h, head, out_dtype=torch.float32)
    else:
        y = matmul_out_dtype(h, head, torch.float32)
    if model.vocab_tp == 1:
        return y
    n = y.shape[-1]
    return model.group.gather_last(y, model.rank * n, model.args.vocab_size)


def join_world(model, infer, stacks, tied=False, first_only=()):
    """Set a model's place in the world: `world` (the rank's
    `parallel.distributed.TPGroup`, None on one device), `group` (the same
    when tp > 1: the tensor-parallel collectives), `stage` (the relay when
    pp > 1), `dp_group` (the replicas of its (stage, TP index) when
    dp > 1), `ring_kv` (the pool's pages stripe over them), `rank` (its TP
    index), `pp`; -> its `StageSlice` over `stacks` ({name: layers})."""
    from chitu_tpu_torch.parallel.distributed import tp_group

    dp, tp, pp = infer.dp_size, infer.tp_size, infer.pp_size
    n = dp * tp * pp
    world = tp_group() if n > 1 else None
    if n > 1 and (world is None or world.size != tp or world.pp != pp
                  or world.dp != dp):
        raise RuntimeError(
            f"dp_size={dp} x pp_size={pp} x tp_size={tp} needs a process "
            f"group of {n} ranks (parallel.distributed.maybe_initialize; the "
            "engine joins it from infer.coordinator / num_processes / "
            "process_id)"
        )
    model.world, model.pp = world, pp
    model.group = world if tp > 1 else None
    model.stage = world.relay if pp > 1 else None
    model.dp_group = world.dp_group if dp > 1 else None
    model.ring_kv = bool(infer.ring_kv) and dp > 1
    model.rank = world.rank if world is not None else 0
    if pp <= 1:
        return StageSlice()
    return StageSlice.of(world.stage, pp, stacks, tied=tied,
                         first_only=first_only)
