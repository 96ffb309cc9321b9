"""DeepSeek-V3 / R1: MLA attention (absorb) + group-limited sparse MoE.

Counterpart of `chitu_tpu/models/deepseek_v3.py` (reference:
chitu/models/model_deepseek_v3.py):

- **MLA absorb** (reference: :475-536, :564-602): queries are absorbed
  through W_uk, so the KV cache holds one latent row a token, [c_kv (512) |
  k_pe (64)] padded to 640 lanes and shared by every head; prefill and
  decode both run as one-KV-head attention over that row (live width 576),
  whose first kv_lora_rank lanes are also the value, then un-absorb
  through W_uv. The absorb projections at T <= 128 go through the B9
  kernel (`ops/absorb_kernels.py`) on the whole stacked `wkv_b`, as the
  JAX model's Pallas branch does; above that (and for a quantized
  `wkv_b`) an einsum runs on the layer's view, as there.
- **Attention kernels** (`ops/attention_kernels.py`), each where its JAX
  counterpart calls its own: `prefill` appends (plain) then B5;
  `prefill_packed` appends then B3; `step_hybrid` appends the decode and
  the prefill rows, then B4 for the decode rows and B3 for the prefill
  rows; `decode` runs B1, which appends in the kernel.
- **Two stacks**: the first `n_dense_layers` layers with a dense SwiGLU
  FFN (`dense_layers`, pool `kv_dense`), the rest with the MoE FFN
  (`moe_layers`, pool `kv_moe`): a shared expert (or its merged
  `shared_gu`), the sigmoid router with score-correction bias over expert
  groups (`models/moe.route`), and the routed experts through
  `moe_ffn_auto` (the token-sorted grouped GEMM, B8).
- **YaRN rope** (interleaved pairs) with the mscale² softmax correction.

The weights are the JAX package's tree: {"embed", "norm", "lm_head",
"dense_layers": {...}, "moe_layers": {...}} of stacked [L, ...] leaves,
dense or `QTensor`, split or merged (`wq_kv_a`, `shared_gu`, `exp_gu`),
kept as two dicts on the module. The KV pools are updated IN PLACE.

`mla_absorb=none` (reference dense paths: :612-670) materializes per-head
K = [k_nope | k_pe] and V through the whole `wkv_b` (`linear`, no B9) and
runs plain multi-head attention on the split K/V layout at head_dim 192,
V padded from 128 to 192 lanes in the pool row: the same four kernels at
that head size (`_mla_dense`). The param tree is the absorb path's.

Its checkpoints (bf16, or the published native fp8 with
`weight_scale_inv`) load through `loaders_moe.load_deepseek_params`.

Tensor parallelism (`infer.tp_size`; `MLALayout`, the JAX package's
`param_partition_specs`): the query projection (`wq` / `wq_b`) and
`wkv_b` are cut by heads (columns), `wo` by heads (rows, then an f32
all-reduce), the dense FFN and the shared expert by columns / rows, the
routed experts by experts (expert parallelism: each rank dispatches its
range of experts through B8, `models.moe.moe_ffn_ep`), the embedding by
vocabulary rows and the head by vocabulary columns; the latent down-
projections (`wq_a`, `wkv_a`, merged `wq_kv_a`), the norms and the router
(`moe_gate`, `gate_bias`) stay whole, and so do both latent pools (a
latent row is shared by every head). Heads that tp does not divide (R1's
128 at tp3) leave the head-cut leaves and the dense MLA's per-head pool
whole on every rank (`MLALayout.heads_split`), and nothing is summed
after wo; experts that tp does not divide take contiguous ranges, the
first E % tp ranks one more (86 / 85 / 85 of 256 at tp3). A rank runs
MLA on its H / tp heads
(the head count comes from the projection's width: B9 and the latent
kernels at H / tp heads), and a MoE layer's shared and routed partials
are summed in one all-reduce. Under `mla_absorb=none` a rank holds its
H / tp heads of the per-head K / V pool (the JAX package's
`kv_cache_partition_spec` of the dense path) and runs `_mla_dense` on
them. A W8A8 row-parallel input (`wo`, the dense FFN's and the shared
expert's `*_down`) is quantized under the whole row's per-token scale
(`linear`'s `row_max`).

Pipeline parallelism (`infer.pp_size`, at any tp): the dense-first layers,
their `kv_dense` pool and the embedding live on stage 0 (cut over stage
0's TP group); every stage holds its contiguous range of the MoE layers
(n_moe // pp, the first n_moe % pp stages one more, perhaps none) and
that slice of `kv_moe`; the last stage the final norm and head. The JAX package
replicates the dense stack and its pool over 'pp' and reconciles the pool
once a window (a shard_map needs one layout on every device); here the
stages that never read them do not hold them. The hidden state, whole on
every TP rank after the all-reduces, crosses each stage boundary once
(`_forward`, as the llama module's `_run_layers`).

Data parallelism (`infer.dp_size`): replicas of the same layout; a MoE
layer splits its tokens over them where the count divides. With
`infer.ring_kv` both latent pools stripe their pages over the replicas
(`ops/attention_ring.py`): owner-write appends and a plain partial over
the rank's pages, combined over the dp group (on the dense MLA path, at
tp 1, decode runs B1's partials mode as the llama module does). Ring
prefill is the Llama family's only, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from chitu_tpu_torch.models import register_model
from chitu_tpu_torch.models.common import (
    apply_rope,
    pad_kv_minor,
    rms_norm,
    rope_tables,
)
from chitu_tpu_torch.models.llama import (
    EXPERT_STACKS,
    embed_rows,
    head_logits,
    join_world,
)
from chitu_tpu_torch.models.moe import moe_ffn_auto, route
from chitu_tpu_torch.ops import attention as attn_ops
from chitu_tpu_torch.ops import attention_kernels as kernels
from chitu_tpu_torch.ops import attention_ring as ring_ops
from chitu_tpu_torch.ops.absorb_kernels import (
    MAX_T,
    absorb_kernel_ok,
    absorb_matmul,
)
from chitu_tpu_torch.ops.linear import linear, op_kernels
from chitu_tpu_torch.ops.qtensor import QTensor
from chitu_tpu_torch.parallel.sharding import (
    StageSlice,
    even_range,
    narrow_out,
    owned,
    shard_leaf,
)
from chitu_tpu_torch.utils import resolve_device

STACKS = ("dense_layers", "moe_layers")
POOLS = {"dense_layers": "kv_dense", "moe_layers": "kv_moe"}
# the parts of each merged leaf, in their order along the out dim
MERGES = {
    "wq_kv_a": ("wq_a", "wkv_a"),
    "shared_gu": ("shared_gate", "shared_up"),
    "exp_gu": ("exp_gate", "exp_up"),
}


@dataclass(frozen=True)
class MLALayout:
    """One rank's view of DeepSeek's weights: its pipeline stage's layers
    (`stage`) and its tensor-parallel slice of each leaf, the JAX
    package's `param_partition_specs` (chitu_tpu/models/deepseek_v3.py:
    236-286) as per-leaf specs (`parallel.sharding`): `wq` / `wq_b` and
    `wkv_b` by query heads on their columns (each head's [nope | rope] or
    [k_nope | v] columns stay together), `wo` by heads on its rows; the
    dense FFN and the shared expert column / row; the expert stacks by
    experts; `embed` by vocabulary rows and `lm_head` by vocabulary
    columns; every other leaf whole. A merged `shared_gu` (tp 1 only, as
    in the JAX package: a plain [gate | up] concatenation would be cut at
    the wrong column) is split into its halves under tp > 1. `merged` is
    read by `loader.load_preprocessed`: this layout merges nothing."""

    rank: int = 0
    tp: int = 1
    n_heads: int = 0
    stage: StageSlice = StageSlice()
    merged: bool = True

    @property
    def heads_split(self) -> bool:
        """Does MLA split over the group (tp divides the heads)? Else every
        rank holds the head-cut leaves whole and runs every head."""
        return self.n_heads % self.tp == 0

    def part_spec(self, name: str, ndim: int) -> tuple:
        spec = [None] * ndim
        heads = ("tp", self.n_heads) if self.heads_split else None
        if name in ("wq", "wq_b", "wkv_b"):
            spec[-1] = heads
        elif name == "wo":
            spec[-2] = heads
        elif name in ("w_gate", "w_up", "shared_gate", "shared_up", "lm_head"):
            spec[-1] = "tp"
        elif name in ("w_down", "shared_down"):
            spec[-2] = "tp"
        elif name in EXPERT_STACKS:
            spec[-3] = "ep"
        elif name == "embed":
            spec[0] = "tp"
        return tuple(spec)

    def local(self, name: str, leaf):
        """Rank's shard of one whole leaf."""
        if self.tp <= 1:
            return leaf
        nd = leaf.data.dim() if isinstance(leaf, QTensor) else leaf.dim()
        return shard_leaf(leaf, self.part_spec(name, nd), self.rank, self.tp)

    def place(self, stack: str, name: str, leaf,
              transform=None) -> Dict[str, Any]:
        """One whole leaf of `stack` ("" for the top level) -> the rank's
        leaves by name: the stage's layers, then the TP slice.
        `transform(name, leaf)` (on-load quantization) sees each leaf
        whole but for the expert stacks, whose rank's experts are cut
        first (each (layer, expert) matrix quantizes on its own)."""
        transform = transform or (lambda n, t: t)
        if not stack and not self.stage.holds(name):
            return {}
        whole = leaf
        if stack:  # a view: the TP cut or `owned` copies the rank's part
            leaf = self.stage.cut(stack, leaf)
        if name == "shared_gu" and self.tp > 1:
            n = leaf.shape[-1] // 2
            out = {**self.place("", "shared_gate", narrow_out(leaf, 0, n)),
                   **self.place("", "shared_up", narrow_out(leaf, n, 2 * n))}
        elif name in EXPERT_STACKS:
            out = {name: transform(name, self.local(name, leaf))}
        else:
            out = {name: self.local(name, transform(name, leaf))}
        return {k: owned(v, whole) for k, v in out.items()}

    def tree(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """A nested tree of whole leaves -> the rank's part of it."""
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            if k not in STACKS:
                out.update(self.place("", k, v))
                continue
            if self.stage.holds(k):
                out[k] = {}
                for n, t in v.items():
                    out[k].update(self.place(k, n, t))
        return out


@register_model("deepseek-v3")
class DeepSeekV3ForCausalLM(nn.Module):
    supports_ring_kv = True  # infer.ring_kv (ops/attention_ring.py)

    def __init__(self, args, cfg, device=None):
        super().__init__()
        if args.mla is None or args.moe is None:
            raise ValueError("a deepseek-v3 model card needs mla and moe sections")
        infer = cfg.infer
        self.args = args
        self.cfg = cfg
        # infer.attn_type: the CUDA kernels, or their plain versions
        self.attn_route, self.attn = kernels.attention_route(infer.attn_type)
        self.device = resolve_device(device)
        self.mla = m = args.mla
        self.moe = args.moe
        # mla_absorb=none: the dense per-head path (the cache holds K and
        # V padded to qk_head_dim per head); absorb is the production path
        self.absorb = infer.mla_absorb != "none"
        self.qk_head_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.kv_dim = m.kv_lora_rank + m.qk_rope_head_dim
        self.kv_minor = pad_kv_minor(1, self.kv_dim)
        # the attention width the executor's slab geometry reads, as in
        # the JAX model
        self.head_dim = self.kv_minor if self.absorb else self.qk_head_dim
        self.n_dense = self.moe.n_dense_layers
        self.n_moe = args.n_layers - self.n_dense
        stage = join_world(
            self, infer, {"dense_layers": self.n_dense, "moe_layers": self.n_moe},
            first_only=("dense_layers",))
        self.n_local = {k: stage.count(k, n) for k, n in (
            ("dense_layers", self.n_dense), ("moe_layers", self.n_moe))}
        # tensor parallelism: H / tp heads a rank; an FFN, shared expert or
        # vocabulary that tp does not divide replicates (nothing summed)
        tp = self.tp = infer.tp_size
        mo = self.moe
        self.ffn_tp = tp if args.inter_dim % tp == 0 else 1
        self.shared_tp = tp if self._shared_dim() % tp == 0 else 1
        self.vocab_tp = tp if args.vocab_size % tp == 0 else 1
        # the rank's contiguous expert range (uneven where tp does not
        # divide the experts)
        self.e_local = len(range(*even_range(mo.n_routed_experts, self.rank,
                                             tp)))
        # params_from_numpy and the loaders read the stage and the cuts
        self.layout = MLALayout(self.rank, tp, args.n_heads, stage)
        # heads that tp does not divide: MLA and its pools replicate, and
        # nothing is summed after wo
        self.attn_tp = tp if self.layout.heads_split else 1

        # softmax scale with the YaRN mscale correction
        # (reference: model_deepseek_v3.py:1420-1445)
        scale = 1.0 / math.sqrt(self.qk_head_dim)
        rs = args.rope_scaling
        if (
            rs is not None
            and rs.kind == "yarn"
            and infer.max_seq_len > rs.original_max_position
            and rs.factor > 1.0
            and rs.mscale_all_dim > 0
        ):
            ms = 0.1 * rs.mscale_all_dim * math.log(rs.factor) + 1.0
            scale = scale * ms * ms
        self.attn_scale = scale
        cos, sin = rope_tables(
            m.qk_rope_head_dim, infer.max_seq_len, args.rope_theta, rs,
            device=self.device,
        )
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)
        self.rotary_layout = "llama"  # interleaved pairs
        self.dense_layers: Dict[str, Any] = {}
        self.moe_layers: Dict[str, Any] = {}

    # -- cache geometry -----------------------------------------------------

    def kv_cache_spec(self) -> Dict[str, Any]:
        # the stage's layers of each stack (a stage after the first holds
        # no dense-first layers, and no pool for them)
        groups = {POOLS[k]: n for k, n in self.n_local.items()
                  if n or self.pp == 1}
        n_layers = sum(groups.values())
        if not self.absorb:
            # dense MLA: per-head K/V rows (V padded to qk_head_dim) of
            # the rank's heads
            return dict(
                n_layers=n_layers,
                kv_heads=self.args.n_heads // self.attn_tp,
                head_dim=self.qk_head_dim,
                kv_dim=0,
                layer_groups=groups,
            )
        # merged-MLA cache: one latent row a token shared across heads
        # (reference: backend.py:186-197)
        return dict(
            n_layers=n_layers,
            kv_heads=0,
            head_dim=0,
            kv_dim=self.kv_dim,
            layer_groups=groups,
        )

    def quantizable_keys(self):
        keys = {
            "wq", "wq_a", "wq_b", "wkv_a", "wkv_b", "wo", "w_gate", "w_up",
            "w_down", "shared_gate", "shared_up", "shared_down", "exp_gate",
            "exp_up", "exp_down",
        }
        # the absorb projections read wkv_b per layer per call: quantized,
        # a call would read the fp8 leaf, write its bf16 dequant and read
        # that again. It is about 2 % of the weights; on-load quantization
        # keeps it bf16 (native fp8 checkpoints still load it quantized)
        return keys - {"wkv_b"}

    # -- parameters ---------------------------------------------------------

    def _shared_dim(self) -> int:
        mo = self.moe
        return mo.moe_inter_dim * max(mo.n_shared_experts, 1)

    def _attn_shapes(self, L: int, H: int) -> Dict[str, tuple]:
        a, m = self.args, self.mla
        D = a.dim
        s = {
            "attn_norm": (L, D),
            "ffn_norm": (L, D),
            "wkv_a": (L, D, self.kv_dim),
            "kv_norm": (L, m.kv_lora_rank),
            "wkv_b": (L, m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)),
            "wo": (L, H * m.v_head_dim, D),
        }
        if m.q_lora_rank > 0:
            s["wq_a"] = (L, D, m.q_lora_rank)
            s["q_norm"] = (L, m.q_lora_rank)
            s["wq_b"] = (L, m.q_lora_rank, H * self.qk_head_dim)
        else:
            s["wq"] = (L, D, H * self.qk_head_dim)
        return s

    def _shapes(self, merged=frozenset(), local: bool = True
                ) -> Dict[str, Dict[str, tuple]]:
        """Logical shapes by stack ("" = top level) of the stage's leaves,
        or (`local=False`) of the whole model; `merged` names the merged
        leaves present (`wq_kv_a`, `shared_gu`, `exp_gu`)."""
        a, mo = self.args, self.moe
        D, V, H, Fd = a.dim, a.vocab_size, a.n_heads, a.inter_dim
        E, Fm, Fs = mo.n_routed_experts, mo.moe_inter_dim, self._shared_dim()
        El = E  # the stacks' experts (the router's are all of them)
        Ld, Lm = ((self.n_local["dense_layers"], self.n_local["moe_layers"])
                  if local else (self.n_dense, self.n_moe))
        if local:  # the rank's slices
            H, El = H // self.attn_tp, self.e_local
            Fd, Fs, V = Fd // self.ffn_tp, Fs // self.shared_tp, V // self.vocab_tp
        dense = self._attn_shapes(Ld, H)
        dense["w_gate"] = (Ld, D, Fd)
        dense["w_up"] = (Ld, D, Fd)
        dense["w_down"] = (Ld, Fd, D)
        moe_l = self._attn_shapes(Lm, H)
        moe_l["moe_gate"] = (Lm, D, E)
        moe_l["gate_bias"] = (Lm, E)
        if mo.n_shared_experts > 0:
            moe_l["shared_gate"] = (Lm, D, Fs)
            moe_l["shared_up"] = (Lm, D, Fs)
            moe_l["shared_down"] = (Lm, Fs, D)
        moe_l["exp_gate"] = (Lm, El, D, Fm)
        moe_l["exp_up"] = (Lm, El, D, Fm)
        moe_l["exp_down"] = (Lm, El, Fm, D)
        for stack in (dense, moe_l):
            for name, (a_, b_) in MERGES.items():
                if name in merged and a_ in stack:
                    sa, sb = stack.pop(a_), stack.pop(b_)
                    stack[name] = (*sa[:-1], sa[-1] + sb[-1])
        out = {
            "": {"embed": (V, D), "norm": (D,), "lm_head": (D, V)},
            "dense_layers": dense,
            "moe_layers": moe_l,
        }
        if local and self.pp > 1:
            st = self.layout.stage
            out[""] = {k: v for k, v in out[""].items() if st.holds(k)}
            out = {k: v for k, v in out.items()
                   if not k or self.n_local[k]}
        return out

    def init_params(
        self, generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.bfloat16, transform=None,
    ):
        """Random weights on the module's device (normal * 0.02, norms 1,
        `gate_bias` 0 in f32), drawn from `generator`; the JAX package's
        `init_params` layout and scales. Every leaf is drawn whole, in the
        one-rank order, and the rank keeps its stage's layers and its TP
        slice (`MLALayout.place`): the weights are those of the one-rank
        draw from the same seed, and no rank holds more than one whole
        leaf beside its own. `transform(name, leaf)` (on-load
        quantization) sees each whole leaf first."""
        tree: Dict[str, Any] = {}
        held = self._shapes()
        for stack, shapes in self._shapes(local=False).items():
            leaves = {}
            for name, shape in shapes.items():
                dt = torch.float32 if name == "gate_bias" else dtype
                t = torch.empty(shape, dtype=dt, device=self.device)
                if "norm" in name:
                    t.fill_(1.0)
                elif name == "gate_bias":
                    t.zero_()
                else:
                    t.normal_(0.0, 0.02, generator=generator)
                if name in held.get(stack, {}):
                    leaves.update(self.layout.place(stack, name, t, transform))
                del t
            if stack:
                if stack in held:
                    tree[stack] = leaves
            else:
                tree.update(leaves)
        return self._install(tree)

    def load_params(self, tensors: Dict[str, Any]):
        """Install the nested tree (from `params_from_numpy`, or the one
        `params_tree` returns) on this module's device, checking every
        logical shape; split or merged leaves."""
        merged = {
            n for s in STACKS for n in tensors.get(s, {})
            if n in MERGES
        }
        for stack, shapes in self._shapes(frozenset(merged)).items():
            given = tensors.get(stack, {}) if stack else tensors
            missing = set(shapes) - set(given)
            if missing:
                raise KeyError(f"missing parameters: {sorted(missing)}")
            for name, shape in shapes.items():
                if tuple(given[name].shape) != shape:
                    raise ValueError(
                        f"{stack}.{name}: shape {tuple(given[name].shape)} != {shape}"
                    )
        tree = {k: tensors[k] for k in ("embed", "norm", "lm_head")
                if k in tensors}
        for stack in STACKS:
            tree[stack] = dict(tensors.get(stack, {}))
        return self._install(tree)

    def _install(self, tree):
        def dev(t):
            if isinstance(t, QTensor):
                return t.to(self.device).contiguous()
            return t.detach().to(self.device).contiguous()

        for name in ("embed", "norm", "lm_head"):
            if name in tree:
                setattr(self, name, dev(tree[name]))
        self.dense_layers = {k: dev(v) for k, v in tree.get("dense_layers", {}).items()}
        self.moe_layers = {k: dev(v) for k, v in tree.get("moe_layers", {}).items()}
        return self

    def params_tree(self, pop: bool = False) -> Dict[str, Any]:
        """The weights as the nested tree the quantization transforms walk.
        With `pop` the module gives them up, so a transform can free each
        dense leaf as it replaces it; `load_params` installs the result."""
        top = [n for n in ("embed", "norm", "lm_head") if hasattr(self, n)]
        tree = {name: getattr(self, name) for name in top}
        for stack in STACKS:
            if getattr(self, stack):
                tree[stack] = dict(getattr(self, stack))
        if pop:
            for name in top:
                delattr(self, name)
            self.dense_layers, self.moe_layers = {}, {}
        return tree

    # -- attention ----------------------------------------------------------

    def _mla_qkv(self, x, lp, layer: int, cos, sin):
        """-> q_nope [T, H, dn], q_pe [T, H, dr] (rotated), c_kv [T, dc]
        (normed), k_pe [T, dr] (rotated) of a [T, D] slab."""
        a, m = self.args, self.mla
        T = x.shape[0]
        dn, dc, ql = m.qk_nope_head_dim, m.kv_lora_rank, m.q_lora_rank
        eps = a.norm_eps
        if "wq_kv_a" in lp:
            # merged lora down-projections: one GEMM yields [q_a | kv_a]
            qkv_a = linear(x, lp["wq_kv_a"], layer=layer)
            q = linear(
                rms_norm(qkv_a[:, :ql], lp["q_norm"][layer], eps),
                lp["wq_b"], layer=layer,
            )
            kv_a = qkv_a[:, ql:]
        elif ql > 0:
            q = linear(
                rms_norm(linear(x, lp["wq_a"], layer=layer),
                         lp["q_norm"][layer], eps),
                lp["wq_b"], layer=layer,
            )
            kv_a = linear(x, lp["wkv_a"], layer=layer)
        else:
            q = linear(x, lp["wq"], layer=layer)
            kv_a = linear(x, lp["wkv_a"], layer=layer)
        # the head count from the projection's width (H / tp on a rank)
        q = q.reshape(T, -1, self.qk_head_dim)
        q_pe = apply_rope(q[..., dn:], cos, sin, self.rotary_layout)
        c_kv = rms_norm(kv_a[:, :dc], lp["kv_norm"][layer], eps)
        k_pe = apply_rope(kv_a[:, None, dc:], cos, sin, self.rotary_layout)[:, 0]
        return q[..., :dn], q_pe, c_kv, k_pe

    def _mla(self, x, lp, layer: int, cos, sin, attend):
        """MLA absorb forward of a [T, D] slab through one layer of the
        stack `lp`; `attend(q [T, H, 576], k [T, 1, 576], None, layer)`
        appends the latent rows and returns the value lanes
        [T, H, kv_lora_rank]."""
        m = self.mla
        T = x.shape[0]
        dn, dv, dc = m.qk_nope_head_dim, m.v_head_dim, m.kv_lora_rank
        q_nope, q_pe, c_kv, k_pe = self._mla_qkv(x, lp, layer, cos, sin)
        H = q_nope.shape[1]

        wkv_b = lp["wkv_b"]
        kernel = (
            op_kernels()  # infer.op_impl=xla: the einsum, as in JAX
            and not isinstance(wkv_b, QTensor)
            and absorb_kernel_ok(wkv_b, dn, dv, dc)
            and T <= MAX_T
        )
        if kernel:
            q_abs = absorb_matmul(q_nope, wkv_b, layer, "uk", dn, dv)
        else:
            w_b = (
                wkv_b[layer].dequantize(x.dtype)
                if isinstance(wkv_b, QTensor)
                else wkv_b[layer].to(x.dtype)
            ).reshape(dc, H, dn + dv)
            q_abs = torch.einsum("thd,chd->thc", q_nope, w_b[..., :dn])

        # merged cache row [c_kv | k_pe], one shared "kv head"; q at its
        # live lanes [q_abs | q_pe]
        new_kv = torch.cat([c_kv, k_pe], dim=-1)[:, None, :]
        q_full = torch.cat([q_abs, q_pe], dim=-1)
        o = attend(q_full, new_kv, None, layer)  # [T, H, dc]

        if kernel:
            v_out = absorb_matmul(o, wkv_b, layer, "uv", dn, dv)
        else:
            v_out = torch.einsum("thc,chd->thd", o, w_b[..., dn:])
        return self._wo(v_out.reshape(T, H * dv), lp, layer)

    def _row_max(self, sharded: bool = True):
        """The group's MAX all-reduce for a W8A8 row-parallel input's
        per-token absmax (`linear`'s `row_max`), or None."""
        return self.group.max_ if sharded and self.group is not None else None

    def _wo(self, o, lp, layer: int):
        """`wo` on the rank's heads' outputs [T, H / tp * dv]: its partial,
        summed over the group (whole when the heads replicate)."""
        split = self.attn_tp > 1
        y = linear(o, lp["wo"], layer=layer, row_max=self._row_max(split))
        return self.group.all_reduce_f32(y) if split else y

    def _mla_dense(self, x, lp, layer: int, cos, sin, attend):
        """mla_absorb=none: per-head K/V through the whole `wkv_b`, then
        multi-head attention at qk_head_dim (reference dense paths:
        model_deepseek_v3.py:612-670) on the rank's H / tp heads (its
        columns of `wkv_b`, its rows of `wo`). `attend(q, k, v, layer)`
        gets q, k [T, H, dn + dr] and V padded to [T, H, dn + dr], and
        returns [T, H, dn + dr], of which the first v_head_dim lanes are
        live."""
        m = self.mla
        T = x.shape[0]
        dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
        q_nope, q_pe, c_kv, k_pe = self._mla_qkv(x, lp, layer, cos, sin)
        H = q_nope.shape[1]
        q = torch.cat([q_nope, q_pe], dim=-1)
        kv = linear(c_kv, lp["wkv_b"], layer=layer).reshape(T, H, dn + dv)
        k = torch.cat([kv[..., :dn], k_pe[:, None, :].expand(T, H, dr)], dim=-1)
        v_pad = F.pad(kv[..., dn:], (0, self.qk_head_dim - dv))
        o = attend(q, k, v_pad, layer)[..., :dv]
        return self._wo(o.reshape(T, H * dv), lp, layer)

    def _attn_kw(self):
        if not self.absorb:
            return dict(
                kv_heads=self.args.n_heads // self.attn_tp,
                head_dim=self.qk_head_dim, scale=self.attn_scale,
            )
        return dict(
            kv_heads=1, head_dim=self.kv_dim, scale=self.attn_scale,
            split_kv=False, v_dim=self.mla.kv_lora_rank,
        )

    # -- FFNs ---------------------------------------------------------------

    def _dense_ffn(self, x, lp, layer: int):
        gate = linear(x, lp["w_gate"], layer=layer)
        up = linear(x, lp["w_up"], layer=layer)
        y = linear((F.silu(gate) * up).to(x.dtype), lp["w_down"], layer=layer,
                   row_max=self._row_max(self.ffn_tp > 1))
        if self.ffn_tp > 1:
            y = self.group.all_reduce_f32(y)
        return y

    def _shared_expert(self, x, lp, layer: int):
        """The shared expert's output (the rank's partial under tensor
        parallelism), or None: no shared expert, or a rank other than 0
        when tp does not divide it (rank 0 adds it whole)."""
        if self.shared_tp == 1 and self.rank != 0:
            return None
        if "shared_gu" in lp:
            gu = linear(x, lp["shared_gu"], layer=layer)
            Fs = gu.shape[-1] // 2
            return linear((F.silu(gu[:, :Fs]) * gu[:, Fs:]).to(x.dtype),
                          lp["shared_down"], layer=layer)
        if "shared_gate" in lp:
            gg = linear(x, lp["shared_gate"], layer=layer)
            u = linear(x, lp["shared_up"], layer=layer)
            return linear((F.silu(gg) * u).to(x.dtype), lp["shared_down"],
                          layer=layer, row_max=self._row_max(self.shared_tp > 1))
        return None

    def _moe_ffn(self, x, lp, layer: int):
        """The shared expert and the routed experts; under tensor
        parallelism both are the rank's partials (the shared expert's
        columns, its experts), summed in one all-reduce (the JAX package's
        one psum, chitu_tpu/models/deepseek_v3.py:560-571)."""
        y = self._shared_expert(x, lp, layer)
        weights, sel = route(
            x, lp["moe_gate"][layer], self.moe, gate_bias=lp["gate_bias"][layer]
        )
        gate_w, up_w = (
            (lp["exp_gu"], None) if "exp_gu" in lp
            else (lp["exp_gate"], lp["exp_up"])
        )
        routed = moe_ffn_auto(
            x, gate_w, up_w, lp["exp_down"], weights, sel, self.moe,
            layer=layer, rank=self.rank, tp=self.tp, dp=self.dp_group,
        )
        y = routed if y is None else y + routed
        return y if self.group is None else self.group.all_reduce_f32(y)

    # -- stacks -------------------------------------------------------------

    def _forward(self, cache, h, cos, sin, attend):
        """The stage's layers between the relay's links -> the normed
        hidden state on the last stage, None on the others."""
        st = self.stage
        if st is not None and not st.first:
            h = st.recv_prev(h)
        h = self._local_forward(cache, h, cos, sin, attend)
        if st is not None and not st.last:
            st.send_next(h.to(self.hidden_dtype))
            return None
        return rms_norm(h, self.norm, self.args.norm_eps)

    def _local_forward(self, cache, h, cos, sin, attend):
        """The stage's layers of both stacks over their pools (the dense
        ones on stage 0 only); `attend(pool, q, k, v, layer)` (v None for
        the latent row)."""
        eps = self.args.norm_eps
        mla = self._mla if self.absorb else self._mla_dense
        for stack, ffn in (
            ("dense_layers", self._dense_ffn),
            ("moe_layers", self._moe_ffn),
        ):
            n = self.n_local[stack]
            if not n:
                continue
            lp = getattr(self, stack)
            pool = cache[POOLS[stack]]

            def att(q, k, v, layer, pool=pool):
                return attend(pool, q, k, v, layer)

            for layer in range(n):
                x = rms_norm(h, lp["attn_norm"][layer], eps)
                h = h + mla(x, lp, layer, cos, sin, att)
                x = rms_norm(h, lp["ffn_norm"][layer], eps)
                h = h + ffn(x, lp, layer)
        return h

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_rows(self, tokens)

    @property
    def hidden_dtype(self) -> torch.dtype:
        """The dtype of the hidden state that crosses a stage boundary:
        the weights' (a stack's norms, else the embedding's or the final
        norm's), or the configured dtype on a stage that holds no weight
        (fewer MoE layers than stages)."""
        for t in (self.moe_layers.get("attn_norm"),
                  self.dense_layers.get("attn_norm"),
                  getattr(self, "embed", None), getattr(self, "norm", None)):
            if t is not None:
                return t.dtype
        return getattr(torch, self.cfg.dtype)

    def _head(self, h, idx=None):
        """Logits of the rows `idx` of the normed hidden state, or None on
        a stage before the last."""
        if h is None:
            return None
        return self._logits(h if idx is None else h[idx])

    def final_logits(self, h: torch.Tensor) -> torch.Tensor:
        """The last stage's head on a hidden state [T, D]: norm, logits."""
        return self._logits(rms_norm(h, self.norm, self.args.norm_eps))

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return head_logits(self, h, self.lm_head)

    def _rope_rows(self, pos: torch.Tensor):
        idx = torch.clamp(pos, 0, self.cos.shape[0] - 1).long()
        return self.cos[idx], self.sin[idx]

    # -- public forwards (the contract of the llama module) -----------------

    def prefill(
        self,
        cache: Dict[str, torch.Tensor],  # {"kv_dense", "kv_moe"} pools
        tokens: torch.Tensor,  # [T] int32 (padded)
        block_table: torch.Tensor,  # [mp] int32
        start_pos: int,
        valid_len: int,
        page_size: int,
        return_all_logits: bool = False,
    ):
        """One request's prefill chunk -> (last-token logits [V], cache):
        a plain append of the chunk's latent rows, then B5."""
        T = tokens.shape[0]
        ar = torch.arange(T, dtype=torch.int32, device=tokens.device)
        pos = ar + start_pos
        total_len = start_pos + valid_len
        q_pos = torch.where(ar < valid_len, pos, torch.zeros_like(pos))
        h = self._embed(tokens)
        cos, sin = self._rope_rows(pos)
        kw = self._attn_kw()

        def attend(pool, q, k, v, layer):
            attn_ops.append_prefill(
                pool, layer, k, v, block_table, pos, valid_len, page_size
            )
            return self.attn.attend_prefill(
                q, pool, layer, block_table, q_pos, total_len, page_size, **kw
            )

        def attend_ring_kv(pool, q, k, v, layer):
            group = self.dp_group
            ring_ops.append_prefill_ring(pool, layer, k, v, block_table, pos,
                                         valid_len, page_size, group)
            if start_pos == 0:
                return ring_ops.attend_prefill_fresh(
                    q, k, v, q_pos, valid_len, pool.dtype, kw["scale"],
                    v_dim=kw.get("v_dim"))
            return ring_ops.attend_prefill_ring(
                q, pool, layer, block_table, q_pos, total_len, page_size,
                group=group, **kw)

        h = self._forward(cache, h, cos, sin,
                          attend_ring_kv if self.ring_kv else attend)
        if return_all_logits:
            return self._head(h), cache
        return self._head(h, max(valid_len - 1, 0)), cache

    def prefill_packed(
        self,
        cache: Dict[str, torch.Tensor],
        tokens: torch.Tensor,  # [T] int32 packed (per-segment padded)
        seg_ids: torch.Tensor,  # [T] int32 (-1 = pad)
        pos: torch.Tensor,  # [T] int32 (-1 = pad)
        block_tables: torch.Tensor,  # [R, mp] int32
        total_lens: torch.Tensor,  # [R] int32
        last_idx: torch.Tensor,  # [R] int32
        block_seg: torch.Tensor,  # [NB] int32
        block_qstart: torch.Tensor,  # [NB] int32
        page_size: int,
    ):
        """R ragged prompts in one forward -> (logits [R, V], cache): a
        plain packed append, then B3 over the block geometry."""
        h = self._embed(tokens)
        cos, sin = self._rope_rows(pos)
        kw = self._attn_kw()

        def attend(pool, q, k, v, layer):
            attn_ops.append_prefill_packed(
                pool, layer, k, v, block_tables, seg_ids, pos, page_size
            )
            return self.attn.attend_prefill_packed(
                q, pool, layer, block_tables, block_seg, block_qstart,
                total_lens, page_size, **kw,
            )

        h = self._forward(cache, h, cos, sin, attend)
        return self._head(h, last_idx.long()), cache

    def step_hybrid(
        self,
        cache: Dict[str, torch.Tensor],
        dec_tokens: torch.Tensor,  # [B] int32
        dec_seq_lens: torch.Tensor,  # [B]
        dec_block_tables: torch.Tensor,  # [B, mp_d]
        dec_valid: torch.Tensor,  # [B] bool
        pf_tokens: torch.Tensor,  # [T] packed
        pf_seg_ids: torch.Tensor,  # [T]
        pf_pos: torch.Tensor,  # [T]
        pf_block_tables: torch.Tensor,  # [R, mp_p]
        pf_total_lens: torch.Tensor,  # [R]
        pf_last_idx: torch.Tensor,  # [R]
        pf_block_seg: torch.Tensor,  # [NB]
        pf_block_qstart: torch.Tensor,  # [NB]
        page_size: int,
    ):
        """Fused prefill+decode step -> (dec_logits [B, V], pf_logits
        [R, V], cache): plain appends of both, then B4 for the decode rows
        and B3 for the prefill rows."""
        B = dec_tokens.shape[0]
        h = self._embed(torch.cat([dec_tokens, pf_tokens]))
        cos, sin = self._rope_rows(torch.cat([dec_seq_lens, pf_pos]))
        kw = self._attn_kw()

        def attend(pool, q, k, v, layer):
            attn_ops.append_decode(
                pool, layer, k[:B], None if v is None else v[:B],
                dec_block_tables, dec_seq_lens, dec_valid, page_size,
            )
            attn_ops.append_prefill_packed(
                pool, layer, k[B:], None if v is None else v[B:],
                pf_block_tables, pf_seg_ids, pf_pos, page_size,
            )
            od = self.attn.attend_decode(
                q[:B], pool, layer, dec_block_tables, dec_seq_lens,
                page_size, **kw,
            )
            op = self.attn.attend_prefill_packed(
                q[B:], pool, layer, pf_block_tables, pf_block_seg,
                pf_block_qstart, pf_total_lens, page_size, **kw,
            )
            return torch.cat([od, op], dim=0)

        h = self._forward(cache, h, cos, sin, attend)
        dec_logits = self._head(h, slice(None, B))
        pf_logits = self._head(h, B + pf_last_idx.long())
        return dec_logits, pf_logits, cache

    def decode(
        self,
        cache: Dict[str, torch.Tensor],
        tokens: torch.Tensor,  # [B] int32
        seq_lens: torch.Tensor,  # [B] context length (new token's position)
        block_tables: torch.Tensor,  # [B, mp] int32
        valid: torch.Tensor,  # [B] bool
        page_size: int,
    ):
        """Batched one-token decode -> (logits [B, V], cache) through B1,
        which appends each live row's latent row in the kernel."""
        h = self._embed(tokens)
        cos, sin = self._rope_rows(seq_lens)
        attend = self._decode_attend(block_tables, seq_lens, valid, page_size)
        return self._head(self._forward(cache, h, cos, sin, attend)), cache

    def _decode_attend(self, block_tables, seq_lens, valid, page_size):
        kw = self._attn_kw()

        def attend(pool, q, k, v, layer):
            return self.attn.attend_decode_fused(
                q, pool, layer, k, v, block_tables, seq_lens, valid,
                page_size, **kw,
            )

        def attend_ring_kv(pool, q, k, v, layer):
            return ring_ops.attend_decode_fused_ring(
                self.attn, q, pool, layer, k, v, block_tables, seq_lens,
                valid, page_size, group=self.dp_group, **kw)

        return attend_ring_kv if self.ring_kv else attend

    def decode_local(self, cache, h, seq_lens, block_tables, valid,
                     page_size):
        """The stage's layers of one decode step on a hidden state [B, D]
        (the pipelined decode's: no relay, no final norm), B1 on the
        stage's pools."""
        cos, sin = self._rope_rows(seq_lens)
        attend = self._decode_attend(block_tables, seq_lens, valid, page_size)
        return self._local_forward(cache, h, cos, sin, attend)
