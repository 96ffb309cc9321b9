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
`weight_scale_inv`) load through `loaders_moe.load_deepseek_params`. Not
ported yet: the ring and pipeline paths (ROADMAP queue A.6).
"""

from __future__ import annotations

import math
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
from chitu_tpu_torch.models.moe import moe_ffn_auto, route
from chitu_tpu_torch.ops import attention as attn_ops
from chitu_tpu_torch.ops import attention_kernels as kernels
from chitu_tpu_torch.ops.absorb_kernels import (
    MAX_T,
    absorb_kernel_ok,
    absorb_matmul,
)
from chitu_tpu_torch.ops.linear import (
    linear,
    matmul_out_dtype,
    op_kernels,
)
from chitu_tpu_torch.ops.qtensor import QTensor
from chitu_tpu_torch.utils import resolve_device

STACKS = ("dense_layers", "moe_layers")
POOLS = {"dense_layers": "kv_dense", "moe_layers": "kv_moe"}


@register_model("deepseek-v3")
class DeepSeekV3ForCausalLM(nn.Module):
    def __init__(self, args, cfg, device=None):
        super().__init__()
        if args.mla is None or args.moe is None:
            raise ValueError("a deepseek-v3 model card needs mla and moe sections")
        infer = cfg.infer
        if infer.tp_size > 1 or infer.pp_size > 1:
            raise NotImplementedError(
                "tp_size/pp_size > 1 are not ported yet (ROADMAP queue "
                "A.6: multi-GPU)"
            )
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
        groups = {"kv_dense": self.n_dense, "kv_moe": self.n_moe}
        if not self.absorb:
            # dense MLA: per-head K/V rows (V padded to qk_head_dim)
            return dict(
                n_layers=self.args.n_layers,
                kv_heads=self.args.n_heads,
                head_dim=self.qk_head_dim,
                kv_dim=0,
                layer_groups=groups,
            )
        # merged-MLA cache: one latent row a token shared across heads
        # (reference: backend.py:186-197)
        return dict(
            n_layers=self.args.n_layers,
            kv_heads=0,
            head_dim=0,
            kv_dim=self.kv_dim,
            layer_groups={"kv_dense": self.n_dense, "kv_moe": self.n_moe},
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

    def _attn_shapes(self, L: int) -> Dict[str, tuple]:
        a, m = self.args, self.mla
        D, H = a.dim, a.n_heads
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

    def _shapes(self, merged=frozenset()) -> Dict[str, Dict[str, tuple]]:
        """Logical shapes by stack ("" = top level); `merged` names the
        merged leaves present (`wq_kv_a`, `shared_gu`, `exp_gu`)."""
        a, mo = self.args, self.moe
        D, V = a.dim, a.vocab_size
        dense = self._attn_shapes(self.n_dense)
        dense["w_gate"] = (self.n_dense, D, a.inter_dim)
        dense["w_up"] = (self.n_dense, D, a.inter_dim)
        dense["w_down"] = (self.n_dense, a.inter_dim, D)
        Lm, E, Fm = self.n_moe, mo.n_routed_experts, mo.moe_inter_dim
        Fs = Fm * max(mo.n_shared_experts, 1)
        moe_l = self._attn_shapes(Lm)
        moe_l["moe_gate"] = (Lm, D, E)
        moe_l["gate_bias"] = (Lm, E)
        if mo.n_shared_experts > 0:
            moe_l["shared_gate"] = (Lm, D, Fs)
            moe_l["shared_up"] = (Lm, D, Fs)
            moe_l["shared_down"] = (Lm, Fs, D)
        moe_l["exp_gate"] = (Lm, E, D, Fm)
        moe_l["exp_up"] = (Lm, E, D, Fm)
        moe_l["exp_down"] = (Lm, E, Fm, D)
        for stack in (dense, moe_l):
            for a_, b_, name in (("wq_a", "wkv_a", "wq_kv_a"),
                                 ("shared_gate", "shared_up", "shared_gu"),
                                 ("exp_gate", "exp_up", "exp_gu")):
                if name in merged and a_ in stack:
                    sa, sb = stack.pop(a_), stack.pop(b_)
                    stack[name] = (*sa[:-1], sa[-1] + sb[-1])
        return {
            "": {"embed": (V, D), "norm": (D,), "lm_head": (D, V)},
            "dense_layers": dense,
            "moe_layers": moe_l,
        }

    def init_params(
        self, generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        """Random weights on the module's device (normal * 0.02, norms 1,
        `gate_bias` 0 in f32), drawn from `generator`; the JAX package's
        `init_params` layout and scales."""
        tree: Dict[str, Any] = {}
        for stack, shapes in self._shapes().items():
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
                leaves[name] = t
            if stack:
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
            if n in ("wq_kv_a", "shared_gu", "exp_gu")
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
        tree = {k: tensors[k] for k in ("embed", "norm", "lm_head")}
        for stack in STACKS:
            tree[stack] = dict(tensors[stack])
        return self._install(tree)

    def _install(self, tree):
        def dev(t):
            if isinstance(t, QTensor):
                return t.to(self.device).contiguous()
            return t.detach().to(self.device).contiguous()

        for name in ("embed", "norm", "lm_head"):
            setattr(self, name, dev(tree[name]))
        self.dense_layers = {k: dev(v) for k, v in tree["dense_layers"].items()}
        self.moe_layers = {k: dev(v) for k, v in tree["moe_layers"].items()}
        return self

    def params_tree(self, pop: bool = False) -> Dict[str, Any]:
        """The weights as the nested tree the quantization transforms walk.
        With `pop` the module gives them up, so a transform can free each
        dense leaf as it replaces it; `load_params` installs the result."""
        tree = {name: getattr(self, name) for name in ("embed", "norm", "lm_head")}
        tree["dense_layers"] = dict(self.dense_layers)
        tree["moe_layers"] = dict(self.moe_layers)
        if pop:
            for name in ("embed", "norm", "lm_head"):
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
        q = q.reshape(T, a.n_heads, self.qk_head_dim)
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
        H = self.args.n_heads
        dn, dv, dc = m.qk_nope_head_dim, m.v_head_dim, m.kv_lora_rank
        q_nope, q_pe, c_kv, k_pe = self._mla_qkv(x, lp, layer, cos, sin)

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
        return linear(v_out.reshape(T, H * dv), lp["wo"], layer=layer)

    def _mla_dense(self, x, lp, layer: int, cos, sin, attend):
        """mla_absorb=none: per-head K/V through the whole `wkv_b`, then
        multi-head attention at qk_head_dim (reference dense paths:
        model_deepseek_v3.py:612-670). `attend(q, k, v, layer)` gets
        q, k [T, H, dn + dr] and V padded to [T, H, dn + dr], and returns
        [T, H, dn + dr], of which the first v_head_dim lanes are live."""
        m = self.mla
        T = x.shape[0]
        H = self.args.n_heads
        dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
        q_nope, q_pe, c_kv, k_pe = self._mla_qkv(x, lp, layer, cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        kv = linear(c_kv, lp["wkv_b"], layer=layer).reshape(T, H, dn + dv)
        k = torch.cat([kv[..., :dn], k_pe[:, None, :].expand(T, H, dr)], dim=-1)
        v_pad = F.pad(kv[..., dn:], (0, self.qk_head_dim - dv))
        o = attend(q, k, v_pad, layer)[..., :dv]
        return linear(o.reshape(T, H * dv), lp["wo"], layer=layer)

    def _attn_kw(self):
        if not self.absorb:
            return dict(
                kv_heads=self.args.n_heads, head_dim=self.qk_head_dim,
                scale=self.attn_scale,
            )
        return dict(
            kv_heads=1, head_dim=self.kv_dim, scale=self.attn_scale,
            split_kv=False, v_dim=self.mla.kv_lora_rank,
        )

    # -- FFNs ---------------------------------------------------------------

    def _dense_ffn(self, x, lp, layer: int):
        gate = linear(x, lp["w_gate"], layer=layer)
        up = linear(x, lp["w_up"], layer=layer)
        return linear((F.silu(gate) * up).to(x.dtype), lp["w_down"], layer=layer)

    def _moe_ffn(self, x, lp, layer: int):
        y = None
        if "shared_gu" in lp:
            gu = linear(x, lp["shared_gu"], layer=layer)
            Fs = gu.shape[-1] // 2
            y = linear((F.silu(gu[:, :Fs]) * gu[:, Fs:]).to(x.dtype),
                       lp["shared_down"], layer=layer)
        elif "shared_gate" in lp:
            gg = linear(x, lp["shared_gate"], layer=layer)
            u = linear(x, lp["shared_up"], layer=layer)
            y = linear((F.silu(gg) * u).to(x.dtype), lp["shared_down"],
                       layer=layer)
        weights, sel = route(
            x, lp["moe_gate"][layer], self.moe, gate_bias=lp["gate_bias"][layer]
        )
        gate_w, up_w = (
            (lp["exp_gu"], None) if "exp_gu" in lp
            else (lp["exp_gate"], lp["exp_up"])
        )
        routed = moe_ffn_auto(
            x, gate_w, up_w, lp["exp_down"], weights, sel, self.moe, layer=layer
        )
        return routed if y is None else y + routed

    # -- stacks -------------------------------------------------------------

    def _forward(self, cache, h, cos, sin, attend):
        """Both stacks over their pools; `attend(pool, q, k, v, layer)`
        (v None for the latent row)."""
        eps = self.args.norm_eps
        mla = self._mla if self.absorb else self._mla_dense
        for stack, n, ffn in (
            ("dense_layers", self.n_dense, self._dense_ffn),
            ("moe_layers", self.n_moe, self._moe_ffn),
        ):
            lp = getattr(self, stack)
            pool = cache[POOLS[stack]]

            def att(q, k, v, layer, pool=pool):
                return attend(pool, q, k, v, layer)

            for layer in range(n):
                x = rms_norm(h, lp["attn_norm"][layer], eps)
                h = h + mla(x, lp, layer, cos, sin, att)
                x = rms_norm(h, lp["ffn_norm"][layer], eps)
                h = h + ffn(x, lp, layer)
        return rms_norm(h, self.norm, eps)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        if isinstance(self.lm_head, QTensor):  # quant.quantize_head
            return linear(h, self.lm_head, out_dtype=torch.float32)
        return matmul_out_dtype(h, self.lm_head, torch.float32)

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
        h = self.embed[tokens.long()]
        cos, sin = self._rope_rows(pos)
        kw = self._attn_kw()

        def attend(pool, q, k, v, layer):
            attn_ops.append_prefill(
                pool, layer, k, v, block_table, pos, valid_len, page_size
            )
            return self.attn.attend_prefill(
                q, pool, layer, block_table, q_pos, total_len, page_size, **kw
            )

        h = self._forward(cache, h, cos, sin, attend)
        if return_all_logits:
            return self._logits(h), cache
        return self._logits(h[max(valid_len - 1, 0)]), cache

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
        h = self.embed[tokens.long()]
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
        return self._logits(h[last_idx.long()]), cache

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
        h = self.embed[torch.cat([dec_tokens, pf_tokens]).long()]
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
        dec_logits = self._logits(h[:B])
        pf_logits = self._logits(h[B + pf_last_idx.long()])
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
        h = self.embed[tokens.long()]
        cos, sin = self._rope_rows(seq_lens)
        kw = self._attn_kw()

        def attend(pool, q, k, v, layer):
            return self.attn.attend_decode_fused(
                q, pool, layer, k, v, block_tables, seq_lens, valid,
                page_size, **kw,
            )

        h = self._forward(cache, h, cos, sin, attend)
        return self._logits(h), cache
