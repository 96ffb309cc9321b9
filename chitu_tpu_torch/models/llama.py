"""Llama-family model (HF Llama-3 / Qwen2 / GLM-4 / R1-Distill / Meta-Llama).

Counterpart of `chitu_tpu/models/llama.py` (reference:
chitu/models/model_hf_llama.py, chitu/models/model_llama.py). The weights
are the JAX package's stacked [L, ...] leaves under the same names
(`wqkv`, `wo`, `w_gate_up`, `w_down`, `attn_norm`, `ffn_norm`, `embed`,
`norm`, `lm_head`, optional `b_qkv`) in the merged layout with
merge_tp == 1, held as frozen parameters of an `nn.Module`. The layer loop
is a Python loop; each layer's projections are `torch.matmul` on views of
the stacked weights, and attention goes through the kernel wrappers of
`ops/attention_kernels.py` (CUDA kernels on the card, their plain
versions on the CPU). The KV pool in `cache["kv"]` is updated IN PLACE
and returned for symmetry with the JAX functions.

Not ported yet: `verify_draft` (speculative decoding), the ring and
tensor-parallel paths, and the unmerged weight layout (an unmerged JAX
tree is merged by `params_from_numpy`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from chitu_tpu_torch.models import register_model
from chitu_tpu_torch.models.common import apply_rope, rms_norm, rope_tables
from chitu_tpu_torch.ops import attention as attn_ops
from chitu_tpu_torch.ops import attention_kernels as kernels
from chitu_tpu_torch.ops.linear import linear, matmul_out_dtype
from chitu_tpu_torch.utils import resolve_device

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
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16)
        ).view(torch.bfloat16)
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's llama parameter tree, as numpy arrays
    ({"embed", "norm", "layers": {...}, "lm_head"}), -> this module's
    tensors by name. An unmerged tree (wq/wk/wv, w_gate/w_up) is merged
    into the wqkv / w_gate_up leaves."""
    layers = tree["layers"]
    out = {k: _to_torch(tree[k]) for k in ("embed", "norm", "lm_head") if k in tree}
    for k in ("attn_norm", "ffn_norm", "wo", "w_down"):
        out[k] = _to_torch(layers[k])
    if "wqkv" in layers:
        out["wqkv"] = _to_torch(layers["wqkv"])
        out["w_gate_up"] = _to_torch(layers["w_gate_up"])
        if "b_qkv" in layers:
            out["b_qkv"] = _to_torch(layers["b_qkv"])
    else:
        cat = lambda *ks: torch.cat([_to_torch(layers[k]) for k in ks], dim=-1)
        out["wqkv"] = cat("wq", "wk", "wv")
        out["w_gate_up"] = cat("w_gate", "w_up")
        if "bq" in layers:
            out["b_qkv"] = cat("bq", "bk", "bv")
    return out


@register_model("hf-llama")
class LlamaForCausalLM(nn.Module):
    """Llama-family module: frozen stacked weights + the four forwards
    (prefill, prefill_packed, step_hybrid, decode)."""

    def __init__(self, args, cfg, device=None):
        super().__init__()
        infer = cfg.infer
        if infer.tp_size > 1 or infer.pp_size > 1:
            raise NotImplementedError(
                "tp_size/pp_size > 1 are not ported yet (ROADMAP queue A, "
                "slice 7: multi-GPU)"
            )
        if infer.merge_qkv_gate_up == "off":
            raise NotImplementedError(
                "the unmerged weight layout is not ported; use "
                "merge_qkv_gate_up=auto"
            )
        self.args = args
        self.cfg = cfg
        self.device = resolve_device(device)
        self.head_dim = args.head_dim_()
        self.inter_dim = _ffn_dim(args)
        self.rot_dim = int(self.head_dim * args.partial_rotary_factor)
        self.attn_scale = 1.0 / math.sqrt(self.head_dim)
        self.rotary_layout = args.rotary_type
        cos, sin = rope_tables(
            self.rot_dim, infer.max_seq_len, args.rope_theta,
            args.rope_scaling, device=self.device,
        )
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    # -- cache geometry -----------------------------------------------------

    def kv_cache_spec(self) -> Dict[str, Any]:
        return dict(
            n_layers=self.args.n_layers,
            kv_heads=self.args.n_kv_heads,
            head_dim=self.head_dim,
            kv_dim=0,
        )

    # -- parameters ---------------------------------------------------------

    def _shapes(self) -> Dict[str, tuple]:
        a = self.args
        L, D, H, KV, Dh, Fd, V = (
            a.n_layers, a.dim, a.n_heads, a.n_kv_heads, self.head_dim,
            self.inter_dim, a.vocab_size,
        )
        shapes = {
            "embed": (V, D),
            "norm": (D,),
            "attn_norm": (L, D),
            "ffn_norm": (L, D),
            "wqkv": (L, D, (H + 2 * KV) * Dh),
            "wo": (L, H * Dh, D),
            "w_gate_up": (L, D, 2 * Fd),
            "w_down": (L, Fd, D),
        }
        if a.attn_bias:
            shapes["b_qkv"] = (L, (H + 2 * KV) * Dh)
        if not a.tie_word_embeddings:
            shapes["lm_head"] = (D, V)
        return shapes

    def init_params(
        self, generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        """Random weights on the module's device (normal * 0.02, norms 1,
        biases 0), drawn from `generator`; the JAX package's
        `init_params` layout and scales."""
        for name, shape in self._shapes().items():
            t = torch.empty(shape, dtype=dtype, device=self.device)
            if name in ("norm", "attn_norm", "ffn_norm"):
                t.fill_(1.0)
            elif name == "b_qkv":
                t.zero_()
            else:
                t.normal_(0.0, 0.02, generator=generator)
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        return self

    def load_params(self, tensors: Dict[str, torch.Tensor]):
        """Install named tensors (e.g. from `params_from_numpy`) as this
        module's weights on its device, checking every shape."""
        shapes = self._shapes()
        missing = set(shapes) - set(tensors)
        if missing:
            raise KeyError(f"missing parameters: {sorted(missing)}")
        for name, shape in shapes.items():
            t = tensors[name]
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
            self.register_parameter(
                name,
                nn.Parameter(t.to(self.device).contiguous(), requires_grad=False),
            )
        return self

    # -- forward ------------------------------------------------------------

    def _layer(self, h: torch.Tensor, layer: int, cos, sin, attend):
        """One decoder layer; `attend(q, k, v, layer)` appends the fresh
        K/V and returns the attention output [T, H, Dh]."""
        a = self.args
        T = h.shape[0]
        H, KV, Dh = a.n_heads, a.n_kv_heads, self.head_dim
        x = rms_norm(h, self.attn_norm[layer], a.norm_eps)
        qkv = linear(
            x, self.wqkv, getattr(self, "b_qkv", None), layer=layer
        )
        q = qkv[:, : H * Dh].reshape(T, H, Dh)
        k = qkv[:, H * Dh : (H + KV) * Dh].reshape(T, KV, Dh)
        v = qkv[:, (H + KV) * Dh :].reshape(T, KV, Dh).contiguous()
        q = apply_rope(q, cos, sin, self.rotary_layout)
        k = apply_rope(k, cos, sin, self.rotary_layout)
        o = attend(q, k, v, layer)
        h = h + linear(o.reshape(T, -1), self.wo, layer=layer)

        x = rms_norm(h, self.ffn_norm[layer], a.norm_eps)
        gu = linear(x, self.w_gate_up, layer=layer)
        Fd = self.inter_dim
        hid = (F.silu(gu[:, :Fd]) * gu[:, Fd:]).to(x.dtype)
        return h + linear(hid, self.w_down, layer=layer)

    def _run_layers(self, h, cos, sin, attend):
        for layer in range(self.args.n_layers):
            h = self._layer(h, layer, cos, sin, attend)
        return rms_norm(h, self.norm, self.args.norm_eps)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.args.tie_word_embeddings else self.lm_head
        return matmul_out_dtype(h, head, torch.float32)

    def _rope_rows(self, pos: torch.Tensor):
        idx = torch.clamp(pos, 0, self.cos.shape[0] - 1).long()
        return self.cos[idx], self.sin[idx]

    def _attn_kw(self):
        a = self.args
        return dict(
            kv_heads=a.n_kv_heads, head_dim=self.head_dim,
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
    ):
        """One request's prefill chunk -> (last-token logits [V], cache):
        a plain indexed append of the chunk's K/V, then the B5 kernel
        (reference: Transformer.prefill_single_device,
        models/model.py:450-465)."""
        T = tokens.shape[0]
        dev = tokens.device
        ar = torch.arange(T, dtype=torch.int32, device=dev)
        pos = ar + start_pos
        total_len = start_pos + valid_len
        q_pos = torch.where(ar < valid_len, pos, torch.zeros_like(pos))
        pool = cache["kv"]
        h = self.embed[tokens.long()]
        cos, sin = self._rope_rows(pos)
        kw = self._attn_kw()

        def attend(q, k, v, layer):
            attn_ops.append_prefill(
                pool, layer, k, v, block_table, pos, valid_len, page_size
            )
            return kernels.attend_prefill(
                q, pool, layer, block_table, q_pos, total_len, page_size, **kw
            )

        h = self._run_layers(h, cos, sin, attend)
        if return_all_logits:
            return self._logits(h), cache
        return self._logits(h[max(valid_len - 1, 0)]), cache

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
        h = self.embed[tokens.long()]
        cos, sin = self._rope_rows(pos)
        kw = self._attn_kw()

        def attend(q, k, v, layer):
            return kernels.attend_prefill_packed_fused(
                q, pool, layer, k, v, block_tables, block_seg, block_qstart,
                total_lens, page_size, **kw,
            )

        h = self._run_layers(h, cos, sin, attend)
        return self._logits(h[last_idx.long()]), cache

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
        h = self.embed[torch.cat([dec_tokens, pf_tokens]).long()]
        cos, sin = self._rope_rows(torch.cat([dec_seq_lens, pf_pos]))
        kw = self._attn_kw()

        def attend(q, k, v, layer):
            od = kernels.attend_decode_fused(
                q[:B], pool, layer, k[:B], v[:B], dec_block_tables,
                dec_seq_lens, dec_valid, page_size, **kw,
            )
            op = kernels.attend_prefill_packed_fused(
                q[B:], pool, layer, k[B:], v[B:], pf_block_tables,
                pf_block_seg, pf_block_qstart, pf_total_lens, page_size, **kw,
            )
            return torch.cat([od, op], dim=0)

        h = self._run_layers(h, cos, sin, attend)
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
        """Batched one-token decode -> (logits [B, V], cache) through the
        B1 kernel (reference: Transformer.decode, models/model.py:537-622)."""
        pool = cache["kv"]
        h = self.embed[tokens.long()]
        cos, sin = self._rope_rows(seq_lens)
        kw = self._attn_kw()

        def attend(q, k, v, layer):
            return kernels.attend_decode_fused(
                q, pool, layer, k, v, block_tables, seq_lens, valid,
                page_size, **kw,
            )

        h = self._run_layers(h, cos, sin, attend)
        return self._logits(h), cache
