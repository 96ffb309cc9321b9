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
versions on the CPU). A projection weight may be a `QTensor` (on-load
quantization, or a quantized JAX tree carried across): `ops.linear`
sends it to the dequant GEMM, and W8A8 projections take per-token int8
activations from the fused norm+quant kernel. The KV pool in
`cache["kv"]` is updated IN PLACE and returned for symmetry with the JAX
functions.

Checkpoints load through `loader.load_checkpoint`, which merges what it
reads. Not ported yet: `verify_draft` (speculative decoding), the ring
and tensor-parallel paths, and the unmerged weight layout (an unmerged
JAX tree is merged by `params_from_numpy`).
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
from chitu_tpu_torch.ops.linear import (
    linear,
    matmul_out_dtype,
    op_kernels,
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
    if not all(
        isinstance(p, QTensor) and p.kind == q0.kind and p.block == q0.block
        and p.oc_idx is None for p in parts
    ):
        raise NotImplementedError(
            "an unmerged quantized tree with mixed kinds or outlier rows "
            "cannot be merged into wqkv / w_gate_up; quantize the merged "
            "layout instead"
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
                "be merged into wqkv / w_gate_up; the unmerged weight "
                "layout is not ported (ROADMAP queue A.6, with multi-GPU)"
            )
    repack = all(p.packed for p in parts)
    parts = [unpack_int4(p) if p.packed else p for p in parts]
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
    )
    if repack:
        from chitu_tpu_torch.quantize.transforms import pack_int4_storage

        q = pack_int4_storage({"w": q})["w"]
    return q


def params_from_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's llama, Mixtral or DeepSeek parameter tree, as
    numpy arrays ({"embed", "norm", "layers": {...}, "lm_head"}, or
    DeepSeek's "dense_layers" and "moe_layers" stacks), -> the tensors of
    this package's module by name. A quantized leaf (the JAX `QTensor`
    with numpy fields, or a mapping of its fields; e4m3 data as
    `ml_dtypes` arrays or a uint8 view) becomes a `QTensor`, byte for
    byte: blockwise or rowwise scales, packed or unpacked int4. Unmerged
    attention and dense-FFN leaves (wq/wk/wv, w_gate/w_up) are merged into
    the wqkv / w_gate_up leaves. The family shows in the tree: a Mixtral
    tree has a router (`moe_gate`), and its expert stacks `[L, E, in, out]`
    cross as they are, dense or quantized, split (`w_gate`, `w_up`) or
    merged (`w_gu`). A DeepSeek tree crosses leaf for leaf into the same
    nested form, `gate_bias` in f32, split or merged leaves (`wq_kv_a`,
    `shared_gu`, `exp_gu`) as they are."""
    if "dense_layers" in tree:
        out = {k: _leaf(tree[k]) for k in ("embed", "norm", "lm_head")}
        for stack in ("dense_layers", "moe_layers"):
            out[stack] = {k: _leaf(v) for k, v in tree[stack].items()}
        return out
    layers = tree["layers"]
    moe = "moe_gate" in layers
    out = {k: _leaf(tree[k]) for k in ("embed", "norm", "lm_head") if k in tree}
    for k in ("attn_norm", "ffn_norm", "wo", "w_down"):
        out[k] = _leaf(layers[k])
    cat = lambda *ks: _cat_out([_leaf(layers[k]) for k in ks])
    if "wqkv" in layers:
        out["wqkv"] = _leaf(layers["wqkv"])
        if "b_qkv" in layers:
            out["b_qkv"] = _leaf(layers["b_qkv"])
    else:
        out["wqkv"] = cat("wq", "wk", "wv")
        if "bq" in layers:
            out["b_qkv"] = cat("bq", "bk", "bv")
    if moe:
        for k in ("moe_gate", "w_gate", "w_up", "w_gu"):
            if k in layers:
                out[k] = _leaf(layers[k])
    elif "w_gate_up" in layers:
        out["w_gate_up"] = _leaf(layers["w_gate_up"])
    else:
        out["w_gate_up"] = cat("w_gate", "w_up")
    return out


_LAYER_LEAVES = (
    "attn_norm", "ffn_norm", "wqkv", "wo", "w_gate_up", "w_down", "b_qkv",
)  # the leaves that live under "layers" in the nested tree


@register_model("hf-llama")
class LlamaForCausalLM(nn.Module):
    """Llama-family module: frozen stacked weights + the four forwards
    (prefill, prefill_packed, step_hybrid, decode). A family with another
    FFN (MoE) subclasses it: it extends `_shapes` and `LAYER_LEAVES` and
    overrides `_ffn`."""

    LAYER_LEAVES = _LAYER_LEAVES

    def __init__(self, args, cfg, device=None):
        super().__init__()
        infer = cfg.infer
        if infer.tp_size > 1 or infer.pp_size > 1:
            raise NotImplementedError(
                "tp_size/pp_size > 1 are not ported yet (ROADMAP queue "
                "A.6: multi-GPU)"
            )
        if infer.merge_qkv_gate_up == "off":
            raise NotImplementedError(
                "the unmerged weight layout is not ported; use "
                "merge_qkv_gate_up=auto"
            )
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
        shapes = self._shapes()
        missing = set(shapes) - set(tensors)
        if missing:
            raise KeyError(f"missing parameters: {sorted(missing)}")
        for name, shape in shapes.items():
            t = tensors[name]
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
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

    def _layer(self, h: torch.Tensor, layer: int, cos, sin, attend):
        """One decoder layer; `attend(q, k, v, layer)` appends the fresh
        K/V and returns the attention output [T, H, Dh]."""
        a = self.args
        T = h.shape[0]
        H, KV, Dh = a.n_heads, a.n_kv_heads, self.head_dim
        x = self._norm_acts(h, self.attn_norm[layer], self.wqkv)
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
        return self._ffn(h, layer)

    def _ffn(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        """The FFN half of a layer, norm and residual included: SwiGLU
        here; the MoE families override it."""
        x = self._norm_acts(h, self.ffn_norm[layer], self.w_gate_up)
        gu = linear(x, self.w_gate_up, layer=layer)
        Fd = self.inter_dim
        hid = (F.silu(gu[:, :Fd]) * gu[:, Fd:]).to(h.dtype)
        hid = self._maybe_quant_acts(hid, self.w_down)
        return h + linear(hid, self.w_down, layer=layer)

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

    def _maybe_quant_acts(self, x, proj_w):
        """Mid-FFN activation quantization feeding a W8A8 down-projection."""
        if not self._w8a8(proj_w):
            return x
        return (quant_acts if op_kernels() else quant_acts_plain)(x.contiguous())

    def _run_layers(self, h, cos, sin, attend):
        for layer in range(self.args.n_layers):
            h = self._layer(h, layer, cos, sin, attend)
        return rms_norm(h, self.norm, self.args.norm_eps)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.args.tie_word_embeddings else self.lm_head
        if isinstance(head, QTensor):  # quant.quantize_head
            return linear(h, head, out_dtype=torch.float32)
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
            return self.attn.attend_prefill(
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
            return self.attn.attend_prefill_packed_fused(
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
            return self.attn.attend_decode_fused(
                q, pool, layer, k, v, block_tables, seq_lens, valid,
                page_size, **kw,
            )

        h = self._run_layers(h, cos, sin, attend)
        return self._logits(h), cache
