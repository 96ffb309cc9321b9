"""Checkpoint adapters for the MoE families (Mixtral, DeepSeek-V3) and the
GLM-4 fused layout.

Counterpart of `chitu_tpu/loaders_moe.py`, the eager paths (reference:
chitu/models/model_hf_mixtral.py:171-178, chitu/backend.py:449-477,
model_deepseek_v3.py:1167-1288, model_hf_llama.py:577-596):
- Mixtral w1/w3/w2 -> gate/up/down and the expert stacks [L, E, in, out];
- GLM-4 fused query_key_value / dense_h_to_4h, which in the port's merged
  layout are `wqkv` / `w_gate_up` already (merge_tp 1);
- DeepSeek-V3 / R1, bf16 or native fp8: e4m3 weights with their
  `weight_scale_inv` blockwise scales load as SOFT_FP8 QTensors
  (`_maybe_fp8`), stored fp8 and computed in bf16.

As in `loader.py`, every leaf is allocated on the device once and filled
there one layer or one expert at a time from views of the mapped files,
so the host never holds the weights. The engine then merges the MoE
gate/up pairs (`quantize.merge_moe_gate_up`).
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, List, Optional

import torch

from chitu_tpu_torch.loader import (
    Checkpoint,
    fill_stacked,
    fp8_qtensor,
    merge_llama_leaves,
    to_device,
)
from chitu_tpu_torch.utils import get_logger

logger = get_logger()


class _Staging:
    """Checkpoint keys by leaf name, flat or per layer, then stacked on
    the device."""

    def __init__(self, ck: Checkpoint, device):
        self.ck, self.device = ck, device
        self.flat: Dict[str, str] = {}
        self.per_layer: Dict[str, Dict[int, Any]] = {}

    def put(self, name: str, layer: Optional[int], value):
        if layer is None:
            self.flat[name] = value
        else:
            self.per_layer.setdefault(name, {})[layer] = value

    def take(self, key: str, transpose: bool = False, dtype=torch.bfloat16):
        return to_device(self.ck.get(key), self.device, dtype, transpose)

    def slot(self, name: str, layers: List[int]) -> Dict[int, Any]:
        slot = self.per_layer.get(name)
        if slot is None:
            # a missing leaf would fail far from the cause: name it here
            raise ValueError(f"checkpoint missing {name} for every layer")
        missing = [i for i in layers if i not in slot]
        if missing:
            raise ValueError(f"checkpoint missing {name} for layers {missing}")
        return slot

    def stack(self, name: str, layers: List[int], make):
        """[len(layers), ...]: make(value) turns a layer's staged value into
        its piece on the device."""
        slot = self.slot(name, layers)
        return fill_stacked((len(layers),), lambda idx: make(slot[layers[idx[0]]]))


# ---------------------------------------------------------------------------
# Mixtral
# ---------------------------------------------------------------------------


def load_mixtral_params(model, cfg, device=None) -> Dict[str, Any]:
    a = model.args
    dev = torch.device(device) if device is not None else model.device
    E = a.moe.n_routed_experts
    ck = Checkpoint(a.ckpt_dir)
    st = _Staging(ck, dev)
    experts: Dict[tuple, str] = {}  # (layer, e, kind) -> key

    for key in ck.keys():
        if key == "model.embed_tokens.weight":
            st.put("embed", None, (key, False))
            continue
        if key == "model.norm.weight":
            st.put("norm", None, (key, False))
            continue
        if key == "lm_head.weight":
            st.put("lm_head", None, (key, True))
            continue
        m = re.fullmatch(r"model\.layers\.(\d+)\.(.+)", key)
        if not m:
            continue
        i, rest = int(m.group(1)), m.group(2)
        if rest == "input_layernorm.weight":
            st.put("attn_norm", i, (key, False))
        elif rest == "post_attention_layernorm.weight":
            st.put("ffn_norm", i, (key, False))
        elif rest.startswith("self_attn.") and rest.endswith(".weight"):
            name = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv",
                    "o_proj": "wo"}.get(rest.split(".")[1])
            if name is not None:
                st.put(name, i, (key, True))
        elif rest == "block_sparse_moe.gate.weight":
            st.put("moe_gate", i, (key, True))  # [D, E]
        else:
            me = re.fullmatch(
                r"block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight", rest
            )
            if me:
                # w1 -> gate, w3 -> up ([F, D] -> [D, F]); w2 -> down
                kind = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}[me.group(2)]
                experts[(i, int(me.group(1)), kind)] = key

    t0 = time.time()
    layers = list(range(a.n_layers))
    take = lambda v: st.take(*v)
    params: Dict[str, Any] = {k: take(v) for k, v in st.flat.items()}
    ly: Dict[str, Any] = {}
    for name in ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "moe_gate"):
        ly[name] = st.stack(name, layers, take)
    for kind in ("w_gate", "w_up", "w_down"):
        missing = [(i, e) for i in layers for e in range(E)
                   if (i, e, kind) not in experts]
        if missing:
            raise ValueError(f"checkpoint missing {kind} experts {missing[:8]}")
        ly[kind] = fill_stacked(  # [L, E, ., .]
            (len(layers), E),
            lambda idx, k=kind: st.take(experts[(idx[0], idx[1], k)], True),
        )
    params["layers"] = merge_llama_leaves(ly)
    if "lm_head" not in params and not a.tie_word_embeddings:
        params["lm_head"] = params["embed"].T.contiguous()
    logger.info("mixtral checkpoint: %.2f GB in %.1fs", ck.nbytes / 1e9,
                time.time() - t0)
    return params


# ---------------------------------------------------------------------------
# GLM-4 (fused checkpoint layout)
# ---------------------------------------------------------------------------


def load_glm4_params(model, cfg, device=None) -> Dict[str, Any]:
    """The fused [(H + 2KV) * Dh, D] query_key_value and [2F, D]
    dense_h_to_4h tensors, transposed, are the merged `wqkv` and
    `w_gate_up` columns [q | k | v] and [gate | up] as they stand."""
    a = model.args
    dev = torch.device(device) if device is not None else model.device
    ck = Checkpoint(a.ckpt_dir)
    st = _Staging(ck, dev)
    top = {
        "transformer.embedding.word_embeddings.weight": ("embed", False),
        "transformer.encoder.final_layernorm.weight": ("norm", False),
        "transformer.output_layer.weight": ("lm_head", True),
    }
    per_layer = {
        "input_layernorm.weight": ("attn_norm", False),
        "post_attention_layernorm.weight": ("ffn_norm", False),
        "self_attention.query_key_value.weight": ("wqkv", True),
        "self_attention.query_key_value.bias": ("b_qkv", False),
        "self_attention.dense.weight": ("wo", True),
        "mlp.dense_h_to_4h.weight": ("w_gate_up", True),
        "mlp.dense_4h_to_h.weight": ("w_down", True),
    }
    for key in ck.keys():
        if key in top:
            name, tr = top[key]
            st.put(name, None, (key, tr))
            continue
        m = re.fullmatch(r"transformer\.encoder\.layers\.(\d+)\.(.+)", key)
        if m and m.group(2) in per_layer:
            name, tr = per_layer[m.group(2)]
            st.put(name, int(m.group(1)), (key, tr))

    layers = list(range(a.n_layers))
    take = lambda v: st.take(*v)
    params: Dict[str, Any] = {k: take(v) for k, v in st.flat.items()}
    names = ["attn_norm", "ffn_norm", "wqkv", "wo", "w_gate_up", "w_down"]
    if a.attn_bias:
        names.append("b_qkv")
    params["layers"] = {n: st.stack(n, layers, take) for n in names}
    return params


# ---------------------------------------------------------------------------
# DeepSeek-V3 / R1
# ---------------------------------------------------------------------------


def load_deepseek_params(model, cfg, device=None) -> Dict[str, Any]:
    a = model.args
    dev = torch.device(device) if device is not None else model.device
    mo, ml = a.moe, a.mla
    E = mo.n_routed_experts
    ck = Checkpoint(a.ckpt_dir)
    scales = {
        k[: -len(".weight_scale_inv")]: k
        for k in ck.keys() if k.endswith(".weight_scale_inv")
    }
    t0 = time.time()

    def take(key, transpose=False, dtype=torch.bfloat16):
        return to_device(ck.get(key), dev, dtype, transpose)

    def get(name, transpose=True):
        """A bf16 leaf (1-D leaves are never transposed)."""
        return take(name + ".weight", transpose)

    def _maybe_fp8(name):
        """fp8 weight + blockwise scale_inv -> a SOFT_FP8 QTensor ([in, out]);
        bf16 [in, out] otherwise."""
        if name not in scales:
            return get(name)
        return fp8_qtensor(take(name + ".weight", dtype=None),
                           take(scales[name], dtype=None))

    def attn_tree(layers: List[int]) -> Dict[str, Any]:
        n = len(layers)

        def stack(make):
            return fill_stacked((n,), lambda idx: make(f"model.layers.{layers[idx[0]]}"))

        out = {
            "attn_norm": stack(lambda p: get(f"{p}.input_layernorm", False)),
            "ffn_norm": stack(lambda p: get(f"{p}.post_attention_layernorm", False)),
        }
        if ml.q_lora_rank > 0:
            out["wq_a"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.q_a_proj"))
            out["q_norm"] = stack(lambda p: get(f"{p}.self_attn.q_a_layernorm", False))
            out["wq_b"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.q_b_proj"))
        else:
            out["wq"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.q_proj"))
        out["wkv_a"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.kv_a_proj_with_mqa"))
        out["kv_norm"] = stack(lambda p: get(f"{p}.self_attn.kv_a_layernorm", False))
        out["wkv_b"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.kv_b_proj"))
        out["wo"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.o_proj"))
        return out

    dense_layers = list(range(mo.n_dense_layers))
    moe_layers = list(range(mo.n_dense_layers, a.n_layers))
    missing = [i for i in range(a.n_layers)
               if f"model.layers.{i}.input_layernorm.weight" not in ck]
    if missing:
        raise ValueError(f"checkpoint missing layers {missing}")

    dense = attn_tree(dense_layers)
    for hf, ours in (("gate_proj", "w_gate"), ("up_proj", "w_up"),
                     ("down_proj", "w_down")):
        dense[ours] = fill_stacked(
            (len(dense_layers),),
            lambda idx, h=hf: _maybe_fp8(f"model.layers.{dense_layers[idx[0]]}.mlp.{h}"),
        )

    moe_p = attn_tree(moe_layers)
    moe_p["moe_gate"] = fill_stacked(
        (len(moe_layers),),
        lambda idx: get(f"model.layers.{moe_layers[idx[0]]}.mlp.gate"),
    )
    bias_key = "model.layers.{}.mlp.gate.e_score_correction_bias"
    if moe_layers and bias_key.format(moe_layers[0]) in ck:
        moe_p["gate_bias"] = fill_stacked(
            (len(moe_layers),),
            lambda idx: take(bias_key.format(moe_layers[idx[0]]), dtype=torch.float32),
        )
    else:
        moe_p["gate_bias"] = torch.zeros((len(moe_layers), E), dtype=torch.float32,
                                         device=dev)
    if mo.n_shared_experts > 0:
        for hf, ours in (("gate_proj", "shared_gate"), ("up_proj", "shared_up"),
                         ("down_proj", "shared_down")):
            moe_p[ours] = fill_stacked(
                (len(moe_layers),),
                lambda idx, h=hf: _maybe_fp8(
                    f"model.layers.{moe_layers[idx[0]]}.mlp.shared_experts.{h}"),
            )
    # routed experts: [L, E, in, out], filled one expert at a time (the
    # merge transform of reference: model_deepseek_v3.py:1167-1288)
    for hf, ours in (("gate_proj", "exp_gate"), ("up_proj", "exp_up"),
                     ("down_proj", "exp_down")):
        moe_p[ours] = fill_stacked(
            (len(moe_layers), E),
            lambda idx, h=hf: _maybe_fp8(
                f"model.layers.{moe_layers[idx[0]]}.mlp.experts.{idx[1]}.{h}"),
        )
    logger.info("deepseek checkpoint: %.2f GB in %.1fs", ck.nbytes / 1e9,
                time.time() - t0)
    return {
        "embed": get("model.embed_tokens", transpose=False),
        "norm": get("model.norm", transpose=False),
        "lm_head": get("lm_head"),
        "dense_layers": dense,
        "moe_layers": moe_p,
    }
