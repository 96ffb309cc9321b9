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
so the host never holds the weights, and a rank reads only its pipeline
stage's layers (DeepSeek: the dense-first layers on stage 0, each stage
its chunk of the MoE stack), the embedding on stage 0 and the norm and
head on the last. Under tensor parallelism a Mixtral or DeepSeek rank
reads only its experts (expert parallelism), and its slice of every
other cut leaf: a bf16 view is cut before it is copied (`rank_view`), a
native fp8 projection is assembled on the device, then cut (its scales
with it). The engine then merges the MoE gate/up pairs
(`quantize.merge_moe_gate_up`).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Dict, List, Optional

import torch

from chitu_tpu_torch.loader import (
    Checkpoint,
    fill_stacked,
    fp8_qtensor,
    holds,
    layers_to_read,
    merge_llama_leaves,
    no_layers,
    rank_experts,
    rank_view,
    stage_layers,
    to_device,
)
from chitu_tpu_torch.parallel.sharding import StageSlice
from chitu_tpu_torch.utils import get_logger

logger = get_logger()


class _Staging:
    """Checkpoint keys by leaf name, flat or per layer, then stacked on
    the device."""

    def __init__(self, ck: Checkpoint, device, layout=None):
        self.ck, self.device, self.layout = ck, device, layout
        self.flat: Dict[str, str] = {}
        self.per_layer: Dict[str, Dict[int, Any]] = {}

    def put(self, name: str, layer: Optional[int], value):
        if layer is None:
            self.flat[name] = value
        else:
            self.per_layer.setdefault(name, {})[layer] = value

    def take(self, key: str, transpose: bool = False, dtype=torch.bfloat16,
             name: Optional[str] = None):
        """One stored tensor on the device; with the leaf's `name`, the
        rank's tensor-parallel slice of it (cut before the copy)."""
        view = rank_view(self.layout, name, self.ck.get(key), transpose)
        return to_device(view, self.device, dtype, transpose)

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
    st = _Staging(ck, dev, model.layout)
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
    layers, held = layers_to_read(model)
    # the rank's experts; its slice of each other leaf the layout cuts
    mine = rank_experts(model.layout, E)
    take = lambda v, name=None: st.take(*v, name=name)  # noqa: E731
    params: Dict[str, Any] = {k: take(v, k) for k, v in st.flat.items()
                              if holds(model, k)}
    ly: Dict[str, Any] = {}
    for name in ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "moe_gate"):
        ly[name] = st.stack(name, layers, lambda v, n=name: take(v, n))
    for kind in ("w_gate", "w_up", "w_down"):
        missing = [(i, e) for i in layers for e in range(E)
                   if (i, e, kind) not in experts]
        if missing:
            raise ValueError(f"checkpoint missing {kind} experts {missing[:8]}")
        ly[kind] = fill_stacked(  # [L, E_r, ., .]: the rank's experts
            (len(layers), len(mine)),
            lambda idx, k=kind: st.take(
                experts[(layers[idx[0]], mine[idx[1]], k)], True),
        )
    params["layers"] = merge_llama_leaves(ly, model)
    if not held:
        params["layers"] = no_layers(params["layers"])
    if ("lm_head" not in st.flat and not a.tie_word_embeddings
            and holds(model, "lm_head")):
        params["lm_head"] = take(st.flat["embed"], "embed").T.contiguous()
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

    layers, held = layers_to_read(model)
    take = lambda v: st.take(*v)
    lay = model.layout
    names = ["attn_norm", "ffn_norm", "wqkv", "wo", "w_gate_up", "w_down"]
    if a.attn_bias:
        names.append("b_qkv")
    params: Dict[str, Any] = {k: take(v) for k, v in st.flat.items()
                              if holds(model, k)}
    if lay.tp <= 1 and lay.merged:
        params["layers"] = {n: st.stack(n, layers, take) for n in names}
        if not held:
            params["layers"] = no_layers(params["layers"])
        return params
    # another layout: each fused layer is split into its parts and cut to
    # the rank's slice on the device (one layer: no stage cut), then the
    # layers are stacked
    one = dataclasses.replace(lay, stage=StageSlice())
    params = {n: v for k, t in params.items() for n, v in one.place(k, t).items()}
    ly: Dict[str, Any] = {}
    for n in names:
        slot = st.slot(n, layers)
        pieces = [one.place(n, take(slot[i])) for i in layers]
        for k in pieces[0]:
            ly[k] = torch.stack([p[k] for p in pieces])
    params["layers"] = lay.assemble(ly)
    if not held:
        params["layers"] = no_layers(params["layers"])
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
    lay = model.layout
    scales = {
        k[: -len(".weight_scale_inv")]: k
        for k in ck.keys() if k.endswith(".weight_scale_inv")
    }
    t0 = time.time()

    def take(key, transpose=False, dtype=torch.bfloat16, leaf=None):
        view = rank_view(lay, leaf, ck.get(key), transpose)
        return to_device(view, dev, dtype, transpose)

    def get(name, transpose=True, leaf=None):
        """A bf16 leaf (1-D leaves are never transposed); the rank's slice
        of the layout's leaf `leaf`, cut before the copy."""
        return take(name + ".weight", transpose, leaf=leaf)

    def _maybe_fp8(name, leaf=None):
        """fp8 weight + blockwise scale_inv -> a SOFT_FP8 QTensor ([in, out]),
        assembled on the device, then cut to the rank's slice of `leaf`;
        bf16 [in, out] otherwise."""
        if name not in scales:
            return get(name, leaf=leaf)
        q = fp8_qtensor(take(name + ".weight", dtype=None),
                        take(scales[name], dtype=None))
        return lay.local(leaf, q).contiguous() if leaf and lay.tp > 1 else q

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
            out["wq_b"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.q_b_proj", "wq_b"))
        else:
            out["wq"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.q_proj", "wq"))
        out["wkv_a"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.kv_a_proj_with_mqa"))
        out["kv_norm"] = stack(lambda p: get(f"{p}.self_attn.kv_a_layernorm", False))
        out["wkv_b"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.kv_b_proj", "wkv_b"))
        out["wo"] = stack(lambda p: _maybe_fp8(f"{p}.self_attn.o_proj", "wo"))
        return out

    # the stage's layers: the dense-first ones on stage 0 only
    dense_layers = stage_layers(model, "dense_layers")
    moe_layers = stage_layers(model, "moe_layers")
    missing = [i for i in dense_layers + moe_layers
               if f"model.layers.{i}.input_layernorm.weight" not in ck]
    if missing:
        raise ValueError(f"checkpoint missing layers {missing}")

    dense = attn_tree(dense_layers)
    for hf, ours in (("gate_proj", "w_gate"), ("up_proj", "w_up"),
                     ("down_proj", "w_down")):
        dense[ours] = fill_stacked(
            (len(dense_layers),),
            lambda idx, h=hf, o=ours: _maybe_fp8(
                f"model.layers.{dense_layers[idx[0]]}.mlp.{h}", o),
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
                lambda idx, h=hf, o=ours: _maybe_fp8(
                    f"model.layers.{moe_layers[idx[0]]}.mlp.shared_experts.{h}",
                    o),
            )
    # routed experts: [L, E_r, in, out], the rank's experts only, filled
    # one expert at a time (the merge transform of reference:
    # model_deepseek_v3.py:1167-1288)
    mine = rank_experts(lay, E)
    for hf, ours in (("gate_proj", "exp_gate"), ("up_proj", "exp_up"),
                     ("down_proj", "exp_down")):
        moe_p[ours] = fill_stacked(
            (len(moe_layers), len(mine)),
            lambda idx, h=hf: _maybe_fp8(
                f"model.layers.{moe_layers[idx[0]]}.mlp.experts.{mine[idx[1]]}.{h}"),
        )
    top = {"embed": ("model.embed_tokens", False),
           "norm": ("model.norm", False), "lm_head": ("lm_head", True)}
    out = {k: get(*v, leaf=k) for k, v in top.items() if holds(model, k)}
    # a stage after the first holds no dense-first layer; with fewer MoE
    # layers than stages, a stage may hold none of those either
    if dense_layers or model.pp == 1:
        out["dense_layers"] = dense
    if moe_layers or model.pp == 1:
        out["moe_layers"] = moe_p
    logger.info("deepseek checkpoint: %.2f GB in %.1fs", ck.nbytes / 1e9,
                time.time() - t0)
    return out
