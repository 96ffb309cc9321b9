"""Mixtral sparse-MoE model.

Counterpart of `chitu_tpu/models/mixtral.py` (reference:
chitu/models/model_hf_mixtral.py:1-182): llama attention + a softmax-top-2
renormalized router + stacked experts. The llama FFN leaves go; in their
place `moe_gate [L, D, E]`, `w_gate` / `w_up [L, E, D, F]` (or, once
`quantize.merge_moe_gate_up` has merged a quantized pair, `w_gu
[L, E, D, 2F]`) and `w_down [L, E, F, D]`, dense or `QTensor`. The FFN half
of a layer is `route` + `moe_ffn_auto` (`models/moe.py`): the token-sorted
dispatch through the grouped GEMM kernel for bf16 and e4m3 experts, the
capacity route for the stacks that kernel does not take.

Its attention takes the llama module's layouts, merged or unmerged
(`infer.merge_qkv_gate_up=off`), and its tensor-parallel attention. Under
tensor parallelism the experts are sharded over the group (expert
parallelism, the JAX package's `param_partition_specs` P('pp', 'tp', ..)
on the expert stacks): rank r holds a contiguous range of E // tp experts
of every stack (the first E % tp ranks one more: 3 / 3 / 2 of 8 at tp3,
where the JAX package falls back to GSPMD's capacity einsum) and the
whole router; attention whose heads tp does not divide replicates (the
llama module's); every rank routes its copy of the
hidden state, dispatches its own experts (`models.moe.moe_ffn_ep`) and
the partial combines are summed in one f32 all-reduce a layer. Its HF
checkpoints load through `loaders_moe.load_mixtral_params`. Pipeline
parallelism is the llama module's (each stage holds its layers' expert
stacks `[L / pp, E / tp, ...]`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from chitu_tpu_torch.models import register_model
from chitu_tpu_torch.models.common import rms_norm
from chitu_tpu_torch.models.llama import _LAYER_LEAVES, LlamaForCausalLM
from chitu_tpu_torch.models.moe import moe_ffn_auto, route
from chitu_tpu_torch.parallel.sharding import even_range

_FFN_LEAVES = ("w_gate_up", "w_gate", "w_up", "w_down")
_MOE_LEAVES = ("moe_gate", "w_gate", "w_up", "w_gu", "w_down")


@register_model("mixtral")
class MixtralForCausalLM(LlamaForCausalLM):
    LAYER_LEAVES = tuple(
        n for n in _LAYER_LEAVES if n not in _FFN_LEAVES
    ) + _MOE_LEAVES

    def __init__(self, args, cfg, device=None):
        if args.moe is None:
            raise ValueError("a mixtral model card needs its moe section")
        super().__init__(args, cfg, device=device)
        self.moe = args.moe
        # gate and up experts in one [.., D, 2F] stack (`w_gu`)
        self.merged_gu = False

    def _shapes(self, local: bool = True, merged=None) -> Dict[str, tuple]:
        a, m = self.args, self.moe
        shapes = {
            k: v for k, v in super()._shapes(local, merged).items()
            if k not in _FFN_LEAVES
        }
        L, D = self.n_local if local else a.n_layers, a.dim
        E, Fd = m.n_routed_experts, m.moe_inter_dim or self.inter_dim
        shapes["moe_gate"] = (L, D, E)
        if local:  # the rank's contiguous expert range
            E = len(range(*even_range(E, self.rank, self.tp)))
        if self.merged_gu:
            shapes["w_gu"] = (L, E, D, 2 * Fd)
        else:
            shapes["w_gate"] = (L, E, D, Fd)
            shapes["w_up"] = (L, E, D, Fd)
        shapes["w_down"] = (L, E, Fd, D)
        return shapes

    def load_params(self, tensors: Dict[str, Any]):
        """As the llama module's; the tree may hold the expert gate and up
        stacks split (`w_gate`, `w_up`) or merged (`w_gu`)."""
        flat = tensors.get("layers", tensors)
        merged = "w_gu" in flat
        if merged != self.merged_gu:
            for name in ("w_gate", "w_up", "w_gu"):
                self._drop(name)
            self.merged_gu = merged
        return super().load_params(tensors)

    def _ffn(self, h: torch.Tensor, layer: int,
             token_split: bool = True) -> torch.Tensor:
        x = rms_norm(h, self.ffn_norm[layer], self.args.norm_eps)
        weights, sel = route(x, self.moe_gate[layer], self.moe)
        gate_w, up_w = (
            (self.w_gu, None) if self.merged_gu else (self.w_gate, self.w_up)
        )
        y = moe_ffn_auto(x, gate_w, up_w, self.w_down, weights, sel,
                         self.moe, layer=layer, rank=self.rank, tp=self.tp,
                         dp=self.dp_group if token_split else None)
        if self.group is not None:
            # the ranks' partial combines: one all-reduce a layer
            y = self.group.all_reduce_f32(y)
        return h + y
