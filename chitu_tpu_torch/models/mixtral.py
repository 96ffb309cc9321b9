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

Its HF checkpoints load through `loaders_moe.load_mixtral_params`. Not
ported yet: expert parallelism over a mesh (ROADMAP queue A.6, multi-GPU).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from chitu_tpu_torch.models import register_model
from chitu_tpu_torch.models.common import rms_norm
from chitu_tpu_torch.models.llama import _LAYER_LEAVES, LlamaForCausalLM
from chitu_tpu_torch.models.moe import moe_ffn_auto, route

_FFN_LEAVES = ("w_gate_up", "w_down")
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

    def _shapes(self) -> Dict[str, tuple]:
        a, m = self.args, self.moe
        shapes = {
            k: v for k, v in super()._shapes().items() if k not in _FFN_LEAVES
        }
        L, D = a.n_layers, a.dim
        E, Fd = m.n_routed_experts, m.moe_inter_dim or self.inter_dim
        shapes["moe_gate"] = (L, D, E)
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

    def _ffn(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        x = rms_norm(h, self.ffn_norm[layer], self.args.norm_eps)
        weights, sel = route(x, self.moe_gate[layer], self.moe)
        gate_w, up_w = (
            (self.w_gu, None) if self.merged_gu else (self.w_gate, self.w_up)
        )
        return h + moe_ffn_auto(
            x, gate_w, up_w, self.w_down, weights, sel, self.moe, layer=layer
        )
