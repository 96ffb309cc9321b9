"""Model registry.

Counterpart of `chitu_tpu/models/__init__.py` (reference:
chitu/backend.py:72-84). This slice ports the llama family (hf-llama /
llama cards: Llama-3, Qwen2, R1-Distill, Meta-Llama); the MoE and MLA
families raise until their slices land.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(type_name: str):
    def deco(cls):
        _REGISTRY[type_name] = cls
        return cls

    return deco


def build_model(model_args, cfg, device=None):
    """Instantiate the model-family module for a model card."""
    # import for registration side effects
    from chitu_tpu_torch.models import llama  # noqa: F401

    t = model_args.type
    if t in ("hf-llama", "llama"):
        cls = _REGISTRY["hf-llama"]
    elif t in ("mixtral", "deepseek-v3"):
        raise NotImplementedError(
            f"model type {t!r} is not ported yet (ROADMAP queue A, slices "
            "3-4: MoE and MLA families)"
        )
    else:
        raise ValueError(f"unknown model type {t!r}")
    return cls(model_args, cfg, device=device)
