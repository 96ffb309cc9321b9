"""Model registry.

Counterpart of `chitu_tpu/models/__init__.py` (reference:
chitu/backend.py:72-84). Ported: the llama family (hf-llama / llama
cards: Llama-3, Qwen2, R1-Distill, Meta-Llama) and Mixtral (mixtral cards:
Mixtral-8x7B, moe-16x-bench); the MLA family (deepseek-v3) raises until
its slice lands.
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
    from chitu_tpu_torch.models import llama, mixtral  # noqa: F401

    t = model_args.type
    if t in ("hf-llama", "llama"):
        cls = _REGISTRY["hf-llama"]
    elif t == "mixtral":
        cls = _REGISTRY["mixtral"]
    elif t == "deepseek-v3":
        raise NotImplementedError(
            f"model type {t!r} is not ported yet (ROADMAP queue A, slice "
            "4: the MLA family)"
        )
    else:
        raise ValueError(f"unknown model type {t!r}")
    return cls(model_args, cfg, device=device)
