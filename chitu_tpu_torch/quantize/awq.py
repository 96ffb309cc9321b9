"""AWQ offline calibration: activation-aware scale and clip search.

Counterpart of `chitu_tpu/quantize/awq.py` (reference:
chitu/awq/auto_scale.py:100-140, chitu/awq/auto_clip.py), operation for
operation in f32 on whatever device the tensors are on (the card, when
the tree is there):

- `auto_scale_search`: for y = x @ w, a 20-point grid over alpha;
  s = mean|x|^alpha normalized by sqrt(max(s) * min(s)); quantizing w * s
  while feeding x / s keeps the product exact but moves the quantization
  noise away from the channels with large activations;
- `auto_clip_search`: 11 clip ratios from 0.5, each group keeps the one
  of least output MSE;
- `calibrate_llama`: the layer loop of a llama-family tree on calibration
  tokens, with causal attention, collecting every projection's input;
- `awq_quantize_llama_params`: one shared scale per norm group, folded
  into `attn_norm` / `ffn_norm` (the runtime needs no extra op), then
  W4A16 `QTensor`s with the searched clips.

The result is a tree the engine serves as `params=` (through the int4
dequant GEMM, B7), merged (`wqkv`, `w_gate_up`) or unmerged.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from chitu_tpu_torch.ops.qtensor import TENSOR_FIELDS, QTensor, QuantKind
from chitu_tpu_torch.quantize.transforms import quantize_weight


def _w4_roundtrip(w: torch.Tensor, group: int) -> torch.Tensor:
    """RTN W4A16 quantize + dequantize (the noise model being minimized)."""
    return quantize_weight(w, QuantKind.W4A16, block=group).dequantize(
        torch.float32
    )


def auto_scale_search(
    w: torch.Tensor,  # [K, N]
    x: torch.Tensor,  # [S, K] calibration inputs
    group: int = 128,
    n_grid: int = 20,
) -> Tuple[torch.Tensor, float]:
    """Grid-search the AWQ per-in-channel scale. Returns (s [K], best
    loss)."""
    xf = x.float()
    wf = w.float().to(xf.device)
    y_ref = xf @ wf
    act_scale = xf.abs().mean(dim=0).clamp_min(1e-8)  # [K]

    best_s = torch.ones((w.shape[0],), dtype=torch.float32, device=xf.device)
    best_loss = float("inf")
    for i in range(n_grid):
        alpha = i / n_grid
        s = act_scale**alpha
        s = s / torch.sqrt(s.max() * s.min())  # normalize (reference trick)
        wq = _w4_roundtrip(wf * s[:, None], group)
        y = (xf / s[None, :]) @ wq
        loss = float(((y - y_ref) ** 2).mean())
        if loss < best_loss:
            best_loss = loss
            best_s = s
    return best_s, best_loss


def auto_clip_search(
    w: torch.Tensor,  # [K, N] (already AWQ-scaled)
    x: torch.Tensor,  # [S, K]
    group: int = 128,
    n_grid: int = 10,
    min_ratio: float = 0.5,
) -> torch.Tensor:
    """Per-group clip-range search: shrink each group's min / max before
    quantization where that lowers its output MSE. Returns the clipped
    weight (dense, before quantization)."""
    xf = x.float()
    wf = w.float().to(xf.device)
    K, N = wf.shape
    ng = (K + group - 1) // group
    pad = ng * group - K
    wp = F.pad(wf, (0, 0, 0, pad)).reshape(ng, group, N)
    xp = F.pad(xf, (0, pad)).reshape(-1, ng, group)
    # per-group output of the unclipped weight: [ng, S, N]
    y_ref = torch.einsum("sgk,gkn->gsn", xp, wp)

    best = wp
    best_loss = None
    for i in range(n_grid + 1):
        ratio = min_ratio + (1.0 - min_ratio) * i / n_grid
        hi = wp.amax(dim=1, keepdim=True) * ratio
        lo = wp.amin(dim=1, keepdim=True) * ratio
        wc = torch.clamp(wp, lo, hi)
        wq = _w4_roundtrip(wc.reshape(ng * group, N)[:K], group)
        wqp = F.pad(wq, (0, 0, 0, pad)).reshape(ng, group, N)
        y = torch.einsum("sgk,gkn->gsn", xp, wqp)
        loss = ((y - y_ref) ** 2).mean(dim=(1, 2))  # [ng]
        del y
        if best_loss is None:
            best_loss = loss
            best = wc
        else:
            better = loss < best_loss
            best_loss = torch.where(better, loss, best_loss)
            best = torch.where(better[:, None, None], wc, best)
    return best.reshape(ng * group, N)[:K]


# ---------------------------------------------------------------------------
# Llama-family calibration driver (offline; mirrors the model's layer loop)
# ---------------------------------------------------------------------------


def calibrate_llama(
    model, params, tokens, max_samples: int = 512
) -> Dict[str, list]:
    """Collect each projection's input activations ([T, K] f32, one per
    layer) over calibration tokens: the layer loop of the nested tree
    `params` (`model.params_tree()`, dense leaves, merged or unmerged) on
    one sequence, with causal attention, on the tree's device. Calibration
    needs representative activation statistics, not generation (the
    reference hooks real forwards, awq/auto_scale.py)."""
    from chitu_tpu_torch.models.common import (
        apply_rope, grouped_attention, rms_norm,
    )

    from chitu_tpu_torch.ops.linear import linear

    a = model.args
    layers = params["layers"]
    dev = params["embed"].device
    T = int(min(len(tokens), max_samples))
    ids = torch.as_tensor(np.asarray(tokens[:T], np.int64), device=dev)
    h = params["embed"][ids].float()
    cos = model.cos[:T].to(dev)
    sin = model.sin[:T].to(dev)
    H, KV, Dh = a.n_heads, a.n_kv_heads, model.head_dim
    stats: Dict[str, list] = {}

    def put(name, x):
        stats.setdefault(name, []).append(x.float())

    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    for l in range(a.n_layers):
        g = lambda n: layers[n][l]  # noqa: E731
        x = rms_norm(h.to(torch.bfloat16), g("attn_norm"), a.norm_eps)
        if "wqkv" in layers:
            put("wqkv", x)
            qkv = linear(x, g("wqkv"), g("b_qkv") if "b_qkv" in layers else None)
            q = qkv[:, : H * Dh].reshape(T, H, Dh)
            k = qkv[:, H * Dh : (H + KV) * Dh].reshape(T, KV, Dh)
            v = qkv[:, (H + KV) * Dh :].reshape(T, KV, Dh)
        else:
            put("wq", x)
            q = linear(x, g("wq")).reshape(T, H, Dh)
            k = linear(x, g("wk")).reshape(T, KV, Dh)
            v = linear(x, g("wv")).reshape(T, KV, Dh)
        q = apply_rope(q, cos, sin, model.rotary_layout)
        k = apply_rope(k, cos, sin, model.rotary_layout)
        o = grouped_attention(q, k, v, mask, scale=model.attn_scale)
        o = o.reshape(T, H * Dh)
        put("wo", o)
        h = h + linear(o, g("wo")).float()

        x = rms_norm(h.to(torch.bfloat16), g("ffn_norm"), a.norm_eps)
        if "w_gate_up" in layers:
            put("w_gate_up", x)
            gu = linear(x, g("w_gate_up"))
            Fd = gu.shape[-1] // 2
            hid = F.silu(gu[:, :Fd]) * gu[:, Fd:]
        else:
            put("w_gate", x)
            hid = F.silu(linear(x, g("w_gate"))) * linear(x, g("w_up"))
        put("w_down", hid)
        h = h + linear(hid, g("w_down")).float()
    return stats


# projections whose input comes straight from an RMSNorm: the AWQ scale
# folds into the norm weight (the runtime stays scale-free)
_NORM_FED = {
    "wq": "attn_norm",
    "wk": "attn_norm",
    "wv": "attn_norm",
    "wqkv": "attn_norm",
    "w_gate": "ffn_norm",
    "w_up": "ffn_norm",
    "w_gate_up": "ffn_norm",
}


def _stack(qs) -> QTensor:
    """Per-layer QTensors -> one stacked [L, ...] QTensor."""
    kw = {
        n: (torch.stack([getattr(q, n) for q in qs])
            if getattr(qs[0], n) is not None else None)
        for n in TENSOR_FIELDS
    }
    return QTensor(kind=qs[0].kind, block=qs[0].block, **kw)


def awq_quantize_llama_params(
    model,
    params,
    calib_tokens,
    group: int = 128,
    do_clip: bool = True,
) -> Any:
    """The AWQ pipeline for a llama-family tree (`model.params_tree()`):
    calibrate, search the scales (folded into the norms) and the clips,
    and return a new tree with W4A16 `QTensor` projections (one nibble a
    byte: the engine packs them when it loads the tree)."""
    stats = calibrate_llama(model, params, calib_tokens)
    layers = params["layers"]
    L = model.args.n_layers
    scaled: Dict[str, list] = {}
    norm_adjust: Dict[str, list] = {}
    quantizable = [
        n for n in ("wq", "wk", "wv", "wqkv", "w_gate", "w_up",
                    "w_gate_up", "wo", "w_down")
        if n in layers
    ]
    for l in range(L):
        # one shared scale per norm group (q/k/v share attn_norm's output)
        s_by_norm: Dict[str, torch.Tensor] = {}
        for name in quantizable:
            w = layers[name][l].float()
            norm = _NORM_FED.get(name)
            xcal = stats[name if name in stats else
                         ("wq" if norm == "attn_norm" else "w_gate")][l]
            s = None
            if norm is not None:
                if norm not in s_by_norm:
                    s_by_norm[norm], _ = auto_scale_search(w, xcal, group=group)
                s = s_by_norm[norm]
                w = w * s[:, None]
            if do_clip:
                # the runtime input to a scaled weight is x / s
                xs = xcal / s[None, :] if s is not None else xcal
                w = auto_clip_search(w, xs, group=group)
            scaled.setdefault(name, [None] * L)[l] = quantize_weight(
                w, QuantKind.W4A16, block=group
            )
            del w
        for norm, s in s_by_norm.items():
            norm_adjust.setdefault(norm, [None] * L)[l] = (
                layers[norm][l].float() / s
            )
    new_layers = dict(layers)
    for name, vals in scaled.items():
        new_layers[name] = _stack(vals)
    for norm, vals in norm_adjust.items():
        new_layers[norm] = torch.stack(vals).to(layers[norm].dtype)
    new_params = dict(params)
    new_params["layers"] = new_layers
    return new_params
