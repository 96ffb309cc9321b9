"""Quantization as transforms of the parameter tree.

Counterpart of `chitu_tpu/quantize/transforms.py`: eligible weight leaves
of a nested parameter dict are replaced by `QTensor`s, and
`chitu_tpu_torch.ops.linear` dispatches those to the dequant GEMM. The
arithmetic is the JAX package's, operation for operation in f32, so the
same dense weights give the same bytes, scales and zeros.

Schemes:
- soft_fp8: e4m3 storage + [in/128, out/128] blockwise f32 scales,
  dequantized inside the GEMM
- fp8: the same storage; activations may be rounded through e4m3 at run
  time (`fp8_act_roundtrip`)
- w8a16: int8 weight, per-out-channel scale
- w8a8: int8 weight per-out-channel + dynamic per-token int8 activations
- w4a16: 4-bit weight, group-128 scale + zero along the in dim
- llmint8: w8a16 with the largest input channels kept dense

`merge_moe_gate_up` then joins quantized gate and up stacks (the MoE
experts' `[L, E, D, F]` pairs and two per-layer pairs of the MLA family)
into one leaf, so each layer runs one GEMM for both.

Not ported: `requantize_fp8_storage` (a workaround for a chip without an
fp8 datapath; this card converts e4m3 natively).
"""

from __future__ import annotations

import itertools
from dataclasses import replace
from typing import Any, Optional, Set

import torch
from torch.nn import functional as F

from chitu_tpu_torch.ops.qtensor import (
    PACK_TILE,
    QTensor,
    QuantKind,
    TENSOR_FIELDS,
    unpack_int4,
)

F8_MAX = 448.0  # float8_e4m3fn max normal
BLOCK = 128
OUTLIER_FRAC = 0.005  # fraction of input channels kept dense (llmint8)


def _block_pad(n: int, b: int) -> int:
    return (n + b - 1) // b * b


def fp8_act_roundtrip(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Round activations through the e4m3 grid with dynamic per-(row,
    128-wide in-block) scales (scale = absmax / 448): the values an
    fp8 x fp8 blockwise GEMM would consume (`quant.fp8_act="e4m3"`)."""
    orig = x.dtype
    *lead, K = x.shape
    kb = _block_pad(K, block) // block
    xf = F.pad(x.float(), (0, kb * block - K)).reshape(*lead, kb, block)
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / F8_MAX
    q = (xf / s).to(torch.float8_e4m3fn).float() * s
    return q.reshape(*lead, kb * block)[..., :K].to(orig)


def quantize_weight(
    w: torch.Tensor, kind: QuantKind, block: int = BLOCK
) -> QTensor:
    """Quantize one [..., in, out] weight; leading dims (stacked layers)
    are independent. Works in f32 on the whole tensor at once: callers
    with large stacked leaves go layer by layer (`quantize_stacked`)."""
    wf = w.float()
    *lead, fin, fout = wf.shape

    if kind in (QuantKind.SOFT_FP8, QuantKind.FP8):
        bi = _block_pad(fin, block) // block
        bo = _block_pad(fout, block) // block
        wp = F.pad(wf, (0, bo * block - fout, 0, bi * block - fin))
        blocks = wp.reshape(*lead, bi, block, bo, block)
        absmax = blocks.abs().amax(dim=(-3, -1))  # [..., bi, bo]
        scale = absmax.clamp_min(1e-8) / F8_MAX
        q = blocks / scale[..., :, None, :, None]
        q = q.reshape(*lead, bi * block, bo * block)[..., :fin, :fout]
        data = q.contiguous().to(torch.float8_e4m3fn)
        return QTensor(data=data, scale=scale, kind=kind, block=block)

    if kind in (QuantKind.W8A16, QuantKind.W8A8):
        absmax = wf.abs().amax(dim=-2)  # [..., out]
        scale = absmax.clamp_min(1e-8) / 127.0
        q = torch.round(wf / scale[..., None, :]).clamp(-127, 127)
        return QTensor(data=q.to(torch.int8), scale=scale, kind=kind)

    if kind == QuantKind.W4A16:
        g = block
        ng = _block_pad(fin, g) // g
        wp = F.pad(wf, (0, 0, 0, ng * g - fin)).reshape(*lead, ng, g, fout)
        # the zero-padded tail rows stay out of the group statistics; 0 is
        # put into the range explicitly, so the zero-point is representable
        real = (
            torch.arange(ng * g, device=wf.device).reshape(ng, g) < fin
        )[..., None]  # [ng, g, 1]
        inf = torch.tensor(float("inf"), device=wf.device)
        wmax = torch.where(real, wp, -inf).amax(dim=-2).clamp_min(0.0)
        wmin = torch.where(real, wp, inf).amin(dim=-2).clamp_max(0.0)
        scale = (wmax - wmin).clamp_min(1e-8) / 15.0  # [..., ng, out]
        # integer zero-point (AWQ/GPTQ convention)
        zeros = torch.round(-wmin / scale).clamp(0, 15)
        q = torch.round(
            wp / scale[..., :, None, :] + zeros[..., :, None, :]
        ).clamp(0, 15)
        data = q.reshape(*lead, ng * g, fout)[..., :fin, :].to(torch.int8)
        return QTensor(
            data=data.contiguous(), scale=scale, zeros=zeros, kind=kind,
            block=g,
        )

    raise ValueError(f"unknown quant kind {kind}")


def quantize_llmint8(w: torch.Tensor, frac: float = OUTLIER_FRAC) -> QTensor:
    """LLM.int8-style quantization with a static outlier set: the input
    channels of largest weight magnitude stay dense in bf16, the rest
    quantize to per-out-channel int8 with those rows zeroed."""
    wf = w.float()
    *lead, K, N = wf.shape
    k_o = max(8, int(K * frac) // 8 * 8)
    norms = wf.abs().amax(dim=-1)  # [..., K]
    idx = torch.topk(norms, k_o, dim=-1).indices
    idx = torch.sort(idx, dim=-1).values
    gidx = idx[..., None].expand(*idx.shape, N)
    oc_w = torch.gather(wf, -2, gidx).to(torch.bfloat16)
    zeroed = wf.scatter(-2, gidx, 0.0)
    q = quantize_weight(zeroed, QuantKind.W8A16)
    return replace(q, oc_idx=idx.to(torch.int32), oc_w=oc_w)


def quantize_stacked(w: torch.Tensor, qfn) -> QTensor:
    """Apply `qfn` (one [in, out] weight -> QTensor) to a stacked
    [L, in, out] or [L, E, in, out] leaf one matrix at a time, so the f32
    intermediates stay one matrix large, and stack the results."""
    lead = tuple(w.shape[:-2])
    out = None
    for idx in itertools.product(*map(range, lead)):
        q = qfn(w[idx])
        if out is None:
            out = q._map(
                lambda t: torch.empty((*lead, *t.shape), dtype=t.dtype,
                                      device=t.device)
            )
        for name in TENSOR_FIELDS:
            if getattr(q, name) is not None:
                getattr(out, name)[idx].copy_(getattr(q, name))
    return out


def expand_fp8_scales_rowwise(params: Any) -> Any:
    """Blockwise fp8 scales [.., in/B, out/B] -> rowwise [.., in/B, out]
    (storage stays fp8; the repeat is exact)."""

    def leaf(t):
        if (
            isinstance(t, QTensor)
            and t.kind in (QuantKind.SOFT_FP8, QuantKind.FP8)
            and t.scale.shape[-1] != t.data.shape[-1]
        ):
            n = t.data.shape[-1]
            scale = torch.repeat_interleave(t.scale, t.block, dim=-1)
            return replace(t, scale=scale[..., :n].float().contiguous())
        return t

    return _walk(params, leaf)


def _walk(tree, leaf):
    if isinstance(tree, dict):
        for k in list(tree.keys()):
            tree[k] = _walk(tree.pop(k), leaf)
        return tree
    return leaf(tree)


def pack_int4_storage(params: Any) -> Any:
    """W4A16 one-nibble-a-byte storage -> two nibbles a byte. The packing
    is relative to PACK_TILE-column tiles: within each tile, byte column c
    holds logical column c (low nibble) and c + PACK_TILE/2 (high nibble),
    the JAX package's layout byte for byte. Out dims that are no multiple
    of PACK_TILE stay one nibble a byte."""

    def leaf(q):
        if not (
            isinstance(q, QTensor)
            and q.kind == QuantKind.W4A16
            and q.data.dim() in (2, 3)
            and not q.packed
        ):
            return q
        *lead, K, N = q.data.shape
        t = PACK_TILE
        if N % t:
            return q
        tiles = q.data.view(torch.uint8).reshape(*lead, K, N // t, t)
        packed = tiles[..., : t // 2] | (tiles[..., t // 2 :] << 4)
        return replace(
            q, data=packed.reshape(*lead, K, N // 2).view(torch.int8))

    return _walk(params, leaf)


def unpack_int4_storage(q: QTensor) -> QTensor:
    """Inverse of `pack_int4_storage` for one leaf."""
    return unpack_int4(q)


def is_packed_int4(q: QTensor) -> bool:
    return q.packed


KIND_BY_METHOD = {
    "soft_fp8": QuantKind.SOFT_FP8,
    "fp8": QuantKind.FP8,
    "w8a16": QuantKind.W8A16,
    "w8a8": QuantKind.W8A8,
    "simple_w8a8": QuantKind.W8A8,
    "w4a16": QuantKind.W4A16,
    "w4a16_awq": QuantKind.W4A16,
    "w4a16_gptq": QuantKind.W4A16,
    "awq": QuantKind.W4A16,
    "gptq": QuantKind.W4A16,
    # llmint8: int8 weight-only + dense outlier input channels
    "llmint8": QuantKind.W8A16,
}

_OUTLIER_METHODS = {"llmint8"}


def quantize_params(
    params: Any,
    quant_args,
    model=None,
    keys: Optional[Set[str]] = None,
) -> Any:
    """Replace eligible weight leaves of the nested parameter dict
    ({"embed", "norm", "lm_head", "layers": {...}}) with QTensors, in
    place. Eligible: linear projection weights under "layers" only, never
    norms, embeddings, biases or router gates; `lm_head` only with
    `quant_args.quantize_head` (untied heads, not for llmint8). Each dense
    leaf is dropped as soon as it is quantized, and stacked leaves go one
    layer at a time, so memory peaks at one extra leaf."""
    method = quant_args.method
    if method in ("none", ""):
        return params
    kind = KIND_BY_METHOD.get(method)
    if kind is None:
        raise ValueError(f"unknown quant method {method!r}")
    block = quant_args.group_size or BLOCK

    if keys is None:
        keys = getattr(model, "quantizable_keys", lambda: None)()

    if (
        getattr(quant_args, "quantize_head", False)
        and isinstance(params, dict)
        and isinstance(params.get("lm_head"), torch.Tensor)
        and method not in _OUTLIER_METHODS
    ):
        params["lm_head"] = quantize_weight(
            params.pop("lm_head"), kind, block
        )

    qfn = (
        quantize_llmint8
        if method in _OUTLIER_METHODS
        else lambda w: quantize_weight(w, kind, block)
    )

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k in list(tree.keys()):
                v = tree.pop(k)
                tree[k] = walk(v, path + (k,))
            return tree
        if isinstance(tree, (list, tuple)):
            return type(tree)(
                walk(v, path + (str(i),)) for i, v in enumerate(tree)
            )
        name = path[-1] if path else ""
        under_layers = any("layers" in p or "experts" in p for p in path[:-1])
        eligible = (
            isinstance(tree, torch.Tensor)
            and tree.dim() >= 2
            and under_layers
            and "norm" not in name
            and not name.startswith("b")
            and name not in ("embed", "lm_head", "moe_gate", "gate_bias")
        )
        if keys is not None:
            eligible = eligible and name in keys
        if not eligible:
            return tree
        if tree.dim() >= 3:
            return quantize_stacked(tree.detach(), qfn)
        return qfn(tree.detach())

    return walk(params)


def merge_moe_gate_up(params: Any, tp: int = 1) -> Any:
    """Concatenate MoE expert gate / up stacks into one [.., D, 2F] leaf,
    in place, so each MoE layer runs one grouped GEMM for gate + up (the
    reference's fused_moe w13 merge,
    chitu/models/model_deepseek_v3.py:1167-1288): the 4-D pairs
    `w_gate`/`w_up` -> `w_gu` and `exp_gate`/`exp_up` -> `exp_gu`, and the
    per-layer 3-D pairs of the MLA family, `wq_a`/`wkv_a` -> `wq_kv_a` and
    (on one device, `tp` <= 1: `shared_gu` is column-sharded otherwise)
    `shared_gate`/`shared_up` -> `shared_gu`. One eligibility rule for all:
    quantized stacks of one fp8 or int8 kind only. Dense stacks stay
    split, as in the JAX package. W4A16 never merges (its nibble packing
    is relative to column tiles), nor do act-order or outlier leaves.
    Per-channel scales concatenate exactly; per-block scales only when
    the gate's out dim fills its last block, else the up half's scale
    grid would shift."""

    def mergeable(a, b, ndim=4):
        if not (isinstance(a, QTensor) and isinstance(b, QTensor)):
            return False
        return (
            a.kind == b.kind
            and a.kind in (QuantKind.SOFT_FP8, QuantKind.FP8,
                           QuantKind.W8A16, QuantKind.W8A8)
            and a.data.dim() == ndim
            and a.in_perm is None and b.in_perm is None
            and a.oc_idx is None and b.oc_idx is None
            and not a.viewed and not b.viewed
            and (
                a.scale.dim() < a.data.dim()  # per-channel: exact concat
                or a.data.shape[-1] % a.block == 0
            )
        )

    def cat(a, b):
        data = torch.cat([a.data.view(torch.uint8), b.data.view(torch.uint8)], dim=-1)
        return QTensor(
            data=data.view(a.data.dtype),
            scale=torch.cat([a.scale, b.scale], dim=-1),
            kind=a.kind, block=a.block,
        )

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        for key in list(tree.keys()):
            tree[key] = walk(tree[key])
        pairs = [
            ("exp_gate", "exp_up", "exp_gu", 4),
            ("w_gate", "w_up", "w_gu", 4),
            ("wq_a", "wkv_a", "wq_kv_a", 3),
        ]
        if tp <= 1:
            pairs.append(("shared_gate", "shared_up", "shared_gu", 3))
        for gate, up, merged, ndim in pairs:
            if gate in tree and up in tree and mergeable(
                tree[gate], tree[up], ndim
            ):
                tree[merged] = cat(tree.pop(gate), tree.pop(up))
        return tree

    return walk(params)
