"""AWQ / GPTQ packed-checkpoint unpacking -> W4A16 QTensors.

Counterpart of `chitu_tpu/quantize/packed.py` (reference:
chitu/awq/qmodule.py:123-278 and the AutoGPTQ QuantLinear load path,
backend.py:334-347), on tensors of any device: the loader unpacks on the
GPU. Both formats unpack to the same logical `QTensor(W4A16)` layout:
data [in, out] int8 nibble values, scale and zeros [in/G, out] f32, which
the dequant GEMM takes (after `pack_int4_storage` packs two a byte).

Packing conventions:
- AWQ: qweight int32 [in, out/8], 8 nibbles a word in the interleaved
  order (0, 2, 4, 6, 1, 3, 5, 7); qzeros int32 [in/G, out/8] in the same
  order; scales fp16 [in/G, out].
- GPTQ: qweight int32 [in/8, out], 8 nibbles a word packed along the
  *in* dim in sequence; qzeros int32 [in/G, out/8] in sequence, each
  stored as zero - 1 (the "+1 quirk", `gptq_zero_plus_one`); scales fp16
  [in/G, out]; g_idx int32 [in] (act-order checkpoints): the group of
  each input row.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
_SEQ = tuple(range(8))


def _shifts(order, device) -> torch.Tensor:
    return torch.tensor(order, dtype=torch.int32, device=device) * 4


def _unpack_nibbles_lastdim(q: torch.Tensor, order) -> torch.Tensor:
    """int32 [..., N/8] -> int8 [..., N] by `order` within each word (the
    arithmetic shift keeps the top nibble in the low four bits)."""
    out = (q.to(torch.int32)[..., None] >> _shifts(order, q.device)) & 0xF
    return out.reshape(*q.shape[:-1], q.shape[-1] * 8).to(torch.int8)


def _unpack_nibbles_firstdim(q: torch.Tensor) -> torch.Tensor:
    """int32 [in/8, out] -> int8 [in, out], in sequence along in."""
    s = _shifts(_SEQ, q.device)[None, :, None]
    out = (q.to(torch.int32)[:, None, :] >> s) & 0xF  # [in/8, 8, out]
    return out.reshape(q.shape[0] * 8, q.shape[1]).to(torch.int8)


def unpack_awq(
    qweight: torch.Tensor,  # int32 [in, out/8]
    qzeros: torch.Tensor,  # int32 [in/G, out/8]
    scales: torch.Tensor,  # fp16/fp32 [in/G, out]
    group_size: int = 128,
) -> QTensor:
    return QTensor(
        data=_unpack_nibbles_lastdim(qweight, AWQ_ORDER),
        scale=scales.float(),
        zeros=_unpack_nibbles_lastdim(qzeros, AWQ_ORDER).float(),
        kind=QuantKind.W4A16,
        block=group_size,
    )


def unpack_gptq(
    qweight: torch.Tensor,  # int32 [in/8, out]
    qzeros: torch.Tensor,  # int32 [in/G, out/8]
    scales: torch.Tensor,  # fp16/fp32 [in/G, out]
    group_size: int = 128,
    gptq_zero_plus_one: bool = True,
    g_idx: Optional[torch.Tensor] = None,  # int32 [in]
) -> QTensor:
    """GPTQ unpack. A `g_idx` that is not the identity assignment
    (act-order checkpoints) has the rows stably sorted by group, so scale
    and zeros keep their contiguous [in/G, out] layout; the sort
    permutation becomes `QTensor.in_perm`, which gathers x before the
    GEMM (exact)."""
    data = _unpack_nibbles_firstdim(qweight)
    zeros = _unpack_nibbles_lastdim(qzeros, _SEQ).float()
    if gptq_zero_plus_one:
        zeros = zeros + 1.0
    in_perm = None
    if g_idx is not None:
        g = g_idx.to(device=data.device, dtype=torch.int64)
        identity = torch.arange(data.shape[0], device=data.device) // group_size
        if not torch.equal(g, identity):
            counts = torch.bincount(g, minlength=scales.shape[0])
            if bool((counts != group_size).any()):
                raise ValueError(
                    "GPTQ g_idx groups are not uniformly sized (expected "
                    f"{group_size} rows/group, got "
                    f"{sorted(set(counts.tolist()))})"
                )
            perm = torch.argsort(g, stable=True)
            data = data[perm]
            in_perm = perm.to(torch.int32)
    return QTensor(
        data=data,
        scale=scales.float(),
        zeros=zeros,
        kind=QuantKind.W4A16,
        block=group_size,
        in_perm=in_perm,
    )


def _pack_words(a: torch.Tensor, order) -> torch.Tensor:
    """[..., 8] nibble values -> int32 [...] (two's complement of the
    unsigned word)."""
    word = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for j, o in enumerate(order):
        word |= (a[..., j].to(torch.int64) & 0xF) << (4 * o)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def pack_awq(q: QTensor) -> Dict[str, torch.Tensor]:
    """Inverse of `unpack_awq` (tests, and checkpoints written from seeded
    weights)."""
    # zero-points must land on the uint4 grid: round and clip, as the JAX
    # package does, before the nibbles are masked
    zeros = torch.clamp(torch.round(q.zeros.float()), 0, 15)

    def pack_last(a):
        return _pack_words(a.reshape(*a.shape[:-1], a.shape[-1] // 8, 8), AWQ_ORDER)

    return {
        "qweight": pack_last(q.data),
        "qzeros": pack_last(zeros),
        "scales": q.scale.to(torch.float16),
    }


def pack_gptq(
    data: torch.Tensor,  # [in, out] nibble values, rows in input order
    zeros: torch.Tensor,  # [in/G, out], integers in 1..16
    scales: torch.Tensor,  # [in/G, out]
    g_idx: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """A GPTQ checkpoint's tensors: `unpack_gptq` of them gives `data`
    (rows sorted by group where `g_idx` permutes them), `zeros` and
    `scales`."""
    K, N = data.shape
    qweight = _pack_words(data.reshape(K // 8, 8, N).transpose(1, 2), _SEQ)
    z = torch.round(zeros.float()).to(torch.int64) - 1
    out = {
        "qweight": qweight,
        "qzeros": _pack_words(z.reshape(z.shape[0], N // 8, 8), _SEQ),
        "scales": scales.to(torch.float16),
    }
    if g_idx is not None:
        out["g_idx"] = g_idx.to(torch.int32)
    return out
