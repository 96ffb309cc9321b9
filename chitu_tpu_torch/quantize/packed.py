"""AWQ / GPTQ packed-checkpoint formats: the nibble unpack and the act-order
row sort that the loader's readers use, and the packers that write such
checkpoints.

Counterpart of `chitu_tpu/quantize/packed.py` (reference:
chitu/awq/qmodule.py:123-278 and the AutoGPTQ QuantLinear load path,
backend.py:334-347), on tensors of any device: the loader
(`loader_streaming.w4a16`) copies the packed words of a rank's slice and
unpacks them on the GPU. Both formats unpack to the same logical
`QTensor(W4A16)` layout: data [in, out] int8 nibble values, scale and
zeros [in/G, out] f32, which the dequant GEMM takes (after
`pack_int4_storage` packs two a byte).

Packing conventions:
- AWQ: qweight int32 [in, out/8], 8 nibbles a word in the interleaved
  order (0, 2, 4, 6, 1, 3, 5, 7); qzeros int32 [in/G, out/8] in the same
  order; scales fp16 [in/G, out].
- GPTQ: qweight int32 [in/8, out], 8 nibbles a word packed along the
  *in* dim in sequence; qzeros int32 [in/G, out/8] in sequence, each
  stored as zero - 1 (the "+1 quirk"); scales fp16
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


def unpack_nibbles(q: torch.Tensor, order, axis: int, lo: int = 0,
                   n: Optional[int] = None) -> torch.Tensor:
    """int32 words packing 8 nibbles each along `axis` (the last: AWQ
    qweight and qzeros [.., N/8]; the first: GPTQ qweight [in/8, out]) ->
    int8 nibble values, `order` giving each nibble's place in its word
    (the arithmetic shift keeps the top nibble in the low four bits).
    `lo`, `n`: only values [lo, lo + n) along `axis` of the words' 8x
    (the streamed loader copies the whole words over a rank's slice and
    cuts the slice here, `loader_streaming.LazyUnpack4`)."""
    axis = axis % q.dim()
    w = q.to(torch.int32).movedim(axis, -1)
    out = (w[..., None] >> _shifts(order, q.device)) & 0xF
    out = out.reshape(*w.shape[:-1], w.shape[-1] * 8)
    if lo or (n is not None and n != out.shape[-1] - lo):
        out = out[..., lo:lo + (out.shape[-1] - lo if n is None else n)]
    return out.movedim(-1, axis).to(torch.int8).contiguous()


def act_order_perm(g_idx: torch.Tensor, group_size: int,
                   n_groups: int) -> Optional[torch.Tensor]:
    """A GPTQ g_idx [in] -> the stable sort of the input rows by group
    (int64), or None when it is the identity assignment (rows in group
    order). Act-order groups must all hold `group_size` rows, so that
    scale and zeros keep their contiguous [in/G, out] layout."""
    g = g_idx.to(torch.int64)
    identity = torch.arange(g.shape[0], device=g.device) // group_size
    if torch.equal(g, identity):
        return None
    counts = torch.bincount(g, minlength=n_groups)
    if bool((counts != group_size).any()):
        raise ValueError(
            "GPTQ g_idx groups are not uniformly sized (expected "
            f"{group_size} rows/group, got "
            f"{sorted(set(counts.tolist()))})"
        )
    return torch.argsort(g, stable=True)


def _pack_words(a: torch.Tensor, order) -> torch.Tensor:
    """[..., 8] nibble values -> int32 [...] (two's complement of the
    unsigned word)."""
    word = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for j, o in enumerate(order):
        word |= (a[..., j].to(torch.int64) & 0xF) << (4 * o)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def pack_awq(q: QTensor) -> Dict[str, torch.Tensor]:
    """An AWQ checkpoint's tensors of a W4A16 QTensor (tests, and
    checkpoints written from seeded weights); the loader reads them back
    to the same QTensor."""
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
    """A GPTQ checkpoint's tensors: the loader reads them back to `data`
    (rows sorted by group where `g_idx` permutes them, the sort as
    `in_perm`), `zeros` and `scales`."""
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
