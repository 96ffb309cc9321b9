"""Quantized weight tensors.

Counterpart of `chitu_tpu/ops/qtensor.py`: a quantized weight is a plain
dataclass of tensors (packed data + scales, optional zeros) that
`chitu_tpu_torch.ops.linear` dispatches on. Covers the whole ladder:
soft-fp8 / fp8 blockwise, W8A16, W8A8, W4A16 (AWQ / GPTQ), with the
act-order permutation and the LLM.int8 outlier rows as optional fields.
fp8 storage is `torch.float8_e4m3fn`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, fields, replace
from typing import Optional, Tuple

import torch

PACK_TILE = 512  # output-tile width the int4 nibble packing is relative to


class QuantKind(str, enum.Enum):
    # weight-only fp8 (e4m3) with [in/128, out/128] blockwise scales
    SOFT_FP8 = "soft_fp8"
    # fp8 weights, activations optionally rounded through the e4m3 grid
    FP8 = "fp8"
    # int8 weight-only, per-out-channel scales
    W8A16 = "w8a16"
    # int8 weight + dynamic per-token int8 activations
    W8A8 = "w8a8"
    # 4-bit weight-only, group-128 scales + zeros along the in dim
    W4A16 = "w4a16"


TENSOR_FIELDS = ("data", "scale", "zeros", "in_perm", "oc_idx", "oc_w")


@dataclass
class QTensor:
    """A quantized weight. The logical layout is [in, out] (`x @ w`),
    optionally stacked [L, in, out] (a projection of every layer) or
    [L, E, in, out] (the experts of every layer; scales [L, E, in/B, out/B]
    blockwise or [L, E, in/B, out] rowwise). Indexing takes leading dims
    off every field at once: `q[layer]`, `q[layer, expert]`. `data` holds
    the storage:

    - SOFT_FP8 / FP8: data [in, out] float8_e4m3fn, scale
      [ceil(in/B), ceil(out/B)] f32 blockwise, or [ceil(in/B), out] rowwise
    - W8A16 / W8A8: data [in, out] int8, scale [out] f32
    - W4A16: data [in, out] int8 holding one nibble value each, or
      [in, out/2] int8 with two nibbles a byte in PACK_TILE-column tiles
      (see `quantize.transforms.pack_int4_storage`); scale and zeros
      [ceil(in/G), out] f32

    `in_perm` [(L,) in]: the rows are stored group-sorted (act-order GPTQ)
    and x is gathered by it before the GEMM. `oc_idx` [(L,) K_o] and
    `oc_w` [(L,) K_o, out]: LLM.int8 outlier input channels kept dense
    (their int8 rows are zero), y = gemm(x) + x[:, oc_idx] @ oc_w.

    `rows` and `cols`: a tensor-parallel rank's view of a weight whose cut
    falls inside a quantization block (`parallel.sharding`). The stored
    rows and columns are the whole blocks that cover the rank's slice;
    the logical weight is stored rows [rows[0], rows[1]) and the
    concatenation of the stored column ranges in `cols` (None: all of
    them). `ops.linear` feeds zeros to the stored rows outside the view
    and keeps the view's columns of the product; `shape` and
    `dequantize` are the logical ones, `data` and `nbytes` the stored.
    """

    data: torch.Tensor
    scale: torch.Tensor
    zeros: Optional[torch.Tensor] = None
    kind: QuantKind = QuantKind.SOFT_FP8
    block: int = 128
    in_perm: Optional[torch.Tensor] = None
    oc_idx: Optional[torch.Tensor] = None
    oc_w: Optional[torch.Tensor] = None
    rows: Optional[Tuple[int, int]] = None
    cols: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def viewed(self) -> bool:
        return self.rows is not None or self.cols is not None

    def stored(self) -> "QTensor":
        """The weight as stored: the view dropped."""
        return replace(self, rows=None, cols=None) if self.viewed else self

    @property
    def packed(self) -> bool:
        return (
            self.kind == QuantKind.W4A16
            and self.scale.shape[-1] == self.data.shape[-1] * 2
        )

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical [(L,) in, out] shape (packed int4 counts both nibbles)."""
        s = tuple(self.data.shape)
        s = s[:-1] + (s[-1] * 2,) if self.packed else s
        if self.rows is not None:
            s = s[:-2] + (self.rows[1] - self.rows[0], s[-1])
        if self.cols is not None:
            s = s[:-1] + (sum(b - a for a, b in self.cols),)
        return s

    @property
    def in_features(self) -> int:
        return self.shape[-2]

    @property
    def out_features(self) -> int:
        return self.shape[-1]

    def _map(self, fn) -> "QTensor":
        kw = {f.name: getattr(self, f.name) for f in fields(self)}
        for name in TENSOR_FIELDS:
            if kw[name] is not None:
                kw[name] = fn(kw[name])
        return QTensor(**kw)

    def __getitem__(self, idx) -> "QTensor":
        """Index the leading (layer, expert) dims: every field is a view."""
        return self._map(lambda t: t[idx])

    def to(self, device) -> "QTensor":
        return self._map(lambda t: t.to(device))

    def contiguous(self) -> "QTensor":
        return self._map(lambda t: t.contiguous())

    def without(self, *names) -> "QTensor":
        kw = {f.name: getattr(self, f.name) for f in fields(self)}
        for n in names:
            kw[n] = None
        return QTensor(**kw)

    def nbytes(self) -> int:
        return sum(
            getattr(self, n).numel() * getattr(self, n).element_size()
            for n in TENSOR_FIELDS
            if getattr(self, n) is not None
        )

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Dense [(L,) in, out] weight in `dtype`: the f32 product of the
        stored values and their scales, rounded once."""
        if self.viewed:
            w = self.stored().dequantize(dtype)
            if self.rows is not None:
                w = w[..., self.rows[0]:self.rows[1], :]
            if self.cols is not None:
                w = torch.cat([w[..., a:b] for a, b in self.cols], dim=-1)
            return w
        if self.oc_idx is not None:
            base = self.without("oc_idx", "oc_w").dequantize(dtype)
            # the dense outlier rows go back where their int8 rows are 0
            ocw = self.oc_w.to(dtype)
            idx = self.oc_idx.long()[..., None].expand(ocw.shape)
            return base.scatter_add_(-2, idx, ocw)
        if self.in_perm is not None:
            # rows are stored group-sorted; put them back in input order
            base = self.without("in_perm").dequantize(dtype)
            inv = torch.argsort(self.in_perm.long(), dim=-1)
            idx = inv[..., None].expand(base.shape)
            return torch.gather(base, -2, idx)
        d = self.data
        K, N = d.shape[-2], d.shape[-1]
        if self.kind in (QuantKind.SOFT_FP8, QuantKind.FP8):
            w = d.float()
            b = self.block
            s = torch.repeat_interleave(self.scale, b, dim=-2)[..., :K, :]
            if self.scale.shape[-1] != N:  # blockwise -> every column
                s = torch.repeat_interleave(s, b, dim=-1)[..., :N]
            return (w * s).to(dtype)
        if self.kind in (QuantKind.W8A16, QuantKind.W8A8):
            return (d.float() * self.scale[..., None, :]).to(dtype)
        if self.kind == QuantKind.W4A16:
            if self.packed:
                return unpack_int4(self).dequantize(dtype)
            g = self.block
            scale = torch.repeat_interleave(self.scale, g, dim=-2)[..., :K, :]
            zeros = torch.repeat_interleave(self.zeros, g, dim=-2)[..., :K, :]
            return ((d.float() - zeros) * scale).to(dtype)
        raise ValueError(f"unknown quant kind {self.kind}")


def unpack_int4(q: QTensor) -> QTensor:
    """Packed W4A16 storage [.., K, N/2] -> one nibble a byte [.., K, N].
    Byte column c of a PACK_TILE-column tile holds logical column c in its
    low nibble and column c + PACK_TILE/2 in its high nibble."""
    *lead, K, half = q.data.shape
    h = PACK_TILE // 2
    tiles = q.data.view(torch.uint8).reshape(*lead, K, half // h, h)
    full = torch.cat([tiles & 0xF, tiles >> 4], dim=-1)
    kw = {f.name: getattr(q, f.name) for f in fields(q)}
    kw["data"] = full.reshape(*lead, K, half * 2).view(torch.int8)
    return QTensor(**kw)
