"""Linear projections over stacked layer weights, dense or quantized.

Counterpart of `chitu_tpu/ops/linear.py`: the one entry point every model
layer uses, dispatching on the weight's type. A dense tensor goes to
`torch.matmul` (the JAX package leaves `x @ w[layer]` to XLA), or, for a
stacked [L, K, N] weight with `CHITU_TPU_DENSE_KERNEL=1` (read as the JAX
package reads it) or `set_dense_kernel(True)`, to the dense stacked-layer
GEMM (`ops/dense_gemm_kernels.dense_matmul_stacked`, B13). A `QTensor`
goes to the dequant GEMM (`ops/quant_gemm_kernels.quant_gemm`) or, for
W8A8, through per-token int8 activations to the int8 GEMM: the CUDA
kernels for tensors on the card, their plain versions for tensors on the
CPU. `infer.op_impl=xla` (`set_op_impl`) sends what the JAX package's
`get_op_impl()` governs to the plain versions on the card too: these
GEMMs, B13, the W8A8 activation quantizers and the MLA absorb
projections (the grouped expert GEMM ignores it, as in the JAX package).

A W8A8 product whose input is one rank's slice of each row (a
row-parallel projection under tensor parallelism) takes `row_max`, the
group's in-place MAX all-reduce: the per-token scale is then the whole
row's, as on one device (`quant_acts_rows`).

A quantized weight whose tensor-parallel cut falls inside its
quantization blocks holds the whole blocks over the cut, with a view of
its own rows and columns (`QTensor.rows` / `cols`): its input is padded
with zeros over the rows it does not own (0 * w adds +0 to each sum), so
the rank's partial product holds exactly its rows' terms, and the
view's columns are kept of the product. The kernels see whole blocks.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from chitu_tpu_torch.ops.dense_gemm_kernels import dense_matmul_stacked
from chitu_tpu_torch.ops.norm_quant import (
    QuantizedActs,
    acts_absmax,
    acts_absmax_plain,
    quant_acts,
    quant_acts_given,
    quant_acts_given_plain,
    quant_acts_plain,
)
from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind
from chitu_tpu_torch.ops.quant_gemm_kernels import (
    int8_gemm,
    int8_gemm_plain,
    quant_gemm,
    quant_gemm_plain,
)

# activation handling for QuantKind.FP8 weights (quant.fp8_act): "e4m3"
# rounds the activations through the fp8 grid with dynamic blockwise
# scales; "int8" leaves them as they are, exactly as the JAX package does
# (there the mode is read at one place only, to switch e4m3 on)
_FP8_ACT = "int8"
# stacked dense weights through the dense stacked-layer GEMM (B13) instead
# of torch.matmul on the layer's view
_DENSE_KERNEL = os.environ.get("CHITU_TPU_DENSE_KERNEL", "0") == "1"


# infer.op_impl: "auto" and "pallas" keep the kernels, "xla" takes the
# plain versions (the JAX package's jnp paths) wherever it governs
OP_IMPLS = ("auto", "pallas", "xla")
_OP_IMPL = "auto"


def set_op_impl(impl: str):
    global _OP_IMPL
    if impl not in OP_IMPLS:
        raise ValueError(f"op_impl={impl!r}: expected one of {OP_IMPLS}")
    _OP_IMPL = impl


def get_op_impl() -> str:
    return _OP_IMPL


def op_kernels() -> bool:
    """Whether the calls op_impl governs launch their kernels."""
    return _OP_IMPL != "xla"


def set_dense_kernel(on: bool):
    global _DENSE_KERNEL
    _DENSE_KERNEL = bool(on)


def get_dense_kernel() -> bool:
    return _DENSE_KERNEL


def set_fp8_act(mode: str):
    global _FP8_ACT
    if mode not in ("int8", "e4m3"):
        raise ValueError(f"fp8_act={mode!r}: expected 'int8' or 'e4m3'")
    _FP8_ACT = mode


def get_fp8_act() -> str:
    return _FP8_ACT


def maybe_fp8_act(x: torch.Tensor, w) -> torch.Tensor:
    """Round x through the e4m3 grid when it feeds an FP8 weight under
    `quant.fp8_act="e4m3"`, else x as it is. `linear` applies it itself;
    callers that bypass `linear` (the grouped expert GEMMs of the MoE
    path) call it on their own inputs."""
    if (
        isinstance(w, QTensor)
        and w.kind == QuantKind.FP8
        and _FP8_ACT == "e4m3"
    ):
        from chitu_tpu_torch.quantize.transforms import fp8_act_roundtrip

        return fp8_act_roundtrip(x)
    return x


def _at(t, layer, stacked_dim):
    """`t[layer]` (a view) when t is stacked, else t."""
    if t is not None and layer is not None and t.dim() == stacked_dim:
        return t[layer]
    return t


def quant_acts_rows(x: torch.Tensor, row_max=None) -> QuantizedActs:
    """Per-token int8 of [T, K] activations for a W8A8 product (B12): each
    row under its own absmax, or, with `row_max` (x is this rank's slice
    of rows split over a tensor-parallel group), under the whole row's:
    the slice's absmax [T] f32 goes through `row_max`, the group's
    in-place MAX all-reduce, before the slice is quantized."""
    k = op_kernels()
    if row_max is None:
        return (quant_acts if k else quant_acts_plain)(x)
    amax = row_max((acts_absmax if k else acts_absmax_plain)(x))
    return (quant_acts_given if k else quant_acts_given_plain)(x, amax)


def linear(
    x: Union[torch.Tensor, QuantizedActs],
    w: Union[torch.Tensor, QTensor],
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
    layer: Optional[int] = None,
    row_max=None,
) -> torch.Tensor:
    """y = x @ w (+ bias). x: [..., in] or per-token int8 `QuantizedActs`;
    w: [in, out] or stacked [L, in, out] with `layer` selecting the slice
    (a view, no copy), dense or quantized. A quantized product is summed in
    f32, the bias added in f32, and the result rounded once to
    `out_dtype` (default: x's dtype, bf16 for int8 activations).
    `row_max`: x is a rank's slice of row-parallel rows (`quant_acts_rows`;
    read by a W8A8 weight only)."""
    bias = _at(bias, layer, 2)
    if isinstance(w, QTensor):
        if out_dtype is None:
            out_dtype = (
                torch.bfloat16 if isinstance(x, QuantizedActs) else x.dtype
            )
        return _quantized_matmul(x, w, layer, bias, out_dtype, row_max)
    if isinstance(x, QuantizedActs):
        # dense weight: reconstruct bf16 activations
        x = x.dequantize(torch.bfloat16)
        out_dtype = out_dtype or torch.bfloat16
    if _DENSE_KERNEL and op_kernels() and layer is not None and w.dim() == 3:
        # the kernel indexes the stack itself; f32 sums and output
        y = dense_matmul_stacked(
            x.reshape(-1, x.shape[-1]).contiguous(), layer, w
        ).reshape(*x.shape[:-1], w.shape[-1])
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.to(out_dtype or x.dtype)
    w = _at(w, layer, 3)
    if out_dtype is not None and out_dtype != x.dtype:
        y = matmul_out_dtype(x, w.to(x.dtype), out_dtype)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _quantized_matmul(x, w: QTensor, layer, bias, out_dtype,
                      row_max=None) -> torch.Tensor:
    if w.oc_idx is not None:
        # LLM.int8 outlier decomposition: a small dense product over the
        # few outlier input channels (their int8 rows are zero), in f32
        idx = _at(w.oc_idx, layer, 2).long()
        ocw = _at(w.oc_w, layer, 3)
        if isinstance(x, QuantizedActs):
            xo = (x.data[..., idx].float() * x.scale[:, None]).to(torch.bfloat16)
        else:
            xo = x[..., idx]
        extra = torch.matmul(xo.float(), ocw.float())
        y = _quantized_matmul(
            x, w.without("oc_idx", "oc_w"), layer, None, torch.float32
        ) + extra
        if bias is not None:
            y = y + bias.float()
        return y.to(out_dtype)
    if isinstance(x, QuantizedActs):
        if w.kind != QuantKind.W8A8:
            raise TypeError(
                f"int8 activations need a W8A8 weight, got {w.kind}"
            )
        w = w[layer] if layer is not None and w.data.dim() == 3 else w
        gemm = int8_gemm if op_kernels() else int8_gemm_plain
        return gemm(x.data, x.scale, w, bias, out_dtype)
    x = maybe_fp8_act(x, w)
    if w.in_perm is not None:
        # act-order GPTQ: rows are group-sorted in storage; gather x to
        # match (exact: y = x[:, perm] @ w_sorted)
        x = x[..., _at(w.in_perm, layer, 2).long()]
        w = w.without("in_perm")
    w = w[layer] if layer is not None and w.data.dim() == 3 else w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if w.viewed:
        return _viewed_matmul(x2, w, bias, out_dtype).reshape(*lead, -1)
    if w.kind == QuantKind.W8A8:
        # dynamic per-token int8 activations, then the int8 GEMM
        xa = quant_acts_rows(x2, row_max)
        gemm = int8_gemm if op_kernels() else int8_gemm_plain
        y = gemm(xa.data, xa.scale, w, bias, out_dtype)
    else:
        y = (quant_gemm if op_kernels() else quant_gemm_plain)(
            x2, w, bias, out_dtype)
    return y.reshape(*lead, y.shape[-1])


def _viewed_matmul(x2, w: QTensor, bias, out_dtype) -> torch.Tensor:
    """x2 [T, k] @ a rank's view of a weight stored in whole blocks: x2
    padded with zeros to the stored rows, the GEMM on the stored weight,
    the view's columns kept (the bias added to them in f32, then one
    rounding)."""
    if w.rows is not None:
        x2 = torch.nn.functional.pad(
            x2, (w.rows[0], w.data.shape[-2] - w.rows[1]))
    gemm = quant_gemm if op_kernels() else quant_gemm_plain
    if w.cols is None:
        return gemm(x2, w.stored(), bias, out_dtype)
    y = gemm(x2, w.stored(), None,
             torch.float32 if bias is not None else out_dtype)
    y = torch.cat([y[:, a:b] for a, b in w.cols], dim=-1)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def matmul_out_dtype(
    x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """x @ w with a wider output than the inputs: the head's f32 logits
    from bf16 activations and weights. On CUDA a bf16-in, f32-out GEMM
    (`torch.mm(..., out_dtype=)`, accumulating in f32 and never rounding
    the logits to bf16) reads the bf16 head once, instead of upcasting the
    whole head on every step. On the CPU both operands are upcast."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype:
        y = torch.mm(x2, w, out_dtype=out_dtype)
    else:
        y = torch.mm(x2.to(out_dtype), w.to(out_dtype))
    return y.reshape(*lead, w.shape[-1])
