"""Linear projections over stacked layer weights.

Counterpart of `chitu_tpu/ops/linear.py`, dense only: the JAX package
leaves `x @ w[layer]` to XLA (linear.py:126-127), and the port leaves it
to `torch.matmul`. Quantized weights (`QTensor` in the JAX package) are
not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """y = x @ w (+ bias). x: [..., in]; w: [in, out] or stacked
    [L, in, out] with `layer` selecting the slice (a view, no copy).
    Accumulates in f32 and rounds once to x.dtype, as the JAX
    `jnp.dot(..., preferred_element_type=f32)` does."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            "quantized weights are not ported yet (ROADMAP queue A, slice 2)"
        )
    if layer is not None and w.dim() == 3:
        w = w[layer]
    y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        if layer is not None and bias.dim() == 2:
            bias = bias[layer]
        y = y + bias.to(y.dtype)
    return y


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
