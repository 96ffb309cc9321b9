"""The dense stacked-layer GEMM (B13): the CUDA kernel of
`csrc/dense_gemm.cu`, its wrapper and its plain PyTorch version.

Counterpart of `chitu_tpu/ops/pallas_quant_gemm.dense_matmul_stacked`:
`y[T, N] = x[T, K] @ w[layer]` for a bf16 stack `w` [L, K, N], summed in
f32 and returned in f32. The kernel reads the layer index itself and
offsets into the whole stack, as the TPU kernel's index map does. It takes
the TPU kernel's own geometry rule: K and N multiples of 128; other shapes
go to `torch.matmul` on the layer's view, as the JAX function falls back
to `jnp.dot` (a documented rule of the reference, not a fallback on
failure). `linear` routes stacked dense weights here when
`CHITU_TPU_DENSE_KERNEL=1` (or `linear.set_dense_kernel(True)`).

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel (or, off the geometry rule, the matmul)
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from chitu_tpu_torch.ops import cuda_build
from chitu_tpu_torch.ops.cuda_build import LAUNCHES

LAUNCHES.setdefault("dense_matmul_stacked", 0)

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("dense_gemm")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.chitu_dense_gemm.argtypes = [P] * 3 + [I] * 4 + [P]
        lib.chitu_dense_gemm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_eligible(K: int, N: int) -> bool:
    """The TPU kernel's geometry rule: K and N multiples of 128."""
    return K % 128 == 0 and N % 128 == 0


def dense_matmul_stacked_plain(
    x: torch.Tensor, layer: int, w: torch.Tensor
) -> torch.Tensor:
    """x [T, K] @ w[layer] with both operands rounded to bf16, as the TPU
    kernel feeds its MXU (a no-op for the bf16 tensors the card serves),
    the products exact in f32 and summed in f32."""
    bf = torch.bfloat16
    return torch.matmul(x.to(bf).float(), w[layer].to(bf).float())


def dense_matmul_stacked(
    x: torch.Tensor,  # [T, K] bf16
    layer: int,
    w: torch.Tensor,  # [L, K, N] bf16, the whole stack
) -> torch.Tensor:
    """-> y [T, N] f32."""
    T, K = x.shape
    L, K2, N = w.shape
    if K2 != K:
        raise ValueError(f"x has {K} columns, the stack's layers {K2} rows")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} of a {L}-layer stack")
    if not x.is_cuda:
        return dense_matmul_stacked_plain(x, layer, w)
    if not kernel_eligible(K, N):
        return torch.mm(x, w[layer].to(x.dtype), out_dtype=torch.float32)
    dev = x.device
    cuda_build.check("x", x, torch.bfloat16, dev)
    cuda_build.check("w", w, torch.bfloat16, dev)
    out = torch.empty((T, N), dtype=torch.float32, device=dev)
    rc = _lib().chitu_dense_gemm(
        cuda_build.ptr(x), cuda_build.ptr(w), cuda_build.ptr(out), T, K, N,
        int(layer), cuda_build.stream(dev),
    )
    cuda_build.raise_on(rc, "dense_matmul_stacked")
    LAUNCHES["dense_matmul_stacked"] += 1
    return out
