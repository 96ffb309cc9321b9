"""The dense stacked-layer GEMM (B13): the CUDA kernel launched by
`csrc/dense_gemm.cu`, its wrapper, its plan and its plain PyTorch version.

Counterpart of `chitu_tpu/ops/pallas_quant_gemm.dense_matmul_stacked`:
`y[T, N] = x[T, K] @ w[layer]` for a bf16 stack `w` [L, K, N], summed in
f32 and returned in f32. The kernel is the shared TMA + wgmma mainloop of
`csrc/gemm_common.cuh` with bf16 tiles; it reads the layer index itself
and loads the layer's tiles from one tensor map over the whole stack, as
the TPU kernel's index map does. `gemm_plan` says how a call runs it
(decode tiles with K splits at up to 64 rows, slab tiles above). An x
whose base a tensor map cannot take (not 16-byte aligned) is copied into
a fresh buffer first. Launches repeat bit for bit. It takes
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

from chitu_tpu_torch.ops import cuda_build, gemm_plan as plan
from chitu_tpu_torch.ops.cuda_build import LAUNCHES

LAUNCHES.setdefault("dense_matmul_stacked", 0)

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("dense_gemm")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.chitu_dense_gemm.argtypes = [P] * 3 + [I] * 7 + [P] * 3
        lib.chitu_dense_gemm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_eligible(K: int, N: int) -> bool:
    """The TPU kernel's geometry rule: K and N multiples of 128."""
    return K % 128 == 0 and N % 128 == 0


_WORKSPACE = plan.Workspace()  # split-K partial tiles and tickets


def gemm_plan(x: torch.Tensor, w: torch.Tensor) -> plan.GemmPlan:
    """How `dense_matmul_stacked(x, layer, w)` runs the kernel on x's card.
    The wrapper copies an x no tensor map takes, and the launcher refuses
    such a w, so the plan is one of shapes alone."""
    T, K = x.shape
    return plan.dense_plan(T, K, w.shape[-1], plan.sm_count(torch, x.device))


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
    if x.is_contiguous() and x.data_ptr() % 16:
        x = x.clone()  # a fresh allocation: a base a tensor map can take
    cuda_build.check("x", x, torch.bfloat16, dev)
    cuda_build.check("w", w, torch.bfloat16, dev)
    out = torch.empty((T, N), dtype=torch.float32, device=dev)
    if T == 0:
        return out
    p = plan.dense_plan(T, K, N, plan.sm_count(torch, dev))
    ws, counters = None, None
    if p.splits > 1:
        ws, counters = _WORKSPACE.get(torch, dev, p.ws_floats, p.tickets)
    rc = _lib().chitu_dense_gemm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), T, K, N, L, int(layer), p.tn,
        p.splits, cuda_build.ptr(ws), cuda_build.ptr(counters), cuda_build.stream(dev),
    )
    cuda_build.raise_on(rc, "dense_matmul_stacked")
    LAUNCHES["dense_matmul_stacked"] += 1
    return out
