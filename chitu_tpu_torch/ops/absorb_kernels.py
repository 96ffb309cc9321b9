"""MLA absorb projections over the stacked `wkv_b` leaf (B9): the CUDA
kernel's wrapper, its plain PyTorch version and the gate.

Counterpart of `chitu_tpu/ops/pallas_absorb.py`. For w [L, C, H*(dn+dv)]
(per head, dn "uk" lanes then dv "uv" lanes):

- kind="uk" (q absorb):    out[t,h,c] = sum_d x[t,h,d] * w[l,c,h*S+d]
- kind="uv" (v un-absorb): out[t,h,d] = sum_c x[t,h,c] * w[l,c,h*S+dn+d]

with S = dn + dv, f32 accumulation and the output in x's dtype. The kernel
(`csrc/absorb.cu`, built and loaded by `ops/cuda_build.py`) reads exactly
the half of w[layer] a projection needs, by TMA straight from the whole
stack, and x through its strides; about one persistent block an SM walks
the (head, 128-column tile) items that `gemm_plan.absorb_plan` assigns it.
The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Launches count in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from chitu_tpu_torch.ops import cuda_build, gemm_plan as plan
from chitu_tpu_torch.ops.cuda_build import LAUNCHES
from chitu_tpu_torch.ops.cuda_build import check as _check
from chitu_tpu_torch.ops.cuda_build import raise_on as _raise_on
from chitu_tpu_torch.ops.cuda_build import stream as _stream

LAUNCHES.setdefault("absorb_matmul", 0)
MAX_T = plan.AB_MAX_T  # the model's gate: above it the einsum runs on the layer's view


def absorb_kernel_ok(w, dn: int, dv: int, dc: int) -> bool:
    """Dense whole-stacked [L, dc, H*(dn+dv)] leaf with 128-aligned
    per-head halves (the flagship's 128/128); a `QTensor` leaf keeps the
    dequant path (the JAX package's gate, pallas_absorb.py:35-46)."""
    return (
        isinstance(w, torch.Tensor)
        and w.dim() == 3
        and dn % 128 == 0
        and dv % 128 == 0
        and dc % 8 == 0
        and w.shape[-1] % (dn + dv) == 0
    )


def _halves(w: torch.Tensor, layer: int, dn: int, dv: int):
    """(w_uk [C, H, dn], w_uv [C, H, dv]): views of w[layer]."""
    C = w.shape[1]
    wl = w[layer].reshape(C, -1, dn + dv)
    return wl[..., :dn], wl[..., dn:]


def absorb_matmul_plain(
    x: torch.Tensor, w: torch.Tensor, layer: int, kind: str, dn: int, dv: int
) -> torch.Tensor:
    """The einsum on the layer's view, in f32, rounded to x's dtype."""
    w_uk, w_uv = _halves(w, layer, dn, dv)
    if kind == "uk":
        out = torch.einsum("thd,chd->thc", x.float(), w_uk.float())
    else:
        out = torch.einsum("thc,chd->thd", x.float(), w_uv.float())
    return out.to(x.dtype)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("absorb")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.chitu_absorb_matmul.argtypes = [P] * 3 + [L] * 2 + [I] * 11 + [P]
        lib.chitu_absorb_matmul.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def gemm_plan(x: torch.Tensor, w: torch.Tensor, kind: str, dn: int,
              dv: int) -> plan.AbsorbPlan:
    """How `absorb_matmul(x, w, layer, kind, dn, dv)` runs the kernel on
    x's card."""
    T, H, _ = x.shape
    return plan.absorb_plan(T, H, w.shape[1], dn, dv, kind,
                            plan.sm_count(torch, x.device))


def absorb_matmul(
    x: torch.Tensor,  # uk: [T, H, dn]; uv: [T, H, C] (last dim contiguous)
    w: torch.Tensor,  # [L, C, H*(dn+dv)] whole stack
    layer: int,
    kind: str,  # "uk" | "uv"
    dn: int,
    dv: int,
) -> torch.Tensor:
    """-> out [T, H, C] (uk) or [T, H, dv] (uv) in x's dtype."""
    if kind not in ("uk", "uv"):
        raise ValueError(f"kind {kind!r}: expected 'uk' or 'uv'")
    T, H, K = x.shape
    L, C, HS = w.shape
    if HS != H * (dn + dv) or K != (dn if kind == "uk" else C):
        raise ValueError(
            f"x {tuple(x.shape)} does not fit w {tuple(w.shape)} as {kind} "
            f"(dn {dn}, dv {dv})"
        )
    if not x.is_cuda:
        return absorb_matmul_plain(x, w, layer, kind, dn, dv)
    dev = x.device
    if T > MAX_T:
        raise NotImplementedError(f"absorb_matmul: T {T} > {MAX_T}")
    if x.dtype != torch.bfloat16 or x.stride(-1) != 1:
        raise TypeError("absorb_matmul: x must be bf16 with a contiguous last dim")
    _check("w", w, torch.bfloat16, dev)
    out = torch.empty(
        (T, H, C if kind == "uk" else dv), dtype=torch.bfloat16, device=dev
    )
    if T == 0:
        return out
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} of a {L}-layer stack")
    p = plan.absorb_plan(T, H, C, dn, dv, kind, plan.sm_count(torch, dev))
    rc = _lib().chitu_absorb_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.stride(0), x.stride(1),
        0 if kind == "uk" else 1, T, H, C, dn, dv, L, int(layer), p.tn,
        p.per_block, p.blocks, _stream(dev),
    )
    _raise_on(rc, "absorb_matmul")
    LAUNCHES["absorb_matmul"] += 1
    return out
