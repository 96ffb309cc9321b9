"""The quantized GEMMs: the two CUDA kernels of `csrc/quant_gemm.cu`, their
wrappers and their plain PyTorch versions.

Counterpart of `chitu_tpu/ops/pallas_quant_gemm.py`:

- `quant_gemm` (B6 + B7, one kernel family): `y[T, N] = x[T, K] bf16 @
  dequant(W)` accumulated in f32, for W as e4m3 bytes (blockwise
  [K/B, N/B] or rowwise [K/B, N] scales), int8 (per-channel [N] scales)
  or int4 with scales and zeros [K/G, N], one nibble a byte or packed two
  a byte. A layer of a stacked [L, K, N] weight is a view, so the stacked
  and the 2-D TPU kernels are one kernel here. Scales are read in place.
  K and N are free; the quant block must be 32, 64 or a multiple of 128
  rows (what tiles with both of the kernel's K tiles), else the wrapper
  raises NotImplementedError. The kernel is the shared TMA + wgmma
  mainloop (`csrc/gemm_common.cuh`); `gemm_plan` says how a call runs it
  (decode or slab tiles, K splits, TMA or cp.async for each operand).
  Plain version: `QTensor.dequantize` + matmul.
- `int8_gemm` (B10): `int32[T, N] = int8 x[T, K] @ int8 W[K, N]`, exact,
  then `f32(acc) * x_scale[t] * w_scale[n]`. The same mainloop with int8
  tiles (`wgmma ... .s32.s8.s8`; the [K, N] weight transposed tile by tile
  in shared memory); `int8_gemm_plan` says how a call runs it. Plain
  version: an exact integer product (int32 on the CPU, float64 on the
  card, where the sums stay below 2^53).

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from chitu_tpu_torch.ops import cuda_build, gemm_plan as plan
from chitu_tpu_torch.ops.cuda_build import LAUNCHES
from chitu_tpu_torch.ops.qtensor import QTensor, QuantKind

for _name in ("quant_gemm", "int8_gemm"):
    LAUNCHES.setdefault(_name, 0)

_OUT = {torch.float32: 0, torch.bfloat16: 1}


def _plain_epilogue(y, bias, out_dtype):
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def quant_gemm_plain(
    x: torch.Tensor, q: QTensor, bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """x [T, K] @ dequantize(q) [K, N]: the weight rounded to bf16, the
    products summed in f32."""
    wd = q.dequantize(torch.bfloat16)
    y = torch.matmul(x.float(), wd.float())
    return _plain_epilogue(y, bias, out_dtype)


def int8_matmul_plain(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product."""
    if xq.is_cuda:
        return torch.matmul(xq.double(), w.double()).to(torch.int32)
    return torch.matmul(xq.to(torch.int32), w.to(torch.int32))


def int8_gemm_plain(
    xq: torch.Tensor, x_scale: torch.Tensor, q: QTensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    acc = int8_matmul_plain(xq, q.data)
    y = acc.float() * x_scale[:, None] * q.scale[None, :].float()
    return _plain_epilogue(y, bias, out_dtype)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("quant_gemm")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.chitu_quant_gemm.argtypes = [P] * 6 + [I] * 12 + [P] * 3
        lib.chitu_int8_gemm.argtypes = [P] * 6 + [I] * 8 + [P] * 3
        lib.chitu_quant_gemm.restype = ctypes.c_int
        lib.chitu_int8_gemm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_WORKSPACE = plan.Workspace()  # split-K partial tiles and tickets


def gemm_plan(x: torch.Tensor, q: QTensor) -> plan.GemmPlan:
    """How `quant_gemm(x, q)` runs the kernel on x's card."""
    T, K = x.shape
    return plan.quant_plan(
        T, K, q.out_features, q.packed, plan.sm_count(torch, x.device),
        q.data.data_ptr(), x.data_ptr(),
    )


def int8_gemm_plan(xq: torch.Tensor, w: torch.Tensor) -> plan.GemmPlan:
    """How `int8_gemm` / `int8_matmul` run the kernel for int8 x [T, K] and
    weight data [K, N] on x's card. The plan sees the pointers' offsets
    from 16 bytes only (all a tensor map asks of them), so its memo hits
    whatever address the caching allocator hands x."""
    T, K = xq.shape
    return plan.int8_plan(T, K, w.shape[1], plan.sm_count(torch, xq.device),
                          w.data_ptr() % 16, xq.data_ptr() % 16)


def _check_2d(q: QTensor, kinds):
    if q.data.dim() != 2:
        raise ValueError(
            f"expected one layer's [K, N] weight, got {tuple(q.data.shape)}"
        )
    if q.kind not in kinds:
        raise ValueError(f"weight kind {q.kind} is not taken here")
    if q.in_perm is not None or q.oc_idx is not None:
        raise ValueError(
            "in_perm / outlier rows are applied by ops.linear, not the GEMM"
        )


def _check_bias(bias, N, dev):
    if bias is not None:
        cuda_build.check("bias", bias, torch.bfloat16, dev, (N,))


def quant_gemm(
    x: torch.Tensor,  # [T, K] bf16
    q: QTensor,  # one layer: data [K, N] (or [K, N/2] packed int4)
    bias: Optional[torch.Tensor] = None,  # [N]
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """-> y [T, N] = x @ dequant(q) (+ bias), summed in f32."""
    _check_2d(q, (QuantKind.SOFT_FP8, QuantKind.FP8, QuantKind.W8A16,
                  QuantKind.W8A8, QuantKind.W4A16))
    if not x.is_cuda:
        return quant_gemm_plain(x, q, bias, out_dtype)
    dev = x.device
    T, K = x.shape
    N = q.out_features
    if q.in_features != K:
        raise ValueError(f"x has {K} features, the weight takes {q.in_features}")
    cuda_build.check("x", x, torch.bfloat16, dev)
    B = q.block
    if B not in (32, 64) and B % 128:
        raise NotImplementedError(
            f"quant block of {B} rows: the kernel takes 32, 64 or a multiple "
            "of 128"
        )
    kb = (K + B - 1) // B
    if q.kind in (QuantKind.SOFT_FP8, QuantKind.FP8):
        mode, wdtype = 0, torch.float8_e4m3fn
        if q.scale.shape[-1] == N:
            smode, sshape = 1, (kb, N)
        else:
            smode, sshape = 0, (kb, (N + B - 1) // B)
    elif q.kind in (QuantKind.W8A16, QuantKind.W8A8):
        mode, wdtype, smode, sshape = 1, torch.int8, 2, (N,)
    else:
        mode, wdtype, smode, sshape = (3 if q.packed else 2), torch.int8, 1, (kb, N)
    cuda_build.check("weight data", q.data, wdtype, dev)
    cuda_build.check("weight scale", q.scale, torch.float32, dev, sshape)
    if mode >= 2:
        cuda_build.check("weight zeros", q.zeros, torch.float32, dev, sshape)
    _check_bias(bias, N, dev)
    if out_dtype not in _OUT:
        raise TypeError(f"out_dtype {out_dtype}: expected float32 or bfloat16")
    out = torch.empty((T, N), dtype=out_dtype, device=dev)
    if T == 0:
        return out
    p = gemm_plan(x, q)
    ws, counters = None, None
    if p.splits > 1:
        ws, counters = _WORKSPACE.get(torch, dev, p.ws_floats, p.tickets)
    rc = _lib().chitu_quant_gemm(
        cuda_build.ptr(x), cuda_build.ptr(q.data), cuda_build.ptr(q.scale),
        cuda_build.ptr(q.zeros if mode >= 2 else None), cuda_build.ptr(bias),
        cuda_build.ptr(out), T, K, N, mode, smode, B, sshape[-1],
        _OUT[out_dtype], p.tn, p.splits, int(p.tma_w), int(p.tma_x),
        cuda_build.ptr(ws), cuda_build.ptr(counters), cuda_build.stream(dev),
    )
    cuda_build.raise_on(rc, "quant_gemm")
    LAUNCHES["quant_gemm"] += 1
    return out


def _int8_launch(xq, x_scale, w, w_scale, bias, out, out_mode):
    T, K = xq.shape
    p = int8_gemm_plan(xq, w)
    ws, counters = None, None
    if p.splits > 1:
        ws, counters = _WORKSPACE.get(torch, xq.device, p.ws_floats, p.tickets)
    rc = _lib().chitu_int8_gemm(
        cuda_build.ptr(xq), cuda_build.ptr(x_scale), cuda_build.ptr(w),
        cuda_build.ptr(w_scale), cuda_build.ptr(bias), cuda_build.ptr(out),
        T, K, w.shape[1], out_mode, p.tn, p.splits, int(p.tma_w),
        int(p.tma_x), cuda_build.ptr(ws), cuda_build.ptr(counters),
        cuda_build.stream(xq.device),
    )
    cuda_build.raise_on(rc, "int8_gemm")
    LAUNCHES["int8_gemm"] += 1
    return out


def int8_matmul(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int8 GEMM's raw int32 sums [T, N] (the kernel without its
    scaling epilogue); on the CPU the exact plain product."""
    if not xq.is_cuda:
        return int8_matmul_plain(xq, w)
    dev = xq.device
    T, K = xq.shape
    cuda_build.check("xq", xq, torch.int8, dev)
    cuda_build.check("w", w, torch.int8, dev, (K, w.shape[1]))
    out = torch.empty((T, w.shape[1]), dtype=torch.int32, device=dev)
    return _int8_launch(xq, None, w, None, None, out, 2) if T else out


def int8_gemm(
    xq: torch.Tensor,  # [T, K] int8
    x_scale: torch.Tensor,  # [T] f32
    q: QTensor,  # W8A8, one layer: data [K, N] int8, scale [N]
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """-> y [T, N] = f32(xq @ w) * x_scale[:, None] * w_scale[None, :]
    (+ bias)."""
    _check_2d(q, (QuantKind.W8A8,))
    if not xq.is_cuda:
        return int8_gemm_plain(xq, x_scale, q, bias, out_dtype)
    dev = xq.device
    T, K = xq.shape
    N = q.out_features
    if q.in_features != K:
        raise ValueError(f"x has {K} features, the weight takes {q.in_features}")
    cuda_build.check("xq", xq, torch.int8, dev)
    cuda_build.check("x_scale", x_scale, torch.float32, dev, (T,))
    cuda_build.check("weight data", q.data, torch.int8, dev)
    cuda_build.check("weight scale", q.scale, torch.float32, dev, (N,))
    _check_bias(bias, N, dev)
    if out_dtype not in _OUT:
        raise TypeError(f"out_dtype {out_dtype}: expected float32 or bfloat16")
    out = torch.empty((T, N), dtype=out_dtype, device=dev)
    if T == 0:
        return out
    return _int8_launch(
        xq, x_scale, q.data, q.scale, bias, out, _OUT[out_dtype]
    )
