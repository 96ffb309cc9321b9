"""Per-token int8 activation quantization, alone and fused with RMSNorm:
the two CUDA kernels of `csrc/norm_quant.cu`, their wrappers and their
plain PyTorch versions.

Counterpart of `chitu_tpu/ops/pallas_norm_quant.py`:

- `rms_norm_quant` (B11): `y = x * rsqrt(mean(x^2) + eps) * w`, then
  per-token symmetric int8 of y. The W8A8 path normalizes and quantizes in
  one pass, and the int8 GEMM takes (values, scales) directly.
- `quant_acts` (B12): per-token symmetric int8 of x as it is (mid-FFN
  activations, and the attention output in front of a W8A8 `wo`).

Both in f32: `amax = max(|y|)` floored at 1e-8, `s = amax / 127`,
`q = clip(rint(y / s), -127, 127)` with round-half-to-even and a true
division. A wrapper runs its plain version only for tensors on the CPU;
for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from chitu_tpu_torch.ops import cuda_build
from chitu_tpu_torch.ops.cuda_build import LAUNCHES

for _name in ("rms_norm_quant", "quant_acts"):
    LAUNCHES.setdefault(_name, 0)


@dataclass
class QuantizedActs:
    """Per-token symmetric int8 activations: values + scales."""

    data: torch.Tensor  # [T, D] int8
    scale: torch.Tensor  # [T] f32

    @property
    def shape(self):
        return self.data.shape

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.data.float() * self.scale[:, None]).to(dtype)


def _quantize_rows(y: torch.Tensor) -> QuantizedActs:
    amax = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    s = amax / 127.0
    q = torch.round(y / s).clamp(-127, 127).to(torch.int8)
    return QuantizedActs(data=q, scale=s[:, 0])


def rms_norm_quant_plain(
    x: torch.Tensor, w: torch.Tensor, eps: float
) -> QuantizedActs:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return _quantize_rows(xf * torch.rsqrt(var + eps) * w.float())


def quant_acts_plain(x: torch.Tensor) -> QuantizedActs:
    return _quantize_rows(x.float())


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("norm_quant")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.chitu_rms_norm_quant.argtypes = [P, P, P, P, I, I, F, P]
        lib.chitu_quant_acts.argtypes = [P, P, P, I, I, P]
        lib.chitu_rms_norm_quant.restype = ctypes.c_int
        lib.chitu_quant_acts.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _outputs(x: torch.Tensor):
    T, D = x.shape
    return (
        torch.empty((T, D), dtype=torch.int8, device=x.device),
        torch.empty((T,), dtype=torch.float32, device=x.device),
    )


def rms_norm_quant(
    x: torch.Tensor,  # [T, D]
    w: torch.Tensor,  # [D]
    eps: float,
) -> QuantizedActs:
    """Fused rmsnorm(x) * w -> per-token int8 (values, scales)."""
    if not x.is_cuda:
        return rms_norm_quant_plain(x, w, eps)
    T, D = x.shape
    dev = x.device
    cuda_build.check("x", x, torch.bfloat16, dev)
    cuda_build.check("w", w, torch.bfloat16, dev, (D,))
    xq, s = _outputs(x)
    rc = _lib().chitu_rms_norm_quant(
        cuda_build.ptr(x), cuda_build.ptr(w), cuda_build.ptr(xq),
        cuda_build.ptr(s), T, D, float(eps), cuda_build.stream(dev),
    )
    cuda_build.raise_on(rc, "rms_norm_quant")
    LAUNCHES["rms_norm_quant"] += 1
    return QuantizedActs(data=xq, scale=s)


def quant_acts(x: torch.Tensor) -> QuantizedActs:
    """Per-token int8 quantization of [T, D] activations (no norm)."""
    if not x.is_cuda:
        return quant_acts_plain(x)
    T, D = x.shape
    dev = x.device
    cuda_build.check("x", x, torch.bfloat16, dev)
    xq, s = _outputs(x)
    rc = _lib().chitu_quant_acts(
        cuda_build.ptr(x), cuda_build.ptr(xq), cuda_build.ptr(s), T, D,
        cuda_build.stream(dev),
    )
    cuda_build.raise_on(rc, "quant_acts")
    LAUNCHES["quant_acts"] += 1
    return QuantizedActs(data=xq, scale=s)
